"""Banded Damerau DP verify: the fast fuzzy path for packed engines.

The trie is a *tree*, so a BFS state at node ``v`` with ``j`` haystack
symbols consumed is reachable only along ``v``'s unique root path — its
minimum penalty is exactly the banded weighted edit distance between
``path(v)`` and ``haystack[s : s+j]`` (substitution scaled by the similarity
table, insertion/deletion/swap at their configured penalties; reference edit
branches src/search.rs:776-1089). So instead of expanding a beam of trie
states per anchor, the lane:

1. runs the packed multi-pattern shift-AND scan once over the corpus with
   per-pattern error budgets (``packed_bitap.packed_hits``: the CUDA kernels
   ``scan_bits_kernel``, ``block_offsets_kernel`` and ``hit_words_kernel``)
   — every true match of pattern ``p`` fires p's bit at the match's exact
   end position, and the hits come out as an ordered list;
2. expands each (pattern, end) hit into candidate (output-node field, start)
   pairs: a <=E-edit match of a depth-``d`` output node consumes ``d + net``
   haystack symbols with ``net`` in [-E, E], so ``start = end - d - delta``
   (:func:`expand_candidates`);
3. verifies each candidate with a banded (2E+1 diagonals) Damerau DP over the
   field's path string, replicating the oracle's f32 penalty arithmetic,
   weakest-link floor, per-node prune ceilings and global budget guards
   (:func:`banded_dp`: the CUDA kernel ``banded_dp_kernel`` in
   ``csrc/banded_dp.cu``, or its plain version :func:`banded_dp_torch` for
   CPU tensors);
4. thresholds the emission channels into compacted match rows
   (:func:`emit_rows`), which cross to the host in one copy per slice and are
   decoded there (``ops/emit.decode_matches``).

On the card steps 2-4 are one step per slice (wrapper :func:`dp_pipeline`):
it takes the hit list and writes the match rows, in the order the three
functions above give them (:func:`dp_pipeline_torch` is their composition,
the steps' plain version). At E = 1 without forbidden edit types or
mappings that step is one kernel, ``dp_pipeline_kernel``
(``csrc/dp_pipeline.cu``, a count and a write pass); every other
count-channel call runs the list step (:func:`typed_expand`,
:func:`count_dp`, one read of two totals, :func:`count_emit`;
``csrc/dp_list.cu``),
which compacts the candidates once and runs each candidate's DP once, a
group of lanes per candidate. :func:`banded_dp` stays as the entry point
that holds the DP body of ``csrc/banded_dp.cuh`` against its plain version
channel by channel.

Emission semantics: the oracle's span end ``me`` is the column of the last
*consuming* move (exact/substitution/swap); insertions advance ``j`` without
advancing ``me`` and deletions advance neither (reference state updates
src/search.rs:776-1089). The DP therefore carries two channels per cell:

* ``pen``  — min penalty over ALL scripts (continuation channel: feeds the
  next row's transitions);
* ``pen_e`` — min penalty over scripts whose moves after the last consume are
  deletions only (emission channel): ``pen_e(i,j) = min(diag/swap arrivals,
  pen_e(i-1,j) + p_del)``. Emission at row ``d`` column ``e`` reads
  ``pen_e(d, e)`` — trailing insertions never emit.

Each cell keeps one state PER EDIT COUNT (a Pareto front over (penalty,
edits)); per-cell ties on equal penalty keep the earlier arrival, in the BFS
push order exact/substitution > swap > insertion > deletion
(src/search.rs:776-1089).

Three more lanes ride the same pipeline (:func:`fuzzy_search_dp` with
``forbid`` / ``maps`` / ``typed``; ``ops/engine.DeviceEngine`` claims exactly
the engines the JAX package claims with :func:`forbid_spec_of`,
:class:`MappedSpec` and :class:`TypedSpec`):

* forbid — a total edit budget with some edit types capped at 0
  (``edits(2).swaps(0)``): the count-channel DP with those arrivals switched
  off by a mask the kernels carry;
* mapped — multi-char mappings (``.mapping("ß", "ss")``) as extra arrivals
  ``(row i-pb, band b-drift) -> (row i, band b)`` of the count-channel DP,
  from a flat table (:class:`MapTables`); the ``MAPS`` instances of
  ``count_dp_kernel`` (and of ``dp_body`` in ``csrc/banded_dp.cuh``);
* typed — per-type caps and per-pattern limits: the DP's channels become
  edit-type vectors (insertions, deletions, substitutions, swaps) with
  per-node caps on every move and per-pattern admissibility at emission
  (:class:`TypedTables`, :func:`banded_dp_typed`, :func:`emit_rows_typed`;
  the kernels of ``csrc/dp_typed.cu``, one warp per candidate).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import trace
from . import _cuda_build
from .compact import compact_indices


class VerifyFields:
    """Host-side DP tables: one field per output-bearing trie node.

    Suffix patterns merged into a deeper node's output list (reference
    builder output-union src/builder.rs:239-276) emit with the full walked
    span, so the DP string is the *node path*, not the pattern — the same
    field model as ops/packed_bitap.PackedExact.
    """

    __slots__ = (
        "num_fields", "depth", "node", "path_cls", "path_node", "max_depth",
        "pat2field", "nf_max",
    )

    def __init__(self, num_fields, depth, node, path_cls, path_node, max_depth,
                 pat2field, nf_max):
        self.num_fields = num_fields
        self.depth = depth
        self.node = node
        self.path_cls = path_cls
        self.path_node = path_node
        self.max_depth = max_depth
        self.pat2field = pat2field
        self.nf_max = nf_max

    @staticmethod
    def build(engine) -> Optional["VerifyFields"]:
        dense = engine.dense
        nodes = engine.nodes
        if nodes[0].output:
            return None  # empty patterns keep oracle semantics

        fields: list = []  # (node_id, class path, node path)
        stack = [(0, [], [])]
        while stack:
            ni, cls_path, node_path = stack.pop()
            node = nodes[ni]
            if node.output and ni != 0:
                fields.append((ni, cls_path, node_path))
            for fc, nxt, _single in node.edges:
                cid = dense.char_class.get(fc, 0)
                stack.append((nxt, cls_path + [cid], node_path + [nxt]))
        if not fields:
            return None

        F = len(fields)
        max_depth = max(len(p) for _, p, _ in fields)
        depth = np.asarray([len(p) for _, p, _ in fields], dtype=np.int32)
        node_arr = np.asarray([ni for ni, _, _ in fields], dtype=np.int32)
        path_cls = np.zeros((F, max_depth), dtype=np.int32)
        path_node = np.zeros((F, max_depth), dtype=np.int32)
        for i, (_ni, cls, npath) in enumerate(fields):
            path_cls[i, : len(cls)] = cls
            path_node[i, : len(npath)] = npath

        # pattern -> fields whose node.output contains it (usually one).
        P = len(engine._patterns)
        lists: list[list[int]] = [[] for _ in range(P)]
        for i, (ni, _c, _n) in enumerate(fields):
            for p in nodes[ni].output:
                lists[p].append(i)
        nf_max = max(len(l) for l in lists)
        if nf_max == 0:
            return None
        pat2field = np.full((P, nf_max), -1, dtype=np.int32)
        for p, l in enumerate(lists):
            pat2field[p, : len(l)] = l
        return VerifyFields(F, depth, node_arr, path_cls, path_node, max_depth,
                            pat2field, nf_max)


def verify_fields_of(engine) -> Optional[VerifyFields]:
    vf = getattr(engine, "_verify_fields_cache", None)
    if vf is None:
        vf = VerifyFields.build(engine)
        engine._verify_fields_cache = vf if vf is not None else False
    return vf if vf is not False else None


# ---------------------------------------------------------------------------
# Mapped-engine eligibility: static mapping-arrival tables for the banded DP
# ---------------------------------------------------------------------------

#: Deepest pattern-side mapping walk the DP history window supports.
MAPPED_PB_MAX = 3
#: Unrolled-DP row bound (mapping arrivals need static window indices).
MAPPED_LMAX = 24


class MappedSpec:
    """Static mapping-arrival tables for the banded DP (device lane for
    multi-char mappings — reference hot-loop branch src/search.rs:883-923,
    precompute src/builder.rs:383-442).

    A mapping at path offset ``i`` of a field consumes ``ha`` haystack
    symbols and ``pb`` pattern symbols at a fixed penalty, counting as one
    substitution-class edit. Because the trie is a tree, a
    ``MappingTransition`` at node ``u = node_at(i)`` whose ``next`` equals
    ``node_at(i + pb)`` applies to exactly that segment of the field's path
    — so every mapping the oracle can take along a root-to-output path
    becomes one static DP arrival ``(row i+pb, col j) <- (row i, col j-ha)``.

    ``maps`` is a tuple of ``(i_to, pb, drift, hay_cls, penalty, fields)``
    entries with ``drift = ha - pb`` (|drift| <= 1 keeps the band width at
    2E+1). ``k`` is the packed-scan budget: every edit costs at most
    ``max(2, max(pb, ha))`` unit bitap errors, and the threshold-derived
    ``k_for`` is unsound here because a score-1.0 mapping has penalty 0 —
    so ``k = E * cmax`` from the edit budget alone.
    """

    __slots__ = ("maps", "k", "ph")

    def __init__(self, maps, k, ph):
        self.maps = maps
        self.k = k
        self.ph = ph

    @staticmethod
    def build(engine) -> Optional["MappedSpec"]:
        from .packed_bitap import packed_fuzzy_of

        if not engine.mappings:
            return None
        E = engine.max_edits_fast
        if not 1 <= E <= 6:
            return None
        dense = engine.dense
        if dense.has_multibyte_edges:
            # Exact transitions under mappings follow single-byte edges only
            # on the ASCII path / full-grapheme equality otherwise
            # (src/structs.rs:499-519); the class model matches the oracle
            # only when every edge is a single ASCII char.
            return None
        vf = verify_fields_of(engine)
        if vf is None or vf.max_depth > MAPPED_LMAX:
            return None
        pk = packed_fuzzy_of(engine)
        if pk is None:
            return None

        nodes = engine.nodes
        cmax = 2  # swap costs 2 unit bitap errors (reference prefilter.rs:174-183)
        grouped: dict[tuple, list] = {}
        for fi in range(vf.num_fields):
            d = int(vf.depth[fi])
            path_node = vf.path_node[fi]

            def node_at(i: int) -> int:
                return 0 if i == 0 else int(path_node[i - 1])

            for i in range(d):
                mts = engine.mappings.get(node_at(i))
                if not mts:
                    continue
                for mt in mts:
                    pb = nodes[mt.next].depth - nodes[node_at(i)].depth
                    if pb < 1 or i + pb > d or node_at(i + pb) != mt.next:
                        continue
                    if any(len(g) != 1 for g in mt.haystack):
                        # Multi-char haystack graphemes can never occur under
                        # the lane's haystack gate (all graphemes 1 code
                        # point) — the entry is statically unmatchable.
                        continue
                    ha = len(mt.haystack)
                    drift = ha - pb
                    if pb > MAPPED_PB_MAX or abs(drift) > 1:
                        return None  # whole engine declines -> oracle
                    hay_cls = tuple(dense.char_class.get(g, 0) for g in mt.haystack)
                    if 0 in hay_cls:
                        return None  # defensive: dense must class every hay char
                    key = (i + pb, pb, drift, hay_cls, float(np.float32(mt.penalty)))
                    grouped.setdefault(key, []).append(fi)
        maps = tuple(
            (i_to, pb, drift, hay_cls, pen, tuple(sorted(set(fields))))
            for (i_to, pb, drift, hay_cls, pen), fields in sorted(grouped.items())
        )
        k = E * max(cmax, max(
            (max(pb, pb + drift) for _t, pb, drift, _h, _p, _f in maps),
            default=1,
        ))
        from ..prefilter import MAX_USEFUL_K

        if k > MAX_USEFUL_K:
            return None
        ph = max([2] + [pb for _t, pb, _d, _h, _p, _f in maps])
        return MappedSpec(maps, k, ph)


def mapped_spec_of(engine) -> Optional[MappedSpec]:
    ms = getattr(engine, "_mapped_spec_cache", None)
    if ms is None:
        ms = MappedSpec.build(engine)
        engine._mapped_spec_cache = ms if ms is not None else False
    return ms if ms is not False else None


# ---------------------------------------------------------------------------
# Typed-limits eligibility: channels are edit-type VECTORS, not counts
# ---------------------------------------------------------------------------

_CAP_BIG = 255
#: Most type-vector channels the typed DP compiles (E=4 all-free needs 70;
#: tighter per-type caps keep higher budgets under this too).
MAX_TYPED_CHANNELS = 96


def _caps_of(lim) -> tuple:
    """(cap_edits, cap_ins, cap_del, cap_subs, cap_swaps) with None -> BIG
    (finalized limits: either ``edits_`` set with per-type None = unlimited
    within the total, or ``edits_`` None with every per-type cap set —
    reference src/structs.rs:317-335)."""
    if lim is None:
        return (0, 0, 0, 0, 0)
    g = lambda v: _CAP_BIG if v is None else int(v)
    return (g(lim.edits_), g(lim.insertions_), g(lim.deletions_),
            g(lim.substitutions_), g(lim.swaps_))


def _total_of(lim) -> int:
    if lim is None:
        return 0
    if lim.edits_ is not None:
        return int(lim.edits_)
    return int((lim.insertions_ or 0) + (lim.deletions_ or 0)
               + (lim.substitutions_ or 0) + (lim.swaps_ or 0))


class TypedSpec:
    """Static channel spec for per-type / per-pattern limit configurations.

    The uniform DP keeps one state per (cell, edit COUNT); with per-type
    caps two equal-penalty scripts with different type mixes are no longer
    interchangeable, so channels become the feasible type VECTORS
    (i, d, s, w) — exactly the oracle's visited-key granularity
    (src/search.rs:31-50). Per-node caps (reference get_node_limits,
    src/search.rs:60-71 + ahead-checks 87-169) mask moves per path row;
    per-pattern emission limits (src/search.rs:151-169) mask channels per
    limits-class at emission.
    """

    __slots__ = (
        "vecs", "E", "sub_src", "ins_src", "del_src", "swap_src", "cnts",
        "node_caps", "root_caps", "limcls", "adm", "n_limcls",
    )

    @staticmethod
    def build(engine) -> Optional["TypedSpec"]:
        pats = engine._patterns
        lims = [p.limits if p.limits is not None else engine.limits for p in pats]
        if all(l is None for l in lims):
            return None
        totals = [_total_of(l) for l in lims]
        E = max(totals)
        if not (1 <= E <= 6):
            return None  # matches the FAST-path ceiling; beyond, oracle serves
        caps = [_caps_of(l) for l in lims]
        loose = tuple(max(c[i] for c in caps) for i in range(5))
        # Feasible vectors under the loosest applicable caps; the channel
        # count grows ~E^4 unconstrained, and MAX_TYPED_CHANNELS bounds the
        # kernel size — past it the oracle serves.
        vecs = []
        for i in range(min(E, loose[1]) + 1):
            for d in range(min(E, loose[2]) + 1):
                for su in range(min(E, loose[3]) + 1):
                    for w in range(min(E, loose[4]) + 1):
                        if i + d + su + w <= min(E, loose[0]):
                            vecs.append((i, d, su, w))
        if len(vecs) > MAX_TYPED_CHANNELS:
            return None
        vecs.sort(key=lambda v: (sum(v), v))
        index = {v: c for c, v in enumerate(vecs)}
        spec = TypedSpec()
        spec.vecs = tuple(vecs)
        spec.E = E
        spec.sub_src = tuple(
            index.get((v[0], v[1], v[2] - 1, v[3]), -1) for v in vecs
        )
        spec.ins_src = tuple(
            index.get((v[0] - 1, v[1], v[2], v[3]), -1) for v in vecs
        )
        spec.del_src = tuple(
            index.get((v[0], v[1] - 1, v[2], v[3]), -1) for v in vecs
        )
        spec.swap_src = tuple(
            index.get((v[0], v[1], v[2], v[3] - 1), -1) for v in vecs
        )
        spec.cnts = tuple(
            v[0] | (v[1] << 8) | (v[2] << 16) | (v[3] << 24) for v in vecs
        )

        # Per-node caps (pattern_index -> its limits, else the global).
        nodes = engine.nodes
        nc = np.zeros((len(nodes), 5), dtype=np.int32)
        gcaps = _caps_of(engine.limits)
        for ni, node in enumerate(nodes):
            pi = node.pattern_index
            if pi is not None and pats[pi].limits is not None:
                nc[ni] = _caps_of(pats[pi].limits)
            else:
                nc[ni] = gcaps
        spec.node_caps = nc
        spec.root_caps = tuple(int(x) for x in nc[0])

        # Emission admissibility per limits-class (src/search.rs:151-169).
        sig_ids: dict = {}
        limcls = np.zeros(len(pats), dtype=np.int32)
        adm = []
        for pi, l in enumerate(lims):
            cs = _caps_of(l)
            lc = sig_ids.get(cs)
            if lc is None:
                lc = len(adm)
                sig_ids[cs] = lc
                adm.append(tuple(
                    int(sum(v) <= cs[0] and v[0] <= cs[1] and v[1] <= cs[2]
                        and v[2] <= cs[3] and v[3] <= cs[4])
                    for v in vecs
                ))
            limcls[pi] = lc
        spec.limcls = limcls
        spec.adm = tuple(adm)
        spec.n_limcls = len(adm)
        return spec


def forbid_spec_of(engine) -> Optional[tuple]:
    """(E, no_ins, no_del, no_sub, no_swap) for configurations that are a
    total edit budget with some edit types simply FORBIDDEN (cap 0) and the
    rest unlimited within the total — e.g. ``edits(2).swaps(0)``. The JAX
    package serves these on the count-channel DP with the forbidden arrivals
    compiled out."""
    if engine.has_pattern_limits or engine.mappings:
        return None
    lim = engine.limits
    if lim is None or lim.edits_ is None or not 1 <= lim.edits_ <= 6:
        return None
    caps = (lim.insertions_, lim.deletions_, lim.substitutions_, lim.swaps_)
    if any(c not in (None, 0) for c in caps):
        return None
    if all(c is None for c in caps):
        return None  # plain FAST config; served without this routing
    return (int(lim.edits_),) + tuple(c == 0 for c in caps)


def typed_spec_of(engine) -> Optional[TypedSpec]:
    sp = getattr(engine, "_typed_spec_cache", None)
    if sp is None:
        sp = TypedSpec.build(engine)
        engine._typed_spec_cache = sp if sp is not None else False
    return sp if sp is not False else None


# ---------------------------------------------------------------------------
# DP tables on the device
# ---------------------------------------------------------------------------

class DpTables:
    """The DP's tables on one device.

    ``depth`` [F], ``node`` [F], ``path_cls`` / ``path_node`` [F, Lmax]
    (int32: per field, its depth, output node, and the class and node id of
    each path row), ``sim`` [C, C] f32 class similarity, ``out_list``
    [N, MO] int32 output patterns per node (-1 padded), ``pat_len`` /
    ``pat_weight`` [P] f32, ``sb_edge`` [N, C] int8 single-byte edges,
    ``out_count`` [N] int32, ``node_ceil`` [N] f32 per-node prune ceilings
    at one threshold (or None)."""

    __slots__ = ("depth", "node", "path_cls", "path_node", "sim", "out_list",
                 "pat_len", "pat_weight", "sb_edge", "out_count", "node_ceil")

    def __init__(self, **arrays):
        for name in self.__slots__:
            setattr(self, name, arrays[name])

    @property
    def Lmax(self) -> int:
        return self.path_cls.shape[1]

    @property
    def C(self) -> int:
        return self.sim.shape[0]

    @property
    def device(self) -> torch.device:
        return self.depth.device

    def with_ceil(self, node_ceil: torch.Tensor) -> "DpTables":
        """The same tables with the ceilings of another threshold."""
        arrays = {name: getattr(self, name) for name in self.__slots__}
        arrays["node_ceil"] = node_ceil
        return DpTables(**arrays)


def dp_tables_from_numpy(depth, node, path_cls, path_node, sim, out_list,
                         pat_len, pat_weight, sb_edge, out_count,
                         node_ceil=None, device="cpu") -> DpTables:
    """The DP's tables on ``device`` from the numpy arrays both packages
    build (``VerifyFields`` arrays, ``dense.sim`` / ``out_list`` /
    ``pat_len`` / ``pat_weight`` / ``sb_edge`` / ``out_count``, and the
    per-node ceilings of one threshold)."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    F = len(depth)
    return DpTables(
        depth=put(depth, np.int32), node=put(node, np.int32),
        path_cls=put(np.reshape(path_cls, (F, -1)), np.int32),
        path_node=put(np.reshape(path_node, (F, -1)), np.int32),
        sim=put(sim, np.float32), out_list=put(out_list, np.int32),
        pat_len=put(pat_len, np.float32), pat_weight=put(pat_weight, np.float32),
        sb_edge=put(sb_edge, np.int8), out_count=put(out_count, np.int32),
        node_ceil=None if node_ceil is None else put(node_ceil, np.float32),
    )


#: Columns of :attr:`MapTables.table`.
MAP_COLS = 9
#: Haystack symbols one mapping arrival may consume (``MAPPED_PB_MAX + 1``).
MAP_HA_MAX = 4


class MapTables:
    """The mapping arrivals of a :class:`MappedSpec` on one device.

    ``entries`` is ``MappedSpec.maps`` itself (the plain version walks it).
    ``table`` int32 [n, 9] holds per entry, in the same order (sorted by
    target row first): target row ``i_to``, ``pb``, ``drift``, ``ha``, the
    ``ha`` haystack classes last-consumed first (4 columns, -2 padded), and
    the penalty's f32 bits. ``row_ptr`` int32 [Lmax + 2]: the entries that
    target row ``i`` are ``row_ptr[i] .. row_ptr[i + 1]``. ``fields`` int32
    [n, FW]: bit ``f & 31`` of word ``f >> 5`` is set where the entry applies
    to field ``f``."""

    __slots__ = ("entries", "table", "row_ptr", "fields")

    def __init__(self, entries, table, row_ptr, fields):
        self.entries = entries
        self.table = table
        self.row_ptr = row_ptr
        self.fields = fields

    @property
    def ph(self) -> int:
        """Rows of history the arrivals reach back."""
        return max([2] + [e[1] for e in self.entries])


def map_tables_from_spec(maps: tuple, num_fields: int, Lmax: int, device="cpu") -> MapTables:
    """``MappedSpec.maps`` (tuples of ``(i_to, pb, drift, hay_cls, penalty,
    fields)``, sorted) as a :class:`MapTables` on ``device``."""
    n = len(maps)
    fw = max(1, -(-num_fields // 32))
    table = np.zeros((n, MAP_COLS), np.int32)
    fields = np.zeros((n, fw), np.uint32)
    row_ptr = np.zeros(Lmax + 2, np.int32)
    last = 0
    for mi, (i_to, pb, drift, hay_cls, pen, flds) in enumerate(maps):
        ha = len(hay_cls)
        if not (1 <= i_to <= Lmax and 1 <= pb <= MAPPED_PB_MAX and abs(drift) <= 1
                and ha == pb + drift and ha <= MAP_HA_MAX and i_to >= last):
            raise ValueError(f"mapping entry {mi} outside the DP's model: {maps[mi][:4]}")
        last = i_to
        rev = list(hay_cls[::-1]) + [-2] * (MAP_HA_MAX - ha)
        table[mi] = [i_to, pb, drift, ha, *rev,
                     np.float32(pen).view(np.int32).item()]
        for f in flds:
            if not 0 <= f < num_fields:
                raise ValueError(f"mapping entry {mi} names field {f} of {num_fields}")
            fields[mi, f >> 5] |= np.uint32(1) << np.uint32(f & 31)
        row_ptr[i_to + 1:] += 1
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return MapTables(tuple(maps), put(table), put(row_ptr), put(fields.view(np.int32)))


#: Columns of :attr:`TypedTables.graph`.
TYPED_COLS = 10


class TypedTables:
    """The typed DP's tables of a :class:`TypedSpec` on one device.

    ``graph`` int32 [NCH, 10] per channel (a type vector, channels sorted by
    (sum, vector), channel 0 the zero vector): the source channel of its
    substitution, insertion, deletion and swap arrival (-1: none), the
    vector's sum, its four components (insertions, deletions,
    substitutions, swaps) and its packed counts. ``node_caps`` int32 [N, 5]
    (edits, insertions, deletions, substitutions, swaps; 255 = unlimited),
    ``root_caps`` int32 [5] the caps of path row 0, ``limcls`` int32 [P] each
    pattern's limits class, ``adm`` int32 [NLC, NCH] whether a class admits a
    channel at emission."""

    __slots__ = ("graph", "node_caps", "root_caps", "limcls", "adm")

    def __init__(self, graph, node_caps, root_caps, limcls, adm):
        self.graph = graph
        self.node_caps = node_caps
        self.root_caps = root_caps
        self.limcls = limcls
        self.adm = adm

    @property
    def nch(self) -> int:
        return self.graph.shape[0]


def typed_tables_from_numpy(vecs, sub_src, ins_src, del_src, swap_src, cnts, root_caps,
                            node_caps, limcls, adm, device="cpu") -> TypedTables:
    """A :class:`TypedSpec`'s static tuples and numpy arrays as a
    :class:`TypedTables` on ``device``."""
    vecs = np.asarray(vecs, np.int64).reshape(-1, 4)
    nch = len(vecs)
    if not 1 <= nch <= MAX_TYPED_CHANNELS or vecs[0].any():
        raise ValueError(f"{nch} typed channels (1..{MAX_TYPED_CHANNELS}, zero vector first)")
    graph = np.stack([np.asarray(a, np.int64) for a in (sub_src, ins_src, del_src, swap_src)]
                     + [vecs.sum(1)] + list(vecs.T) + [np.asarray(cnts, np.int64)], axis=1)
    if graph.shape != (nch, TYPED_COLS) or (graph[:, :4] >= nch).any():
        raise ValueError("typed channel graph of the wrong shape")
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
    return TypedTables(
        put(graph), put(np.reshape(node_caps, (-1, 5))), put(np.reshape(root_caps, 5)),
        put(limcls), put(np.reshape(adm, (-1, nch))))


class DpVariant(NamedTuple):
    """Which DP a lane runs: ``forbid`` the (no_ins, no_del, no_sub, no_swap)
    flags of the count-channel DP, ``maps`` its mapping arrivals, ``typed``
    the typed DP's tables (then the other two are unset)."""

    forbid: Optional[Tuple[bool, bool, bool, bool]] = None
    maps: Optional[MapTables] = None
    typed: Optional[TypedTables] = None


def _forbid_mask(forbid) -> int:
    """The kernels' mask: bit 0 no insertions, 1 no deletions, 2 no
    substitutions, 3 no swaps."""
    if forbid is None:
        return 0
    if len(forbid) != 4:
        raise ValueError("forbid is (no_ins, no_del, no_sub, no_swap)")
    return sum(1 << i for i, flag in enumerate(forbid) if flag)


class DpPenalties(NamedTuple):
    """The DP's f32 scalars: global budget ``max_pen``, per-edit penalties,
    and the weakest-link similarity ``floor``."""

    max_pen: np.float32
    p_sub: np.float32
    p_ins: np.float32
    p_del: np.float32
    p_swap: np.float32
    floor: np.float32


# ---------------------------------------------------------------------------
# Candidate expansion
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _combos(E: int, BITS: tuple, P2F: tuple, DEPTHS: tuple) -> np.ndarray:
    """[5, n_combo] int64 (match-word column, bit, field, start offset
    ``d + b - E``, ``b == 0``) per (pattern, field, band), combo-major in
    the JAX package's order."""
    rows = []
    for p, (col, sh) in enumerate(BITS):
        for fld in P2F[p]:
            d = DEPTHS[fld]
            for b in range(2 * E + 1):
                rows.append((col, sh, fld, d + (b - E), int(b == 0)))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 5).T.copy()


def expand_candidates(pos, words, start_lo, start_hi, pos_hi, E, BITS, P2F, DEPTHS,
                      h0: int = 0, combos: bool = False):
    """Hit (pos, words) -> candidate (field, start) pairs with ``start_lo <=
    start < start_hi`` and hit position ``< pos_hi`` (the sliced path keeps
    the starts a slice owns; reference ownership rule src/stream.rs:262-297).

    ``pos`` [K] int64 ascending hit positions and ``words`` [K, 2W] int64
    u32 halves, as ``packed_hits`` returns them. ``BITS`` holds each
    pattern's (match-word column, bit), ``P2F`` each pattern's fields and
    ``DEPTHS`` each field's depth (python ints). Hits before ``h0`` are not
    expanded, only read as the predecessor of hit ``h0`` (a range of a
    longer hit list, handed its preceding hit).

    Order as in the JAX package: combo-major over (pattern, field, band),
    hits ascending within each combo. Run dedup: a hit run at consecutive
    ends e-1, e for the same pattern generates the same (field, start) from
    (e, b) and (e-1, b-1), so only the b == 0 copy (or the run's first end)
    is kept. Returns (cand_field, cand_start), int32 [M] each, and with
    ``combos`` each candidate's combo index too."""
    dev = pos.device
    K = pos.numel()
    col, sh, fld, off, first = torch.from_numpy(_combos(E, BITS, P2F, DEPTHS)).to(dev)
    if K == 0 or col.numel() == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return (empty, empty.clone()) + ((empty.clone(),) if combos else ())
    fired = ((words[:, col] >> sh) & 1) == 1                      # [K, n_combo]
    hit_ok = (pos >= 0) & (pos < pos_hi) & (torch.arange(K, device=dev) >= h0)
    prev_same = torch.zeros(K, dtype=torch.bool, device=dev)
    prev_same[1:] = pos[1:] == pos[:-1] + 1
    dup = torch.zeros_like(fired)
    dup[1:] = fired[:-1] & prev_same[1:, None]
    ends = pos + 1
    start = ends[:, None] - off[None, :]                          # [K, n_combo]
    ok = (
        fired & hit_ok[:, None] & (start >= start_lo) & (start < start_hi)
        & ((first == 1)[None, :] | ~dup)
    )
    idx = compact_indices(ok.T.reshape(-1))                        # combo-major
    c = idx // K
    h = idx - c * K
    cand_field = fld[c].to(torch.int32)
    cand_start = (ends[h] - off[c]).to(torch.int32)
    if combos:
        return cand_field, cand_start, c.to(torch.int32)
    return cand_field, cand_start


# ---------------------------------------------------------------------------
# Banded DP: plain version and kernel wrapper
# ---------------------------------------------------------------------------

def banded_dp_torch(cand_field, cand_start, ids, limit, T: DpTables,
                    pens: DpPenalties, E: int, deadend: bool = False,
                    forbid=None, maps: Optional[MapTables] = None):
    """Plain version of ``banded_dp_kernel``: the JAX package's
    ``verify_dp._banded_dp`` (count channels), op for op in f32.

    ``cand_field`` / ``cand_start`` [M] int32 (field -1 = dead slot),
    ``ids`` the dense class-id stream (reads below 0 or at/after ``limit``
    are out of text, -1), ``T`` the tables with ``node_ceil`` set.
    ``deadend`` enables the reference's last-edit dead-end filter
    (src/search.rs:839-847, 994-1007, 1050-1063): an edit move that spends
    the final budget unit is dropped unless the resulting node has output or
    a single-byte edge matching the next text char. ``forbid`` (no_ins,
    no_del, no_sub, no_swap) drops those arrivals, the trailing deletion of
    the emission channel with the deletions. ``maps`` adds the mapping
    arrivals (src/search.rs:883-923): ``(row i-pb, band b-drift) -> (row i,
    band b)`` consuming ``ha`` haystack symbols equal to the entry's classes,
    at a fixed penalty, counting one substitution; merged into the consuming
    and the continuation channel after the deletion and before the
    insertions, in the entries' order.

    Returns (pen [B*NE, M] f32, cnt [B*NE, M] int32): the emission channel
    at row ``depth``, column ``depth + (b - E)``, per exact edit count, row
    ``b * NE + e``; dead cells carry +inf. Counts pack the script's edit
    types as ``ins | del << 8 | sub << 16 | swap << 24``."""
    dev = cand_field.device
    B, NE = 2 * E + 1, E + 1
    M = cand_field.numel()
    Lmax = T.Lmax
    f32 = torch.float32
    INF = float("inf")
    scal = lambda x: torch.tensor(float(np.float32(x)), dtype=f32, device=dev)
    max_pen, p_sub, p_ins, p_del, p_swap, floor = (scal(x) for x in pens)
    f_ins, f_del, f_sub, f_swap = forbid if forbid is not None else (False,) * 4
    maps_by_row: dict = {}
    for i_to, *entry in (maps.entries if maps is not None else ()):
        maps_by_row.setdefault(i_to, []).append(entry)
    PH = maps.ph if maps is not None else 2

    f = cand_field.clamp(min=0).long()
    alive = cand_field >= 0
    WLEN = Lmax + 2 * E + 1 + (1 if deadend else 0)
    idx = (cand_start.long() - (E + 1))[None, :] + torch.arange(WLEN, device=dev)[:, None]
    sym = ids[idx.clamp(0, ids.numel() - 1)].long()
    win = torch.where((idx >= 0) & (idx < limit), sym, -1)        # [WLEN, M]
    pcls = T.path_cls.long()[f].T                                   # [Lmax, M]
    pnode = T.path_node.long()[f].T
    dpth = torch.where(alive, T.depth.long()[f], 0)
    ceil_t = T.node_ceil[pnode]                                     # [Lmax, M]
    if deadend:
        out_t = T.out_count[pnode] > 0
        sbe = T.sb_edge.long()

    def grid(val, dtype):
        return [[torch.full((M,), val, dtype=dtype, device=dev) for _ in range(NE)]
                for _ in range(B)]

    zero_or_inf = torch.where(alive, 0.0, INF).to(f32)
    prev_pen, prev_cnt = grid(INF, f32), grid(0, torch.int32)
    prev_pen[E][0] = zero_or_inf
    # hist[p - 1] is row i - p; rows below 0 are dead.
    hist = [(prev_pen, prev_cnt)] + [(grid(INF, f32), grid(0, torch.int32))
                                     for _ in range(PH - 1)]
    preve_pen, preve_cnt = grid(INF, f32), grid(0, torch.int32)   # emission row 0
    preve_pen[E][0] = zero_or_inf
    emit_pen, emit_cnt = grid(INF, f32), grid(0, torch.int32)

    def merge(bp, bc, op, oc, ok):
        take = ok & (op < bp)
        return torch.where(take, op, bp), torch.where(take, oc, bc)

    for i in range(1, Lmax + 1):
        (prev_pen, prev_cnt), (prev2_pen, prev2_cnt) = hist[0], hist[1]
        row_live = alive & (i <= dpth)
        pc, pc_prev = pcls[i - 1], pcls[max(i - 2, 0)]
        ceil_i = ceil_t[i - 1]
        hcs, okrow = [], []
        cons_pen, cons_cnt = grid(INF, f32), grid(0, torch.int32)
        new_pen, new_cnt = grid(INF, f32), grid(0, torch.int32)
        for b in range(B):
            hc = win[i + b]
            if deadend:
                nxt = win[i + b + 1]
                edge = sbe[pnode[i - 1], nxt.clamp(min=0)] > 0
                okrow.append(out_t[i - 1] | ((nxt >= 0) & edge))
            hcs.append(hc)
        for b in range(B):
            j = i + (b - E)  # haystack symbols consumed at this cell
            hc, hc_jm1 = hcs[b], win[i - 1 + b]
            sim = torch.where(hc >= 0, T.sim[pc, hc.clamp(min=0)], 0.0)
            spen = p_sub * (1.0 - sim)
            for e in range(NE):
                # exact: (i-1, b, e) — no edit (src/search.rs:776-798). The
                # count is carried even where the penalty is dead, as in JAX.
                p_pen = prev_pen[b][e]
                bp = torch.full_like(p_pen, INF)
                if j >= 1:
                    bp = torch.where(torch.isfinite(p_pen) & (hc == pc), p_pen, INF)
                bc = prev_cnt[b][e]
                if e >= 1 and j >= 1 and not f_sub:
                    # substitution: (i-1, b, e-1) (src/search.rs:803-874)
                    q_pen, q_cnt = prev_pen[b][e - 1], prev_cnt[b][e - 1]
                    ok_s = (
                        torch.isfinite(q_pen) & (hc >= 0) & (hc != pc)
                        & ~(sim < floor) & ~(spen > (max_pen - q_pen))
                    )
                    if deadend and e == NE - 1:
                        ok_s = ok_s & okrow[b]
                    bp, bc = merge(bp, bc, q_pen + spen, q_cnt + 0x1_0000, ok_s)
                if e >= 1 and i >= 2 and j >= 2 and not f_swap:
                    # swap: (i-2, b, e-1) (src/search.rs:935-989)
                    s_pen, s_cnt = prev2_pen[b][e - 1], prev2_cnt[b][e - 1]
                    ok_sw = (
                        torch.isfinite(s_pen) & ~(p_swap > (max_pen - s_pen))
                        & (hc >= 0) & (hc_jm1 >= 0)
                        & (hc == pc_prev) & (hc_jm1 == pc)
                    )
                    bp, bc = merge(bp, bc, s_pen + p_swap, s_cnt + 0x100_0000, ok_sw)
                cons_pen[b][e], cons_cnt[b][e] = bp, bc
                if e >= 1 and b + 1 < B and not f_del:
                    # deletion: (i-1, b+1, e-1) — consume pc only
                    # (src/search.rs:1035-1089; column j is band b+1 on row i-1)
                    d_pen, d_cnt = prev_pen[b + 1][e - 1], prev_cnt[b + 1][e - 1]
                    ok_del = torch.isfinite(d_pen) & ~(p_del > (max_pen - d_pen))
                    if deadend and e == NE - 1:
                        ok_del = ok_del & okrow[b]
                    bp, bc = merge(bp, bc, d_pen + p_del, d_cnt + 0x100, ok_del)
                new_pen[b][e], new_cnt[b][e] = bp, bc

        # Mapping arrivals: the guard is the oracle's, new_pen > max_pen at
        # push time. Out-of-text symbols read -1, never a dedicated class.
        for pb, drift, hay_cls, mpen, fields in maps_by_row.get(i, ()):
            if i - pb < 0:
                continue
            src_pen, src_cnt = hist[pb - 1]
            ha = len(hay_cls)
            fm = torch.isin(cand_field, torch.tensor(fields, dtype=torch.int32, device=dev))
            mp = scal(mpen)
            for b in range(B):
                b_src = b - drift
                if not 0 <= b_src < B or i + (b - E) < ha:
                    continue
                ok_m = fm
                for t in range(ha):
                    ok_m = ok_m & (win[i + b + 1 - ha + t] == hay_cls[t])
                for e in range(1, NE):
                    q_pen = src_pen[b_src][e - 1]
                    val = q_pen + mp
                    ok_e = ok_m & torch.isfinite(q_pen) & ~(val > max_pen)
                    cntv = src_cnt[b_src][e - 1] + 0x1_0000
                    cons_pen[b][e], cons_cnt[b][e] = merge(
                        cons_pen[b][e], cons_cnt[b][e], val, cntv, ok_e)
                    new_pen[b][e], new_cnt[b][e] = merge(
                        new_pen[b][e], new_cnt[b][e], val, cntv, ok_e)

        # insertion: same row, (b-1, e-1) -> b — consume hc only, ascending b
        # (src/search.rs:994-1029), reading the already-updated band b-1.
        # Forbidden from cells with zero hay consumed: source col j-1 >= 1.
        for b in (range(1, B) if not f_ins else ()):
            j = i + (b - E)
            if j < 2:
                continue
            for e in range(1, NE):
                ip, ic = new_pen[b - 1][e - 1], new_cnt[b - 1][e - 1]
                ok_ins = (
                    torch.isfinite(ip) & ~(p_ins > (max_pen - ip)) & (hcs[b] >= 0)
                )
                if deadend and e == NE - 1:
                    ok_ins = ok_ins & okrow[b]
                new_pen[b][e], new_cnt[b][e] = merge(
                    new_pen[b][e], new_cnt[b][e], ip + p_ins, ic + 1, ok_ins
                )

        # Per-node prune ceiling + row liveness (src/search.rs:637-642), and
        # the emission channel: min(consuming arrival, trailing deletion from
        # the emission channel one row up — column j is band b+1 there).
        newe_pen, newe_cnt = grid(INF, f32), grid(0, torch.int32)
        emit_here = row_live & (i == dpth)
        for b in range(B):
            for e in range(NE):
                dead = ~row_live | (new_pen[b][e] > ceil_i)
                new_pen[b][e] = torch.where(dead, INF, new_pen[b][e])
                ep, ec = cons_pen[b][e], cons_cnt[b][e]
                if e >= 1 and b + 1 < B and not f_del:
                    t_pen, t_cnt = preve_pen[b + 1][e - 1], preve_cnt[b + 1][e - 1]
                    ok_t = torch.isfinite(t_pen) & ~(p_del > (max_pen - t_pen))
                    if deadend and e == NE - 1:
                        ok_t = ok_t & okrow[b]
                    ep, ec = merge(ep, ec, t_pen + p_del, t_cnt + 0x100, ok_t)
                edead = ~row_live | (ep > ceil_i)
                newe_pen[b][e] = torch.where(edead, INF, ep)
                newe_cnt[b][e] = ec
                emit_pen[b][e] = torch.where(emit_here, newe_pen[b][e], emit_pen[b][e])
                emit_cnt[b][e] = torch.where(emit_here, newe_cnt[b][e], emit_cnt[b][e])
        hist = [(new_pen, new_cnt)] + hist[: PH - 1]
        preve_pen, preve_cnt = newe_pen, newe_cnt

    pen = torch.stack([emit_pen[b][e] for b in range(B) for e in range(NE)])
    cnt = torch.stack([emit_cnt[b][e] for b in range(B) for e in range(NE)])
    return pen, cnt


#: Edit budgets the DP kernel is instantiated for.
MAX_E = 6


def _check_dp(cand_field, cand_start, ids, T: DpTables, E: int) -> None:
    for name, t in (("cand_field", cand_field), ("cand_start", cand_start)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
    if cand_field.shape != cand_start.shape:
        raise ValueError("cand_field and cand_start differ in shape")
    if ids.dtype not in (torch.uint8, torch.int32) or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous 1-D uint8 or int32 tensor")
    if not (cand_field.device == cand_start.device == ids.device == T.device):
        raise ValueError(
            f"candidates on {cand_field.device}, ids on {ids.device}, tables on {T.device}"
        )
    if T.node_ceil is None:
        raise ValueError("tables carry no node ceilings (DpTables.with_ceil)")
    if not 1 <= E <= MAX_E:
        raise ValueError(f"edit budget {E} outside 1..{MAX_E}")


def _map_args(maps: Optional[MapTables], T: DpTables) -> tuple:
    """The C entries' mapping arguments: table, row pointers, field masks
    (None without mappings) and the masks' words per entry."""
    if maps is None:
        return None, None, None, 0
    if maps.table.device != T.device:
        raise ValueError(f"mapping tables on {maps.table.device}, DP tables on {T.device}")
    if maps.row_ptr.numel() != T.Lmax + 2:
        raise ValueError("mapping tables were built for another Lmax")
    return (maps.table.data_ptr(), maps.row_ptr.data_ptr(), maps.fields.data_ptr(),
            maps.fields.shape[1])


def banded_dp(cand_field, cand_start, ids, limit, T: DpTables,
              pens: DpPenalties, E: int, deadend: bool = False,
              forbid=None, maps: Optional[MapTables] = None):
    """(pen [B*NE, M] f32, cnt [B*NE, M] int32) of the banded DP (see
    :func:`banded_dp_torch`). CPU tensors run :func:`banded_dp_torch`; CUDA
    tensors launch ``banded_dp_kernel``."""
    from .packed_bitap import LAUNCHES

    _check_dp(cand_field, cand_start, ids, T, E)
    mask = _forbid_mask(forbid)
    if maps is not None and deadend:
        raise ValueError("the mapped DP has no dead-end filter")
    map_args = _map_args(maps, T)
    if ids.device.type == "cpu":
        return banded_dp_torch(cand_field, cand_start, ids, limit, T, pens, E, deadend,
                               forbid, maps)
    if ids.device.type != "cuda":
        raise ValueError(f"no DP kernel for device {ids.device}")
    M = cand_field.numel()
    rows = (2 * E + 1) * (E + 1)
    pen = torch.empty((rows, M), dtype=torch.float32, device=ids.device)
    cnt = torch.empty((rows, M), dtype=torch.int32, device=ids.device)
    if M == 0:
        return pen, cnt
    kern = _cuda_build.load()
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kern.lib.fac_banded_dp(
            cand_field.data_ptr(), cand_start.data_ptr(), M,
            ids.data_ptr(), int(ids.dtype == torch.uint8), ids.numel(), int(limit),
            T.path_cls.data_ptr(), T.path_node.data_ptr(), T.depth.data_ptr(),
            T.Lmax, T.depth.numel(), T.sim.data_ptr(), T.C, T.node_ceil.data_ptr(),
            T.sb_edge.data_ptr(), T.out_count.data_ptr(), T.out_count.numel(),
            *(float(np.float32(x)) for x in pens),
            E, int(bool(deadend)), mask, *map_args,
            pen.data_ptr(), cnt.data_ptr(), stream,
        )
    kern.check(rc, "banded_dp")
    LAUNCHES["dp"] += 1
    return pen, cnt


# ---------------------------------------------------------------------------
# Typed DP: channels are edit-type vectors
# ---------------------------------------------------------------------------

def banded_dp_typed_torch(cand_field, cand_start, ids, limit, T: DpTables,
                          pens: DpPenalties, E: int, TT: TypedTables):
    """Plain version of ``banded_dp_typed_kernel``: the JAX package's
    ``verify_dp._banded_dp_typed``, op for op in f32.

    The recurrences of :func:`banded_dp_torch` without a dead-end filter,
    over ``NCH`` channels that are edit-type vectors: a substitution,
    insertion, deletion or swap arrives in channel ``ch`` from the channel
    with one edit of that type less (``TT.graph``), and only where the
    source's edit total and that type's count are below the node's caps
    (reference ahead-checks src/search.rs:87-169). Substitution, deletion
    and the emission channel's trailing deletion read the caps of path row
    ``i - 1`` (row 0: ``TT.root_caps``), insertion and swap those of row
    ``i``. Counts are static per channel, so only penalties come back:
    pen [B*NCH, M] f32, row ``b * NCH + ch``, +inf where dead."""
    dev = cand_field.device
    B, NCH = 2 * E + 1, TT.nch
    M = cand_field.numel()
    Lmax = T.Lmax
    f32 = torch.float32
    INF = float("inf")
    scal = lambda x: torch.tensor(float(np.float32(x)), dtype=f32, device=dev)
    max_pen, p_sub, p_ins, p_del, p_swap, floor = (scal(x) for x in pens)

    f = cand_field.clamp(min=0).long()
    alive = cand_field >= 0
    WLEN = Lmax + 2 * E + 1
    idx = (cand_start.long() - (E + 1))[None, :] + torch.arange(WLEN, device=dev)[:, None]
    sym = ids[idx.clamp(0, ids.numel() - 1)].long()
    win = torch.where((idx >= 0) & (idx < limit), sym, -1)        # [WLEN, M]
    pcls = T.path_cls.long()[f].T                                   # [Lmax, M]
    pnode = T.path_node.long()[f].T
    dpth = torch.where(alive, T.depth.long()[f], 0)
    ceil_t = T.node_ceil[pnode]                                     # [Lmax, M]
    caps_t = TT.node_caps.long()[pnode]                             # [Lmax, M, 5]
    root = TT.root_caps.long()

    graph = TT.graph.long()
    srcs = [graph[:, q] for q in range(4)]                          # sub, ins, del, swap
    has_sub, has_ins, has_del, has_swap = ((s >= 0)[:, None] for s in srcs)
    sub_c, ins_c, del_c, swap_c = (s.clamp(min=0) for s in srcs)
    vsum, v_ins, v_del, v_sub, v_swap = (graph[:, 4 + q] for q in range(5))

    def caps_of(row: int):
        """The five caps of path row ``row``, [M] each (row 0: the root's)."""
        if row == 0:
            return [root[q].expand(M) for q in range(5)]
        return [caps_t[row - 1, :, q] for q in range(5)]

    def below(src, comp, cap_e, cap_q):
        """[NCH, M]: the source channel's total and its ``comp`` count are
        below the caps."""
        return (vsum[src][:, None] < cap_e[None, :]) & (comp[src][:, None] < cap_q[None, :])

    def merge(bp, op, ok):
        return torch.where(ok & (op < bp), op, bp)

    zero_or_inf = torch.where(alive, 0.0, INF).to(f32)
    prev = torch.full((B, NCH, M), INF, dtype=f32, device=dev)
    prev[E, 0] = zero_or_inf
    prev2 = torch.full_like(prev, INF)                              # row -1
    preve = prev.clone()                                            # emission row 0
    emit = torch.full_like(prev, INF)

    for i in range(1, Lmax + 1):
        row_live = alive & (i <= dpth)
        pc, pc_prev = pcls[i - 1], pcls[max(i - 2, 0)]
        ceil_i = ceil_t[i - 1]
        ce_1, _ci_1, cd_1, cs_1, _cw_1 = caps_of(i - 1)
        ce_0, ci_0, _cd_0, _cs_0, cw_0 = caps_of(i)
        cons, new = [], []
        for b in range(B):
            j = i + (b - E)
            hc, hc_jm1 = win[i + b], win[i - 1 + b]
            sim = torch.where(hc >= 0, T.sim[pc, hc.clamp(min=0)], 0.0)
            spen = p_sub * (1.0 - sim)
            p_pen = prev[b]
            bp = torch.full_like(p_pen, INF)
            if j >= 1:
                bp = torch.where(torch.isfinite(p_pen) & (hc == pc)[None, :], p_pen, INF)
                q_pen = prev[b][sub_c]
                ok_s = (
                    has_sub & torch.isfinite(q_pen)
                    & ((hc >= 0) & (hc != pc) & ~(sim < floor))[None, :]
                    & ~(spen[None, :] > (max_pen - q_pen))
                    & below(sub_c, v_sub, ce_1, cs_1)
                )
                bp = merge(bp, q_pen + spen[None, :], ok_s)
            if i >= 2 and j >= 2:
                s_pen = prev2[b][swap_c]
                ok_sw = (
                    has_swap & torch.isfinite(s_pen) & ~(p_swap > (max_pen - s_pen))
                    & ((hc >= 0) & (hc_jm1 >= 0) & (hc == pc_prev) & (hc_jm1 == pc))[None, :]
                    & below(swap_c, v_swap, ce_0, cw_0)
                )
                bp = merge(bp, s_pen + p_swap, ok_sw)
            cons.append(bp)
            if b + 1 < B:
                d_pen = prev[b + 1][del_c]
                ok_del = (
                    has_del & torch.isfinite(d_pen) & ~(p_del > (max_pen - d_pen))
                    & below(del_c, v_del, ce_1, cd_1)
                )
                bp = merge(bp, d_pen + p_del, ok_del)
            new.append(bp)

        # insertion: ascending b over the already-updated band b-1
        for b in range(1, B):
            if i + (b - E) < 2:
                continue
            ip = new[b - 1][ins_c]
            ok_ins = (
                has_ins & torch.isfinite(ip) & ~(p_ins > (max_pen - ip))
                & (win[i + b] >= 0)[None, :] & below(ins_c, v_ins, ce_0, ci_0)
            )
            new[b] = merge(new[b], ip + p_ins, ok_ins)

        newe = []
        for b in range(B):
            dead = ~row_live[None, :] | (new[b] > ceil_i[None, :])
            new[b] = torch.where(dead, INF, new[b])
            ep = cons[b]
            if b + 1 < B:
                t_pen = preve[b + 1][del_c]
                ok_t = (
                    has_del & torch.isfinite(t_pen) & ~(p_del > (max_pen - t_pen))
                    & below(del_c, v_del, ce_1, cd_1)
                )
                ep = merge(ep, t_pen + p_del, ok_t)
            edead = ~row_live[None, :] | (ep > ceil_i[None, :])
            newe.append(torch.where(edead, INF, ep))
        prev2, prev, preve = prev, torch.stack(new), torch.stack(newe)
        emit = torch.where((row_live & (i == dpth))[None, None, :], preve, emit)
    return emit.reshape(B * NCH, M)


def _check_typed(T: DpTables, TT: TypedTables) -> None:
    if TT.graph.device != T.device:
        raise ValueError(f"typed tables on {TT.graph.device}, DP tables on {T.device}")
    if TT.graph.dim() != 2 or TT.graph.shape[1] != TYPED_COLS or not 1 <= TT.nch <= MAX_TYPED_CHANNELS:
        raise ValueError(f"typed channel graph of shape {tuple(TT.graph.shape)}")
    if TT.node_caps.shape != (T.out_count.numel(), 5) or TT.root_caps.numel() != 5:
        raise ValueError("node caps must be [N, 5] and root caps [5]")
    if TT.limcls.numel() != T.pat_len.numel() or TT.adm.dim() != 2 or TT.adm.shape[1] != TT.nch:
        raise ValueError("limits classes must be [P] and admissibility [NLC, NCH]")
    for name in TypedTables.__slots__:
        t = getattr(TT, name)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"typed table {name} must be contiguous int32")


def banded_dp_typed(cand_field, cand_start, ids, limit, T: DpTables,
                    pens: DpPenalties, E: int, TT: TypedTables):
    """pen [B*NCH, M] f32 of the typed DP (see :func:`banded_dp_typed_torch`).
    CPU tensors run the plain version; CUDA tensors launch
    ``banded_dp_typed_kernel``."""
    from .packed_bitap import LAUNCHES

    _check_dp(cand_field, cand_start, ids, T, E)
    _check_typed(T, TT)
    if ids.device.type == "cpu":
        return banded_dp_typed_torch(cand_field, cand_start, ids, limit, T, pens, E, TT)
    if ids.device.type != "cuda":
        raise ValueError(f"no DP kernel for device {ids.device}")
    M = cand_field.numel()
    pen = torch.empty(((2 * E + 1) * TT.nch, M), dtype=torch.float32, device=ids.device)
    if M == 0:
        return pen
    kern = _cuda_build.load()
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kern.lib.fac_banded_dp_typed(
            cand_field.data_ptr(), cand_start.data_ptr(), M,
            ids.data_ptr(), int(ids.dtype == torch.uint8), ids.numel(), int(limit),
            T.path_cls.data_ptr(), T.path_node.data_ptr(), T.depth.data_ptr(),
            T.Lmax, T.depth.numel(), T.sim.data_ptr(), T.C, T.node_ceil.data_ptr(),
            T.out_count.numel(), *(float(np.float32(x)) for x in pens), E,
            TT.graph.data_ptr(), TT.nch, TT.node_caps.data_ptr(), TT.root_caps.data_ptr(),
            pen.data_ptr(), stream,
        )
    kern.check(rc, "banded_dp_typed")
    LAUNCHES["dp_typed"] += 1
    return pen


# ---------------------------------------------------------------------------
# Emission
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _pen_floats(pens: DpPenalties) -> tuple:
    """The DP's f32 scalars as Python floats, the kernels' arguments."""
    return tuple(float(np.float32(x)) for x in pens)


@functools.lru_cache(maxsize=256)
def emit_bound(thr) -> float:
    """The f32 bound of the emission's similarity test: the threshold less a
    slack (the host recomputes the test exactly)."""
    thr32 = np.float32(thr)
    slack = np.float32(1e-4) + np.float32(1e-4) * np.abs(thr32)
    return float(np.float32(thr32 - slack))


def _row_tags(chan, m, combo, n_combo: int):
    """The rows' tags, ``channel * n_combo + combo`` of the row's candidate
    (``csrc/dp_pipeline.cu``)."""
    return (chan * n_combo + combo.long()[m]).to(torch.int32)


def emit_rows(pen, cnt, cand_field, cand_start, T: DpTables, limit, thr, E,
              combo=None, n_combo: int = 0):
    """DP emission channels -> match rows, int32 [K, 5]: (start, penalty f32
    bits, span ``me``, pattern, packed edit counts).

    The NE edit-count channels of one (candidate, band) map to the same
    (pattern, start, end), and the host keeps the max similarity, so they are
    pre-minimised here with strict <: the lowest edit count wins penalty
    ties. Emission order is channel-major (band, output slot) x candidate, as
    in the JAX package. The similarity test is a superset
    (``sim >= thr - slack``); the host recomputes it exactly. With the
    candidates' ``combo`` indices (of ``n_combo``) also returns the rows'
    tags (:func:`_row_tags`)."""
    B, NE = 2 * E + 1, E + 1
    M = cand_field.numel()
    MO = T.out_list.shape[1]
    alive = cand_field >= 0
    f = cand_field.clamp(min=0).long()
    start = cand_start
    d = T.depth[f]
    pats = T.out_list[T.node[f].long()]                              # [M, MO]
    p_safe = pats.clamp(min=0).long()
    pl, pw = T.pat_len[p_safe], T.pat_weight[p_safe]
    bound = emit_bound(thr)
    ok_rows, pen_best, cnt_best = [], [], []
    for b in range(B):
        ends_b = start + d + (b - E)
        span_ok = alive & (ends_b <= limit) & (ends_b >= start)
        pen_b, cnt_b = pen[b * NE], cnt[b * NE]
        for e in range(1, NE):
            take = pen[b * NE + e] < pen_b
            pen_b = torch.where(take, pen[b * NE + e], pen_b)
            cnt_b = torch.where(take, cnt[b * NE + e], cnt_b)
        pen_best.append(pen_b)
        cnt_best.append(cnt_b)
        fin = torch.isfinite(pen_b)
        pen_s = torch.where(fin, pen_b, 0.0)
        for o in range(MO):
            sim = ((pl[:, o] - pen_s) / pl[:, o]) * pw[:, o]
            ok_rows.append(span_ok & fin & (pats[:, o] >= 0) & (sim >= bound))
    gidx = compact_indices(torch.stack(ok_rows).reshape(-1))
    m = gidx % M
    chan = gidx // M
    o = chan % MO
    b = chan // MO
    pen_bits = torch.stack(pen_best).view(torch.int32)[b, m]
    rows = torch.stack([
        start[m], pen_bits, d[m] + (b - E).to(torch.int32), pats[m, o],
        torch.stack(cnt_best)[b, m],
    ], dim=1).to(torch.int32)
    return rows if combo is None else (rows, _row_tags(chan, m, combo, n_combo))


def typed_decisions_torch(pen, cand_field, cand_start, T: DpTables, TT: TypedTables,
                          limit, thr, E):
    """What the typed emission decides per emission channel (band, output
    slot) and candidate, int32 [B * MO, M, 2]: the winning penalty's f32
    bits and channel, or (0, -1) where the channel emits no row.

    Per band and limits class the channels the class admits are minimised
    with strict <, in channel order (fewest edits first); each output slot
    takes the minimum of its pattern's limits class (reference emission-time
    check src/search.rs:151-169), and emits where its span lies in the text,
    the penalty is finite and the similarity passes :func:`emit_bound`."""
    B, NCH = 2 * E + 1, TT.nch
    M = cand_field.numel()
    MO = T.out_list.shape[1]
    dev = pen.device
    alive = cand_field >= 0
    f = cand_field.clamp(min=0).long()
    start = cand_start
    d = T.depth[f]
    pats = T.out_list[T.node[f].long()]                              # [M, MO]
    p_safe = pats.clamp(min=0).long()
    pl, pw = T.pat_len[p_safe], T.pat_weight[p_safe]
    patcls = TT.limcls.long()[p_safe]                                # [M, MO]
    adm = TT.adm.tolist()
    bound = emit_bound(thr)
    ar = torch.arange(M, device=dev)
    dec = []
    for b in range(B):
        ends_b = start + d + (b - E)
        span_ok = alive & (ends_b <= limit) & (ends_b >= start)
        pen_lc, ch_lc = [], []
        for row in adm:
            pen_b = torch.full((M,), float("inf"), dtype=torch.float32, device=dev)
            ch_b = torch.zeros(M, dtype=torch.int32, device=dev)
            for ch in range(NCH):
                if row[ch]:
                    take = pen[b * NCH + ch] < pen_b
                    pen_b = torch.where(take, pen[b * NCH + ch], pen_b)
                    ch_b = torch.where(take, ch, ch_b)
            pen_lc.append(pen_b)
            ch_lc.append(ch_b)
        pen_lc, ch_lc = torch.stack(pen_lc), torch.stack(ch_lc)      # [NLC, M]
        for o in range(MO):
            pen_sel, ch_sel = pen_lc[patcls[:, o], ar], ch_lc[patcls[:, o], ar]
            fin = torch.isfinite(pen_sel)
            pen_s = torch.where(fin, pen_sel, 0.0)
            sim = ((pl[:, o] - pen_s) / pl[:, o]) * pw[:, o]
            ok = span_ok & fin & (pats[:, o] >= 0) & (sim >= bound)
            dec.append(torch.stack([torch.where(ok, pen_sel.view(torch.int32), 0),
                                    torch.where(ok, ch_sel, -1)], dim=1))
    if not dec or M == 0:
        return torch.zeros((B * MO, M, 2), dtype=torch.int32, device=dev)
    return torch.stack(dec).to(torch.int32)


def _placed_rows(dec, cand_field, cand_start, T: DpTables, E, counts_of, combo, n_combo: int):
    """The rows of decisions ``dec`` ([B * MO, M, 2], no row where column 1
    is negative) in (channel, candidate) order, int32 [K, 5] as
    :func:`emit_rows` gives them; ``counts_of(y)`` maps a row's column 1 to
    its packed counts. With the candidates' ``combo`` indices also the rows'
    tags (:func:`_row_tags`)."""
    M = cand_field.numel()
    MO = T.out_list.shape[1]
    gidx = compact_indices((dec[..., 1] >= 0).reshape(-1))
    m = gidx % max(M, 1)
    chan = gidx // max(M, 1)
    o = chan % MO
    b = chan // MO
    f = cand_field.long()[m]
    rows = torch.stack([
        cand_start[m], dec[chan, m, 0], T.depth[f] + (b - E).to(torch.int32),
        T.out_list[T.node[f].long(), o], counts_of(dec[chan, m, 1]),
    ], dim=1).to(torch.int32)
    return rows if combo is None else (rows, _row_tags(chan, m, combo, n_combo))


def typed_rows_torch(dec, cand_field, cand_start, T: DpTables, TT: TypedTables, E,
                     combo=None, n_combo: int = 0):
    """The typed rows of decisions ``dec`` (:func:`typed_decisions_torch`,
    [B * MO, M, 2]), int32 [K, 5] as :func:`emit_rows` gives them: (start,
    penalty bits, span, pattern, the winning channel's packed counts), in
    (channel, candidate) order; with the candidates' ``combo`` indices also
    the rows' tags (:func:`_row_tags`)."""
    return _placed_rows(dec, cand_field, cand_start, T, E,
                        lambda ch: TT.graph[ch.long(), 9], combo, n_combo)


def count_decisions_torch(pen, cnt, cand_field, cand_start, T: DpTables, limit, thr, E):
    """What the count-channel emission decides per emission channel (band,
    output slot) and candidate, int32 [B * MO, M, 2]: the band's strict-<
    minimum over the edit channels as (penalty f32 bits, packed counts), or
    (0, -1) where the channel emits no row. The same test as
    :func:`emit_rows`: the span in the text, a finite penalty, a pattern in
    the slot and the similarity against :func:`emit_bound`."""
    B, NE = 2 * E + 1, E + 1
    M = cand_field.numel()
    MO = T.out_list.shape[1]
    if M == 0:
        return torch.zeros((B * MO, 0, 2), dtype=torch.int32, device=pen.device)
    alive = cand_field >= 0
    f = cand_field.clamp(min=0).long()
    d = T.depth[f]
    pats = T.out_list[T.node[f].long()]                              # [M, MO]
    p_safe = pats.clamp(min=0).long()
    pl, pw = T.pat_len[p_safe], T.pat_weight[p_safe]
    bound = emit_bound(thr)
    dec = []
    for b in range(B):
        ends_b = cand_start + d + (b - E)
        span_ok = alive & (ends_b <= limit) & (ends_b >= cand_start)
        pen_b, cnt_b = pen[b * NE], cnt[b * NE]
        for e in range(1, NE):
            take = pen[b * NE + e] < pen_b
            pen_b = torch.where(take, pen[b * NE + e], pen_b)
            cnt_b = torch.where(take, cnt[b * NE + e], cnt_b)
        fin = torch.isfinite(pen_b)
        pen_s = torch.where(fin, pen_b, 0.0)
        for o in range(MO):
            sim = ((pl[:, o] - pen_s) / pl[:, o]) * pw[:, o]
            ok = span_ok & fin & (pats[:, o] >= 0) & (sim >= bound)
            dec.append(torch.stack([torch.where(ok, pen_b.view(torch.int32), 0),
                                    torch.where(ok, cnt_b, -1)], dim=1))
    return torch.stack(dec).to(torch.int32)


def emit_rows_typed(pen, cand_field, cand_start, T: DpTables, TT: TypedTables,
                    limit, thr, E, combo=None, n_combo: int = 0):
    """Typed DP channels -> match rows, int32 [K, 5] as :func:`emit_rows`
    gives them, in the same order (the JAX package's ``_emit_rows_typed``),
    and the rows' tags where ``combo`` is given: the decisions of
    :func:`typed_decisions_torch` placed by :func:`typed_rows_torch`."""
    dec = typed_decisions_torch(pen, cand_field, cand_start, T, TT, limit, thr, E)
    return typed_rows_torch(dec, cand_field, cand_start, T, TT, E, combo, n_combo)


# ---------------------------------------------------------------------------
# Expansion, DP and emission as one step
# ---------------------------------------------------------------------------

#: Emission channels (bands x output slots) the pipeline kernels take.
MAX_CHANNELS = 128
#: The count-channel DP, nothing forbidden, no mappings.
FAST = DpVariant()


class DpWindow(NamedTuple):
    """What a slice owns: candidate starts in ``[start_lo, start_hi)`` from
    hits at positions below ``pos_hi``."""

    start_lo: int
    start_hi: int
    pos_hi: int


def dp_pipeline_torch(pos, words, window: DpWindow, ids, limit, T: DpTables,
                      pens: DpPenalties, thr, E: int, deadend: bool, statics: tuple,
                      variant: DpVariant = FAST, h0: int = 0, tags: bool = False):
    """Plain version of ``dp_pipeline_kernel`` and of the typed step
    (``typed_expand_kernel``, ``typed_dp_kernel`` / ``typed_dp_rows_kernel``,
    ``count_emit_kernel``):
    :func:`expand_candidates` of the hits from ``h0`` on, then
    :func:`banded_dp_torch` and :func:`emit_rows`, or for a typed
    ``variant`` :func:`banded_dp_typed_torch` and :func:`emit_rows_typed`.
    Returns (rows int32 [K, 5], number of candidates), and with ``tags`` the
    rows' tags (int32 [K], ``channel * n_combo + combo``) last."""
    cand_field, cand_start, combo = expand_candidates(pos, words, *window, E, *statics, h0=h0,
                                                      combos=True)
    tag_args = (combo, _combos(E, *statics).shape[1]) if tags else ()
    if variant.typed is not None:
        pen = banded_dp_typed_torch(cand_field, cand_start, ids, limit, T, pens, E,
                                    variant.typed)
        rows = emit_rows_typed(pen, cand_field, cand_start, T, variant.typed, limit, thr, E,
                               *tag_args)
    else:
        pen, cnt = banded_dp_torch(cand_field, cand_start, ids, limit, T, pens, E, deadend,
                                   variant.forbid, variant.maps)
        rows = emit_rows(pen, cnt, cand_field, cand_start, T, limit, thr, E, *tag_args)
    if tags:
        rows, row_tags = rows
        return rows, cand_field.numel(), row_tags
    return rows, cand_field.numel()


def pipeline_max_hits(n_combo: int, MO: int, E: int) -> int:
    """Most hits :func:`dp_pipeline` takes in one call (one range of a
    longer hit list, :func:`dp_pipeline_ranges`): int32 offsets over their
    (combo, hit) items' candidates and rows (at most one of each per item
    and emission channel). The typed and the list step keep one decision
    per (candidate, emission channel), a candidate per item at most, and
    scan row counts per (channel, tile of ``TYPED_TILE`` candidates) with
    the candidates' total last: items x channels decisions and at most
    items x (channels + 1) rows and candidates in that scan, so the same
    bound keeps their offsets and indices inside int32."""
    channels = (2 * E + 1) * MO
    items = ((1 << 31) - 1) // (channels + 1)
    return max(1, items // max(n_combo, 1))


#: Bytes of one range's per-item buffers in the list and typed steps: the
#: candidate list (3 int32) and the decisions (2 int32 per emission channel)
#: are sized by the (combo, hit) items, live or not.
STEP_RANGE_BYTES = 2 << 30


def step_max_hits(n_combo: int, MO: int, E: int, variant: DpVariant) -> int:
    """Most hits one :func:`dp_pipeline` call of ``variant`` takes:
    :func:`pipeline_max_hits`, and for the list and typed steps also the
    hits whose items' candidate list and decisions fit ``STEP_RANGE_BYTES``
    (an unselective search then runs in more ranges, not out of memory)."""
    most = pipeline_max_hits(n_combo, MO, E)
    if variant.typed is None and not _list_step(E, variant):
        return most
    per_hit = (12 + 8 * (2 * E + 1) * MO) * max(n_combo, 1)
    return max(1, min(most, STEP_RANGE_BYTES // per_hit))


@functools.lru_cache(maxsize=64)
def _combos_on(device: str, E: int, BITS: tuple, P2F: tuple, DEPTHS: tuple) -> torch.Tensor:
    """:func:`_combos` as an int32 [5, n_combo] tensor on ``device``."""
    return torch.from_numpy(_combos(E, BITS, P2F, DEPTHS).astype(np.int32)).to(device)


def _check_pipeline(pos, words, ids, T: DpTables, E: int, deadend: bool, statics: tuple,
                    variant: DpVariant, h0: int) -> None:
    """The checks of :func:`dp_pipeline`'s arguments; the kernels' channel
    and int32 bounds only for CUDA tensors."""
    for name, t in (("pos", pos), ("words", words)):
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int64 tensor")
    if pos.dim() != 1 or words.dim() != 2 or words.shape[0] != pos.numel():
        raise ValueError("pos must be [H] and words [H, 2W]")
    if ids.dtype not in (torch.uint8, torch.int32) or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous 1-D uint8 or int32 tensor")
    if not (pos.device == words.device == ids.device == T.device):
        raise ValueError(f"hits on {pos.device}, ids on {ids.device}, tables on {T.device}")
    if ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no DP kernel for device {ids.device}")
    if T.node_ceil is None:
        raise ValueError("tables carry no node ceilings (DpTables.with_ceil)")
    if not 1 <= E <= MAX_E:
        raise ValueError(f"edit budget {E} outside 1..{MAX_E}")
    if variant.typed is not None:
        if deadend or variant.forbid is not None or variant.maps is not None:
            raise ValueError("the typed DP takes no dead-end filter, forbid flags or mappings")
        _check_typed(T, variant.typed)
    _forbid_mask(variant.forbid)
    if variant.maps is not None and deadend:
        raise ValueError("the mapped DP has no dead-end filter")
    _map_args(variant.maps, T)
    if not 0 <= h0 <= max(pos.numel() - 1, 0):
        raise ValueError(f"first hit {h0} outside the {pos.numel()} hits")
    if ids.device.type != "cuda":
        return
    H, n_combo = pos.numel() - h0, _combos(E, *statics).shape[1]
    nch = (2 * E + 1) * T.out_list.shape[1]
    if nch > MAX_CHANNELS:
        raise ValueError(f"{nch} emission channels, the kernel takes {MAX_CHANNELS}")
    # Candidates and rows (and the list and typed steps' decisions and row
    # counts, pipeline_max_hits) of one call stay inside int32.
    if H * n_combo * (nch + 1) >= 1 << 31:
        raise ValueError(f"{H} hits x {n_combo} combos x {nch} channels overflow int32 offsets")
    if nch * n_combo >= 1 << 31:
        raise ValueError(f"{nch} channels x {n_combo} combos overflow the int32 row tags")


def _count_pass(pos, words, window: DpWindow, ids, limit, T: DpTables,
                pens: DpPenalties, thr, E: int, deadend: bool, statics: tuple, h0: int = 0):
    """The count pass of the count-channel step at E = 1 without a forbid
    mask or mappings (``dp_pipeline_kernel``) on CUDA tensors with at least
    one hit; the caller checked the arguments.
    Returns (launch, counts, channels, units): ``counts`` int32 [(channels +
    1) * units] holds every block's rows per emission channel and, in the
    last row, its candidates; ``launch(1, offsets, rows, tags)`` runs the
    write pass."""
    from . import packed_bitap as pb

    dev = ids.device
    combos = _combos_on(str(dev), E, *statics)
    H, n_combo = pos.numel() - h0, combos.shape[1]
    MO = T.out_list.shape[1]
    nch = (2 * E + 1) * MO
    kern = _cuda_build.load()
    nunits = -(-(H * n_combo) // kern.lib.fac_dp_pipeline_threads())
    counts = torch.empty((nch + 1) * nunits, dtype=torch.int32, device=dev)
    args = (
        pos.data_ptr(), words.data_ptr(), pos.numel(), h0, words.shape[1],
        combos.data_ptr(), n_combo, *(int(x) for x in window),
        ids.data_ptr(), int(ids.dtype == torch.uint8), ids.numel(), int(limit),
        T.path_cls.data_ptr(), T.path_node.data_ptr(), T.depth.data_ptr(),
        T.node.data_ptr(), T.Lmax, T.depth.numel(), T.sim.data_ptr(), T.C,
        T.node_ceil.data_ptr(), T.sb_edge.data_ptr(), T.out_count.data_ptr(),
        T.out_count.numel(), T.out_list.data_ptr(), MO,
        T.pat_len.data_ptr(), T.pat_weight.data_ptr(),
        *_pen_floats(pens), emit_bound(thr), E, int(bool(deadend)),
    )

    def launch(write: int, offsets, rows, tags=None):
        with pb.on_device(dev):
            rc = kern.lib.fac_dp_pipeline(
                *args, write, nunits, counts.data_ptr(),
                None if offsets is None else offsets.data_ptr(),
                None if rows is None else rows.data_ptr(),
                None if tags is None else tags.data_ptr(),
                pb.stream_of(dev))
        kern.check(rc, "dp_pipeline")
        pb.LAUNCHES["dp_pipeline"] += 1

    launch(0, None, None)
    return launch, counts, nch, nunits


# ---------------------------------------------------------------------------
# The typed step: expansion, DP over the candidate list, emission
# ---------------------------------------------------------------------------

#: Candidates per row-count tile of the typed and the list step (TYPED_TILE
#: of csrc/dp_typed.cu, LIST_TILE of csrc/dp_list.cu; checked against the
#: library).
TYPED_TILE = 1024
#: (combo, hit) items per block of the typed expansion (TE_TILE).
TYPED_EXPAND_ITEMS = 2048


class TypedCands(NamedTuple):
    """The typed step's candidate list: ``field``, ``start``, ``combo``
    int32, at least ``total`` long, in (combo, hit) item order; ``total``
    int32 [1] on the list's device (the kernel's count stays on the card);
    ``items`` the list's bound, (hits - h0) x combos."""

    field: torch.Tensor
    start: torch.Tensor
    combo: torch.Tensor
    total: torch.Tensor
    items: int


_TYPED_CHECKED: Optional[_cuda_build.Kernels] = None


def _typed_kernels():
    """The built library, checked once against this module's typed geometry."""
    global _TYPED_CHECKED
    kern = _cuda_build.load()
    if kern is not _TYPED_CHECKED:
        if (kern.lib.fac_typed_tile(), kern.lib.fac_typed_expand_items()) != (
                TYPED_TILE, TYPED_EXPAND_ITEMS):
            raise RuntimeError("csrc/dp_typed.cu and verify_dp disagree on TYPED_TILE / "
                               "TYPED_EXPAND_ITEMS")
        _TYPED_CHECKED = kern
    return kern


def typed_expand_torch(pos, words, window: DpWindow, E: int, statics: tuple,
                       h0: int = 0) -> TypedCands:
    """Plain version of ``typed_expand_kernel``: :func:`expand_candidates`
    with the candidates' combos, as a :class:`TypedCands` of exactly
    ``total`` candidates."""
    field, start, combo = expand_candidates(pos, words, *window, E, *statics, h0=h0,
                                            combos=True)
    items = (pos.numel() - h0) * _combos(E, *statics).shape[1]
    total = torch.tensor([field.numel()], dtype=torch.int32, device=pos.device)
    return TypedCands(field, start, combo, total, items)


def typed_expand(pos, words, window: DpWindow, E: int, statics: tuple,
                 h0: int = 0) -> TypedCands:
    """The typed step's candidate list (see :func:`typed_expand_torch`; the
    caller checked the arguments). CPU tensors run the plain version; CUDA
    tensors launch ``typed_expand_kernel`` once: its blocks place their
    candidates by decoupled look-back (``packed_bitap.lookback_launch``),
    and the last writes the total, which stays on the card."""
    from . import packed_bitap as pb

    if pos.device.type == "cpu":
        return typed_expand_torch(pos, words, window, E, statics, h0)
    dev = pos.device
    combos = _combos_on(str(dev), E, *statics)
    n_combo = combos.shape[1]
    items = (pos.numel() - h0) * n_combo
    nblk = -(-items // TYPED_EXPAND_ITEMS)
    cand = torch.empty(3 * items + 1, dtype=torch.int32, device=dev)
    at = cand.data_ptr()  # field, start, combo [items] each, then the total
    kern = _typed_kernels()
    with pb.on_device(dev):
        stream = pb.stream_of(dev)
        rc = pb.lookback_launch(dev, stream, nblk, lambda status, epoch, base: (
            kern.lib.fac_typed_expand(
                pos.data_ptr(), words.data_ptr(), pos.numel(), h0, words.shape[1],
                combos.data_ptr(), n_combo, window[0], window[1], window[2], nblk, status, epoch,
                base, at, at + 4 * items, at + 8 * items, at + 12 * items, stream)))
    kern.check(rc, "typed_expand")
    pb.LAUNCHES["typed_expand"] += 1
    return TypedCands(*cand.split((items, items, items, 1)), items)


def _typed_tiles(items: int) -> int:
    return -(-items // TYPED_TILE)


def typed_dp_torch(cands: TypedCands, ids, limit, T: DpTables, pens: DpPenalties, thr,
                   E: int, TT: TypedTables):
    """Plain version of ``typed_dp_kernel`` (and ``typed_dp_rows_kernel``):
    (dec int32 [B * MO, items, 2], row_counts int32 [B * MO * (ntile + 1) +
    2]). ``dec`` holds :func:`typed_decisions_torch` of the first ``total``
    candidates (of :func:`banded_dp_typed_torch`'s penalties) and (0, -1)
    past them; ``row_counts`` the rows of each (channel, tile of
    ``TYPED_TILE`` candidates), channel-major, the rows of each channel,
    then the rows' total and ``total``: :func:`count_dp_torch`'s layout."""
    M = int(cands.total[0])
    cf, cs = cands.field[:M], cands.start[:M]
    pen = banded_dp_typed_torch(cf, cs, ids, limit, T, pens, E, TT)
    return _tiled(typed_decisions_torch(pen, cf, cs, T, TT, limit, thr, E), cands, True)


def _tiled(live, cands: TypedCands, totals: bool = False):
    """(dec int32 [nce, items, 2], row_counts int32 [nce * ntile + 1]) of the
    decisions ``live`` [nce, total, 2] of the list's candidates: (0, -1) past
    the total, the rows of each (channel, tile of ``TYPED_TILE``
    candidates) channel-major, and the total last; with ``totals`` [nce *
    ntile + nce + 2]: after the tiles' counts the rows of each channel and
    the rows' total, then the candidates'."""
    M = live.shape[1]
    nce, ntile = live.shape[0], _typed_tiles(cands.items)
    dec = torch.zeros((nce, cands.items, 2), dtype=torch.int32, device=live.device)
    dec[..., 1] = -1
    dec[:, :M] = live
    flags = torch.zeros((nce, ntile * TYPED_TILE), dtype=torch.int32, device=live.device)
    flags[:, :M] = (live[..., 1] >= 0).to(torch.int32)
    counts = flags.reshape(nce, ntile, TYPED_TILE).sum(dim=2).reshape(-1)
    per_channel = counts.reshape(nce, ntile).sum(dim=1)
    sums = [per_channel, counts.sum().reshape(1)] if totals else []
    return dec, torch.cat([counts] + sums + [cands.total.to(live.device)]).to(torch.int32)


def typed_dp(cands: TypedCands, ids, limit, T: DpTables, pens: DpPenalties, thr, E: int,
             TT: TypedTables):
    """(dec, row_counts) of :func:`typed_dp_torch` (the caller checked the
    arguments). CPU tensors run the plain version; CUDA tensors launch
    ``typed_dp_kernel`` (a group of 8, 16 or 32 lanes per candidate, one
    cell each, where B x NCH fits 32 lanes; a grid over the list's bound)
    or ``typed_dp_rows_kernel<E, S, G>`` (a group of 16 or 32 lanes per
    candidate, a channel per lane and slot with its bands in registers; a
    grid of four waves of the card's resident blocks striding over the
    list); columns of ``dec`` past the total are left unwritten."""
    from . import packed_bitap as pb

    if ids.device.type == "cpu":
        return typed_dp_torch(cands, ids, limit, T, pens, thr, E, TT)
    dev = ids.device
    MO = T.out_list.shape[1]
    nce, ntile = (2 * E + 1) * MO, _typed_tiles(cands.items)
    dec = torch.empty((nce, cands.items, 2), dtype=torch.int32, device=dev)
    row_counts = torch.empty(nce * (ntile + 1) + 2, dtype=torch.int32, device=dev)
    kern = _typed_kernels()
    with pb.on_device(dev):
        rc = kern.lib.fac_typed_dp(
            cands.field.data_ptr(), cands.start.data_ptr(), cands.total.data_ptr(), cands.items,
            ids.data_ptr(), int(ids.dtype == torch.uint8), ids.numel(), int(limit),
            T.path_cls.data_ptr(), T.path_node.data_ptr(), T.depth.data_ptr(), T.node.data_ptr(),
            T.Lmax, T.depth.numel(), T.sim.data_ptr(), T.C, T.node_ceil.data_ptr(),
            T.out_count.numel(), T.out_list.data_ptr(), MO, T.pat_len.data_ptr(),
            T.pat_weight.data_ptr(), *_pen_floats(pens), emit_bound(thr), E,
            TT.graph.data_ptr(), TT.nch, TT.node_caps.data_ptr(), TT.root_caps.data_ptr(),
            TT.limcls.data_ptr(), TT.adm.data_ptr(), TT.adm.shape[0], dec.data_ptr(),
            row_counts.data_ptr(), ntile, pb.stream_of(dev))
    kern.check(rc, "typed_dp")
    pb.LAUNCHES["typed_dp"] += 1
    return dec, row_counts


def typed_emit_torch(dec, row_counts, cands: TypedCands, T: DpTables, TT: TypedTables,
                     E: int, n_combo: int, n_rows: int, tags: bool = False):
    """Plain version of the typed step's emission (``count_emit_kernel``
    with the graph's packed-counts column): (rows int32 [n_rows, 5], tags
    int32 [n_rows] or None), the decisions of the first ``total`` candidates
    placed by :func:`typed_rows_torch` in (channel, candidate) order, whose
    row count ``row_counts`` (``typed_dp``'s) ends with."""
    return _emit_torch(dec, row_counts, cands, T, E, n_combo, n_rows, tags,
                       lambda ch: TT.graph[ch.long(), TYPED_COLS - 1])


def typed_emit(dec, row_counts, cands: TypedCands, T: DpTables, TT: TypedTables, E: int,
               n_combo: int, n_rows: int, n_cand: int, tags: bool = False):
    """(rows, tags or None) of :func:`typed_emit_torch`. CPU tensors run the
    plain version; CUDA tensors launch ``count_emit_kernel`` (the list
    step's emission, :func:`count_emit`) with the graph's packed-counts
    column: a block per (channel, tile) pair of the first ``n_cand``
    candidates (the total, which the caller read), each placed by the
    channel totals and the tile counts before it."""
    if dec.device.type == "cpu":
        return typed_emit_torch(dec, row_counts, cands, T, TT, E, n_combo, n_rows, tags)
    # The packed counts of each channel: a strided column of the graph.
    return _emit_launch(dec, row_counts, cands, T, E, n_combo, n_rows, n_cand, tags,
                        TT.graph[:, TYPED_COLS - 1], "typed_emit")


# ---------------------------------------------------------------------------
# The count-channel list step: the typed step's expansion, then the
# count-channel DP over the candidate list and its emission
# ---------------------------------------------------------------------------

_LIST_CHECKED: Optional[_cuda_build.Kernels] = None


def _list_kernels():
    """The built library, checked once against the list step's tile."""
    global _LIST_CHECKED
    kern = _typed_kernels()
    if kern is not _LIST_CHECKED:
        if kern.lib.fac_count_tile() != TYPED_TILE:
            raise RuntimeError("csrc/dp_list.cu and verify_dp disagree on the row-count tile")
        _LIST_CHECKED = kern
    return kern


def _list_step(E: int, variant: DpVariant) -> bool:
    """Whether :func:`dp_pipeline` runs the count-channel list step
    (:func:`typed_expand`, :func:`count_dp`, one read of two totals,
    :func:`count_emit`): every count-channel call with E >= 2, forbidden
    edit types or mapping arrivals. E = 1 without either stays on
    ``dp_pipeline_kernel``."""
    return variant.typed is None and (
        E >= 2 or variant.forbid is not None or variant.maps is not None)


def count_dp_torch(cands: TypedCands, ids, limit, T: DpTables, pens: DpPenalties, thr,
                   E: int, deadend: bool = False, forbid=None,
                   maps: Optional[MapTables] = None):
    """Plain version of ``count_dp_kernel`` (and ``count_dp_rows_kernel``):
    (dec int32 [B * MO, items, 2], row_counts int32 [B * MO * (ntile + 1) +
    2]). ``dec`` holds :func:`count_decisions_torch` of the first ``total``
    candidates (of :func:`banded_dp_torch`'s channels) and (0, -1) past
    them; ``row_counts`` the rows of each (channel, tile of ``TYPED_TILE``
    candidates), channel-major, the rows of each channel, then the rows'
    total and ``total``: the two values the host reads."""
    M = int(cands.total[0])
    cf, cs = cands.field[:M], cands.start[:M]
    pen, cnt = banded_dp_torch(cf, cs, ids, limit, T, pens, E, deadend, forbid, maps)
    return _tiled(count_decisions_torch(pen, cnt, cf, cs, T, limit, thr, E), cands, True)


def count_dp(cands: TypedCands, ids, limit, T: DpTables, pens: DpPenalties, thr, E: int,
             deadend: bool = False, forbid=None, maps: Optional[MapTables] = None):
    """(dec, row_counts) of :func:`count_dp_torch` (the caller checked the
    arguments). CPU tensors run the plain version; CUDA tensors launch
    ``count_dp_kernel`` (a group of 8, 16 or 32 lanes per candidate, one
    cell each, up to E = 3) or ``count_dp_rows_kernel<E, MAPS>`` (a group
    of 16 lanes per candidate, a band of channels each in registers, E =
    4..6) over the list's bound, both with or without mappings; columns of
    ``dec`` past the total are left unwritten."""
    from . import packed_bitap as pb

    if ids.device.type == "cpu":
        return count_dp_torch(cands, ids, limit, T, pens, thr, E, deadend, forbid, maps)
    dev = ids.device
    MO = T.out_list.shape[1]
    nce, ntile = (2 * E + 1) * MO, _typed_tiles(cands.items)
    dec = torch.empty((nce, cands.items, 2), dtype=torch.int32, device=dev)
    row_counts = torch.empty(nce * (ntile + 1) + 2, dtype=torch.int32, device=dev)
    kern = _list_kernels()
    with pb.on_device(dev):
        rc = kern.lib.fac_count_dp(
            cands.field.data_ptr(), cands.start.data_ptr(), cands.total.data_ptr(), cands.items,
            ids.data_ptr(), int(ids.dtype == torch.uint8), ids.numel(), int(limit),
            T.path_cls.data_ptr(), T.path_node.data_ptr(), T.depth.data_ptr(), T.node.data_ptr(),
            T.Lmax, T.depth.numel(), T.sim.data_ptr(), T.C, T.node_ceil.data_ptr(),
            T.sb_edge.data_ptr(), T.out_count.data_ptr(), T.out_count.numel(),
            T.out_list.data_ptr(), MO, T.pat_len.data_ptr(), T.pat_weight.data_ptr(),
            *_pen_floats(pens), emit_bound(thr), E, int(bool(deadend)), _forbid_mask(forbid),
            *_map_args(maps, T), dec.data_ptr(), row_counts.data_ptr(), ntile,
            pb.stream_of(dev))
    kern.check(rc, "count_dp")
    pb.LAUNCHES["count_dp"] += 1
    return dec, row_counts


def count_emit_torch(dec, row_counts, cands: TypedCands, T: DpTables, E: int, n_combo: int,
                     n_rows: int, tags: bool = False):
    """Plain version of ``count_emit_kernel``: (rows int32 [n_rows, 5], tags
    int32 [n_rows] or None), the decisions of the first ``total``
    candidates in (channel, candidate) order, whose row count ``row_counts``
    (``count_dp``'s) ends with; a row's packed counts are its decision's."""
    return _emit_torch(dec, row_counts, cands, T, E, n_combo, n_rows, tags, lambda y: y)


def _emit_torch(dec, row_counts, cands: TypedCands, T: DpTables, E: int, n_combo: int,
                n_rows: int, tags: bool, counts_of):
    """The plain emission of both steps: the first ``total`` candidates'
    decisions placed by :func:`_placed_rows` (``counts_of`` maps a
    decision's column 1 to the row's packed counts), checked against the
    rows' total that ``row_counts`` ends with and ``n_rows``."""
    M = int(cands.total[0])
    combo = cands.combo[:M] if tags else None
    out = _placed_rows(dec[:, :M], cands.field[:M], cands.start[:M], T, E, counts_of, combo,
                       n_combo)
    rows, row_tags = out if tags else (out, None)
    if rows.shape[0] != n_rows or int(row_counts[-2]) != n_rows:
        raise ValueError(f"{rows.shape[0]} rows decided, the row counts give "
                         f"{int(row_counts[-2])}, {n_rows} asked for")
    return rows, row_tags


def count_emit(dec, row_counts, cands: TypedCands, T: DpTables, E: int, n_combo: int,
               n_rows: int, n_cand: int, tags: bool = False):
    """(rows, tags or None) of :func:`count_emit_torch`. CPU tensors run the
    plain version; CUDA tensors launch ``count_emit_kernel``, a block per
    (channel, tile) pair of the first ``n_cand`` candidates (the total,
    which the caller read), each placed by the channel totals and the tile
    counts before it."""
    if dec.device.type == "cpu":
        return count_emit_torch(dec, row_counts, cands, T, E, n_combo, n_rows, tags)
    return _emit_launch(dec, row_counts, cands, T, E, n_combo, n_rows, n_cand, tags, None,
                        "count_emit")


def _emit_launch(dec, row_counts, cands: TypedCands, T: DpTables, E: int, n_combo: int,
                 n_rows: int, n_cand: int, tags: bool, counts, key: str):
    """``count_emit_kernel`` on CUDA tensors for both steps, counted under
    the launch counter ``key``: a row's packed counts are ``counts`` (int32,
    a value per channel, any stride) at its decision's column 1, or that
    column itself where ``counts`` is None."""
    from . import packed_bitap as pb

    dev = dec.device
    rows = torch.empty((n_rows, 5), dtype=torch.int32, device=dev)
    row_tags = torch.empty(n_rows, dtype=torch.int32, device=dev) if tags else None
    if n_rows == 0:
        return rows, row_tags
    kern = _list_kernels()
    with pb.on_device(dev):
        rc = kern.lib.fac_count_emit(
            cands.field.data_ptr(), cands.start.data_ptr(), cands.combo.data_ptr(),
            cands.total.data_ptr(), cands.items, int(n_cand), T.depth.data_ptr(),
            T.node.data_ptr(), T.out_list.data_ptr(), T.out_list.shape[1], E, n_combo,
            None if counts is None else counts.data_ptr(),
            0 if counts is None else counts.stride(0), dec.data_ptr(), row_counts.data_ptr(),
            _typed_tiles(cands.items), rows.data_ptr(),
            None if row_tags is None else row_tags.data_ptr(), pb.stream_of(dev))
    kern.check(rc, key)
    pb.LAUNCHES[key] += 1
    return rows, row_tags


def emit_pairs(n_cand: int, E: int, MO: int) -> int:
    """Blocks of ``count_emit_kernel`` for ``n_cand`` candidates: one per
    (channel, tile of ``TYPED_TILE`` candidates), (2E + 1) MO channels."""
    return (2 * E + 1) * MO * -(-n_cand // TYPED_TILE)


def dp_pipeline_counts(pos, words, window: DpWindow, ids, limit, T: DpTables,
                       pens: DpPenalties, thr, E: int, deadend: bool, statics: tuple,
                       variant: DpVariant = FAST, h0: int = 0) -> tuple:
    """The counts :func:`dp_pipeline` scans, on CUDA tensors with at least
    one hit: the count pass's per-block counts, which it hands
    ``block_offsets``. The typed and the list step scan nothing: their
    emission places its rows from the DP's channel totals."""
    _check_pipeline(pos, words, ids, T, E, deadend, statics, variant, h0)
    if ids.device.type != "cuda" or pos.numel() - h0 <= 0:
        raise ValueError("the count pass runs on CUDA tensors with at least one hit")
    if variant.typed is not None or _list_step(E, variant):
        raise ValueError("the typed and the list step hand block_offsets no counts")
    return (_count_pass(pos, words, window, ids, limit, T, pens, thr, E, deadend, statics,
                        h0)[1],)


def _list_pipeline(pos, words, window: DpWindow, ids, limit, T: DpTables,
                   pens: DpPenalties, thr, E: int, deadend: bool, statics: tuple,
                   variant: DpVariant, h0: int, tags: bool):
    """The typed step, or the count-channel list step, of :func:`dp_pipeline`
    on any device: the candidate list, its DP and decisions, one read of the
    rows' and the candidates' totals, the emission."""
    cands = typed_expand(pos, words, window, E, statics, h0)
    TT = variant.typed
    n_combo = _combos(E, *statics).shape[1]
    if TT is not None:
        dec, row_counts = typed_dp(cands, ids, limit, T, pens, thr, E, TT)
    else:
        dec, row_counts = count_dp(cands, ids, limit, T, pens, thr, E, deadend, variant.forbid,
                                   variant.maps)
    # The DP kept the rows' total and the candidates': one read.
    with trace.wait("row_totals"):
        n_rows, n_cand = row_counts[-2:].tolist()
    if TT is not None:
        rows, row_tags = typed_emit(dec, row_counts, cands, T, TT, E, n_combo, n_rows, n_cand,
                                    tags)
    else:
        rows, row_tags = count_emit(dec, row_counts, cands, T, E, n_combo, n_rows, n_cand,
                                    tags)
    return (rows, n_cand) + ((row_tags,) if tags else ())


def dp_pipeline(pos, words, window: DpWindow, ids, limit, T: DpTables,
                pens: DpPenalties, thr, E: int, deadend: bool, statics: tuple,
                variant: DpVariant = FAST, h0: int = 0, tags: bool = False):
    """Hit list -> match rows of one slice: (rows int32 [K, 5] on the hits'
    device, number of candidates), and with ``tags`` the rows' tags (int32
    [K], ``channel * n_combo + combo``) last. ``pos`` [H] int64 ascending
    and ``words`` [H, 2W] int64 as ``packed_hits`` returns them, of which
    the hits from ``h0`` on are expanded (see :func:`expand_candidates`);
    ``statics`` the (BITS, P2F, DEPTHS) of :func:`expand_candidates`;
    ``variant`` the DP the lane runs; rows as :func:`emit_rows` orders them.

    The count-channel variant at E = 1 without a forbid mask or mappings:
    CPU tensors run :func:`dp_pipeline_torch`; CUDA tensors launch
    ``dp_pipeline_kernel`` twice, a count pass and a write pass with
    ``block_offsets_kernel`` between them, and read the two totals back.
    Every other count-channel variant runs the list step
    (:func:`typed_expand`, :func:`count_dp`, one read of the rows' and the
    candidates' totals, :func:`count_emit`), the typed variant :func:`typed_expand`,
    :func:`typed_dp`, the same read and :func:`typed_emit` (each piece its
    plain version on CPU tensors), so each candidate's DP runs once."""
    from . import packed_bitap as pb

    _check_pipeline(pos, words, ids, T, E, deadend, statics, variant, h0)
    empty = pos.numel() - h0 <= 0 or _combos(E, *statics).shape[1] == 0
    if (variant.typed is not None or _list_step(E, variant)) and not empty:
        return _list_pipeline(pos, words, window, ids, limit, T, pens, thr, E, deadend, statics,
                              variant, h0, tags)
    if ids.device.type == "cpu":
        return dp_pipeline_torch(pos, words, window, ids, limit, T, pens, thr, E,
                                 deadend, statics, variant, h0, tags)
    if empty:
        rows = torch.zeros((0, 5), dtype=torch.int32, device=ids.device)
        return (rows, 0) + ((rows[:, 0],) if tags else ())
    launch, counts, nch, nunits = _count_pass(pos, words, window, ids, limit, T, pens, thr, E,
                                              deadend, statics, h0)
    offsets = pb.block_offsets(counts)
    # The rows' total ends the last channel's counts, the grand total (rows
    # and candidates) the array: one strided read of two values.
    with trace.wait("step_totals"):
        n_rows, n_all = offsets[nch * nunits::nunits].tolist()
    rows = torch.empty((n_rows, 5), dtype=torch.int32, device=ids.device)
    row_tags = torch.empty(n_rows, dtype=torch.int32, device=ids.device) if tags else None
    if n_rows:
        launch(1, offsets, rows, row_tags)
    return (rows, n_all - n_rows) + ((row_tags,) if tags else ())


def dp_pipeline_ranges(pos, words, max_hits: int, *args):
    """:func:`dp_pipeline` (arguments ``args`` after the hits) over a hit
    list of any length: in ranges of at most ``max_hits`` hits
    (:func:`step_max_hits`), each handed its preceding hit for the run
    dedup, so that every count stays inside int32. Returns what one call over
    the whole list would: the rows in its order and the candidates' count.
    Each range's rows are ordered by (channel, combo, hit) within the range;
    a stable sort of all ranges' rows by their tags (channel, combo)
    restores the order of one range, which decode's tie rule reads (the
    earliest row of a span wins a similarity tie)."""
    count = pos.numel()
    if count <= max_hits:
        return dp_pipeline(pos, words, *args)
    rows, tags, n_cand = [], [], 0
    for a in range(0, count, max_hits):
        h0 = min(a, 1)
        r, c, t = dp_pipeline(pos[a - h0:a + max_hits], words[a - h0:a + max_hits], *args,
                              h0=h0, tags=True)
        rows.append(r)
        tags.append(t)
        n_cand += c
    order = torch.sort(torch.cat(tags), stable=True).indices
    return torch.cat(rows)[order], n_cand


# ---------------------------------------------------------------------------
# The lane
# ---------------------------------------------------------------------------

#: Slice length of the sliced pipeline (grapheme symbols); corpora of at
#: least 1.5 slices are cut into overlapping slices.
SLICE_SYMS = 16 << 20


class _Plan(NamedTuple):
    pk: object
    vf: VerifyFields
    ks: Tuple[int, ...]
    dam: bool
    k: int
    E: int
    n_combo: int
    ceil: np.ndarray
    max_pen: np.float32


def dp_plan(engine, threshold, n: int, typed=None, maps=None, forbid=None
            ) -> Optional[_Plan]:
    """The host decisions the JAX package's ``fuzzy_search_dp`` makes before
    any device work, or None where it declines (the caller falls back):
    corpus past ``RESIDENT_MAX``, no packed tables or DP fields, or a
    threshold budget past ``MAX_USEFUL_K`` (for ``maps``,
    :meth:`MappedSpec.build` already declined those). ``typed`` / ``maps`` /
    ``forbid`` pick the lane's budgets: the mapped lane scans with the
    uniform budget ``maps.k`` (2E-4E rows, up to 24) and no Damerau rows,
    and the DP's ``E`` is the forbid spec's, the typed spec's, or
    ``engine.max_edits_fast``."""
    from .packed_bitap import RESIDENT_MAX, packed_fuzzy_of

    thr = np.float32(threshold)
    if n > RESIDENT_MAX:
        return None
    pk = packed_fuzzy_of(engine)
    if pk is None:
        return None
    vf = verify_fields_of(engine)
    if vf is None:
        return None
    if maps is not None:
        ks = [maps.k] * len(pk.filt.patterns)
        dam = False
    else:
        # Damerau-aware scan budgets: the scan's native transposition
        # transition prices a swap at 1 bitap error instead of 2, so
        # swap-permitting configs scan with fewer error rows and a more
        # selective filter. The plain model serves when it wins nothing.
        ks_p = [pk.filt.k_for(bp, thr) for bp in pk.filt.patterns]
        ks_d = [pk.filt.k_for(bp, thr, damerau=True) for bp in pk.filt.patterns]
        dam = None not in ks_d and (None in ks_p or max(ks_d) < max(ks_p))
        ks = ks_d if dam else ks_p
        if None in ks:
            return None
    if forbid is not None:
        E = forbid[0]
    else:
        E = engine.max_edits_fast if typed is None else typed.E
    n_combo = int((vf.pat2field >= 0).sum()) * (2 * E + 1)
    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr)
    return _Plan(pk, vf, tuple(ks), dam, max(ks), E, n_combo, ceil, np.float32(ceil[0]))


def _dev_cache(engine, key: tuple, build):
    """Per-engine cache of small device tables (scan tables, DP tables, node
    ceilings); ``engine.to`` drops it."""
    cache = getattr(engine, "_dp_dev_consts", None)
    if cache is None:
        cache = {}
        engine._dp_dev_consts = cache
    hit = cache.get(key)
    if hit is None:
        hit = build()
        cache[key] = hit
    return hit


def _statics(engine, pk, vf) -> tuple:
    """(BITS, P2F, DEPTHS) of :func:`expand_candidates`, cached."""
    statics = getattr(engine, "_dp_statics", None)
    if statics is None:
        bits = tuple(
            (2 * lw + ((lo + m_p - 1) >> 5), (lo + m_p - 1) & 31)
            for (lw, lo), m_p in zip(pk.offsets, pk.ms)
        )
        p2f = tuple(tuple(int(fi) for fi in row if fi >= 0) for row in vf.pat2field)
        statics = (bits, p2f, tuple(int(dd) for dd in vf.depth))
        engine._dp_statics = statics
    return statics


class _Part(NamedTuple):
    """One slice of the corpus as the DP lane runs it: the prefilter and
    dense symbol streams on the device, the slice's symbol count, the
    window ``[lo, hi)`` of match starts it owns, and its global offset."""

    ids_pf: torch.Tensor
    ids_de: torch.Tensor
    local_n: int
    lo: int
    hi: int
    base: int


class DpRun(NamedTuple):
    """Everything the lane needs on the device for one search: scan tables,
    DP tables with this threshold's ceilings, penalties, the candidate
    expansion's static tables, the dead-end flag, the DP variant, and the
    corpus slices."""

    plan: _Plan
    T_scan: object
    T: DpTables
    pens: DpPenalties
    statics: tuple
    deadend: bool
    variant: DpVariant
    halo: int
    parts: List[_Part]


class LaneTables(NamedTuple):
    """The lane's tables on one device: scan tables, DP tables with this
    threshold's ceilings, penalties, the DP variant and the dead-end flag."""

    T_scan: object
    T: DpTables
    pens: DpPenalties
    variant: DpVariant
    deadend: bool


def lane_tables(engine, plan: _Plan, device, typed: Optional[TypedSpec] = None,
                maps: Optional[MappedSpec] = None, forbid: Optional[tuple] = None
                ) -> LaneTables:
    """The device tables of ``plan`` on ``device``, built once per engine
    and device (``typed`` / ``maps`` / ``forbid`` as :func:`dp_plan` took
    them)."""
    from .packed_bitap import tables_from_numpy

    pk, vf = plan.pk, plan.vf
    dense = engine.dense
    dkey = str(device)
    T_scan = _dev_cache(engine, ("scan", plan.ks, plan.dam, dkey), lambda: tables_from_numpy(
        pk.word_tbl, pk.starts, *pk.fuzzy_masks(list(plan.ks))[:2],
        notlast=pk.notlast() if plan.dam else None, device=device,
    ))
    T_base = _dev_cache(engine, ("dp", dkey), lambda: dp_tables_from_numpy(
        vf.depth, vf.node, vf.path_cls, vf.path_node, dense.sim, dense.out_list,
        dense.pat_len, dense.pat_weight, dense.sb_edge, dense.out_count,
        device=device,
    ))
    T = T_base.with_ceil(_dev_cache(
        engine, ("ceil", plan.ceil.tobytes(), dkey),
        lambda: torch.from_numpy(np.ascontiguousarray(plan.ceil, np.float32)).to(device),
    ))
    pens = engine.penalties
    dp_pens = DpPenalties(plan.max_pen, pens.substitution, pens.insertion,
                          pens.deletion, pens.swap, engine.min_symbol_similarity)
    variant = DpVariant(
        forbid=None if forbid is None else tuple(bool(x) for x in forbid[1:]),
        maps=None if maps is None else _dev_cache(
            engine, ("maps", dkey),
            lambda: map_tables_from_spec(maps.maps, vf.num_fields, vf.max_depth, device)),
        typed=None if typed is None else _dev_cache(
            engine, ("typed", dkey),
            lambda: typed_tables_from_numpy(
                typed.vecs, typed.sub_src, typed.ins_src, typed.del_src, typed.swap_src,
                typed.cnts, typed.root_caps, typed.node_caps, typed.limcls, typed.adm,
                device)),
    )
    # The last-edit dead-end filter is the FAST path's; typed and forbid
    # configurations run the reference's general path, which has none
    # (src/search.rs:204-393), and mapped engines have no multi-byte edges.
    deadend = bool(dense.has_multibyte_edges) and typed is None and forbid is None
    return LaneTables(T_scan, T, dp_pens, variant, deadend)


def dp_inputs(engine, haystack: str, plan: _Plan, view, n: int,
              typed: Optional[TypedSpec] = None, maps: Optional[MappedSpec] = None,
              forbid: Optional[tuple] = None) -> DpRun:
    """The device tables (:func:`lane_tables` on ``engine.device``) and
    resident corpus slices for ``plan``; ``typed`` / ``maps`` / ``forbid``
    as :func:`dp_plan` took them.

    Corpora of at least 1.5 ``SLICE_SYMS`` (with a dense alphabet of at most
    256 classes) are cut into overlapping slices: slice i owns match starts
    in its core range, its buffer carries a left scan warm-up halo (pattern
    length + error budget) and a right completion halo (max depth + E), so
    every owned match ends in-buffer (reference stream-window rule
    src/stream.rs:262-297)."""
    from ..utils import device_corpus
    from .packed_bitap import _space_token

    pk, vf, E = plan.pk, plan.vf, plan.E
    halo = pk.m_max + plan.k
    dense = engine.dense
    device = engine.device
    lt = lane_tables(engine, plan, device, typed, maps, forbid)

    tok = _space_token(engine)
    hay_bytes = view.hay_bytes() if view.ascii else None
    pf_transcode = lambda h: np.ascontiguousarray(
        pk.filt.transcode(h, hay_bytes=hay_bytes)[0], dtype=np.uint8
    )
    narrow = dense.num_classes <= 256
    de_transcode = lambda h: np.ascontiguousarray(
        dense.transcode(h, view), dtype=np.uint8 if narrow else np.int32
    )
    if narrow and n >= SLICE_SYMS + (SLICE_SYMS >> 1):
        S = max(2, -(-n // SLICE_SYMS))
        Q = -(-n // S)
        R_halo = vf.max_depth + E
        bounds, meta = [], []
        for si in range(S):
            g0 = si * Q
            g1 = min(n, g0 + Q)
            base = max(0, g0 - halo)
            end = min(n, g1 + R_halo)
            bounds.append((base, end - base))
            meta.append((end - base, g0 - base, g1 - base, base))
        pad_len = device_corpus.bucket_len(max(ln for _, ln in bounds) + device_corpus.TAIL_MARGIN)
        pf_slices = device_corpus.resident_sliced(
            haystack, ("pk-fuzzy", tok), pf_transcode, tuple(bounds), pad_len, device)
        de_slices = device_corpus.resident_sliced(
            haystack, ("dense", tok), de_transcode, tuple(bounds), pad_len, device)
        parts = [_Part(pf, de, *m) for pf, de, m in zip(pf_slices, de_slices, meta)]
    else:
        ids_pf, n_pf = device_corpus.resident(haystack, ("pk-fuzzy", tok), pf_transcode, device)
        ids_de, n_de = device_corpus.resident(haystack, ("dense", tok), de_transcode, device)
        assert n_pf == n_de == n
        parts = [_Part(ids_pf, ids_de, n, 0, n, 0)]
    return DpRun(plan, lt.T_scan, lt.T, lt.pens, _statics(engine, pk, vf), lt.deadend,
                 lt.variant, halo, parts)


def dp_candidates(run: DpRun, part: _Part):
    """(hit count, cand_field, cand_start) of one slice: the hit-list scan,
    then :func:`expand_candidates` over the slice's owned starts; the
    candidates :func:`banded_dp` is held against its plain version on."""
    from .packed_bitap import packed_hits

    count, pos, words = packed_hits(part.ids_pf, run.T_scan, run.halo)
    cand_field, cand_start = expand_candidates(
        pos, words, part.lo, part.hi, part.local_n, run.plan.E, *run.statics)
    return count, cand_field, cand_start


def fuzzy_search_dp(engine, haystack: str, threshold, view, n: int,
                    typed: Optional[TypedSpec] = None, maps: Optional[MappedSpec] = None,
                    forbid: Optional[tuple] = None) -> Optional[List]:
    """DP-verified fuzzy search; oracle-identical matches. None where the
    lane declines — the caller falls back, as the JAX package's callers do.
    Without a spec it serves FAST-path engines (uniform edit budget E =
    ``engine.max_edits_fast``); ``forbid`` (:func:`forbid_spec_of`) switches
    edit types off, ``maps`` (:class:`MappedSpec`) adds mapping arrivals,
    ``typed`` (:class:`TypedSpec`) runs the type-vector DP — at most one of
    the three.

    The JAX package declines up front on a guess of the hit capacity (its
    callers then take the beam lanes, or the oracle for beamed, typed and
    mapped engines); here a slice's hit list of any length is served, in
    ranges of at most :func:`step_max_hits` hits where it is longer
    (:func:`dp_pipeline_ranges`), with the rows of one range's order, so the
    matches are the JAX package's.

    Large corpora run as overlapping slices (:func:`dp_inputs`), one after
    another. Per slice: the hit-list scan (``packed_hits``), the expansion,
    DP and emission as one step (:func:`dp_pipeline`), and one copy of the
    match rows to the host."""
    from .emit import decode_matches
    from .packed_bitap import packed_hits

    plan = dp_plan(engine, threshold, n, typed, maps, forbid)
    if plan is None:
        return None
    if np.float32(0.0) > plan.max_pen:
        return []
    thr = np.float32(threshold)
    E = plan.E
    run = dp_inputs(engine, haystack, plan, view, n, typed, maps, forbid)
    dev_parts = []
    sum_h = sum_c = 0
    max_hits = step_max_hits(plan.n_combo, run.T.out_list.shape[1], E, run.variant)
    at = trace.mark()
    for part in run.parts:
        count, pos, words = packed_hits(part.ids_pf, run.T_scan, run.halo)
        with trace.span("step") as sp:
            rows, n_cand = dp_pipeline_ranges(
                pos, words, max_hits, DpWindow(part.lo, part.hi, part.local_n), part.ids_de,
                part.local_n, run.T, run.pens, thr, E, run.deadend, run.statics, run.variant)
            if sp:
                sp.set(candidates=n_cand, rows=rows.shape[0])
        dev_parts.append(rows)
        sum_h += count
        sum_c += n_cand
    with trace.span("finish"):
        trace.timing_sync(engine.device)
        row_parts = []
        for part, rows in zip(run.parts, dev_parts):
            with trace.wait("rows", rows.nbytes):
                rows = rows.cpu().numpy()
            rows[:, 0] += part.base  # slice-local starts -> global graphemes
            row_parts.append(rows)
        rows = row_parts[0] if len(row_parts) == 1 else np.concatenate(row_parts)
        results = decode_matches(
            engine, view, haystack, n,
            rows[:, 0], rows[:, 2], rows[:, 3],
            np.ascontiguousarray(rows[:, 1]).view(np.float32), rows[:, 4], thr,
        )
        engine.last_stats = {
            "backend": (
                "device-fuzzy-dp-typed" if typed is not None
                else "device-fuzzy-dp-mapped" if maps is not None
                else "device-fuzzy-dp-forbid" if forbid is not None
                else "device-fuzzy-dp"
            ),
            "hits": sum_h,
            "candidates": sum_c,
            "positions": int(n),
            "emissions": len(rows),
            "matches": len(results),
            "slices": len(run.parts),
        }
        engine.last_stats.update(trace.stage_stats(at, row_parts))
    return results


def lane_specs_of(engine) -> tuple:
    """(typed, maps, forbid) as the device dispatchers hand them to
    :func:`fuzzy_search_dp` for ``engine``; at most one is set. An engine
    with mappings gets its :class:`MappedSpec`; a plain total-edits engine
    (the FAST lane) gets none; any other gets its forbid spec where
    :func:`forbid_spec_of` holds it, else its :class:`TypedSpec`. A spec the
    engine does not have is None."""
    if engine.mappings:
        return None, mapped_spec_of(engine), None
    if not engine.has_pattern_limits and 1 <= engine.max_edits_fast <= MAX_E:
        return None, None, None
    forbid = forbid_spec_of(engine)
    if forbid is not None:
        return None, None, forbid
    return typed_spec_of(engine), None, None


def fuzzy_search_typed_device(engine, haystack: str, threshold) -> List:
    """Device search for per-type / per-pattern limit configurations: the
    forbid lane where :func:`forbid_spec_of` holds the engine, else the
    typed lane. Falls back to the host oracle where the lane declines (a
    threshold budget past the scan's)."""
    from .. import oracle
    from ..utils.graphemes import view_of

    typed, _maps, forbid = lane_specs_of(engine)
    if typed is None and forbid is None:
        raise ValueError("the engine has no typed spec (DeviceEngine gates on typed_spec_of)")
    view = view_of(haystack, engine.case_insensitive)
    n = len(view)
    if n == 0:
        return []
    res = fuzzy_search_dp(engine, haystack, threshold, view, n, typed=typed, forbid=forbid)
    if res is None:
        return oracle.search_raw(engine, haystack, threshold)
    return res


def fuzzy_search_mapped_device(engine, haystack: str, threshold) -> List:
    """Device search for mapped engines. Falls back to the host oracle where
    the lane declines, and for a haystack with a grapheme of more than one
    code point: the class model's identity guarantee needs one code point
    per grapheme (grapheme count == code-point count tests it exactly)."""
    from .. import oracle
    from ..utils.graphemes import view_of

    spec = lane_specs_of(engine)[1]
    if spec is None:
        raise ValueError("the engine has no mapped spec (DeviceEngine gates on mapped_spec_of)")
    view = view_of(haystack, engine.case_insensitive)
    n = len(view)
    if n == 0:
        return []
    if not haystack.isascii() and n != len(haystack):
        return oracle.search_raw(engine, haystack, threshold)
    res = fuzzy_search_dp(engine, haystack, threshold, view, n, maps=spec)
    if res is None:
        return oracle.search_raw(engine, haystack, threshold)
    return res
