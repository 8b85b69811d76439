"""Large-dictionary fuzzy lane: pattern-chunked scan -> sparse expansion ->
banded DP -> emission.

The fuzzy DP lane (``ops/verify_dp``) packs the whole dictionary into one
scan of at most ``packed_bitap.MAX_LIMBS`` u64 limbs. A dictionary that does
not fit (thousands of patterns: the reference's ``search_many_patterns``
bench, benches/benchmark.rs:45-76) is served here, as the JAX package's
``ops/many.py`` serves it:

* the PRIMARY layout is stratified-folded (:func:`_fold_assign`): patterns
  of the same length share aligned bit lanes (symbol masks OR'd), so the
  whole dictionary scans in one or few wide passes; a containment pre-verify
  and the banded DP kill the superposition's false fires. Past a hit ceiling
  (a corpus too match-dense for superposition) the search re-runs with the
  plain chunking, and the lane remembers that for this corpus and threshold;
* the fallback splits the dictionary into chunks of consecutive patterns,
  each of at most ``MANY_LIMBS`` limbs;
* the banded-DP tables are the engine's (fields are global verify-field
  ids), so both corpora (the prefilter and the dense symbol stream) are
  resident once, shared with the DP lane, and every chunk reads them.

Per chunk (:func:`many_pipeline`; plain version :func:`many_pipeline_torch`),
on the card:

1. the hit-list scan (``packed_bitap.packed_hits``): at more than
   ``MAX_LIMBS`` limbs ``scan_bits_wide_kernel``, ``block_offsets_kernel``
   and ``hit_words_wide_kernel`` (``csrc/scan_wide.cu``); the host reads the
   hit count;
2. the step (:func:`many_step`, ``many_step_kernel`` of
   ``csrc/many_step.cu``; plain version :func:`many_step_torch`): the sparse
   expansion (each hit's nonzero u32 columns name the verify fields whose
   match bit lives there, so only those rows expand into candidates; plain
   version :func:`expand_candidates_sparse`), each candidate's banded DP (the
   body of ``csrc/banded_dp.cuh``) and its emission (plain version
   :func:`dp_list_torch`), as a count pass and a write pass around
   ``block_offsets_kernel`` and one host read of the totals, with no
   candidate list in device memory;

step 2 over ranges of at most :func:`many_max_hits` hits, so that no count
passes int32 offsets, and one copy of the rows to the host: three host
waits per chunk. One merged decode (``ops/emit.decode_matches``) serves all
chunks.

Not ported: the JAX package's capacity machinery (``_fine_cap``, the cap
cache, the KH / KH2 / CAND / KG retries, ``_retry_transient``): every count
here is exact. Nor the permanent ``engine._many_fold_off`` pin: an overflow
is remembered per (engine, corpus content, threshold). The port reads no
environment variable; ``FOLD`` switches the folded layout off.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..utils import trace
from . import _cuda_build
from .compact import compact_indices

#: Uniform u64 limb budget per PLAIN (unsuperimposed) chunk.
MANY_LIMBS = 32

#: Folded-layout tuning (see :func:`_fold_assign`): total false-fire budget
#: per corpus position (split across length strata), the superposition cap
#: per bit lane, and the per-chunk limb budget of folded chunks.
FOLD_EPS = 1.0 / 16.0
FOLD_MAX_F = 8.0
FOLD_CHUNK_LIMBS = 64
#: Floor of the folded layout's hit ceiling (tests patch it down to reach
#: the plain-chunking fallback on small corpora).
FOLD_HIT_CEIL_MIN = 1 << 14
#: Whether the lane tries the folded layout first.
FOLD = True
#: (corpus, threshold) pairs per engine whose folded scan passed the hit
#: ceiling, remembered so that the next search goes straight to the plain
#: chunking.
FOLD_OVERFLOW_MEMORY = 64


def _fold_assign(pats, A: int, E: int):
    """Stratified-folded (limb, bit) assignment: one aligned bit lane serves
    up to ``f`` patterns of the same length (their symbol masks OR'd).

    The scan costs ~``total_limbs`` words of recurrence per corpus position,
    so the only way to scan a large dictionary faster is to put more
    patterns per bit. Superimposing f same-length patterns on one aligned
    lane raises the per-step advance probability from ~1/A to ~f/A, i.e. the
    lane's false-fire rate grows as (f/A)^(m-k): long patterns tolerate
    exponentially more fold. Every fired candidate is verified by the banded
    DP (exact), so folding trades verify work for scan work — false
    positives only, never false negatives: all scan masks are bitwise ORs of
    the per-pattern masks and the recurrence is monotone in every mask bit.
    Aligned lanes (same lo, same m) keep the last bits of co-resident
    patterns together, so the Damerau ``notlast`` guard never clears an
    interior bit of one of them.

    Returns a list of (pattern index, (limb, lo)) in limb order, or None
    when some pattern exceeds 64 graphemes."""
    strata: dict = {}
    for i, bp in enumerate(pats):
        if bp.m < 1 or bp.m > 64:
            return None
        strata.setdefault(bp.m, []).append(i)
    A_h = max(2, A - 1)
    eps_m = FOLD_EPS / len(strata)
    out = []
    base = 0
    for m in sorted(strata):
        idxs = strata[m]
        g = 64 // m
        kk = min(E, max(0, m - 1))
        # Solve (f/A)^(m-k) * (m+1)^k * count <= eps_m for the fold factor.
        denom = float((m + 1) ** kk * len(idxs))
        q = (eps_m / denom) ** (1.0 / max(1, m - kk))
        f = max(1.0, min(FOLD_MAX_F, q * A_h))
        per_limb = max(g, min(len(idxs), int(f * g)))
        n_limbs = -(-len(idxs) // per_limb)
        for j, p in enumerate(idxs):
            limb = base + j // per_limb
            slot = (j % per_limb) % g
            out.append((p, (limb, slot * m)))
        base += n_limbs
    return out


class ManyPackSpec:
    """Per-engine chunked packing: host numpy tables, one entry per chunk.

    ``chunks`` entries hold (pidx, offsets, ms, word_tbl, cr_field,
    cr_shift, cr_depth, cr_pc): the chunk's pattern indices (engine order),
    the (limb, bit) of each — folded layouts put several patterns on one
    aligned bit lane —, their lengths, the [A, 2W] word table, and per u32
    match-word column the expansion rows [2W, R] (verify field, shift,
    depth; field -1 pads) and their first 4 path classes [2W, R, 4] (-1
    pads). ``W`` / ``A`` / ``R`` are uniform over the chunks, ``m_max`` the
    longest pattern (the scan's halo), ``rd_min`` / ``rd_max`` the row
    depths' range."""

    __slots__ = ("filt", "chunks", "W", "A", "R", "m_max", "n_pat", "folded",
                 "rd_min", "rd_max")

    def __init__(self, filt, chunks, W, A, R, m_max, n_pat, folded=False,
                 rd_min=1, rd_max=1):
        self.filt = filt
        self.chunks = chunks
        self.W = W
        self.A = A
        self.R = R
        self.m_max = m_max
        self.n_pat = n_pat
        self.folded = folded
        self.rd_min = rd_min
        self.rd_max = rd_max

    @staticmethod
    def build(engine, fold: bool = False) -> Optional["ManyPackSpec"]:
        from ..prefilter import BitapFilter
        from .packed_bitap import MAX_ALPHABET_PACKED, _pack_fields, _word_table
        from .verify_dp import verify_fields_of

        filt = getattr(engine, "_bitap_filter_cache", None)
        if filt is None:
            filt = BitapFilter.build(engine, allow_mappings=True)
            engine._bitap_filter_cache = filt if filt is not None else False
        if filt is False or filt is None:
            return None
        vf = verify_fields_of(engine)
        if vf is None:
            return None
        pats = filt.patterns
        A = len(filt.symbol_ids) + 1
        if A > MAX_ALPHABET_PACKED:
            return None

        # ranges: (pidx ndarray, offsets list) per chunk.
        ranges = []
        if fold:
            assign = _fold_assign(pats, A, engine.max_edits_fast)
            if assign is None:
                return None
            # Split the folded layout at FOLD_CHUNK_LIMBS limb boundaries,
            # rebasing limb indices per chunk (patterns arrive limb-ordered).
            cur_p, cur_o, cur_c = [], [], 0
            for p, (lw, lo) in assign:
                c = lw // FOLD_CHUNK_LIMBS
                if c != cur_c and cur_p:
                    ranges.append((np.asarray(cur_p), cur_o))
                    cur_p, cur_o = [], []
                cur_c = c
                cur_p.append(p)
                cur_o.append((lw - c * FOLD_CHUNK_LIMBS, lo))
            if cur_p:
                ranges.append((np.asarray(cur_p), cur_o))
            # Fold pays off only when it actually cuts the pass count.
            offs_plain = _pack_fields([bp.m for bp in pats])
            if offs_plain is None:
                return None
            plain_chunks = -(-(max(w for w, _ in offs_plain) + 1) // MANY_LIMBS)
            if len(ranges) >= plain_chunks:
                return None
        else:
            # Greedy consecutive chunking under the limb budget.
            p0 = 0
            while p0 < len(pats):
                p1 = p0 + 1
                while p1 <= len(pats):
                    offs = _pack_fields([bp.m for bp in pats[p0:p1]])
                    if offs is None:
                        return None  # some pattern > 64 graphemes
                    if max(w for w, _ in offs) + 1 > MANY_LIMBS:
                        break
                    p1 += 1
                p1 -= 1
                if p1 <= p0:
                    return None  # a single pattern exceeds the limb budget
                ranges.append((np.arange(p0, p1), _pack_fields([bp.m for bp in pats[p0:p1]])))
                p0 = p1

        # Expansion rows grouped by u32 column: the expansion looks up a
        # fired word's rows directly (one bit lane's co-resident patterns all
        # live in the same column).
        chunks = []
        W = 1
        R = 1
        for (pidx, offsets) in ranges:
            ms = [pats[p].m for p in pidx]
            W = max(W, max(w for w, _ in offsets) + 1)
            by_col: dict = {}
            for p, (lw, lo), m_p in zip(pidx, offsets, ms):
                bit = lo + m_p - 1
                col, sh = 2 * lw + (bit >> 5), bit & 31
                for fld in vf.pat2field[p]:
                    if fld < 0:
                        continue
                    row = (int(fld), sh, int(vf.depth[fld]))
                    rows = by_col.setdefault(col, [])
                    if row not in rows:
                        rows.append(row)
            R = max([R] + [len(v) for v in by_col.values()])
            chunks.append((pidx, offsets, ms, by_col))
        rd_all = [d for (_pi, _o, _m, bc) in chunks for rows_ in bc.values() for (_f, _s, d) in rows_]
        rd_min = min(rd_all) if rd_all else 1
        rd_max = max(rd_all) if rd_all else 1

        # Uniform-shape numpy tables (padded to the global W / R).
        out_chunks = []
        for (pidx, offsets, ms, by_col) in chunks:
            limb = np.zeros((A, W), dtype=np.uint64)
            for p, (lw, lo) in zip(pidx, offsets):
                bp = pats[p]
                limb[: len(bp.mask), lw] |= bp.mask << np.uint64(lo)
            word_tbl = _word_table(limb, A, W)            # [A, 2W] i32
            cr_field = np.full((2 * W, R), -1, dtype=np.int32)
            cr_shift = np.zeros((2 * W, R), dtype=np.int32)
            cr_depth = np.zeros((2 * W, R), dtype=np.int32)
            cr_pc = np.full((2 * W, R, 4), -1, dtype=np.int32)
            for col, rows in by_col.items():
                for i, (fld, sh, d) in enumerate(rows):
                    cr_field[col, i] = fld
                    cr_shift[col, i] = sh
                    cr_depth[col, i] = d
                    jj = min(4, d)
                    cr_pc[col, i, :jj] = vf.path_cls[fld, :jj]
            out_chunks.append((pidx, offsets, ms, word_tbl, cr_field, cr_shift, cr_depth, cr_pc))
        m_max = max(bp.m for bp in pats)
        return ManyPackSpec(filt, out_chunks, W, A, R, m_max, len(pats), folded=fold,
                            rd_min=rd_min, rd_max=rd_max)

    def masks_for(self, ks: List[int], k: int):
        """Per-chunk (starts [2W] u32, match [k+1, 2W] u32, init [k+1, 2W]
        u32, notlast [2W] i32) at the per-pattern budgets ``ks``; ``k`` is
        the uniform row count. Folded layouts OR the masks of co-resident
        patterns; their last bits coincide (aligned lanes), so ``notlast``
        never clears an interior bit."""
        from .packed_bitap import _last_bit_mask, _starts_mask

        out = []
        for (pidx, offsets, ms, *_rest) in self.chunks:
            starts = _starts_mask(offsets, self.W)
            match = _last_bit_mask(offsets, ms, k + 1, lambda i: ks[pidx[i]], self.W)
            init = np.zeros((k + 1, 2 * self.W), dtype=np.uint32)
            for (lw, lo), m in zip(offsets, ms):
                for d in range(1, k + 1):
                    word = np.uint64((1 << min(d, m)) - 1) << np.uint64(lo)
                    init[d, 2 * lw] |= np.uint32(word & np.uint64(0xFFFFFFFF))
                    init[d, 2 * lw + 1] |= np.uint32(word >> np.uint64(32))
            notlast = (
                np.uint32(0xFFFFFFFF) ^ _last_bit_mask(offsets, ms, 1, lambda i: 0, self.W)[0]
            ).view(np.int32)
            out.append((starts, match, init, notlast))
        return out


def many_spec_of(engine, fold: bool = False) -> Optional[ManyPackSpec]:
    key = "_many_spec_cache_fold" if fold else "_many_spec_cache"
    sp = getattr(engine, key, None)
    if sp is None:
        sp = ManyPackSpec.build(engine, fold=fold)
        setattr(engine, key, sp if sp is not None else False)
    return sp if sp is not False else None


# ---------------------------------------------------------------------------
# The chunk step: sparse expansion, banded DP, emission
# ---------------------------------------------------------------------------

class ExpandTables(NamedTuple):
    """A chunk's expansion rows on one device: ``field`` / ``shift`` /
    ``depth`` int32 [2W, R], ``pc`` int32 [2W, R, 4] (see
    :class:`ManyPackSpec`), the row depths' range over the whole dictionary,
    and the table's live rows (field >= 0): the most candidates one (band,
    hit) item can give."""

    field: torch.Tensor
    shift: torch.Tensor
    depth: torch.Tensor
    pc: torch.Tensor
    rd_min: int
    rd_max: int
    rows: int

    @property
    def R(self) -> int:
        return self.field.shape[1]


#: Path classes of a row the containment test reads.
CONTAIN_J = 4


def expand_candidates_sparse(pos, words, window, E: int, X: ExpandTables, ids=None, k: int = 0,
                             h0: int = 0):
    """The expansion of :func:`many_step_torch`: the JAX package's
    ``many._expand_candidates_sparse``, op for op.

    ``pos`` [K] int64 ascending and ``words`` [K, 2W] int64 u32 halves as
    ``packed_hits`` returns them; ``window`` a ``verify_dp.DpWindow``
    (candidate starts in ``[start_lo, start_hi)``, hits below ``pos_hi``);
    ``ids`` the dense class-id stream for the containment pre-verify (taken
    where some row's depth is >= 4); ``k`` the scan's error rows; hits
    before ``h0`` are not expanded, only read as the predecessor of hit
    ``h0`` (a range of a longer hit list, handed its preceding hit).

    The nonzero (hit, column) pairs of valid hits are taken in (hit, column)
    order, each expands the rows of its column whose bit fired; bands past
    0 drop a row whose bit fired one position earlier too (the hit-run
    dedup). Containment: of a row's first J = 4 path classes at least J - k
    must appear in the corpus window [s0 - 2k, s0 + 4 + 2k) (s0 = end -
    depth), cut to the pair's window of width WP = 4 + 4k + rd_max - rd_min
    from wlo = clip(end - rd_max - 2k, 0, max(start_hi - WP, 0)); reads past
    the stream read its last symbol, as the JAX gather clamps them. Order:
    band-major, then pair, then row. Returns (nonzero pairs, cand_field,
    cand_start int32 [M])."""
    dev = pos.device
    start_lo, start_hi, pos_hi = (int(x) for x in window)
    K, W2 = words.shape
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    hit_ok = (pos >= 0) & (pos < pos_hi) & (torch.arange(K, device=dev) >= h0)
    pidx = compact_indices(((words != 0) & hit_ok[:, None]).reshape(-1))
    if pidx.numel() == 0:
        return 0, empty, empty.clone()
    h, c = pidx // W2, pidx % W2
    w = words[h, c]
    ends = pos[h] + 1
    hprev = (h - 1).clamp(min=0)
    prev_same = (h > 0) & (pos[hprev] + 1 == pos[h])
    wprev = torch.where(prev_same, words[hprev, c], 0)
    rf = X.field[c].long()                                     # [P, R]
    rs = X.shift[c].long()
    rd = X.depth[c].long()
    fired = (rf >= 0) & (((w[:, None] >> rs) & 1) == 1)
    dup = prev_same[:, None] & (((wprev[:, None] >> rs) & 1) == 1)
    if ids is not None and X.rd_max >= CONTAIN_J:
        wj = CONTAIN_J + 4 * k
        wp = wj + (X.rd_max - X.rd_min)
        lo_r = ends[:, None] - rd - 2 * k                      # [P, R]
        wlo = (ends - X.rd_max - 2 * k).clamp(min=0).clamp(max=max(start_hi - wp, 0))
        t_abs = wlo[:, None] + torch.arange(wp, device=dev)   # [P, WP]
        win = ids[t_abs.clamp(max=ids.numel() - 1)].long()
        valid = (t_abs[:, None, :] >= lo_r[..., None]) & (t_abs[:, None, :] < (lo_r + wj)[..., None])
        pc = X.pc[c].long()                                    # [P, R, J]
        eq = (pc[..., :, None] == win[:, None, None, :]) & valid[..., None, :]
        cnt = eq.any(-1).sum(-1)                               # [P, R]
        fired = fired & ((rd < CONTAIN_J) | (cnt >= CONTAIN_J - k))
    oks, starts = [], []
    for b in range(2 * E + 1):
        start = ends[:, None] - (rd + (b - E))
        ok = fired & (start >= start_lo) & (start < start_hi)
        if b > 0:
            ok = ok & ~dup
        oks.append(ok.reshape(-1))
        starts.append(start.reshape(-1))
    idx = compact_indices(torch.cat(oks))
    fields = rf.reshape(-1).repeat(2 * E + 1)
    return pidx.numel(), fields[idx].to(torch.int32), torch.cat(starts)[idx].to(torch.int32)


def dp_list_torch(cand_field, cand_start, ids, limit, T, pens, thr, E: int, deadend: bool):
    """The DP and emission of :func:`many_step_torch` over a candidate list
    (``cand_field`` / ``cand_start`` int32 [M]): ``verify_dp.banded_dp_torch``
    then ``verify_dp.emit_rows``. Returns rows int32 [K, 5]."""
    from .verify_dp import banded_dp_torch, emit_rows

    pen, cnt = banded_dp_torch(cand_field, cand_start, ids, limit, T, pens, E, deadend)
    return emit_rows(pen, cnt, cand_field, cand_start, T, limit, thr, E)


def many_max_hits(X: ExpandTables, E: int, nch: int) -> int:
    """Most hits one range of a chunk's hit list may hold: the counts of
    :func:`many_step` over it (per (band, hit) item at most every live row
    as a candidate, a row per candidate and emission channel, of ``nch``,
    and every column per hit as a pair) stay inside int32 offsets."""
    return ((1 << 31) - 1) // ((nch + 1) * (2 * E + 1) * max(X.rows, 1) + X.field.shape[0])


def _check_step(pos, words, ids, T, E: int, X: ExpandTables, k: int, h0: int) -> None:
    for name, t in (("pos", pos), ("words", words)):
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int64 tensor")
    if pos.dim() != 1 or words.dim() != 2 or words.shape[0] != pos.numel():
        raise ValueError("pos must be [H] and words [H, 2W]")
    for name, t in (("field", X.field), ("shift", X.shift), ("depth", X.depth), ("pc", X.pc)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != pos.device:
            raise ValueError(f"expansion table {name} must be a contiguous int32 tensor on "
                             f"{pos.device}")
    if X.field.shape != (words.shape[1], X.R) or X.pc.shape != (words.shape[1], X.R, CONTAIN_J):
        raise ValueError("expansion tables of another width than the match words")
    if ids.dtype != torch.uint8 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous 1-D uint8 tensor")
    if not (words.device == pos.device == ids.device == T.device):
        raise ValueError(f"hits on {pos.device}, words on {words.device}, ids on {ids.device}, "
                         f"tables on {T.device}")
    if T.node_ceil is None:
        raise ValueError("tables carry no node ceilings (DpTables.with_ceil)")
    if not 1 <= E <= 6 or not 0 <= k <= 6:
        raise ValueError(f"edit budget {E} or error rows {k} outside 1..6 / 0..6")
    if not 0 <= h0 <= pos.numel():
        raise ValueError(f"first hit {h0} outside the {pos.numel()} hits")


def many_step_torch(pos, words, window, ids, limit, T, pens, thr, E: int, deadend: bool,
                    X: ExpandTables, k: int = 0, h0: int = 0, contain: bool = True):
    """Plain version of ``many_step_kernel``: :func:`expand_candidates_sparse`
    of the hits from ``h0`` on (the containment test on ``ids`` where
    ``contain``), then :func:`dp_list_torch` over the candidates with the DP
    reading ``ids`` up to ``limit``. Returns (rows int32 [K, 5], nonzero
    pairs, candidates)."""
    pairs, cand_field, cand_start = expand_candidates_sparse(
        pos, words, window, E, X, ids if contain else None, k, h0)
    rows = dp_list_torch(cand_field, cand_start, ids, limit, T, pens, thr, E, deadend)
    return rows, pairs, cand_field.numel()


def many_step(pos, words, window, ids, limit, T, pens, thr, E: int, deadend: bool,
              X: ExpandTables, k: int = 0, h0: int = 0, contain: bool = True):
    """One range of a chunk's hit list -> match rows: (rows int32 [K, 5] on
    the hits' device, nonzero (hit, column) pairs, candidates), rows as
    :func:`dp_list_torch` orders them (see :func:`many_step_torch`).
    ``pos`` [H] int64 ascending and ``words`` [H, 2W] int64 as
    ``packed_hits`` returns them; ``window`` a ``verify_dp.DpWindow``;
    ``ids`` the u8 dense class ids; ``k`` the scan's error rows. CPU tensors
    run :func:`many_step_torch`; CUDA tensors launch ``many_step_kernel``
    twice, a count pass and a write pass with ``block_offsets_kernel``
    between them, and read the three totals back in one read."""
    from . import packed_bitap as pb
    from .verify_dp import MAX_CHANNELS, _pen_floats, emit_bound

    _check_step(pos, words, ids, T, E, X, k, h0)
    if ids.device.type == "cpu":
        return many_step_torch(pos, words, window, ids, limit, T, pens, thr, E, deadend, X, k,
                               h0, contain)
    if ids.device.type != "cuda":
        raise ValueError(f"no step kernel for device {ids.device}")
    K, dev = pos.numel(), ids.device
    MO = T.out_list.shape[1]
    nch = (2 * E + 1) * MO
    if nch > MAX_CHANNELS:
        raise ValueError(f"{nch} emission channels, the kernel takes {MAX_CHANNELS}")
    if K - h0 > many_max_hits(X, E, nch):
        raise ValueError(f"{K - h0} hits: the step's counts would overflow int32 offsets")
    items = (2 * E + 1) * (K - h0)
    if items == 0:
        return torch.zeros((0, 5), dtype=torch.int32, device=dev), 0, 0
    kern = _cuda_build.load()
    counts = torch.empty((nch + 2) * items, dtype=torch.int32, device=dev)
    args = (
        pos.data_ptr(), words.data_ptr(), K, h0, words.shape[1], X.field.data_ptr(),
        X.shift.data_ptr(), X.depth.data_ptr(), X.pc.data_ptr(), X.R, k, X.rd_min, X.rd_max,
        int(contain and X.rd_max >= CONTAIN_J), *(int(x) for x in window), ids.data_ptr(),
        ids.numel(), int(limit), T.path_cls.data_ptr(), T.path_node.data_ptr(),
        T.depth.data_ptr(), T.node.data_ptr(), T.Lmax, T.depth.numel(), T.sim.data_ptr(), T.C,
        T.node_ceil.data_ptr(), T.sb_edge.data_ptr(), T.out_count.data_ptr(),
        T.out_count.numel(), T.out_list.data_ptr(), MO, T.pat_len.data_ptr(),
        T.pat_weight.data_ptr(), *_pen_floats(pens), emit_bound(thr), E, int(bool(deadend)),
    )

    def launch(write: int, offsets, rows):
        with pb.on_device(dev):
            rc = kern.lib.fac_many_step(
                *args, write, counts.data_ptr(), None if offsets is None else offsets.data_ptr(),
                None if rows is None else rows.data_ptr(), pb.stream_of(dev))
        kern.check(rc, "many_step")
        pb.LAUNCHES["many_step"] += 1

    launch(0, None, None)
    offsets = pb.block_offsets(counts)
    # The rows' total ends the channels' counts, the candidates' and the
    # pairs' follow: one strided read of three values.
    with trace.wait("step_totals"):
        n_rows, n_rc, n_all = offsets[nch * items::items].tolist()
    rows = torch.empty((n_rows, 5), dtype=torch.int32, device=dev)
    if n_rows:
        launch(1, offsets, rows)
    return rows, n_all - n_rc, n_rc - n_rows


# ---------------------------------------------------------------------------
# One chunk: scan -> expand -> DP -> emit
# ---------------------------------------------------------------------------

class ManyChunk(NamedTuple):
    """A chunk's tables on one device: the scan's and the expansion's."""

    T_scan: object
    X: ExpandTables


class ManyStep(NamedTuple):
    """One chunk's result: match rows int32 [K, 5] on the corpus's device
    and the counts of hits, nonzero (hit, column) pairs and candidates."""

    rows: torch.Tensor
    hits: int
    pairs: int
    candidates: int


def _packed_hits_torch(ids, T, halo: int, max_count: Optional[int] = None):
    """The plain versions of the hit-list scan's three kernels, composed as
    ``packed_bitap.packed_hits`` composes the kernels."""
    from .packed_bitap import block_offsets_torch, hit_words_torch, scan_bits_torch

    bits, counts = scan_bits_torch(ids, T, halo)
    offsets = block_offsets_torch(counts)
    count = int(offsets[-1])
    if max_count is not None and count > max_count:
        return count, None, None
    if count == 0:
        return 0, torch.zeros(0, dtype=torch.int64, device=ids.device), \
            torch.zeros((0, 2 * T.W), dtype=torch.int64, device=ids.device)
    pos, words = hit_words_torch(ids, bits, offsets, count, T, halo)
    return count, pos, words


def _step(hits_fn, step_fn, ids_pf, ids_de, n: int, chunk: ManyChunk, halo: int, T, pens, thr,
          E: int, deadend: bool, hit_ceil: Optional[int]) -> Optional[ManyStep]:
    from .verify_dp import DpWindow

    count, pos, words = hits_fn(ids_pf, chunk.T_scan, halo, hit_ceil)
    if pos is None:
        return None
    # Ranges of at most max_hits hits keep every count inside int32 offsets;
    # each range but the first takes its preceding hit along for the dedup.
    max_hits = many_max_hits(chunk.X, E, (2 * E + 1) * T.out_list.shape[1])
    rows, pairs, cands = [], 0, 0
    with trace.span("step") as sp:
        for a in range(0, max(count, 1), max_hits):
            h0 = min(a, 1)
            r, p, c = step_fn(pos[a - h0:a + max_hits], words[a - h0:a + max_hits],
                              DpWindow(0, n, n), ids_de, n, T, pens, thr, E, deadend, chunk.X,
                              chunk.T_scan.k, h0)
            rows.append(r)
            pairs += p
            cands += c
        rows = rows[0] if len(rows) == 1 else torch.cat(rows)
        if sp:
            sp.set(candidates=cands, rows=rows.shape[0])
    return ManyStep(rows, count, pairs, cands)


def many_pipeline(ids_pf, ids_de, n: int, chunk: ManyChunk, halo: int, T, pens, thr, E: int,
                  deadend: bool, hit_ceil: Optional[int] = None) -> Optional[ManyStep]:
    """One chunk's search over the resident corpus (``ids_pf`` the prefilter
    symbols, ``ids_de`` the u8 dense class ids, ``n`` symbols of text): the
    hit-list scan (``packed_bitap.packed_hits``) and :func:`many_step` over
    ranges of at most :func:`many_max_hits` hits (one range at any real
    corpus). None where the chunk fires more than ``hit_ceil`` hits (the
    folded layout's ceiling). The host reads the hit count and, per range,
    the step's three totals (one read)."""
    from .packed_bitap import packed_hits

    return _step(packed_hits, many_step, ids_pf, ids_de, n, chunk, halo, T, pens, thr, E,
                 deadend, hit_ceil)


def many_pipeline_torch(ids_pf, ids_de, n: int, chunk: ManyChunk, halo: int, T, pens, thr,
                        E: int, deadend: bool, hit_ceil: Optional[int] = None
                        ) -> Optional[ManyStep]:
    """Plain version of :func:`many_pipeline`: the plain versions of every
    kernel it launches, on tensors of any device."""
    return _step(_packed_hits_torch, many_step_torch, ids_pf, ids_de, n, chunk, halo, T, pens,
                 thr, E, deadend, hit_ceil)


# ---------------------------------------------------------------------------
# The lane
# ---------------------------------------------------------------------------

#: Sentinel: the folded scan fired past its hit ceiling; the caller re-runs
#: with the plain chunks.
_FOLD_OVERFLOW = object()


def _overflow_key(haystack: str, n: int, thr) -> tuple:
    from ..utils.device_corpus import _content_key

    return _content_key(haystack) + (n, float(np.float32(thr)))


def fuzzy_search_many(engine, haystack: str, threshold, view, n: int) -> Optional[List]:
    """Chunked large-dictionary fuzzy search; None where the lane does not
    apply (the caller goes on to the next lane). Oracle-identical matches.
    FAST-path configurations only (global total-edit budget, no mappings,
    no per-pattern limits — the DeviceEngine gate).

    Tries the stratified-folded layout first (:func:`_fold_assign`); where
    its scan fires past the hit ceiling on this corpus, the search re-runs
    with the plain chunking, and later searches of the same corpus at the
    same threshold go to it directly."""
    memo = getattr(engine, "_many_fold_overflow", None)
    if memo is None:
        memo = engine._many_fold_overflow = OrderedDict()
    key = _overflow_key(haystack, n, threshold)
    if FOLD and key not in memo:
        spec = many_spec_of(engine, fold=True)
        if spec is not None:
            res = _many_search_spec(engine, spec, haystack, threshold, view, n)
            if res is not _FOLD_OVERFLOW:
                return res
            memo[key] = True
            while len(memo) > FOLD_OVERFLOW_MEMORY:
                memo.popitem(last=False)
    spec = many_spec_of(engine)
    if spec is None:
        return None
    res = _many_search_spec(engine, spec, haystack, threshold, view, n)
    return None if res is _FOLD_OVERFLOW else res


def many_budgets(engine, spec: ManyPackSpec, thr):
    """(per-pattern scan budgets, Damerau rows) at threshold ``thr``, cached
    per engine: the Damerau model (swap = one error) where it needs fewer
    rows than the plain one, as the DP lane decides; budgets None where the
    scan cannot serve the threshold."""
    cache = getattr(engine, "_many_ks_cache", None)
    if cache is None:
        cache = engine._many_ks_cache = {}
    key = float(np.float32(thr))
    got = cache.get(key)
    if got is None:
        ks_p = [spec.filt.k_for(bp, np.float32(thr)) for bp in spec.filt.patterns]
        ks_d = [spec.filt.k_for(bp, np.float32(thr), damerau=True) for bp in spec.filt.patterns]
        dam = None not in ks_d and (None in ks_p or max(ks_d) < max(ks_p))
        got = cache[key] = (ks_d if dam else ks_p, dam)
    return got


class ManyRun(NamedTuple):
    """Everything one search of the lane needs on the device: the chunks'
    tables, the DP tables with this threshold's ceilings, penalties, the
    dead-end flag, the scan's halo and row count, the resident corpora
    (``ids_pf`` prefilter symbols, ``ids_de`` dense class ids) and the folded
    layout's hit ceiling (None for the plain chunking)."""

    chunks: List[ManyChunk]
    T: object
    pens: object
    E: int
    deadend: bool
    halo: int
    k: int
    dam: bool
    ids_pf: torch.Tensor
    ids_de: torch.Tensor
    hit_ceil: Optional[int]


def many_inputs(engine, spec: ManyPackSpec, haystack: str, threshold, view, n: int):
    """The lane's device inputs for one search (:class:`ManyRun`), or None
    where the lane declines (corpus past ``RESIDENT_MAX``, no DP fields, a
    dense alphabet past 256 classes, a threshold the scan cannot serve), or
    [] where no match can pass the threshold."""
    from ..utils import device_corpus
    from .packed_bitap import RESIDENT_MAX, _space_token, tables_from_numpy
    from .verify_dp import DpPenalties, _dev_cache, dp_tables_from_numpy, verify_fields_of

    thr = np.float32(threshold)
    if n > RESIDENT_MAX:
        return None
    vf = verify_fields_of(engine)
    if vf is None:
        return None
    dense = engine.dense
    if dense.num_classes > 256:
        return None
    ks, dam = many_budgets(engine, spec, thr)
    if None in ks:
        return None
    k = max(ks)
    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr)
    max_pen = np.float32(ceil[0])
    if np.float32(0.0) > max_pen:
        return []

    device = engine.device
    dkey = str(device)
    tok = _space_token(engine)
    hay_bytes = view.hay_bytes() if view.ascii else None
    ids_pf, n_pf = device_corpus.resident(
        haystack, ("pk-fuzzy", tok),
        lambda h: np.ascontiguousarray(spec.filt.transcode(h, hay_bytes=hay_bytes)[0],
                                       dtype=np.uint8),
        device)
    ids_de, n_de = device_corpus.resident(
        haystack, ("dense", tok),
        lambda h: np.ascontiguousarray(dense.transcode(h, view), dtype=np.uint8), device)
    assert n_pf == n_de == n

    def ship():
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
        out = []
        for chunk, (starts, match, init, notlast) in zip(spec.chunks, spec.masks_for(ks, k)):
            word_tbl, cr_field, cr_shift, cr_depth, cr_pc = chunk[3:]
            out.append(ManyChunk(
                tables_from_numpy(word_tbl, starts, match, init, notlast if dam else None,
                                  device=device),
                ExpandTables(put(cr_field), put(cr_shift), put(cr_depth), put(cr_pc),
                             spec.rd_min, spec.rd_max, int((cr_field >= 0).sum()))))
        return out

    chunks = _dev_cache(engine, ("many", float(thr), dam, spec.folded, dkey), ship)
    T_base = _dev_cache(engine, ("dp", dkey), lambda: dp_tables_from_numpy(
        vf.depth, vf.node, vf.path_cls, vf.path_node, dense.sim, dense.out_list,
        dense.pat_len, dense.pat_weight, dense.sb_edge, dense.out_count, device=device))
    T = T_base.with_ceil(_dev_cache(
        engine, ("ceil", ceil.tobytes(), dkey),
        lambda: torch.from_numpy(np.ascontiguousarray(ceil, np.float32)).to(device)))
    pens = engine.penalties
    dp_pens = DpPenalties(max_pen, pens.substitution, pens.insertion, pens.deletion,
                          pens.swap, engine.min_symbol_similarity)
    hit_ceil = max(FOLD_HIT_CEIL_MIN, ids_pf.numel() >> 8) if spec.folded else None
    return ManyRun(chunks, T, dp_pens, engine.max_edits_fast,
                   bool(dense.has_multibyte_edges), spec.m_max + k, k, dam, ids_pf, ids_de,
                   hit_ceil)


def _many_search_spec(engine, spec, haystack: str, threshold, view, n: int):
    from .emit import decode_matches

    run = many_inputs(engine, spec, haystack, threshold, view, n)
    if not isinstance(run, ManyRun):
        return run
    thr = np.float32(threshold)
    dev_parts = []
    sum_h = sum_c = 0
    at = trace.mark()
    for chunk in run.chunks:
        step = many_pipeline(run.ids_pf, run.ids_de, n, chunk, run.halo, run.T, run.pens, thr,
                             run.E, run.deadend, run.hit_ceil)
        if step is None:
            return _FOLD_OVERFLOW
        dev_parts.append(step.rows)
        sum_h += step.hits
        sum_c += step.candidates
    with trace.span("finish"):
        trace.timing_sync(engine.device)
        parts = []
        for rows in dev_parts:
            with trace.wait("rows", rows.nbytes):
                parts.append(rows.cpu().numpy())
        # One merged decode over all chunks: decode_matches sorts globally by
        # (pattern, start, end), so the result does not depend on chunk order;
        # duplicate emissions (a verify field shared by patterns in two chunks)
        # collapse in its best-per-span pass with identical values.
        rows = parts[0] if len(parts) == 1 else np.concatenate(parts)
        results = decode_matches(
            engine, view, haystack, n, rows[:, 0], rows[:, 2], rows[:, 3],
            np.ascontiguousarray(rows[:, 1]).view(np.float32), rows[:, 4], thr,
        )
        engine.last_stats = {
            "backend": "device-fuzzy-many",
            "hits": sum_h,
            "candidates": sum_c,
            "positions": int(n),
            "emissions": len(rows),
            "matches": len(results),
            "chunks": len(run.chunks),
            "damerau": run.dam,
            "folded": spec.folded,
        }
        engine.last_stats.update(trace.stage_stats(at, parts))
    return results
