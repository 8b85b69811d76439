"""Device fuzzy search for FAST-path configurations: routing and the
beam-frontier lanes.

The JAX package serves these engines on three device lanes, tried in order
(its ``ops/fuzzy.fuzzy_search_device``), and so does the port:

1. the banded-DP verify lane (``ops/verify_dp.fuzzy_search_dp``);
2. the large-dictionary lane (``ops/many.fuzzy_search_many``) when the
   dictionary does not fit the packed scan tables;
3. the beam frontier (this module), for what both decline: a prefilter
   alphabet past 128 symbols, a pattern past 63 graphemes, a threshold
   budget past ``MAX_USEFUL_K``, or one search past ``RESIDENT_MAX``
   graphemes.

The beam frontier is the reference's per-start BFS (reference
src/search.rs:418-1119, SURVEY §7) advanced in *rounds* over a chunk of
candidate starts (the JAX package's is XLA code, not Pallas). Each round
expands every live state by one reference BFS pop (:func:`_expand`: the
exact, substitution, swap, insertion and deletion pushes with every push
guard, f32 in the oracle's op order, the dead-end filters on the ``sb_edge``
single-byte-edge table), then:

* E = 1 (:func:`_pool_chunk`): a state that has spent its edit can only take
  exact transitions, so the frontier is the 0-edit walk ``s0`` per start plus
  an append-only pool of 1-edit walks spawned from it, no dedup needed;
* E >= 2 (:func:`_beam_chunk`): per round, a lexicographic sort of the
  candidates on (start, node, j << 16 | me, counts, penalty), the first of
  each (start, node, j, me, counts) kept, at most ``B = 32 + 24 E`` per start;
  a start with more overflows and is re-searched by the host oracle.

Per-round dedup is exact: in a tree trie the node fixes its depth ``d``, and
every BFS path reaching state key ``(node, j, me, counts)`` has length
``rounds = d + insertions - swaps``, a function of the key alone, so all
paths to equal keys meet in the same round.

On the card hand kernels run all of a run's rounds (``csrc/beam.cu``): at
E = 1 ``beam_pool_thread_kernel``, a thread a start, and
``beam_pool_kernel``, a warp a start for the starts whose pool outgrows a
thread's walks; at E >= 2 ``beam_sorted_kernel``, a warp a start
(:func:`pool_frontier`, :func:`sorted_frontier`). A count phase keeps one
count a start, ``block_offsets`` scans them, a write phase runs again the
starts that emit and stages each start's emissions together, and
``beam_order_kernel`` (:func:`order_emissions`) puts each chunk in round
order; a start's frontier never reads another's, so each start takes its
own rounds until its frontier empties. On CPU tensors the
wrappers run the plain versions :func:`_pool_chunk` and :func:`_beam_chunk`:
torch in lockstep rounds that hold only live states (each round compacts
with ``torch.nonzero``; a run stops when no state is left). Unlike the JAX
package (static shapes, padded chunks, capacity retries) both take the
starts unpadded. Chunks keep the JAX package's size and the emission order
(chunk, round, start, slot, output), so the host's best-per-span reduction
keeps the same first emission on a tie and returns the JAX package's list,
in its order.

The JAX package's fused E = 1 pipeline (``_fuzzy1_fused``) is not ported: it
runs only where the packed prefilter takes the engine with every plain
threshold budget defined, below ``RESIDENT_MAX``, and there the port's DP
lane never declines (its ``dp_plan`` accepts whenever the plain budgets
are defined), so no search reaches it.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..utils import trace
from . import _cuda_build

#: Start positions per chunk (the JAX package's dispatch size; the chunk
#: bound below keeps its memory cap).
NCHUNK = 1 << 13
#: Below this corpus size the filters are not worth their pass: every
#: position is a candidate start.
FILTER_MIN_N = 1 << 14
#: The per-pattern bitap pre-pass is linear in pattern count; past this
#: every position is a candidate start.
FILTER_MAX_PATTERNS = 64
#: Candidates the plain frontier may hold in one round: it takes whole
#: chunks of the JAX package's size, as many as fit this many candidates at
#: the most a start can have in a round (2 D + 3 at the root; at E >= 2 up to
#: B slots of 2 D + 3 each later), at least one. One round costs about the
#: same host time whatever its size, and a run takes as many rounds as its
#: longest-lived walk, so fewer, larger runs take fewer rounds.
GROUP_CANDIDATES = 1 << 24
#: Bytes a run of the kernels may hold per start on the card (its count,
#: offset, flag and place in the handed-off list: ``RUN_START_BYTES``): the
#: card's run is as many whole chunks as fit ``RUN_BYTES``, at least one.
RUN_BYTES = 1 << 27
RUN_START_BYTES = 13
#: ``csrc/beam.cu``'s constants (``fac_beam_const``): the most dynamic shared
#: memory a block may opt in to on sm_90 (SMEM_MAX), the pool and the sorted
#: kernels' threads a block (POOL_THREADS, SORT_THREADS: a warp a start on
#: the warp paths), the order kernel's warps (ORDER_WARPS) and the bytes its
#: round histograms may take on chip (ORDER_SMEM), the bytes of a pool walk
#: or a sort key (ENTRY_BYTES), the most candidates a round sorts in
#: registers (WARP_SORT_KEYS), the most starts a warp takes at once (BATCH)
#: and the stats' slots (emissions, states expanded, rounds, overflowed
#: starts, starts that went to the global scratch, rounds sorted in memory,
#: starts handed from the pool's thread path to its warp path, their
#: emissions, whether the tables were read from shared memory, the work
#: counters).
FRONTIER_SMEM_MAX = 232448
POOL_THREADS = 256
SORT_THREADS = 256
ORDER_WARPS = 32
ORDER_SMEM = 49152
FRONTIER_ENTRY_BYTES = 16
WARP_SORT_KEYS = 64
FRONTIER_BATCH = 32
STATS_SLOTS = 16
#: Walks a pool thread keeps in shared memory: a start whose pool grows past
#: them is handed to the pool's warp path.
THREAD_POOL_WALKS = 8
#: Walks a pool warp keeps in shared memory, and candidates a sorted warp
#: keeps there beside its beam: a start whose pool, or a round whose
#: candidates, grow past them moves to the warp's region of the global
#: scratch.
POOL_CHIP_WALKS = 256
SORT_CHIP_KEYS = 128
#: The automaton's tables are staged into each block's shared memory up to
#: this many bytes (``tables_bytes``), where they fit beside the workspace.
#: These four are ``csrc/beam.cu``'s too (``fac_beam_const`` 9-12): the
#: kernels' layout is the library's (``fac_beam_layout``), and
#: :func:`frontier_workspace`, :func:`tables_bytes` and
#: :func:`tables_on_chip` mirror it.
TABLES_SMEM_MAX = 1 << 16
#: The most global scratch a launch takes for spilled pools or keys; the
#: persistent grid shrinks to fit it (at least one block).
FRONTIER_SPILL_BYTES = 1 << 27
#: The staged emission's int32 fields (``csrc/beam.cu`` ``Em``): the start's
#: index in the run, me, pattern, counts, the penalty's bits, the round.
STAGED_FIELDS = 6


class KernelTables(NamedTuple):
    """The tables the frontier kernels read: int32 ``goto`` [nodes, C], the
    edge lists, ``out_count`` and ``out_list``, and ``sb`` as uint8."""

    goto: torch.Tensor
    sb: torch.Tensor
    et_full: torch.Tensor
    ec_full: torch.Tensor
    et_deep: torch.Tensor
    ec_deep: torch.Tensor
    out_count: torch.Tensor
    out_list: torch.Tensor


class BeamTables(NamedTuple):
    """The dense automaton on the device, as the frontier gathers from it:
    ``goto`` and ``sb`` flat [nodes * C]; the edge lists at full width
    (``et_full`` / ``ec_full``, the root round) and at the deepest non-root
    degree (``et_deep`` / ``ec_deep``); ``sim`` flat [C * C]; outputs and
    per-pattern length and weight (int64 and bool, as the plain versions
    gather them); ``k32`` the same for the kernels."""

    C: int
    num_nodes: int
    goto: torch.Tensor
    sb: torch.Tensor
    et_full: torch.Tensor
    ec_full: torch.Tensor
    et_deep: torch.Tensor
    ec_deep: torch.Tensor
    sim: torch.Tensor
    out_count: torch.Tensor
    out_list: torch.Tensor
    pat_len: torch.Tensor
    pat_weight: torch.Tensor
    k32: KernelTables


class BeamParams(NamedTuple):
    """One search's scalars: the node ceilings [nodes], and the budget,
    penalties, symbol floor and slack threshold as 0-dim float32 tensors on
    the device (so every product and sum is float32, in the oracle's order);
    the edit budget ``E``, the rounds ``T`` and the corpus length; ``host``
    the seven float32 scalars (max_pen, p_sub, p_ins, p_del, p_swap, floor,
    slack) as numpy values, which the kernels take by value."""

    ceil: torch.Tensor
    max_pen: torch.Tensor
    p_sub: torch.Tensor
    p_ins: torch.Tensor
    p_del: torch.Tensor
    p_swap: torch.Tensor
    floor: torch.Tensor
    slack: torch.Tensor
    E: int
    T: int
    limit: int
    host: tuple


class States(NamedTuple):
    """A flat frontier: per state its start's index in the chunk ``si``, the
    start's corpus position ``pos0``, the trie node, text offset ``j``,
    match end ``me``, packed edit counts (insertions | deletions << 8 |
    substitutions << 16 | swaps << 24), penalty and pool slot (E = 1)."""

    si: torch.Tensor
    pos0: torch.Tensor
    node: torch.Tensor
    j: torch.Tensor
    me: torch.Tensor
    counts: torch.Tensor
    pen: torch.Tensor
    slot: torch.Tensor


def _take(st: States, idx: torch.Tensor) -> States:
    return States(*(f[idx] for f in st))


def deep_degree(dense) -> int:
    """The widest edge list of a non-root node (at least 1): the width of
    every round's expansion but the root's."""
    deg = (dense.edge_target >= 0).sum(axis=1)
    return max(int(deg[1:].max()) if dense.num_nodes > 1 else 1, 1)


def beam_tables(engine, device) -> BeamTables:
    """The engine's :class:`BeamTables` on ``device``, cached per engine
    (``engine.to`` drops them)."""
    from .verify_dp import _dev_cache

    dense = engine.dense
    d_deep = deep_degree(dense)

    def build():
        put = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)
        i64, i32, f32 = torch.int64, torch.int32, torch.float32
        tables = (dense.edge_target, dense.edge_class, dense.edge_target[:, :d_deep],
                  dense.edge_class[:, :d_deep])
        return BeamTables(
            dense.num_classes, dense.num_nodes,
            put(dense.goto.reshape(-1), i64), put(dense.sb_edge.reshape(-1) > 0, torch.bool),
            *(put(t, i64) for t in tables),
            put(dense.sim.reshape(-1), f32), put(dense.out_count, i64),
            put(dense.out_list, i64), put(dense.pat_len, f32), put(dense.pat_weight, f32),
            KernelTables(put(dense.goto, i32), put(dense.sb_edge > 0, torch.uint8),
                         *(put(t, i32) for t in tables), put(dense.out_count, i32),
                         put(dense.out_list, i32)),
        )

    return _dev_cache(engine, ("beam", str(device)), build)


def beam_params(engine, thr: np.float32, ceil: np.ndarray, n: int, device) -> BeamParams:
    """The search's :class:`BeamParams` (the slack threshold is the JAX
    kernels': ``thr - (1e-4 + 1e-4 |thr|)``; the host refilters exactly).
    The device copies are cached per engine and threshold: each upload is a
    host wait."""
    from .verify_dp import _dev_cache

    pens = engine.penalties
    E = engine.max_edits_fast
    slack = np.float32(thr - (np.float32(1e-4) + np.float32(1e-4) * np.abs(thr)))
    dev_ceil = _dev_cache(engine, ("ceil", ceil.tobytes(), str(device)), lambda: torch.from_numpy(
        np.ascontiguousarray(ceil, np.float32)).to(device))
    host = tuple(np.float32(x) for x in (ceil[0], pens.substitution, pens.insertion,
                                         pens.deletion, pens.swap,
                                         engine.min_symbol_similarity, slack))
    scalars = _dev_cache(engine, ("beam-scalars", np.asarray(host).tobytes(), str(device)),
                         lambda: torch.from_numpy(np.asarray(host)).to(device).unbind())
    return BeamParams(dev_ceil, *scalars, E, engine.dense.max_depth + E, n, host)


def _expand(st: States, et: torch.Tensor, ec: torch.Tensor, tabs: BeamTables,
            prm: BeamParams, ids: torch.Tensor, E: int):
    """One reference BFS pop per state of ``st``: (node, j, me, counts,
    pen), each [L, 2D + 3], the candidates in push order — exact, D
    substitutions, swap, insertion, D deletions (D = ``et``'s width) — with
    every push-time guard applied; a candidate that fails one has node -1."""
    node, j, me, counts, pen = st.node, st.j, st.me, st.counts, st.pen
    C = tabs.C
    npad = ids.numel()
    alive = node >= 0
    safe = node.clamp(min=0)
    edits = (counts & 0xFF) + ((counts >> 8) & 0xFF) + ((counts >> 16) & 0xFF) \
        + ((counts >> 24) & 0xFF)
    can_edit = edits < E
    is_last = can_edit & (edits + 1 >= E)

    pos_j = st.pos0 + j
    in_text = (pos_j < prm.limit) & alive
    sym_j = torch.where(in_text, ids[pos_j.clamp(0, npad - 1)].long(), 0)
    in_text2 = (pos_j + 1 < prm.limit) & alive
    sym_j1 = torch.where(in_text2, ids[(pos_j + 1).clamp(0, npad - 1)].long(), 0)
    remaining = prm.max_pen - pen

    # Exact transition (src/search.rs:776-798); class 0 has no edges, so
    # padded symbols resolve to -1.
    exact_next = torch.where(in_text, tabs.goto[safe * C + sym_j], -1)

    def goto_of(nodes, syms, mask):
        return torch.where(mask & (nodes >= 0), tabs.goto[nodes.clamp(min=0) * C + syms], -1)

    # Last-edit dead-end predicate: the node has a SINGLE-byte edge on the
    # symbol (reference has_matching_edge_char, src/structs.rs:471-476; a
    # multi-byte edge does not rescue the state, see ops/dense.py sb_edge).
    def sb_of(nodes, syms, mask):
        return mask & (nodes >= 0) & tabs.sb[nodes.clamp(min=0) * C + syms]

    out0_self = tabs.out_count[safe] == 0
    cols = ([], [], [], [], [])  # node, j, me, counts, pen

    def col(x):
        return x if x.dim() == 2 else x[:, None]

    def push(valid, c_node, c_j, c_me, c_counts, c_pen):
        # Per-node prune ceiling at pop time (src/search.rs:637-642): a
        # candidate that the next round would prune is dropped now.
        c_node = col(c_node)
        valid = col(valid) & (c_node >= 0) & ~(col(c_pen) > prm.ceil[c_node.clamp(min=0)])
        w = c_node.shape[1]
        for out, x in zip(cols, (torch.where(valid, c_node, -1), c_j, c_me, c_counts, c_pen)):
            out.append(col(x).expand(-1, w))

    # 1) exact
    push(in_text, exact_next, j + 1, j + 1, counts, pen)

    # 2) substitutions over all edges (src/search.rs:803-874)
    et_n, ec_n = et[safe], ec[safe]                             # [L, D]
    sim = tabs.sim[ec_n * C + sym_j[:, None]]
    pnl = prm.p_sub * (1.0 - sim)
    sub_valid = (
        in_text[:, None] & can_edit[:, None] & (et_n >= 0)
        & (et_n != exact_next[:, None]) & ~(sim < prm.floor) & ~(pnl > remaining[:, None])
    )
    # Last-edit dead-end filter (src/search.rs:839-847): the child must emit
    # or have a single-byte edge on text[j + 1].
    child_has_next = sb_of(et_n, sym_j1[:, None], in_text2[:, None])
    child_out = tabs.out_count[et_n.clamp(min=0)] > 0
    sub_valid &= ~(is_last[:, None] & ~child_out & ~child_has_next)
    push(sub_valid, et_n, j + 1, j + 1, counts + 0x1_0000, pen[:, None] + pnl)

    # 3) swap (src/search.rs:935-989)
    mid = goto_of(safe, sym_j1, in_text2)
    node2 = goto_of(mid, sym_j, mid >= 0)
    swap_valid = in_text2 & (prm.p_swap <= remaining) & can_edit & (node2 >= 0)
    push(swap_valid, node2, j + 2, j + 2, counts + 0x100_0000, pen + prm.p_swap)

    # 4) insertion (src/search.rs:994-1029)
    self_has_next = sb_of(safe, sym_j1, in_text2)
    ins_valid = (
        in_text & ((me != 0) | (j != 0)) & (prm.p_ins <= remaining) & can_edit
        & ~(is_last & out0_self & ~self_has_next)
    )
    push(ins_valid, node, j + 1, me, counts + 1, pen + prm.p_ins)

    # 5) deletions over all edges (src/search.rs:1035-1089)
    del_child_next = sb_of(et_n, sym_j[:, None], in_text[:, None])
    del_valid = (
        alive[:, None] & can_edit[:, None] & (prm.p_del <= remaining)[:, None] & (et_n >= 0)
        & ~(is_last[:, None] & ~child_out & ~del_child_next)
    )
    push(del_valid, et_n, j, me, counts + 0x100, pen + prm.p_del)
    return tuple(torch.cat(c, dim=1) for c in cols)


def _emit(st: States, tabs: BeamTables, prm: BeamParams):
    """The emissions of the states ``st`` at output nodes (reference
    src/search.rs:659-737): (state index, output column) int64 of each
    (state, output pattern) whose similarity passes the slack threshold, in
    (state, output) order."""
    at = torch.nonzero(tabs.out_count[st.node] > 0).squeeze(1)
    pats = tabs.out_list[st.node[at]]                            # [H, MO]
    p = pats.clamp(min=0)
    total, weight = tabs.pat_len[p], tabs.pat_weight[p]
    sim = ((total - st.pen[at][:, None]) / total) * weight
    r, o = torch.nonzero((pats >= 0) & (sim >= prm.slack), as_tuple=True)
    return at[r], o


def _roots(starts: torch.Tensor) -> States:
    """The root state (node 0, j = me = 0, no edit) of every start."""
    z = torch.zeros_like(starts)
    return States(torch.arange(starts.numel(), device=starts.device), starts, z, z, z, z,
                  torch.zeros(starts.numel(), dtype=torch.float32, device=starts.device), z)


def _flat(st: States, cand, slot_base: int = 0, first_col: int = 0) -> States:
    """The live candidates of ``cand`` (its columns from ``first_col`` on) as
    a flat frontier, row-major (state, column); each gets the pool slot
    ``slot_base + column - first_col``."""
    cand = tuple(c[:, first_col:] for c in cand)
    w = cand[0].shape[1]
    live = torch.nonzero(cand[0].reshape(-1) >= 0).squeeze(1)
    row = live // w
    node, j, me, counts, pen = (c.reshape(-1)[live] for c in cand)
    return States(st.si[row], st.pos0[row], node, j, me, counts, pen, live % w + slot_base)


def _empty_emissions(device):
    """No emissions: (si, me, pattern, penalty, counts), each empty."""
    z = torch.zeros(0, dtype=torch.int64, device=device)
    return z, z, z, torch.zeros(0, dtype=torch.float32, device=device), z


def _emissions(parts, keys, tabs: BeamTables):
    """(si, me, pattern, penalty, counts) of the emissions ``parts``, a list
    of (frontier, state index, output column), in the order of their
    ``keys`` (int64, one tensor per part)."""
    if not parts:
        return _empty_emissions(tabs.goto.device)
    fields = [(st.si[i], st.me[i], tabs.out_list[st.node[i], o], st.pen[i], st.counts[i])
              for st, i, o in parts]
    order = torch.argsort(torch.cat(keys))
    return tuple(torch.cat([f[k] for f in fields])[order] for k in range(5))


def _order_key(si: torch.Tensor, t: int, slot: torch.Tensor, o: torch.Tensor, nchunk: int,
               T: int, slots: int, MO: int) -> torch.Tensor:
    """The JAX kernels' emission order as an int64 key: chunk of ``nchunk``
    starts, round, start in the chunk, slot, output."""
    chunk, local = si // nchunk, si % nchunk
    return (((chunk * T + t) * nchunk + local) * slots + slot) * MO + o


def _pool_chunk(starts: torch.Tensor, tabs: BeamTables, prm: BeamParams, ids: torch.Tensor,
                nchunk: int):
    """The E = 1 frontier over a run of chunks of ``nchunk`` starts:
    emissions (si, me, pattern, penalty, counts) in the JAX pool kernel's
    order (chunk, round, start, slot, output; the 0-edit walk's slot after
    every pool slot). No start overflows: the pool's capacity is
    structural."""
    S0, Sd = 2 * tabs.et_full.shape[1] + 2, 2 * tabs.et_deep.shape[1] + 2
    P = S0 + (prm.T - 1) * Sd
    MO = tabs.out_list.shape[1]
    parts, keys = [], []

    def emit(t, pool, s0):
        for st in (pool, s0):
            idx, o = _emit(st, tabs, prm)
            keys.append(_order_key(st.si[idx], t, st.slot[idx], o, nchunk, prm.T, P + 1, MO))
            parts.append((st, idx, o))

    roots = _roots(starts)
    cand = _expand(roots, tabs.et_full, tabs.ec_full, tabs, prm, ids, 1)
    s0 = _flat(roots, tuple(c[:, :1] for c in cand), slot_base=P)
    pool = _flat(roots, cand, first_col=1)
    emit(0, pool, s0)
    for r in range(1, prm.T):
        if pool.node.numel() == 0 and s0.node.numel() == 0:
            break
        # 1) every pool walk takes its exact transition.
        pos = pool.pos0 + pool.j
        in_text = pos < prm.limit
        sym = torch.where(in_text, ids[pos.clamp(0, ids.numel() - 1)].long(), 0)
        nxt = torch.where(in_text, tabs.goto[pool.node * tabs.C + sym], -1)
        # Per-node prune ceiling at push time (src/search.rs:637-642).
        nxt = torch.where(pool.pen > prm.ceil[nxt.clamp(min=0)], -1, nxt)
        live = torch.nonzero(nxt >= 0).squeeze(1)
        pool = _take(pool, live)
        pool = pool._replace(node=nxt[live], j=pool.j + 1, me=pool.j + 1)
        # 2) the 0-edit walk: its exact step, and the round's 1-edit spawns.
        cand = _expand(s0._replace(me=s0.j), tabs.et_deep, tabs.ec_deep, tabs, prm, ids, 1)
        spawns = _flat(s0, cand, slot_base=S0 + (r - 1) * Sd, first_col=1)
        s0 = _flat(s0, tuple(c[:, :1] for c in cand), slot_base=P)
        pool = States(*(torch.cat([a, b]) for a, b in zip(pool, spawns)))
        emit(r, pool, s0)
    return _emissions(parts, keys, tabs)


def _float_order(pen: torch.Tensor) -> torch.Tensor:
    """int64 keys that order float32 values totally (-0.0 before +0.0), as
    the JAX sort compares them."""
    bits = pen.view(torch.int32).long()
    return torch.where(bits < 0, bits ^ 0x7FFF_FFFF, bits)


def _dedup(st: States, cand, num_nodes: int, B: int, overflow: torch.Tensor) -> States:
    """The next beam from the candidates ``cand`` of ``st``: sorted on
    (start, node, j << 16 | me, counts, penalty), the first of each (start,
    node, j, me, counts) kept, at most ``B`` per start in that order (the
    slots, held in ``slot``). A start with more is marked in ``overflow``
    and loses all its states: its emissions are discarded and the host
    oracle re-searches it."""
    flat = _flat(st, cand)
    key_a = flat.si * num_nodes + flat.node
    key_b = (((flat.j << 16) | flat.me) << 32) | flat.counts
    order = torch.argsort(_float_order(flat.pen), stable=True)
    order = order[torch.argsort(key_b[order], stable=True)]
    order = order[torch.argsort(key_a[order], stable=True)]
    ka, kb = key_a[order], key_b[order]
    first = torch.ones_like(ka, dtype=torch.bool)
    first[1:] = (ka[1:] != ka[:-1]) | (kb[1:] != kb[:-1])
    kept = order[first]
    si = flat.si[kept]
    idx = torch.arange(si.numel(), device=si.device)
    head = torch.ones_like(si, dtype=torch.bool)
    head[1:] = si[1:] != si[:-1]
    rank = idx - torch.cummax(torch.where(head, idx, 0), dim=0).values
    overflow[si[rank >= B]] = True
    keep = torch.nonzero(~overflow[si]).squeeze(1)
    return _take(flat, kept[keep])._replace(slot=rank[keep])


def _beam_chunk(starts: torch.Tensor, tabs: BeamTables, prm: BeamParams, ids: torch.Tensor,
                nchunk: int, B: int):
    """The E >= 2 beam over a run of chunks of ``nchunk`` starts:
    (emissions (si, me, pattern, penalty, counts) in the JAX kernel's order
    (chunk, round, start, slot, output), bool overflow per start). Emissions
    of overflowed starts are left out."""
    overflow = torch.zeros(starts.numel(), dtype=torch.bool, device=starts.device)
    MO = tabs.out_list.shape[1]
    st = _roots(starts)
    parts, keys = [], []
    for t in range(prm.T):
        et, ec = (tabs.et_full, tabs.ec_full) if t == 0 else (tabs.et_deep, tabs.ec_deep)
        st = _dedup(st, _expand(st, et, ec, tabs, prm, ids, prm.E), tabs.num_nodes, B, overflow)
        if st.node.numel() == 0:
            break
        idx, o = _emit(st, tabs, prm)
        keys.append(_order_key(st.si[idx], t, st.slot[idx], o, nchunk, prm.T, B, MO))
        parts.append((st, idx, o))
    em = _emissions(parts, keys, tabs)
    keep = torch.nonzero(~overflow[em[0]]).squeeze(1)
    return tuple(f[keep] for f in em), overflow


def _candidate_starts(engine, haystack: str, view, n: int, thr) -> torch.Tensor:
    """Ascending int64 positions on the engine's device that can start a
    match (a superset: identical final results; soundness argument at
    reference src/prefilter.rs:10-21), from the first source that serves:
    every position below ``FILTER_MIN_N``; the packed multi-pattern scan
    (``packed_bitap.fuzzy_anchors_packed``); the seed-partition filter
    (``ops/seeds.SeedFilter``); the per-pattern bitap pass up to
    ``FILTER_MAX_PATTERNS`` patterns; else every position."""
    device = engine.device
    every = torch.arange(n, device=device)
    if n < FILTER_MIN_N:
        return every
    from .packed_bitap import fuzzy_anchors_packed

    anchors = fuzzy_anchors_packed(engine, haystack, thr)
    if anchors is not None:
        return anchors

    from .seeds import SeedFilter

    sf = getattr(engine, "_seed_filter_cache", None)
    if sf is None:
        sf = SeedFilter.build(engine)
        engine._seed_filter_cache = sf if sf is not None else False
    if sf:
        if sf.seed_engine.device != device:
            sf.seed_engine.to(device)
        return torch.from_numpy(sf.candidate_starts(haystack, n).astype(np.int64)).to(device)
    if len(engine._patterns) > FILTER_MAX_PATTERNS:
        return every

    from ..prefilter import BitapFilter

    filt = getattr(engine, "_bitap_filter_cache", None)
    if filt is None:
        filt = BitapFilter.build(engine)
        engine._bitap_filter_cache = filt if filt is not None else False
    if not filt:
        return every
    ks = [filt.k_for(bp, thr) for bp in filt.patterns]
    if None in ks:
        return every

    from ..utils import native

    bids, _offsets = filt.transcode(haystack)
    flags = np.zeros(n + 1, dtype=np.int64)
    for bp, k in zip(filt.patterns, ks):
        hits = native.bitap_scan_hits(bp.mask, bp.m, k, bids)
        span = bp.m + k
        if hits is None:
            from .bitap import bitap_windows_chunked

            wins: list = []
            bitap_windows_chunked(bp.mask, bp.m, k, bids, wins)
            for s, e in wins:
                flags[s] += 1
                flags[min(e, n)] -= 1
        else:
            ends = np.nonzero(hits)[0] + 1
            np.add.at(flags, np.maximum(ends - span, 0), 1)
            np.add.at(flags, np.minimum(ends, n), -1)
    covered = np.cumsum(flags[:n]) > 0
    return torch.from_numpy(np.nonzero(covered)[0]).to(device)


def _chunk_len(E: int, T: int, d_deep: int) -> int:
    """The JAX package's starts per chunk: ``NCHUNK``, halved (not below
    1,024) while its round history would pass 512 MiB."""
    width = (2 * d_deep + 2) * T if E == 1 else 32 + 24 * E
    nchunk = NCHUNK
    while nchunk > 1024 and nchunk * (T + 1) * width * 24 > 512 * 1024 * 1024:
        nchunk //= 2
    return nchunk


def run_len(E: int, tabs: BeamTables, nchunk: int, T: int, kernels: bool) -> int:
    """Starts the frontier takes at once: whole chunks of ``nchunk``, at
    least one; for the kernels (``kernels``) as many as keep a run's per-start
    arrays (``RUN_START_BYTES`` a start: its count, offset and overflow flag)
    within ``RUN_BYTES``, for the plain versions as many as
    ``GROUP_CANDIDATES`` allows."""
    if kernels:
        return max(1, RUN_BYTES // (RUN_START_BYTES * nchunk)) * nchunk
    width = 2 * tabs.et_full.shape[1] + 3
    if E >= 2:
        width = max(width, (32 + 24 * E) * (2 * tabs.et_deep.shape[1] + 3))
    return max(1, GROUP_CANDIDATES // (width * nchunk)) * nchunk


class FrontierLayout(NamedTuple):
    """A frontier launch's workspace (``csrc/beam.cu`` ``layout_of``, whose
    first six entries ``fac_beam_layout`` returns): the
    warp path's ``units`` (warps, a start each) a block, the entries a warp
    keeps on chip (``chip``: pool walks, or candidate keys beside its beam of
    B), the block's on-chip bytes ``ws`` (beside any tables) and the global
    scratch bytes ``spill`` a warp needs (0 where its most entries fit on
    chip); at E = 1 the walks a thread of the thread path keeps on chip
    (``light_chip``) and that path's on-chip bytes a block (``light_ws``)."""

    units: int
    chip: int
    ws: int
    spill: int
    light_chip: int
    light_ws: int


def frontier_workspace(E: int, Df: int, Dd: int, T: int) -> FrontierLayout:
    """The :class:`FrontierLayout` of the pool kernels (E = 1: a thread keeps
    ``THREAD_POOL_WALKS`` walks; a start's pool holds at most P = (2 Df + 2)
    + (T - 1) (2 Dd + 2) walks, ``POOL_CHIP_WALKS`` of them on chip on the
    warp path) or of the sorted kernel (a warp's round has at most max(2 Df
    + 3, B (2 Dd + 3)) candidates, B = 32 + 24 E, ``SORT_CHIP_KEYS`` of them
    on chip beside its B beam states), 16 bytes an entry."""
    if E == 1:
        most = (2 * Df + 2) + (T - 1) * (2 * Dd + 2)
        units = POOL_THREADS // 32
        chip = min(POOL_CHIP_WALKS, most)
        ws = units * FRONTIER_ENTRY_BYTES * chip
        light = THREAD_POOL_WALKS
        light_ws = POOL_THREADS * FRONTIER_ENTRY_BYTES * light
    else:
        B = 32 + 24 * E
        most = max(2 * Df + 3, B * (2 * Dd + 3))
        units = SORT_THREADS // 32
        chip = min(SORT_CHIP_KEYS, most)
        ws = units * FRONTIER_ENTRY_BYTES * (B + chip)
        light = light_ws = 0
    return FrontierLayout(units, chip, ws, FRONTIER_ENTRY_BYTES * most if most > chip else 0,
                          light, light_ws)


def tables_bytes(N: int, C: int, Df: int, MO: int, npat: int) -> int:
    """Bytes of the automaton's tables staged into a block's shared memory
    (``csrc/beam.cu`` ``tables_layout``), each from a 16-byte boundary:
    ``go`` and ``sim`` (int32 / f32 [N, C], [C, C]), the full edge lists
    ``et`` and ``ec`` (int32 [N, Df]; the deep rounds read them with stride
    Df), ``out_count`` and ``ceil`` [N], ``out_list`` [N, MO], ``pat_len``
    and ``pat_weight`` [npat], ``sb`` (uint8 [N, C])."""
    r16 = lambda b: -(-b // 16) * 16
    return (r16(4 * N * C) + r16(4 * C * C) + 2 * r16(4 * N * Df) + 2 * r16(4 * N)
            + r16(4 * N * MO) + 2 * r16(4 * npat) + r16(N * C))


def tables_on_chip(table_bytes: int, layout: FrontierLayout, sym_bytes: int) -> bool:
    """Whether a launch stages the tables: for u8 ids (``sym_bytes`` 1) up to
    ``TABLES_SMEM_MAX`` bytes, where they fit beside each of its kernels'
    workspace."""
    return (sym_bytes == 1 and table_bytes <= TABLES_SMEM_MAX
            and table_bytes + max(layout.ws, layout.light_ws) <= FRONTIER_SMEM_MAX)


def order_hist_on_chip(T: int) -> bool:
    """Whether the order kernel's round histograms (``ORDER_WARPS`` x T int32
    a block) fit ``ORDER_SMEM``; past it they take a global scratch."""
    return 4 * ORDER_WARPS * T <= ORDER_SMEM


_CHECKED = None


def _frontier_lib():
    """The built library, its frontier constants checked once against this
    module's mirrors."""
    global _CHECKED
    kern = _cuda_build.load()
    if kern is not _CHECKED:
        got = tuple(kern.lib.fac_beam_const(i) for i in range(13))
        want = (FRONTIER_SMEM_MAX, POOL_THREADS, SORT_THREADS, ORDER_WARPS, ORDER_SMEM,
                FRONTIER_ENTRY_BYTES, WARP_SORT_KEYS, FRONTIER_BATCH, STATS_SLOTS,
                THREAD_POOL_WALKS, POOL_CHIP_WALKS, SORT_CHIP_KEYS, TABLES_SMEM_MAX)
        if got != want:
            raise RuntimeError(f"csrc/beam.cu's constants {got} differ from ops/fuzzy.py's {want}")
        _CHECKED = kern
    return kern


def frontier_layout(E: int, Df: int, Dd: int, T: int, N: int, C: int, MO: int, npat: int,
                    sym_bytes: int):
    """The library's layout of a frontier launch (``fac_beam_layout``): a
    :class:`FrontierLayout`, the tables' bytes, and whether they go into
    shared memory."""
    out = (ctypes.c_longlong * 8)()
    kern = _frontier_lib()
    kern.check(kern.lib.fac_beam_layout(E, Df, Dd, T, N, C, MO, npat, sym_bytes, out),
               "beam_layout")
    return FrontierLayout(*out[:6]), int(out[6]), bool(out[7])


def order_emissions_torch(staged: torch.Tensor, offsets: torch.Tensor, n: int, nchunk: int,
                          T: int):
    """Plain version of ``beam_order_kernel``: the staged emissions (int32
    [total, ``STAGED_FIELDS``], start-major at ``offsets``, int32 [n + 1])
    in the JAX order, each chunk of ``nchunk`` starts sorted by round,
    stably: (si, me, pattern, penalty, counts)."""
    if staged.shape[0] != int(offsets[-1]) or offsets.numel() != n + 1:
        raise ValueError(f"{staged.shape[0]} staged emissions, offsets end at {int(offsets[-1])}")
    if staged.shape[0] == 0:
        return _empty_emissions(staged.device)
    si = staged[:, 0].long()
    order = torch.argsort((si // nchunk) * T + staged[:, 5].long(), stable=True)
    pen = staged[:, 4].contiguous().view(torch.float32)
    return (si[order], staged[:, 1].long()[order], staged[:, 2].long()[order], pen[order],
            staged[:, 3].long()[order])


def order_emissions(staged: torch.Tensor, offsets: torch.Tensor, n: int, nchunk: int, T: int):
    """The JAX order of a run's staged emissions, as
    :func:`order_emissions_torch` computes it: CPU tensors run that, CUDA
    tensors launch ``beam_order_kernel`` (``csrc/beam.cu``) once, a block per
    chunk."""
    dev = staged.device
    if dev.type == "cpu":
        return order_emissions_torch(staged, offsets, n, nchunk, T)
    if dev.type != "cuda":
        raise ValueError(f"no order kernel for device {dev}")
    from . import packed_bitap as pb

    total = staged.shape[0]
    if (staged.dtype != torch.int32 or staged.dim() != 2 or staged.shape[1] != STAGED_FIELDS
            or not staged.is_contiguous() or offsets.dtype != torch.int32
            or offsets.numel() != n + 1 or offsets.device != dev or total < 1):
        raise ValueError(f"staged must be contiguous int32 [total >= 1, {STAGED_FIELDS}] and "
                         f"offsets int32 [{n + 1}] on {dev}")
    out = torch.empty((4, total), dtype=torch.int64, device=dev)
    pen = torch.empty(total, dtype=torch.float32, device=dev)
    hist = None if order_hist_on_chip(T) else torch.empty(
        -(-n // nchunk) * ORDER_WARPS * T, dtype=torch.int32, device=dev)
    kern = _frontier_lib()
    with pb.on_device(dev):
        rc = kern.lib.fac_beam_order(staged.data_ptr(), offsets.data_ptr(), n, nchunk, T,
                                     out.data_ptr(), pen.data_ptr(), total,
                                     None if hist is None else hist.data_ptr(), pb.stream_of(dev))
    kern.check(rc, "beam_order")
    pb.LAUNCHES["beam_order"] += 1
    return out[0], out[1], out[2], pen, out[3]


def _frontier_kernels(starts: torch.Tensor, tabs: BeamTables, prm: BeamParams,
                      ids: torch.Tensor, nchunk: int):
    """One run of the frontier on the card: the count launch, ``block_offsets``
    over its n counts, one read of the run's stats, and where the run emits
    the write launch (the starts that emit) and :func:`order_emissions`.
    Returns (emissions (si, me, pattern, penalty, counts), overflow flags [n]
    bool (E >= 2, else None), stats (emissions, states expanded, rounds,
    overflowed starts, starts that went to the global scratch, rounds
    sorted in memory, starts the pool's thread path handed to its warp
    path, their emissions, 1 where the count launch read the tables from
    shared memory) as ints)."""
    from . import packed_bitap as pb

    dev = starts.device
    E, T, n = prm.E, prm.T, starts.numel()
    k32 = tabs.k32
    if starts.dtype != torch.int64 or starts.dim() != 1 or not starts.is_contiguous():
        raise ValueError("starts must be a contiguous 1-D int64 tensor")
    if ids.dtype not in (torch.uint8, torch.int32) or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous 1-D uint8 or int32 tensor")
    if any(x.device != dev for x in (ids, k32.goto, prm.ceil, tabs.sim)):
        raise ValueError(f"starts on {dev}, but the ids, tables or ceilings elsewhere")
    if not 1 <= E <= 6 or not 1 <= n < 1 << 31 or T + 2 >= 1 << 16:
        raise ValueError(f"E {E}, {n} starts x {T} rounds outside the kernels' range")
    Df, Dd = k32.et_full.shape[1], k32.et_deep.shape[1]
    C, N, MO, npat = tabs.C, tabs.num_nodes, k32.out_list.shape[1], tabs.pat_len.numel()
    lay, _tb, _on_chip = frontier_layout(E, Df, Dd, T, N, C, MO, npat, ids.element_size())
    kern = _frontier_lib()
    scratch = None
    if lay.spill:
        per_block = lay.units * lay.spill
        blocks = max(1, min(-(-n // lay.units), FRONTIER_SPILL_BYTES // per_block))
        scratch = torch.empty(blocks * per_block, dtype=torch.uint8, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    stats = torch.zeros(STATS_SLOTS, dtype=torch.int64, device=dev)
    # E >= 2: the overflowed starts; E = 1: the starts handed to the warp
    # path, and their list.
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    handed = torch.empty(n, dtype=torch.int32, device=dev) if E == 1 else None
    args = (ids.data_ptr(), ids.element_size(), prm.limit, k32.goto.data_ptr(),
            k32.sb.data_ptr(), N, C, k32.et_full.data_ptr(), k32.ec_full.data_ptr(), Df,
            k32.et_deep.data_ptr(), k32.ec_deep.data_ptr(), Dd, tabs.sim.data_ptr(),
            k32.out_count.data_ptr(), k32.out_list.data_ptr(), MO, tabs.pat_len.data_ptr(),
            tabs.pat_weight.data_ptr(), npat, prm.ceil.data_ptr(),
            *(float(x) for x in prm.host), E, T, starts.data_ptr(), n)
    tail = (flags.data_ptr(), None if handed is None else handed.data_ptr(), stats.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.numel())
    name = "beam_pool" if E == 1 else "beam_sorted"

    def launch(write: int, offsets, staged, total: int):
        with pb.on_device(dev):
            rc = kern.lib.fac_beam_frontier(
                *args, write, counts.data_ptr(), None if offsets is None else offsets.data_ptr(),
                None if staged is None else staged.data_ptr(), total, *tail, pb.stream_of(dev))
        kern.check(rc, name)
        pb.LAUNCHES[name] += 1
        if E == 1:
            pb.LAUNCHES["beam_pool_warp"] += 1

    launch(0, None, None, 0)
    offsets = pb.block_offsets(counts)
    got = stats.tolist()
    total = got[0]
    if total >= 1 << 31:
        raise ValueError(f"{total} emissions in a run: the offsets would overflow int32")
    if total:
        staged = torch.empty((total, STAGED_FIELDS), dtype=torch.int32, device=dev)
        launch(1, offsets, staged, total)
        em = order_emissions(staged, offsets, n, nchunk, T)
    else:
        em = _empty_emissions(dev)
    return em, flags.view(torch.bool) if E >= 2 else None, tuple(got[:9])


def _frontier_device(starts: torch.Tensor) -> bool:
    """Whether the kernels take ``starts``: False on the CPU (the plain
    versions), True on CUDA; any other device raises."""
    if starts.device.type == "cpu":
        return False
    if starts.device.type != "cuda":
        raise ValueError(f"no frontier kernel for device {starts.device}")
    return True


def pool_frontier(starts: torch.Tensor, tabs: BeamTables, prm: BeamParams, ids: torch.Tensor,
                  nchunk: int):
    """The E = 1 frontier over a run of chunks of ``nchunk`` starts:
    (emissions (si, me, pattern, penalty, counts) in the JAX pool kernel's
    order, stats). CPU tensors run :func:`_pool_chunk` (stats None); CUDA
    tensors launch ``beam_pool_thread_kernel`` and ``beam_pool_kernel``
    (``csrc/beam.cu``: a thread a start, and a warp a start for the starts
    whose pool outgrows a thread's walks) around ``block_offsets`` (the
    write phase only where the run emits), with one host read, then
    :func:`order_emissions`, and return its stats (emissions, states
    expanded, rounds, overflowed starts, starts that went to the global
    scratch, rounds sorted in memory, starts handed to the warp path, their
    emissions, whether the tables were read from shared memory)."""
    if not _frontier_device(starts):
        return _pool_chunk(starts, tabs, prm, ids, nchunk), None
    if prm.E != 1:
        raise ValueError(f"the pool frontier takes E = 1, not {prm.E}")
    em, _ov, stats = _frontier_kernels(starts, tabs, prm, ids, nchunk)
    return em, stats


def sorted_frontier(starts: torch.Tensor, tabs: BeamTables, prm: BeamParams, ids: torch.Tensor,
                    nchunk: int, B: int):
    """The E >= 2 beam over a run of chunks of ``nchunk`` starts:
    (emissions as :func:`_beam_chunk` gives them, bool overflow per start,
    stats). CPU tensors run :func:`_beam_chunk` (stats None); CUDA tensors
    launch ``beam_sorted_kernel`` (``csrc/beam.cu``) around ``block_offsets``
    as :func:`pool_frontier` does and return its stats."""
    if not _frontier_device(starts):
        return (*_beam_chunk(starts, tabs, prm, ids, nchunk, B), None)
    if not 2 <= prm.E <= 6 or B != 32 + 24 * prm.E:
        raise ValueError(f"the sorted beam takes E = 2..6 and B = 32 + 24 E, not E = {prm.E}, "
                         f"B = {B}")
    return _frontier_kernels(starts, tabs, prm, ids, nchunk)


def _best_per_span(engine, view, n: int, em, thr):
    """The host's best-per-(start byte, end byte, pattern) reduction over
    the emissions ``em`` = (start, me, pattern, penalty, counts) numpy
    arrays in emission order: the f32 similarity recomputed in the oracle's
    op order (the device thresholds with slack), refiltered at ``thr``, the
    highest similarity of each key kept, the first emission on a tie, keys
    in the order of their first emission (a dict's order). Returns (start
    bytes, end bytes, pattern, similarity, counts) of the winners."""
    dense = engine.dense
    start, me, pat, pen, cnts = em
    pl = dense.pat_len[pat]
    pw = dense.pat_weight[pat]
    sim = np.float32(np.float32(np.float32(pl - pen) / pl) * pw)
    ok = np.nonzero(sim >= thr)[0]
    start, end, pat, sim, cnts = start[ok], start[ok] + me[ok], pat[ok], sim[ok], cnts[ok]
    offs = view.offsets_array(len(view.hay_bytes()))
    sb, eb = (start, end) if offs is None else (offs[start], offs[end])
    m = len(pat)
    order = np.lexsort((np.arange(m), -sim.astype(np.float64), pat, eb, sb))
    head = np.ones(m, dtype=bool)
    head[1:] = (sb[order][1:] != sb[order][:-1]) | (eb[order][1:] != eb[order][:-1]) \
        | (pat[order][1:] != pat[order][:-1])
    bounds = np.nonzero(head)[0]
    win = order[bounds]
    first = np.minimum.reduceat(order, bounds) if m else bounds
    win = win[np.argsort(first, kind="stable")]
    return sb[win], eb[win], pat[win], sim[win], cnts[win]


def beam_emissions(engine, haystack: str, view, n: int, cand: torch.Tensor, thr,
                   ceil: np.ndarray, stats: Optional[list] = None):
    """The frontier over the candidate starts ``cand``: runs of chunks of
    the JAX package's size through :func:`pool_frontier` (E = 1) or
    :func:`sorted_frontier` (E >= 2) against the resident dense corpus.
    Returns the emissions (start, me, pattern, penalty, counts) as tensors
    on the engine's device in the JAX package's order, and the overflowed
    starts in the order the JAX package rescues them. On the card each run's
    kernel stats are appended to ``stats`` where it is given."""
    from ..utils import device_corpus
    from .packed_bitap import _space_token

    dense = engine.dense
    device = engine.device
    E = engine.max_edits_fast
    tabs = beam_tables(engine, device)
    prm = beam_params(engine, np.float32(thr), ceil, n, device)
    nchunk = _chunk_len(E, prm.T, tabs.et_deep.shape[1])
    narrow = dense.num_classes <= 256
    ids, n_ids = device_corpus.resident(
        haystack, ("dense", _space_token(engine)),
        lambda h: np.ascontiguousarray(dense.transcode(h, view),
                                       dtype=np.uint8 if narrow else np.int32),
        device)
    assert n_ids == n

    # Chunks of the JAX package's size order the emissions (and the
    # rescues); runs of them go through the frontier together.
    run = run_len(E, tabs, nchunk, prm.T, _frontier_device(cand))
    parts, overflow_starts = [], []
    for g0 in range(0, cand.numel(), run):
        starts = cand[g0:g0 + run]
        if E == 1:
            em, st = pool_frontier(starts, tabs, prm, ids, nchunk)
        else:
            em, ov, st = sorted_frontier(starts, tabs, prm, ids, nchunk, 32 + 24 * E)
            ov_idx = torch.nonzero(ov).squeeze(1).tolist() if st is None or st[3] else []
            if ov_idx:
                pos = starts.tolist()
                for c0 in range(0, len(pos), nchunk):
                    # The JAX package's order of the rescues: a set of the
                    # chunk's overflowed indices, filled in ascending order.
                    ov_local = set(i - c0 for i in ov_idx if c0 <= i < c0 + nchunk)
                    overflow_starts.extend(pos[c0 + i] for i in ov_local)
        if stats is not None and st is not None:
            stats.append(st)
        parts.append((starts[em[0]],) + em[1:])
    if not parts:
        return _empty_emissions(device), overflow_starts
    if len(parts) == 1:
        return parts[0], overflow_starts
    return tuple(torch.cat([p[k] for p in parts]) for k in range(5)), overflow_starts


def beam_search(engine, haystack: str, threshold, view, n: int, ceil: np.ndarray):
    """The beam-frontier lanes over the whole corpus: candidate starts
    (:func:`_candidate_starts`), the frontier (:func:`beam_emissions`), one
    copy of the emissions to the host, the best-per-span reduction, and the
    host oracle over each overflowed start (its first window only), as the
    JAX package rescues them."""
    from .. import oracle
    from ..structs import LazyMatchList

    trace.opaque()
    thr = np.float32(threshold)
    cand = _candidate_starts(engine, haystack, view, n, thr)
    em, overflow_starts = beam_emissions(engine, haystack, view, n, cand, thr, ceil)
    em = [f.cpu().numpy() for f in em]
    sb, eb, pat, sim, cnts = _best_per_span(engine, view, n, em, thr)

    # Oracle rescue for beam-overflowed starts (exactness guarantee).
    hay_bytes = view.hay_bytes()
    rescued: dict = {}
    if overflow_starts:
        offs = view.offsets_array(len(hay_bytes))
        byte_of = (lambda g: g) if offs is None else (lambda g: int(offs[g]))
        span = engine.max_match_graphemes() + 1
        for s_g in overflow_starts:
            sb0, eb0 = byte_of(s_g), byte_of(min(n, s_g + span))
            sub = hay_bytes[sb0:eb0].decode("utf-8")
            for m in oracle.search_raw(engine, sub, threshold, only_first_window=True):
                key = (sb0 + m.start, sb0 + m.end, m.pattern_index)
                c = m.insertions | (m.deletions << 8) | (m.substitutions << 16) | (m.swaps << 24)
                entry = rescued.get(key)
                if entry is None or m.similarity > entry[0]:
                    rescued[key] = (np.float32(m.similarity), c)
    if rescued:
        keys = np.asarray(list(rescued), dtype=np.int64).reshape(-1, 3)
        vals = list(rescued.values())
        sb = np.concatenate([sb, keys[:, 0]])
        eb = np.concatenate([eb, keys[:, 1]])
        pat = np.concatenate([pat, keys[:, 2]])
        sim = np.concatenate([sim, np.asarray([v[0] for v in vals], np.float32)])
        cnts = np.concatenate([cnts, np.asarray([v[1] for v in vals], np.int64)])

    engine.last_stats = {
        "backend": "device-fuzzy",
        "anchors": int(cand.numel()),
        "positions": int(n),
        "overflow_rescues": len(overflow_starts),
        "matches": len(pat),
    }
    return LazyMatchList(engine._patterns, hay_bytes, sb, eb, pat, sim, cnts)


def fuzzy_search_device(engine, haystack: str, threshold: float, view=None) -> List["FuzzyMatch"]:
    """Device fuzzy search (FAST-path configs): oracle-identical matches.
    The DP lane, else the large-dictionary lane where the engine does not
    pack, else the beam frontier (:func:`beam_search`)."""
    from ..utils.graphemes import view_of
    from .many import fuzzy_search_many
    from .packed_bitap import packed_fuzzy_of
    from .verify_dp import fuzzy_search_dp

    thr = np.float32(threshold)
    if view is None:
        view = view_of(haystack, engine.case_insensitive)
    n = len(view)  # grapheme count == transcoded length
    if n == 0:
        return []
    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr)
    if np.float32(0.0) > np.float32(ceil[0]):
        return []

    dp = fuzzy_search_dp(engine, haystack, threshold, view, n)
    if dp is not None:
        return dp
    if packed_fuzzy_of(engine) is None:
        res = fuzzy_search_many(engine, haystack, threshold, view, n)
        if res is not None:
            return res
    return beam_search(engine, haystack, threshold, view, n, ceil)
