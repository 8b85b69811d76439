"""Exact-match (edits = 0) device search: the packed shift-AND lane, then
the goto walk.

With no edit budget the reference's per-start BFS degenerates to a pure trie
walk (reference src/search.rs:776-798); every match is an exact arrival at
an output-bearing trie node. Two lanes find them:

* the packed lane (:func:`exact_search_packed`, ops/packed_bitap.py): one
  pass of the shift-AND kernels over the corpus regardless of dictionary
  size, the narrow kernels up to ``MAX_LIMBS`` limbs and the wide ones up to
  ``MAX_SCAN_LIMBS`` (the JAX package packs only the narrow form and walks
  the rest);
* the goto walk (:func:`exact_search_walk`) for what does not pack: more
  than 128 symbol classes, a field longer than 64 graphemes, or more than
  ``MAX_SCAN_LIMBS`` limbs. It is the JAX package's
  ``exact._exact_scan_rows`` (:func:`goto_walk`): on the card a hand kernel
  pair (``csrc/goto_walk.cu``) that walks every start over the folded goto
  table (:func:`fold_table`) until its node dies, a count pass that keeps
  each tile's few arrivals and a write pass that copies them, around
  ``block_offsets`` with one host read between them; on the CPU its plain
  version, a gather of the root row (the JAX one-hot matmul over three u8
  planes was a TPU workaround) and one compaction per step. Each start is
  walked once over the whole corpus, so each match is reported once
  (ownership by start, with no halo duplicates to drop), and the buffers
  are sized by the counts, with no capacity retries.

Both match the oracle exactly, including the per-node prune ceiling
``0 > prune_len - prune_len_over_weight * thr`` which can drop a match whose
similarity ties the threshold (f32 rounding — reference src/search.rs:637-642):
the packed lane applies it host-side to each field's trie path, the walk
folds it into the goto table as an alive mask.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..utils import trace
from . import _cuda_build


def _packed_path_alive(engine, thr: np.float32):
    """Per packed field: whether every node on its trie path survives the
    per-node prune ceiling at zero penalty (reference src/search.rs:637-642).
    Returns None when the engine isn't packable."""
    from .packed_bitap import packed_exact_of

    pk = packed_exact_of(engine)
    if pk is None:
        return None
    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr)
    alive = ceil >= 0.0
    return pk, np.asarray(
        [bool(alive[0]) and all(alive[ni] for ni in path) for _, _, _, _, path in pk.fields]
    )


def _emit(engine, view, start_g: np.ndarray, end_g: np.ndarray, node: np.ndarray, thr):
    """Arrivals (start, end, output node) -> per-output-pattern matches
    (reference emission src/search.rs:659-737; exact similarity is the
    pattern weight). Object construction is deferred (structs.LazyMatchList)."""
    from ..structs import LazyMatchList

    dense = engine.dense
    pats = dense.out_list[node]                                # [H, MO]
    cols_s, cols_e, cols_p = [], [], []
    for o in range(pats.shape[1]):
        p_o = pats[:, o].astype(np.int64)
        ok = (p_o >= 0) & (dense.pat_weight[np.maximum(p_o, 0)] >= thr)
        if ok.any():
            cols_s.append(start_g[ok])
            cols_e.append(end_g[ok])
            cols_p.append(p_o[ok])
    if not cols_s:
        return []
    sg = np.concatenate(cols_s)
    eg = np.concatenate(cols_e)
    pat = np.concatenate(cols_p)
    sim = dense.pat_weight[pat].astype(np.float32)
    hay_bytes = view.hay_bytes()
    offs = view.offsets_array(len(hay_bytes))
    if offs is None:
        sb, eb = sg, eg
    else:
        sb, eb = offs[sg], offs[eg]
    return LazyMatchList(
        engine._patterns, hay_bytes, sb, eb, pat, sim,
        np.zeros(len(pat), dtype=np.int64),
    )


def exact_search_packed(engine, haystack: str, threshold: float, view) -> Optional[List["FuzzyMatch"]]:
    """Exact search via the packed multi-field shift-AND kernels
    (ops/packed_bitap.py) — one pass over the corpus regardless of dictionary
    size. None when the engine isn't packable."""
    from .packed_bitap import exact_hits_packed

    thr = np.float32(threshold)
    pa = _packed_path_alive(engine, thr)
    if pa is None:
        return None
    pk, field_alive = pa

    got = exact_hits_packed(engine, haystack, view)
    if got is None:
        return None
    with trace.span("finish"):
        ends, fidx = got
        n = len(haystack) if view.ascii else len(view)
        engine.last_stats = {
            "backend": "device-exact-packed",
            "positions": int(n),
            "emissions": int(len(ends)),
            "limbs": int(pk.W),
        }
        keep = field_alive[fidx]
        ends = np.asarray(ends, dtype=np.int64)[keep]
        fidx = np.asarray(fidx, dtype=np.int64)[keep]
        depth_arr = np.asarray([d for _, d, _, _, _ in pk.fields], dtype=np.int64)
        node_arr = np.asarray([ni for ni, _, _, _, _ in pk.fields], dtype=np.int64)
        return _emit(engine, view, ends - depth_arr[fidx], ends, node_arr[fidx], thr)


# ---------------------------------------------------------------------------
# The goto walk
# ---------------------------------------------------------------------------

#: Mirrors of ``csrc/goto_walk.cu``: the starts of one tile (``WALK_TILE``),
#: the arrivals a tile keeps for the write pass (``WALK_KEEP``), and the
#: classes up to which the folded table carries the pair table
#: (``PAIR_MAX``). ``chip_smoke.py`` holds them against the library's.
WALK_TILE = 2048
WALK_KEEP = 16
WALK_PAIR_MAX = 64


def fold_table(goto: torch.Tensor, emits: torch.Tensor) -> torch.Tensor:
    """The goto table as the card's walk reads it, int32 [N (+ C), C] on
    the goto table's device, built once per table: each entry ``t >= 0`` as
    ``2 t + emits[t]`` (one lookup gives the next node and whether it
    emits), -1 kept; where ``C <= WALK_PAIR_MAX``, ``C`` rows more, the
    pair table: row ``c0`` is the folded row of the root's child by
    ``c0``, all -1 where the root has none (spans 1 and 2 of a walk are
    then two independent lookups)."""
    t = goto.long()
    folded = torch.where(t >= 0, 2 * t + emits[t.clamp(min=0)].long(), -1)
    if goto.shape[1] <= WALK_PAIR_MAX:
        root = t[0]
        pair = torch.where((root >= 0)[:, None], folded[root.clamp(min=0)], -1)
        folded = torch.cat([folded, pair])
    return folded.to(torch.int32).contiguous()


def walk_tables(engine, thr, device):
    """(goto int32 [N, C] with the threshold's alive mask folded in, emits
    bool [N]: the node has outputs, :func:`fold_table` of the two) on
    ``device``, cached per threshold (``engine.to`` drops them); None where
    the root itself is pruned. A pruned node becomes unreachable (JAX
    ``exact.py:276-283``)."""
    from .verify_dp import _dev_cache

    dense = engine.dense
    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * np.float32(thr))
    alive = np.asarray(ceil >= 0.0, dtype=bool)
    if not alive[0]:
        return None

    def build():
        goto = np.where((dense.goto >= 0) & alive[np.maximum(dense.goto, 0)], dense.goto, -1)
        goto[~alive, :] = -1
        return _tables_on(goto, dense.out_count > 0, device)

    return _dev_cache(engine, ("goto", alive.tobytes(), str(device)), build)


def _tables_on(goto: np.ndarray, emits: np.ndarray, device):
    """(goto, emits, folded) built on the host, then moved to ``device``."""
    goto = torch.from_numpy(np.ascontiguousarray(goto, dtype=np.int32))
    emits = torch.from_numpy(np.asarray(emits, dtype=bool))
    return tuple(x.to(device) for x in (goto, emits, fold_table(goto, emits)))


def keep_edge_text(tile: int = WALK_TILE, keep: int = WALK_KEEP):
    """(patterns, text): an input on which the walk's first tile holds
    exactly ``keep`` arrivals and its second ``keep + 1`` (the write pass
    copies the first tile's kept rows and walks the second again), the
    third none. Patterns "a", "ab", "b" over a text of three tiles of
    "x": an "ab" is three arrivals (two at its start, spans 1 and 2), a
    lone "b" one, and one "ab" straddles the first two tiles."""
    buf = ["x"] * (3 * tile)
    buf[tile - 1], buf[tile] = "a", "b"  # 2 arrivals in tile 0, 1 in tile 1
    for first, need in ((0, keep - 2), (tile, keep)):
        at = first + 8
        for i in range(need // 3 + need % 3):
            if i < need // 3:
                buf[at], buf[at + 1] = "a", "b"
            else:
                buf[at] = "b"
            at += 8
    return ["a", "ab", "b"], "".join(buf)


def goto_walk_torch(ids: torch.Tensor, n_starts: int, n_read: int, goto: torch.Tensor,
                    emits: torch.Tensor, L: int):
    """Plain version of the ``goto_walk_count_kernel`` / ``goto_walk_emit_kernel``
    pair: the root step is a gather of the goto table's root row for the
    starts below ``n_starts``, the survivors are compacted once, and they
    walk one symbol per step, compacted again after every step (a
    ``torch.nonzero`` reads each count); a walk that would read at or past
    symbol ``n_read`` ends. Returns the arrivals in the kernels' order (start,
    then span) and the walks alive at each span."""
    C = goto.shape[1]
    flat = goto.reshape(-1)
    sym = ids[:n_read].long()
    st = goto[0][sym[:n_starts]]
    pos = torch.nonzero(st >= 0).squeeze(1)
    st = st[pos]
    out, alive = [], []
    for span in range(1, L + 1):
        if span > 1:
            at = pos + (span - 1)
            nxt = flat[st.long() * C + sym[at.clamp(max=n_read - 1)]]
            live = torch.nonzero((nxt >= 0) & (at < n_read)).squeeze(1)
            pos, st = pos[live], nxt[live]
        if pos.numel() == 0:
            break
        alive.append(pos.numel())
        hit = torch.nonzero(emits[st.long()]).squeeze(1)
        out.append(torch.stack([pos[hit], torch.full_like(hit, span), st[hit].long()]))
    if not out:
        return torch.zeros((3, 0), dtype=torch.int64, device=ids.device), alive
    found = torch.cat(out, dim=1)  # span by span, starts ascending in each
    return found[:, torch.argsort(found[0], stable=True)], alive


def goto_walk(ids: torch.Tensor, n_starts: int, n_read: int, goto: torch.Tensor,
              emits: torch.Tensor, L: int, folded: Optional[torch.Tensor] = None):
    """Every exact arrival at an output node of a walk from a start below
    ``n_starts`` over at most ``L`` symbols, none at or past symbol
    ``n_read`` (a shard's halo lies between the two): (found int64 [3, H] of
    (start, span, node), ordered by start then span, on the ids' device;
    the walks alive after each span, a list whose first two entries are the
    JAX package's ``survivors_stage1`` and ``survivors_stage2``). ``ids`` is
    u8 or int32, ``goto`` int32 [N, C] with -1 for a missing or pruned edge,
    ``emits`` bool [N]. CPU tensors run :func:`goto_walk_torch`; CUDA tensors
    launch ``goto_walk_count_kernel``, ``block_offsets`` and
    ``goto_walk_emit_kernel`` (``csrc/goto_walk.cu``), with one host read
    of the arrivals, the alive counts and the tiles that walk again between
    them. The kernels read ``folded``, :func:`fold_table` of ``goto`` and
    ``emits``, which the caller builds once per table (``walk_tables``
    caches it); on the card it is required."""
    from . import packed_bitap as pb

    dev = ids.device
    if not 0 <= n_starts <= n_read <= ids.numel():
        raise ValueError(f"need 0 <= n_starts {n_starts} <= n_read {n_read} <= {ids.numel()}")
    if dev.type == "cpu":
        return goto_walk_torch(ids, n_starts, n_read, goto, emits, L)
    if dev.type != "cuda":
        raise ValueError(f"no goto walk kernel for device {dev}")
    if ids.dtype not in (torch.uint8, torch.int32) or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous 1-D uint8 or int32 tensor")
    if goto.dtype != torch.int32 or goto.dim() != 2 or not goto.is_contiguous() \
            or goto.device != dev or emits.dtype != torch.bool \
            or emits.shape != goto.shape[:1] or emits.device != dev:
        raise ValueError(f"goto must be a contiguous int32 [N, C] and emits a bool [N] on {dev}")
    N, C = goto.shape
    rows = N + (C if C <= WALK_PAIR_MAX else 0)
    if folded is None or folded.dtype != torch.int32 or not folded.is_contiguous() \
            or folded.shape != (rows, C) or folded.device != dev:
        raise ValueError(f"the card's walk reads folded = fold_table(goto, emits), int32 "
                         f"[{rows}, {C}] on {dev}, built once per table")
    if n_read >= 1 << 31 or L < 1:
        raise ValueError(f"n_read {n_read} past 2^31 - 1 or L {L} < 1")
    if n_starts == 0:
        return torch.zeros((3, 0), dtype=torch.int64, device=dev), []
    kern = _cuda_build.load()
    tiles = -(-n_starts // kern.lib.fac_goto_walk_tile())
    keep = kern.lib.fac_goto_walk_keep()
    # One buffer: each tile's kept rows (int32 x 4 each, first: 16-byte
    # aligned), its arrivals, and the list of tiles past ``keep``.
    scratch = torch.empty(tiles * (4 * keep + 2), dtype=torch.int32, device=dev)
    slots = scratch[: tiles * 4 * keep]
    counts = scratch[tiles * 4 * keep: tiles * (4 * keep + 1)]
    overflow = scratch[tiles * (4 * keep + 1):]
    tally = torch.zeros(L + 2, dtype=torch.int64, device=dev)
    args = (ids.data_ptr(), ids.element_size(), n_starts, n_read, folded.data_ptr(), N, C, L)

    def launch(write: int, offsets, total: int, n_over: int, found):
        with pb.on_device(dev):
            rc = kern.lib.fac_goto_walk(
                *args, write, counts.data_ptr(), slots.data_ptr(), overflow.data_ptr(),
                tally.data_ptr(), None if offsets is None else offsets.data_ptr(), total, n_over,
                None if found is None else found.data_ptr(), pb.stream_of(dev))
        kern.check(rc, "goto_walk")
        pb.LAUNCHES["goto_walk"] += 1

    launch(0, None, 0, 0, None)
    offsets = pb.block_offsets(counts)
    with trace.wait("walk_totals"):
        total, *alive, n_over = tally.tolist()
    if total >= 1 << 31:
        raise ValueError(f"{total} arrivals: the block offsets would overflow int32")
    while alive and alive[-1] == 0:
        alive.pop()
    found = torch.empty((3, total), dtype=torch.int64, device=dev)
    if total:
        launch(1, offsets, total, n_over, found)
    return found, alive


def exact_search_walk(engine, haystack: str, threshold: float, view) -> List["FuzzyMatch"]:
    """Exact search by the goto walk (see the module docstring): the JAX
    package's ``exact_search_device`` past its packed lane."""
    from ..utils import device_corpus
    from .packed_bitap import _space_token

    thr = np.float32(threshold)
    dense = engine.dense
    n = len(view)
    if n == 0:
        return []
    device = engine.device
    tables = walk_tables(engine, thr, device)
    if tables is None:
        return []
    goto, emits, folded = tables
    narrow = dense.num_classes <= 256
    ids, n_ids = device_corpus.resident(
        haystack, ("dense", _space_token(engine)),
        lambda h: np.ascontiguousarray(dense.transcode(h, view),
                                       dtype=np.uint8 if narrow else np.int32),
        device)
    assert n_ids == n
    trace.launch()
    with trace.span("step") as sp:
        found, alive = goto_walk(ids, n, n, goto, emits, max(dense.max_depth, 1), folded=folded)
        if sp:
            sp.set(rows=found.shape[1])
    with trace.span("finish"):
        with trace.wait("rows", found.nbytes):
            start, span, node = found.cpu().numpy()
        stage1, stage2 = (alive + [0, 0])[:2]
        engine.last_stats = {
            "backend": "device-exact",
            "positions": int(n),
            "survivors_stage1": stage1,
            "survivors_stage2": stage2,
            "emissions": int(start.size),
        }
        return _emit(engine, view, start, start + span, node, thr)


def exact_search_device(engine, haystack: str, threshold: float, view=None) -> List["FuzzyMatch"]:
    """Device exact search: oracle-identical match list (unsorted). The
    packed lane where the dictionary packs, else the goto walk."""
    from ..utils.graphemes import view_of

    if view is None:
        view = view_of(haystack, engine.case_insensitive)
    packed = exact_search_packed(engine, haystack, threshold, view)
    if packed is not None:
        return packed
    return exact_search_walk(engine, haystack, threshold, view)


def _outputs_of(engine, start_g: np.ndarray, node: np.ndarray):
    """Arrivals (start, output node) -> (starts, pattern ids) int64, one pair
    per pattern in the node's output list."""
    pats = engine.dense.out_list[node].astype(np.int64)    # [H, MO]
    ok = pats >= 0
    return np.broadcast_to(start_g[:, None], pats.shape)[ok], pats[ok]


def exact_scan_hits(engine, haystack: str, view=None):
    """Every exact occurrence of a pattern as numpy int64 arrays (start
    grapheme, pattern id), at threshold 0: the seed filter's pass
    (``ops/seeds.py``). The packed lane's hits where the dictionary packs,
    else the goto walk; each occurrence once, in no particular order."""
    from ..utils import device_corpus
    from ..utils.graphemes import view_of
    from .packed_bitap import _space_token, exact_hits_packed, packed_exact_of

    dense = engine.dense
    if view is None:
        view = view_of(haystack, engine.case_insensitive)
    n = len(view)
    empty = np.zeros(0, np.int64)
    if n == 0:
        return empty, empty
    got = exact_hits_packed(engine, haystack, view)
    if got is not None:
        ends, fidx = got
        fields = packed_exact_of(engine).fields
        depth = np.asarray([d for _, d, _, _, _ in fields], dtype=np.int64)
        node = np.asarray([ni for ni, _, _, _, _ in fields], dtype=np.int64)
        fidx = np.asarray(fidx, dtype=np.int64)
        return _outputs_of(engine, np.asarray(ends, dtype=np.int64) - depth[fidx], node[fidx])

    device = engine.device
    from .verify_dp import _dev_cache

    goto, emits, folded = _dev_cache(engine, ("goto-all", str(device)), lambda: _tables_on(
        dense.goto, dense.out_count > 0, device))
    narrow = dense.num_classes <= 256
    ids, n_ids = device_corpus.resident(
        haystack, ("dense", _space_token(engine)),
        lambda h: np.ascontiguousarray(dense.transcode(h, view),
                                       dtype=np.uint8 if narrow else np.int32),
        device)
    assert n_ids == n
    found, _alive = goto_walk(ids, n, n, goto, emits, max(dense.max_depth, 1), folded=folded)
    start, _span, node = found.cpu().numpy()
    return _outputs_of(engine, start, node)
