"""Native-C BFS search lane for small/latency-sensitive haystacks (a copy of
the JAX package's ``ops/native_bfs``).

The reference's hot loop is monomorphized native code answering small-string
searches in microseconds (src/search.rs:418-1119); the Python oracle, while
bit-exact, costs far more per call. This lane runs the identical BFS in C
(native/fastpath.c ``bfs_search`` — same queue order, same f32 op order, same
dedup/prune semantics) over the dense class-space automaton and returns its
rows as a ``LazyMatchList``, with the Python oracle as the checked fallback
for everything outside the envelope:

* FAST configs (global total-edit budget 1..=6) or exact configs — no
  per-pattern limits, no mappings, no beams;
* ASCII haystacks (byte == grapheme == class id);
* trie depth and node counts within the packed dedup-key ranges.

``backend = "oracle"`` still forces the pure-Python oracle, so differential
tests retain an independent reference implementation.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

#: Per-thread emission-row buffers (the C scratch is __thread storage, so
#: concurrent callers scale per-thread like the reference's freely shared
#: &FuzzyAhoCorasick — no process-global call lock).
_TLS = threading.local()


def _tls_rows(min_cap: int) -> np.ndarray:
    rows = getattr(_TLS, "rows", None)
    if rows is None or rows.shape[0] < min_cap:
        rows = np.empty((max(min_cap, 1 << 12), 5), dtype=np.int32)
        _TLS.rows = rows
    return rows


def _tables_of(engine):
    """C-ready automaton tables, cached on the engine (False = ineligible)."""
    cached = getattr(engine, "_native_bfs_tables", None)
    if cached is not None:
        return cached if cached is not False else None

    from ..utils import native

    ok = (
        native.lib() is not None
        and hasattr(native.lib(), "bfs_search_h")
        and not engine.mappings
        and not engine.has_pattern_limits
        and engine.beam_width is None
        and engine.auto_beam is None
        and not engine.nodes[0].output
    )
    mef = engine.max_edits_fast
    if ok and not 1 <= mef <= 6:
        from .engine import _max_edit_budget

        mef = 0 if _max_edit_budget(engine) == 0 else None
        ok = mef is not None
    dense = engine.dense if ok else None
    if ok:
        ok = (
            dense.num_classes <= 255
            and dense.num_nodes < (1 << 24)
            and dense.max_depth + 6 < 200
        )
    if not ok:
        engine._native_bfs_tables = False
        return None

    C = dense.num_classes
    # 2-gram window-skip masks in class space (oracle precompute, reference
    # src/search.rs:504-521): only for 1-edit searches with no depth-1/2
    # outputs. Char-level masks translate to class bits exactly because every
    # edge first-char owns its class.
    use_ws = 0
    nwords = (C + 63) >> 6
    skip_first = np.zeros(nwords, dtype=np.uint64)
    skip_second = np.zeros(nwords, dtype=np.uint64)
    if mef == 1:
        nodes = engine.nodes
        root = nodes[0]
        first = root.single_char_edge_bits()
        second = 0
        child_output = False
        for _fc, nxt, _sb in root.edges:
            child = nodes[nxt]
            bits = child.single_char_edge_bits()
            second |= bits
            first |= bits
            if child.output:
                child_output = True
        if not child_output:
            use_ws = 1
            for b in range(128):
                cls = int(dense.ascii_class[b])
                if (first >> b) & 1:
                    skip_first[cls >> 6] |= np.uint64(1) << np.uint64(cls & 63)
                if (second >> b) & 1:
                    skip_second[cls >> 6] |= np.uint64(1) << np.uint64(cls & 63)

    arrays = (
        np.ascontiguousarray(dense.goto, dtype=np.int32),
        np.ascontiguousarray(dense.edge_target, dtype=np.int32),
        np.ascontiguousarray(dense.edge_class, dtype=np.int32),
        np.ascontiguousarray(dense.out_count, dtype=np.int32),
        np.ascontiguousarray(dense.out_list, dtype=np.int32),
        np.ascontiguousarray(dense.sb_edge, dtype=np.int8),
        np.ascontiguousarray(dense.sim, dtype=np.float32),
        skip_first, skip_second,
        np.ascontiguousarray(dense.ascii_class_u8, dtype=np.uint8),
    )
    tabs = {
        # raw pointers for the c_void_p argtypes; `arrays` pins them alive
        "arrays": arrays,
        "ptrs": tuple(a.ctypes.data for a in arrays),
        "max_deg": int(dense.max_degree),
        "max_out": int(dense.max_out),
        "C": C,
        "mef": int(mef),
        "use_ws": use_ws,
        "pens": (
            float(engine.penalties.substitution),
            float(engine.penalties.insertion),
            float(engine.penalties.deletion),
            float(engine.penalties.swap),
        ),
        "min_sym": float(engine.min_symbol_similarity),
        # float(thr) -> (ceil_f32, max_pen, data_ptr, thr_f32)
        "ceil_cache": {},
        "pat_len": np.ascontiguousarray(dense.pat_len, dtype=np.float32),
        "pat_weight": np.ascontiguousarray(dense.pat_weight, dtype=np.float32),
    }
    tabs["pl_ptr"] = tabs["pat_len"].ctypes.data
    tabs["pw_ptr"] = tabs["pat_weight"].ctypes.data

    # Free the per-threshold C config handles when the engine goes away.
    import weakref

    cache = tabs["ceil_cache"]

    def _free(cache=cache):
        L = native.lib()
        if L is None:
            return
        try:
            for entry in cache.values():
                if len(entry) >= 3 and entry[2]:
                    L.bfs_engine_free(entry[2])
        except Exception:
            pass
        cache.clear()

    weakref.finalize(engine, _free)
    engine._native_bfs_tables = tabs
    return tabs


def search_raw(engine, haystack: str, threshold: float) -> Optional[List]:
    """Native BFS search; None when the (engine, haystack) pair is outside
    the C lane's envelope (caller falls back to the Python oracle)."""
    if not haystack.isascii():
        return None
    tabs = _tables_of(engine)
    if tabs is None:
        return None
    n = len(haystack)
    if n == 0:
        return []
    if n > (1 << 30):
        return None  # u32::MAX grapheme cap is enforced by the oracle

    from ..utils import native

    L = native.lib()
    tkey = float(threshold)
    hit = tabs["ceil_cache"].get(tkey)
    if hit is None:
        thr = np.float32(threshold)
        ceil = np.ascontiguousarray(
            engine.prune_len_arr
            - np.float32(engine.prune_len_over_weight_arr * thr),
            dtype=np.float32,
        )
        # Persistent C-side config handle: the per-call marshal of ~30
        # ctypes arguments costs more than the BFS itself on
        # microsecond-class searches. One handle per (engine, threshold),
        # freed with the engine's table dict (finalizer below).
        (p_goto, p_et, p_ec, p_oc, p_ol, p_sb, p_sim, p_sk1, p_sk2,
         p_cls) = tabs["ptrs"]
        ps, pi, pd, pw = tabs["pens"]
        handle = L.bfs_engine_new(
            p_goto, p_et, p_ec, tabs["max_deg"],
            p_oc, p_ol, tabs["max_out"],
            p_sb, p_sim, tabs["C"],
            ceil.ctypes.data, tabs["pl_ptr"], tabs["pw_ptr"],
            tabs["mef"], float(thr),
            float(ceil[0]), ps, pi, pd, pw, tabs["min_sym"],
            tabs["use_ws"], p_sk1, p_sk2,
            p_cls,
        )
        if not handle:
            return None
        hit = (ceil, float(ceil[0]), handle)
        tabs["ceil_cache"][tkey] = hit
    _ceil, max_pen, handle = hit
    if 0.0 > max_pen:
        return []

    hay = haystack.encode("ascii")
    search_h = L.bfs_search_h
    rows = _tls_rows(1)
    while True:
        cap = rows.shape[0]
        cnt = search_h(handle, hay, n, rows.ctypes.data, cap)
        if cnt == -2 and cap < (1 << 24):
            rows = _tls_rows(cap * 8)
            continue
        break
    if cnt < 0:
        return None  # queue overflow: pathological window, oracle handles it

    # The C side already did the threshold refilter and the best-per-(start,
    # end, pattern) reduction in the oracle's f32 op order, and sorted
    # winners to the canonical (pattern, start, end) output order — the rows
    # become a LazyMatchList directly.
    from ..structs import LazyMatchList

    rows = rows[:cnt].copy()
    start = rows[:, 0].astype(np.int64)
    matches = LazyMatchList(
        engine._patterns, hay, start, start + rows[:, 1],
        rows[:, 2].astype(np.int64),
        rows[:, 3].copy().view(np.float32),
        rows[:, 4].astype(np.int64),
    )
    engine.last_stats = {
        "backend": "native-bfs",
        "emissions": int(cnt),
        "positions": n,
        "matches": int(cnt),
    }
    return matches
