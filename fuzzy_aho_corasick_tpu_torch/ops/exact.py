"""Exact-match (edits = 0) device search through the packed shift-AND lane.

With no edit budget the reference's per-start BFS degenerates to a pure trie
walk (reference src/search.rs:776-798); every match is an exact arrival at
an output-bearing trie node, which the packed kernel (ops/packed_bitap.py)
finds in one pass over the corpus regardless of dictionary size.

Matches the oracle exactly, including the per-node prune ceiling
``0 > prune_len - prune_len_over_weight * thr`` which can drop a match whose
similarity ties the threshold (f32 rounding — reference src/search.rs:637-642);
the ceiling is evaluated host-side per (threshold, node) and applied to each
packed field's trie path.

Engines the packed lane cannot hold (more than 128 symbol classes, a field
longer than 64 graphemes, more than 8 limbs) are served in the JAX package by
a goto-walk kernel (``exact._exact_scan_rows``); it is not ported yet
(ROADMAP queue A item 7), so they raise ``NotImplementedError`` here.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


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


def exact_search_packed(engine, haystack: str, threshold: float, view) -> Optional[List["FuzzyMatch"]]:
    """Exact search via the packed multi-field shift-AND kernel
    (ops/packed_bitap.py) — one pass over the corpus regardless of dictionary
    size. None when the engine isn't packable."""
    from ..structs import LazyMatchList
    from .packed_bitap import exact_hits_packed

    thr = np.float32(threshold)
    pa = _packed_path_alive(engine, thr)
    if pa is None:
        return None
    pk, field_alive = pa

    got = exact_hits_packed(engine, haystack, view)
    if got is None:
        return None
    ends, fidx = got

    hay_bytes = view.hay_bytes()
    is_ascii = view.ascii
    n = len(haystack) if is_ascii else len(view)
    dense = engine.dense
    engine.last_stats = {
        "backend": "device-exact-packed",
        "positions": int(n),
        "emissions": int(len(ends)),
    }

    # Vectorized emission: field hits -> per-output-pattern match columns
    # (reference emission src/search.rs:659-737; exact similarity is the
    # pattern weight). Object construction is deferred (structs.LazyMatchList).
    keep = field_alive[fidx]
    ends = np.asarray(ends, dtype=np.int64)[keep]
    fidx = np.asarray(fidx, dtype=np.int64)[keep]
    depth_arr = np.asarray([d for _, d, _, _, _ in pk.fields], dtype=np.int64)
    node_arr = np.asarray([ni for ni, _, _, _, _ in pk.fields], dtype=np.int64)
    start_g = ends - depth_arr[fidx]
    node = node_arr[fidx]
    pats = dense.out_list[node]                                # [H, MO]
    cols_s, cols_e, cols_p = [], [], []
    for o in range(pats.shape[1]):
        p_o = pats[:, o].astype(np.int64)
        ok = (p_o >= 0) & (dense.pat_weight[np.maximum(p_o, 0)] >= thr)
        if ok.any():
            cols_s.append(start_g[ok])
            cols_e.append(ends[ok])
            cols_p.append(p_o[ok])
    if not cols_s:
        return []
    sg = np.concatenate(cols_s)
    eg = np.concatenate(cols_e)
    pat = np.concatenate(cols_p)
    sim = dense.pat_weight[pat].astype(np.float32)
    offs = view.offsets_array(len(hay_bytes))
    if offs is None:
        sb, eb = sg, eg
    else:
        sb, eb = offs[sg], offs[eg]
    return LazyMatchList(
        engine._patterns, hay_bytes, sb, eb, pat, sim,
        np.zeros(len(pat), dtype=np.int64),
    )


def exact_search_device(engine, haystack: str, threshold: float, view=None) -> List["FuzzyMatch"]:
    """Device exact search: oracle-identical match list (unsorted)."""
    from ..utils.graphemes import view_of

    if view is None:
        view = view_of(haystack, engine.case_insensitive)
    packed = exact_search_packed(engine, haystack, threshold, view)
    if packed is None:
        raise NotImplementedError(
            "this exact engine does not fit the packed shift-AND lane; the "
            "goto-walk lane that serves it is not ported yet "
            "(ROADMAP queue A item 7)"
        )
    return packed
