"""Vectorized host-side emission decode for the device fuzzy paths.

Turns the kernel's compacted emission tuples into the final best-per-span
match list (reference emission semantics src/search.rs:694-737): exact f32
similarity recompute in the oracle's op order, threshold refilter, and the
best-per-(start, end, pattern) reduction — max similarity, earliest emission
on ties (the oracle's ``sim > entry.similarity`` strict replace keeps the
first-popped winner).

NumPy throughout; only the surviving winners (actual matches) pay Python
object construction.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..structs import FuzzyMatch, LazyMatchList
from ..utils import trace


def decode_matches(
    engine, view, haystack: str, n: int,
    em_start, em_me, em_pat, em_pen, em_counts,
    thr,
) -> List[FuzzyMatch]:
    """em_* are 1-D numpy arrays (grapheme-indexed start, me span length,
    pattern id, f32 penalty, packed edit counts); returns FuzzyMatch list.
    Traced (``utils/trace``) as the span ``decode`` and its four steps."""
    with trace.span("decode"):
        return _decode(engine, view, em_start, em_me, em_pat, em_pen, em_counts, thr)


def _decode(engine, view, em_start, em_me, em_pat, em_pen, em_counts, thr) -> List[FuzzyMatch]:
    if len(em_start) == 0:
        return []
    dense = engine.dense
    with trace.span("decode:filter"):
        pat = np.asarray(em_pat, dtype=np.int64)
        pl = dense.pat_len[np.maximum(pat, 0)]
        pw = dense.pat_weight[np.maximum(pat, 0)]
        pen = np.asarray(em_pen, dtype=np.float32)
        # Exact f32 similarity in the oracle's op order (the device thresholds
        # with slack, and the host refilters exactly).
        sim = np.float32(np.float32(np.float32(pl - pen) / pl) * pw)

        keep = sim >= thr
        if not keep.any():
            return []
        start_g = np.asarray(em_start, dtype=np.int64)[keep]
        end_g = start_g + np.asarray(em_me, dtype=np.int64)[keep]
        pat = pat[keep]
        sim = sim[keep]
        cnts = np.asarray(em_counts, dtype=np.int64)[keep]

    with trace.span("decode:sort"):
        # Best per (pattern, start, end): sort groups together with sim
        # descending, emission order ascending; the first row of each group
        # wins.
        m = len(pat)
        order = np.lexsort(
            (np.arange(m), -sim.astype(np.float64), end_g, start_g, pat)
        )
        p_o, s_o, e_o = pat[order], start_g[order], end_g[order]
        first = np.ones(m, dtype=bool)
        first[1:] = (p_o[1:] != p_o[:-1]) | (s_o[1:] != s_o[:-1]) | (e_o[1:] != e_o[:-1])
        win = order[first]

    with trace.span("decode:offsets"):
        hay_bytes = view.hay_bytes()
        sg = start_g[win]
        eg = end_g[win]
        offs = view.offsets_array(len(hay_bytes))
        if offs is None:  # ASCII: byte offset == grapheme index
            sb, eb = sg, eg
        else:
            sb, eb = offs[sg], offs[eg]

    with trace.span("decode:build"):
        return LazyMatchList(
            engine._patterns, hay_bytes, sb, eb, pat[win],
            np.asarray(sim[win], dtype=np.float32), cnts[win],
        )
