"""Device fuzzy search for FAST-path configurations (routing).

The JAX package serves these engines on three device lanes, tried in order
(its ``ops/fuzzy.fuzzy_search_device``):

1. the banded-DP verify lane (``ops/verify_dp.fuzzy_search_dp``);
2. the large-dictionary lane (``ops/many.fuzzy_search_many``) when the
   dictionary does not fit the packed scan tables;
3. the beam-frontier kernels (the fused E=1 pipeline and the chunked beam
   rounds) — not ported yet (ROADMAP queue A item 7).

Where the first two decline, the port raises ``NotImplementedError`` naming
the beam lanes; it never runs the pure-Python oracle in their place.
"""

from __future__ import annotations

from typing import List

import numpy as np


def fuzzy_search_device(engine, haystack: str, threshold: float, view=None) -> List["FuzzyMatch"]:
    """Device fuzzy search (FAST-path configs): oracle-identical matches."""
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
    raise NotImplementedError(
        "the fuzzy DP and large-dictionary lanes declined this search; the "
        "beam-frontier lanes that serve it are not ported to the torch "
        "package yet (ROADMAP queue A item 7)"
    )
