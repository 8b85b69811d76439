"""Bit-parallel (Bitap / Wu-Manber) pre-filter model (reference: src/prefilter.rs).

Host copy of the JAX package's ``prefilter`` tables: the per-pattern bit
masks, the symbol alphabet and the threshold-derived error budgets
(``k_for``). The fuzzy DP lane packs these into the shift-AND scan's limb
tables (``ops/packed_bitap.PackedFuzzy``).

The public pre-filtered search (``Prefiltered``, ``search_unsorted``) is not
ported yet (ROADMAP queue A item 8) and raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .structs import FuzzyLimits, FuzzyMatch, f32
from .utils.graphemes import fold_graphemes, graphemes

#: Longest pattern (graphemes) the u64 bit-vectors hold (reference src/prefilter.rs:30).
MAX_PATTERN_GRAPHEMES = 63
#: Beyond this k the filter stops pruning meaningfully (reference src/prefilter.rs:32).
MAX_USEFUL_K = 24
#: Most distinct symbols supported, so ids fit u8 (reference src/prefilter.rs:35).
MAX_ALPHABET = 255


def k_from_limits(lim: FuzzyLimits, damerau: bool = False) -> Optional[int]:
    """Upper bound on Levenshtein distance under ``lim``
    (reference src/prefilter.rs:388-405); swaps count 2 — or 1 under a
    Damerau-aware recurrence (``damerau=True``: the packed device scan's
    native transposition transition, csrc/packed_bitap.cu)."""
    swap_cost = 1 if damerau else 2
    if lim.edits_ is not None:
        swaps_forbidden = lim.swaps_ == 0
        return lim.edits_ if swaps_forbidden else swap_cost * lim.edits_
    if None in (lim.insertions_, lim.deletions_, lim.substitutions_, lim.swaps_):
        return None
    return (lim.insertions_ + lim.deletions_ + lim.substitutions_
            + swap_cost * lim.swaps_)


class _BitapPattern:
    __slots__ = ("m", "weight", "mask", "k_limit", "k_limit_d")

    def __init__(self, m: int, weight: np.float32, mask: np.ndarray,
                 k_limit: Optional[int], k_limit_d: Optional[int] = None):
        self.m = m
        self.weight = weight
        self.mask = mask  # uint64[alphabet+1]
        self.k_limit = k_limit
        #: Budget under the Damerau-aware recurrence (swap = 1 error).
        self.k_limit_d = k_limit_d if k_limit_d is not None else k_limit


class BitapFilter:
    """Precomputed, threshold-independent state for the bit-parallel scan
    (reference src/prefilter.rs:69-93, 161-245)."""

    def __init__(self, engine) -> None:
        self.symbol_ids: Dict[str, int] = {}
        self.case_insensitive = engine.case_insensitive
        self.patterns: List[_BitapPattern] = []
        self.edit_cost_mult: np.float32 = f32(0.0)
        self.edit_cost_mult_d: np.float32 = f32(0.0)
        self.ascii_id = np.zeros(256, dtype=np.uint8)

    @staticmethod
    def build(engine, allow_mappings: bool = False) -> Optional["BitapFilter"]:
        """Try to build a filter; ``None`` when the config isn't reducible
        (reference src/prefilter.rs:161-245).

        ``allow_mappings`` lifts the mapping rejection for the device DP
        lane only (ops/packed_bitap.PackedFuzzy): the threshold-derived
        ``k_for`` budget stays mapping-unsound there (a score-1.0 mapping
        has penalty 0), so that caller substitutes its own edit-count-based
        budget (ops/verify_dp.MappedSpec.k)."""
        if (engine.mappings and not allow_mappings) or not engine.patterns():
            return None

        p = engine.penalties
        max_sim = engine.similarity.max_off_diagonal()
        p_sub_min = np.float32(p.substitution * np.float32(1.0 - max_sim))
        with np.errstate(divide="ignore"):
            mults = [
                np.float32(1.0) / p.insertion,
                np.float32(1.0) / p.deletion,
                np.float32(1.0) / p_sub_min,
                np.float32(2.0) / p.swap,
            ]
        if any((not np.isfinite(m)) or m <= 0.0 for m in mults):
            return None

        self = BitapFilter(engine)
        self.edit_cost_mult = np.float32(max(mults))
        # Damerau-aware recurrences pay 1 bitap error per swap, not 2.
        mults_d = mults[:3] + [np.float32(1.0) / p.swap]
        self.edit_cost_mult_d = np.float32(max(mults_d))

        id_lists: List[List[int]] = []
        for pat in engine.patterns():
            gs = fold_graphemes(pat.pattern, engine.case_insensitive)
            m = len(gs)
            if m == 0 or m > MAX_PATTERN_GRAPHEMES:
                return None
            ids = []
            for g in gs:
                gid = self.symbol_ids.get(g)
                if gid is None:
                    gid = len(self.symbol_ids) + 1  # ids start at 1; 0 = "other"
                    if gid > MAX_ALPHABET:
                        return None
                    self.symbol_ids[g] = gid
                ids.append(gid)
            applicable = pat.limits if pat.limits is not None else engine.limits
            self.patterns.append(
                _BitapPattern(
                    m,
                    pat.weight,
                    np.zeros(0, dtype=np.uint64),
                    k_from_limits(applicable) if applicable is not None else None,
                    k_from_limits(applicable, damerau=True)
                    if applicable is not None else None,
                )
            )
            id_lists.append(ids)

        # ASCII fast-path table (reference src/prefilter.rs:214-225).
        for b in range(128):
            ch = chr(b)
            folded = ch.lower() if engine.case_insensitive else ch
            gid = self.symbol_ids.get(folded)
            if gid is not None:
                self.ascii_id[b] = gid

        alphabet = len(self.symbol_ids)
        for bp, ids in zip(self.patterns, id_lists):
            mask = np.zeros(alphabet + 1, dtype=np.uint64)
            for i, gid in enumerate(ids):
                mask[gid] |= np.uint64(1) << np.uint64(i)
            bp.mask = mask
        return self

    # ------------------------------------------------------------------
    def transcode(self, haystack: str, hay_bytes: Optional[bytes] = None
                  ) -> Tuple[np.ndarray, Optional[List[int]]]:
        """Haystack -> u8 symbol-id stream + grapheme->byte offsets
        (reference src/prefilter.rs:251-281). Offsets ``None`` = identity
        (all-ASCII). ``hay_bytes``: the haystack's already-encoded bytes, if
        the caller has them."""
        if haystack.isascii():
            data = hay_bytes if hay_bytes is not None else haystack.encode("ascii")
            return self.ascii_id[np.frombuffer(data, dtype=np.uint8)], None
        from .utils.graphemes import map_singleton_chars, view_of

        view = view_of(haystack, self.case_insensitive)
        fast = map_singleton_chars(view, self.symbol_ids)
        if fast is not None:
            offs = view.offsets_array(len(view.hay_bytes()))
            return fast, offs
        ids: List[int] = []
        offsets: List[int] = []
        pos = 0
        get = self.symbol_ids.get
        for g in graphemes(haystack):
            offsets.append(pos)
            pos += len(g.encode("utf-8"))
            if self.case_insensitive:
                if g.isascii() and not any("A" <= c <= "Z" for c in g):
                    gid = get(g)
                else:
                    gid = get(g.lower())
            else:
                gid = get(g)
            ids.append(gid or 0)
        offsets.append(len(haystack.encode("utf-8")))
        return np.asarray(ids, dtype=np.uint8), offsets

    def k_for(self, bp: _BitapPattern, threshold: np.float32,
              damerau: bool = False) -> Optional[int]:
        """Effective edit budget at this threshold, or None -> full search
        (reference src/prefilter.rs:285-302). ``damerau=True`` prices a swap
        at 1 error (sound only for scans whose recurrence has the native
        transposition transition)."""
        n = np.float32(bp.m)
        p_max = np.float32(n * np.float32(1.0 - np.float32(threshold / bp.weight)))
        mult = self.edit_cost_mult_d if damerau else self.edit_cost_mult
        lim = bp.k_limit_d if damerau else bp.k_limit
        if p_max <= 0.0:
            k_pen = 0
        else:
            k_pen = int(np.floor(np.float32(p_max * mult)))
        k = k_pen if lim is None else min(k_pen, lim)
        return None if k > MAX_USEFUL_K else k

    def search_unsorted(self, engine, haystack: str, threshold: float) -> List[FuzzyMatch]:
        """Pre-filtered raw search: not ported yet."""
        from .automaton import not_ported

        not_ported("the pre-filtered search", "item 8")


class Prefiltered:
    """An engine wrapped with the bit-parallel pre-filter: not ported yet
    (ROADMAP queue A item 8)."""

    def __init__(self, engine):
        from .automaton import not_ported

        not_ported("Prefiltered", "item 8")
