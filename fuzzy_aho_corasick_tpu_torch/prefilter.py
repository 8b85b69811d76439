"""Bit-parallel (Bitap / Wu-Manber) pre-filter (reference: src/prefilter.rs).

Host copy of the JAX package's ``prefilter``. An opt-in fast lane with an
**identical results** guarantee: the shift-AND scan admits every region
whose unit-cost Levenshtein distance to some pattern is within a
conservatively derived budget ``k``, and the full engine re-searches only
those candidate windows. Configurations that don't reduce to the bit model
(mappings, patterns > 63 graphemes, free edits, > 255 distinct symbols, huge
``k``) transparently fall back to the full search.

The same tables (per-pattern bit masks, the symbol alphabet, the
threshold-derived budgets ``k_for``) feed the fuzzy DP lane's packed
shift-AND scan on the card (``ops/packed_bitap.PackedFuzzy``); on inputs the
device serves, ``Prefiltered`` routes there. The host scan for the rest is
:mod:`fuzzy_aho_corasick_tpu_torch.ops.bitap` (native C, NumPy fallback).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .matches import FuzzyMatches
from .options import SearchOptions
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
        the caller has them (streaming superwindows are built bytes-first)."""
        if haystack.isascii():
            from .utils import native

            data = hay_bytes if hay_bytes is not None else haystack.encode("ascii")
            # Native C table pass: the numpy fancy-index gather holds the
            # GIL; the C loop releases it for the streaming pipeline's other
            # threads.
            return native.transcode_bytes_u8(data, self.ascii_id), None
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
        """Pre-filtered raw search (reference src/prefilter.rs:304-374).

        On kernel-eligible configurations the fast lane IS the device path:
        the packed multi-pattern shift-AND scan is fused into the device
        pipelines (ops/packed_bitap feeding ops/verify_dp — the device form
        of the reference's scan-then-re-search), so ``Prefiltered`` routes
        straight there and only the host window re-search below serves the
        residual configs (oracle-only engines, tiny inputs).
        """
        thr = np.float32(threshold)
        if engine.backend != "oracle" and len(haystack) >= engine.AUTO_DEVICE_MIN:
            dev = engine._device_engine()
            if dev.supports(haystack):
                return dev.search_raw(haystack, threshold)
        # Per-pattern budget model: the Damerau-aware recurrence (swap = 1
        # error — the host form of the packed kernel's pending-transposition
        # rows, ops/bitap.bitap_windows) whenever it shrinks k; the plain
        # model otherwise (pending rows cost a little per step and win
        # nothing when swaps are forbidden), as the device lanes take it.
        ks: List[int] = []
        dams: List[bool] = []
        for bp in self.patterns:
            k = self.k_for(bp, thr)
            k_d = self.k_for(bp, thr, damerau=True)
            dam = k_d is not None and (k is None or k_d < k)
            if dam:
                k = k_d
            if k is None:
                return engine.search_raw(haystack, threshold)
            ks.append(k)
            dams.append(dam)

        ids, offsets = self.transcode(haystack)
        n = len(ids)

        from .ops.bitap import bitap_windows_auto

        windows: List[Tuple[int, int]] = []
        for bp, k, dam in zip(self.patterns, ks, dams):
            bitap_windows_auto(bp.mask, bp.m, k, ids, windows, damerau=dam)
        if not windows:
            return []

        windows.sort()
        merged: List[List[int]] = []
        for s, e in windows:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])

        hay_bytes = haystack.encode("utf-8")

        def byte_of(i: int) -> int:
            return i if offsets is None else offsets[i]

        best: Dict[Tuple[int, int, int], FuzzyMatch] = {}
        for gs, ge in merged:
            bstart = byte_of(gs)
            bend = byte_of(min(ge, n))
            sub = hay_bytes[bstart:bend].decode("utf-8")
            for m in engine.search_raw(sub, threshold):
                start = bstart + m.start
                end = bstart + m.end
                key = (start, end, m.pattern_index)
                entry = best.get(key)
                if entry is None or m.similarity > entry.similarity:
                    best[key] = dataclasses.replace(
                        m,
                        start=start,
                        end=end,
                        text=hay_bytes[start:end].decode("utf-8"),
                    )
        inner = sorted(best.values(), key=lambda m: (m.start, m.end, m.pattern_index))
        return inner


class Prefiltered:
    """An engine wrapped with an optional bit-parallel pre-filter
    (reference src/prefilter.rs:57-156). Obtain via
    :meth:`FuzzyAhoCorasick.with_prefilter`."""

    def __init__(self, engine):
        self.engine = engine
        self.filter = BitapFilter.build(engine)

    def is_active(self) -> bool:
        """Whether a usable filter was built (reference src/prefilter.rs:121-127)."""
        return self.filter is not None

    def search(self, haystack: str, opts: SearchOptions) -> FuzzyMatches:
        """Identical results to ``engine.search`` (reference src/prefilter.rs:135-143)."""
        opts = SearchOptions.coerce(opts)
        if self.filter is not None:
            inner = self.filter.search_unsorted(self.engine, haystack, opts.threshold)
        else:
            inner = self.engine.search_raw(haystack, opts.threshold)
        matches = FuzzyMatches(haystack, inner)
        matches.apply(opts.order, opts.overlap)
        return matches
