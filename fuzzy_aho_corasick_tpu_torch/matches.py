"""Match post-processing: ranking, overlap resolution, segmentation, replace
(reference: src/matches.rs).

Pure in-memory transforms on the raw best-per-span matches. All offsets are
byte offsets into the UTF-8 haystack, exactly as in the reference.
"""

from __future__ import annotations

import bisect
from typing import Callable, Iterable, Iterator, List, Optional

from .options import Order, Overlap
from .structs import FuzzyMatch, Segment, UnmatchedSegment, unique_id_of


class FuzzyMatches:
    """The matches from a search (reference src/structs.rs:848-889 +
    src/matches.rs). Iterates and indexes like a list of :class:`FuzzyMatch`."""

    __slots__ = ("haystack", "_hay_bytes", "inner")

    def __init__(self, haystack: str, inner: List[FuzzyMatch], hay_bytes: Optional[bytes] = None):
        self.haystack = haystack
        self._hay_bytes = hay_bytes if hay_bytes is not None else haystack.encode("utf-8")
        self.inner = inner

    # --- slice-like access -------------------------------------------------
    def __iter__(self) -> Iterator[FuzzyMatch]:
        return iter(self.inner)

    def __len__(self) -> int:
        return len(self.inner)

    def __getitem__(self, i):
        return self.inner[i]

    def is_empty(self) -> bool:
        return not self.inner

    def iter(self):
        return iter(self.inner)

    def inner_mut(self) -> List[FuzzyMatch]:
        return self.inner

    def _slice(self, start: int, end: int) -> str:
        return self._hay_bytes[start:end].decode("utf-8")

    # --- ranking + overlap (reference src/matches.rs:7-149) ----------------
    def apply(self, order: Order, overlap: Overlap) -> "FuzzyMatches":
        if order == Order.Default:
            self.default_sort()
        elif order == Order.Greedy:
            self.greedy_sort()
        elif order == Order.CoverageWeighted:
            self.coverage_weighted_sort()
        if overlap == Overlap.NonOverlapping:
            self.non_overlapping()
        elif overlap == Overlap.NonOverlappingUnique:
            self.non_overlapping_unique()
        return self

    def _lexsort_columns(self, major_keys) -> bool:
        """Vectorized sort for SoA-backed (unmaterialized) match lists:
        ``major_keys(start, end, pat, sim, plen)`` returns the sort keys in
        MAJOR-first order; applied via np.lexsort without constructing any
        FuzzyMatch objects. Returns False when the inner list is a plain
        (or already materialized) list and the caller must sort that."""
        import numpy as np
        from .structs import LazyMatchList

        inner = self.inner
        if not (isinstance(inner, LazyMatchList) and inner.unmaterialized):
            return False
        cols = inner.columns()
        keys = major_keys(*cols)
        inner.reorder(np.lexsort(tuple(reversed(keys))))
        return True

    def default_sort(self) -> None:
        """Higher similarity, longer pattern, longer text, earlier span, with
        total-order tiebreakers (reference src/matches.rs:24-38)."""
        if self._lexsort_columns(
            lambda s, e, p, sim, pl: (
                -sim.astype("float64"), -pl, -(e - s), s, e, p
            )
        ):
            return
        self.inner.sort(
            key=lambda m: (
                -float(m.similarity),
                -len(m.pattern),
                -(m.end - m.start),
                m.start,
                m.end,
                m.pattern_index,
            )
        )

    def greedy_sort(self) -> None:
        """Longer pattern first, then similarity (reference src/matches.rs:44-58)."""
        if self._lexsort_columns(
            lambda s, e, p, sim, pl: (-pl, -sim.astype("float64"), s, e, p)
        ):
            return
        self.inner.sort(
            key=lambda m: (
                -len(m.pattern),
                -float(m.similarity),
                m.start,
                m.end,
                m.pattern_index,
            )
        )

    def coverage_weighted_sort(self) -> None:
        """similarity^2 * pattern_len primary (reference src/matches.rs:65-81).

        The score product is computed in f32 like the reference.
        """
        import numpy as np

        if self._lexsort_columns(
            lambda s, e, p, sim, pl: (
                -np.float32(
                    np.float32(sim * sim) * pl.astype(np.float32)
                ).astype("float64"),
                -sim.astype("float64"),
                s, e, p,
            )
        ):
            return

        def score(m: FuzzyMatch) -> float:
            return float(np.float32(np.float32(m.similarity * m.similarity) * np.float32(len(m.pattern))))

        self.inner.sort(
            key=lambda m: (
                -score(m),
                -float(m.similarity),
                m.start,
                m.end,
                m.pattern_index,
            )
        )

    def non_overlapping(self) -> None:
        """Greedy interval scheduling in current order, then re-sort by start
        (reference src/matches.rs:86-112)."""
        starts: list[int] = []
        ends: list[int] = []
        kept: list[FuzzyMatch] = []
        for m in self.inner:
            pos = bisect.bisect_left(starts, m.start)
            prev_ok = pos == 0 or ends[pos - 1] <= m.start
            next_ok = pos == len(starts) or starts[pos] >= m.end
            if prev_ok and next_ok:
                starts.insert(pos, m.start)
                ends.insert(pos, m.end)
                kept.append(m)
        kept.sort(key=lambda m: m.start)
        self.inner = kept

    def non_overlapping_unique(self) -> None:
        """Non-overlapping + at most one match per pattern identity
        (reference src/matches.rs:116-149)."""
        used = set()
        starts: list[int] = []
        ends: list[int] = []
        kept: list[FuzzyMatch] = []
        for m in self.inner:
            uid = unique_id_of(m)
            if uid in used:
                continue
            pos = bisect.bisect_left(starts, m.start)
            prev_ok = pos == 0 or ends[pos - 1] <= m.start
            next_ok = pos == len(starts) or starts[pos] >= m.end
            if prev_ok and next_ok:
                used.add(uid)
                starts.insert(pos, m.start)
                ends.insert(pos, m.end)
                kept.append(m)
        kept.sort(key=lambda m: m.start)
        self.inner = kept

    # --- replace / strip / split / segment (reference src/matches.rs:165-594)
    def replace(self, callback: Callable[[FuzzyMatch], Optional[str]]) -> str:
        """Fuzzy find-and-replace over the current match list
        (reference src/matches.rs:165-188)."""
        out: list[bytes] = []
        last = 0
        for m in self.inner:
            if m.start >= last:
                out.append(self._hay_bytes[last : m.start])
                last = m.end
                repl = callback(m)
                if repl is not None:
                    out.append(repl.encode("utf-8"))
                else:
                    out.append(m.text.encode("utf-8"))
        out.append(self._hay_bytes[last:])
        return b"".join(out).decode("utf-8")

    def strip_prefix(self) -> str:
        """Strip the leading fuzzy-matched prefix (reference src/matches.rs:218-245)."""
        out: list[str] = []
        skipping = True
        for seg in self.segment_iter():
            m = seg.matched()
            if m is not None:
                if skipping:
                    continue
                out.append(m.text)
            else:
                u = seg.unmatched()
                if skipping:
                    if not u.text.strip():
                        continue
                    skipping = False
                    out.append(u.text.lstrip())
                else:
                    out.append(u.text)
        return "".join(out)

    def strip_suffix(self) -> str:
        """Strip the trailing fuzzy-matched suffix (reference src/matches.rs:276-307)."""
        buf: list[Segment] = []
        keep = 0
        for seg in self.segment_iter():
            buf.append(seg)
            u = seg.unmatched()
            if u is not None and u.text.strip():
                keep = len(buf)
        out: list[str] = []
        for i, seg in enumerate(buf[:keep]):
            is_last = i + 1 == keep
            m = seg.matched()
            if m is not None:
                out.append(m.text)
            else:
                u = seg.unmatched()
                out.append(u.text.rstrip() if is_last else u.text)
        return "".join(out)

    def split(self) -> Iterator[str]:
        """Unmatched substrings between matches (reference src/matches.rs:344-354)."""
        for seg in self.segment_iter():
            u = seg.unmatched()
            if u is not None:
                yield u.text

    def retain(self, pred: Callable[[FuzzyMatch], bool]) -> "FuzzyMatches":
        self.inner = [m for m in self.inner if pred(m)]
        return self

    def filter(self, pred: Callable[[FuzzyMatch], bool]) -> "FuzzyMatches":
        return FuzzyMatches(
            self.haystack, [m for m in self.inner if pred(m)], self._hay_bytes
        )

    def matched_spans(self) -> list[tuple[int, int]]:
        return [(m.start, m.end) for m in self.inner]

    def matched_strings(self) -> list[str]:
        return [m.text for m in self.inner]

    def segment_iter(self) -> Iterator[Segment]:
        """Interleaved matched/unmatched segments, left-to-right
        (reference src/matches.rs:526-553)."""
        segments: list[Segment] = []
        last = 0
        for m in self.inner:
            if m.start >= last:
                if m.start > last:
                    segments.append(
                        Segment.of_unmatched(
                            UnmatchedSegment(last, m.start, self._slice(last, m.start))
                        )
                    )
                last = m.end
                segments.append(Segment.of_match(m))
        total = len(self._hay_bytes)
        if last < total:
            segments.append(
                Segment.of_unmatched(UnmatchedSegment(last, total, self._slice(last, total)))
            )
        return iter(segments)

    def segment_text(self) -> str:
        """Re-space segments into a normalized string (reference src/matches.rs:566-594)."""
        SPACE = (" ", "\t")
        NO_LEADING_SPACE_PUNCTUATION = (",", ".", "?", "!", ";", ":", "—", "-", "…")
        result = ""
        prev_matched = False
        for seg in self.segment_iter():
            m = seg.matched()
            if m is not None:
                if prev_matched or (result and not result.endswith(SPACE)):
                    result += " "
                prev_matched = True
                result += m.text
            else:
                u = seg.unmatched()
                if prev_matched and not u.text.startswith(NO_LEADING_SPACE_PUNCTUATION):
                    result += " "
                prev_matched = False
                result += u.text
        return result
