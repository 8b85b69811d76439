"""Search options: threshold, ranking order, overlap resolution
(reference: src/options.rs)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace

import numpy as np

#: Default similarity threshold (reference src/options.rs:7).
DEFAULT_THRESHOLD: float = 0.0


class Order(enum.Enum):
    """How raw matches are ranked (reference src/options.rs:10-21)."""

    Unsorted = 0
    Default = 1
    Greedy = 2
    CoverageWeighted = 3


class Overlap(enum.Enum):
    """How overlapping matches are resolved (reference src/options.rs:24-34)."""

    Keep = 0
    NonOverlapping = 1
    NonOverlappingUnique = 2


@dataclass(frozen=True)
class SearchOptions:
    """Configuration for a search (reference src/options.rs:44-132)."""

    threshold: float = DEFAULT_THRESHOLD
    order: Order = Order.Unsorted
    overlap: Overlap = Overlap.Keep

    @staticmethod
    def new() -> "SearchOptions":
        return SearchOptions()

    @staticmethod
    def coerce(value) -> "SearchOptions":
        """Accept a ``SearchOptions`` or a bare threshold number anywhere an
        options argument is expected (Python-side convenience; the reference
        achieves the same with ``impl From<f32> for SearchOptions``)."""
        if isinstance(value, SearchOptions):
            return value
        return SearchOptions().with_threshold(float(value))

    def with_threshold(self, threshold: float) -> "SearchOptions":
        return replace(self, threshold=float(np.float32(threshold)))

    def with_order(self, order: Order) -> "SearchOptions":
        return replace(self, order=order)

    def with_overlap(self, overlap: Overlap) -> "SearchOptions":
        return replace(self, overlap=overlap)

    def sorted(self) -> "SearchOptions":
        return self.with_order(Order.Default)

    def greedy(self) -> "SearchOptions":
        return self.with_order(Order.Greedy)

    def coverage_weighted(self) -> "SearchOptions":
        return self.with_order(Order.CoverageWeighted)

    def non_overlapping(self) -> "SearchOptions":
        return self.with_overlap(Overlap.NonOverlapping)

    def non_overlapping_unique(self) -> "SearchOptions":
        return self.with_overlap(Overlap.NonOverlappingUnique)

    # Rust-style aliases so ported examples read naturally.
    threshold_ = with_threshold
