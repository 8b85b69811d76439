"""Error types for the fallible search entry points (reference: src/error.rs)."""

from __future__ import annotations


class SearchError(Exception):
    """Base error from a search call (reference src/error.rs:9)."""


class HaystackTooLarge(SearchError):
    """The haystack exceeds the u32 grapheme position space
    (reference src/error.rs:13-17, src/search.rs:198-202). Use the streaming
    API for inputs larger than ~4 GiB."""

    def __init__(self, graphemes: int):
        self.graphemes = graphemes
        super().__init__(
            f"haystack has {graphemes} grapheme clusters, exceeding the u32 position "
            "space this engine indexes with; use the streaming API for inputs larger "
            "than ~4 GiB"
        )
