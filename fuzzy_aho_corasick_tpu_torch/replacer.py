"""Turnkey fuzzy find-and-replace (reference: src/replacer.rs)."""

from __future__ import annotations

from typing import List

from .automaton import FuzzyAhoCorasick
from .options import SearchOptions


class FuzzyReplacer:
    """Pairs an engine with a parallel replacement list: a fuzzy match of
    pattern *i* is substituted with replacement *i*
    (reference src/replacer.rs:9-52). Built by
    :meth:`FuzzyAhoCorasickBuilder.build_replacer`."""

    def __init__(self, engine: FuzzyAhoCorasick, replacements: List[str]):
        self._engine = engine
        self.replacements = replacements

    def replace(self, text: str, opts: SearchOptions) -> str:
        """Replace each fuzzy match with its configured replacement
        (reference src/replacer.rs:22-25)."""
        return self._engine.replace(
            text,
            opts,
            lambda m: self.replacements[m.pattern_index]
            if m.pattern_index < len(self.replacements)
            else None,
        )

    def replace_stream(self, reader, writer, threshold: float) -> int:
        """Streaming counterpart of :meth:`replace` (reference src/replacer.rs:35-44)."""
        return self._engine.replace_stream(
            reader,
            writer,
            threshold,
            lambda m: self.replacements[m.pattern_index]
            if m.pattern_index < len(self.replacements)
            else None,
        )

    def replace_stream_parallel(self, reader, writer, shards: int,
                                threshold: float) -> int:
        """Parallel streaming replace: passes the replacement table itself,
        which rides the vectorized no-objects emit lane (stream.py
        ``emit_window_table``) — the high-throughput form of
        :meth:`replace_stream`."""
        return self._engine.replace_stream_parallel(
            reader, writer, shards, threshold, self.replacements
        )

    def engine(self) -> FuzzyAhoCorasick:
        return self._engine
