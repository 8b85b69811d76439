"""Seed-partition prefilter for dictionaries the packed scan does not take.

The bit-parallel prefilter is linear in pattern count (one shift-AND pass per
pattern — reference src/prefilter.rs:323-326), which caps it at small
dictionaries. The scalable filter is the classical partition/pigeonhole
scheme: split each pattern into ``2E + 1`` pieces (an edit budget of ``E``
operations corrupts at most ``2E`` pieces — substitution/deletion touch one
piece, an insertion can split one, a transposition can straddle two), so
every accepted match contains at least one piece **exactly**. The pieces of
all patterns compile into one exact engine on the parent engine's device,
piece hits come from its exact pass (``ops/exact.exact_scan_hits``: the
packed scan, or the goto walk), and each hit votes a +-E anchor window
around ``hit_start - piece_offset``.

The resulting anchor set is a superset of all true match starts (identical
final results); the beam lanes then verify only those anchors. Host code,
as in the JAX package's ``ops/seeds.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.graphemes import fold_graphemes


class SeedFilter:
    """Per-engine compiled seed engine + piece offset metadata."""

    __slots__ = ("seed_engine", "piece_offsets", "E", "min_piece")

    def __init__(self, seed_engine, piece_offsets, E: int, min_piece: int):
        self.seed_engine = seed_engine
        self.piece_offsets = piece_offsets  # piece pattern_index -> list of offsets
        self.E = E
        self.min_piece = min_piece

    @staticmethod
    def build(engine) -> Optional["SeedFilter"]:
        """None when some pattern is too short to partition (m < 2E + 1) or
        the configuration is outside the FAST envelope."""
        from ..builder import FuzzyAhoCorasickBuilder

        E = engine.max_edits_fast
        if not (1 <= E <= 6) or engine.has_pattern_limits or engine.mappings:
            return None
        num_pieces = 2 * E + 1
        piece_map: dict[str, list[int]] = {}
        min_piece = 1 << 30
        for pat in engine._patterns:
            gs = fold_graphemes(pat.pattern, engine.case_insensitive)
            m = len(gs)
            if m < num_pieces:
                return None
            bounds = np.linspace(0, m, num_pieces + 1).astype(int)
            for a, b in zip(bounds[:-1], bounds[1:]):
                piece = "".join(gs[a:b])
                min_piece = min(min_piece, b - a)
                piece_map.setdefault(piece, [])
                if int(a) not in piece_map[piece]:
                    piece_map[piece].append(int(a))

        pieces = list(piece_map.keys())
        seed_engine = (
            FuzzyAhoCorasickBuilder.new()
            .case_insensitive(engine.case_insensitive)
            .device(engine.device)
            .build(pieces)
        )
        return SeedFilter(seed_engine, [piece_map[p] for p in pieces], E, min_piece)

    def candidate_starts(self, haystack: str, n: int) -> np.ndarray:
        """Anchor positions covering every possible match start (vectorized
        diff-array marking over the piece hits), ascending int32."""
        from .exact import exact_scan_hits

        starts, pids = exact_scan_hits(self.seed_engine, haystack)
        flags = np.zeros(n + 2, dtype=np.int64)
        E = self.E
        if len(starts):
            order = np.argsort(pids, kind="stable")
            starts, pids = starts[order], pids[order]
            bounds = np.searchsorted(pids, np.arange(len(self.piece_offsets) + 1))
            for pid, (b0, b1) in enumerate(zip(bounds[:-1], bounds[1:])):
                if b0 == b1:
                    continue
                s = starts[b0:b1]
                for off in self.piece_offsets[pid]:
                    lo = np.clip(s - off - E, 0, n)
                    hi = np.clip(s - off + E + 1, 0, n)
                    np.add.at(flags, lo, 1)
                    np.add.at(flags, hi, -1)
        covered = np.cumsum(flags[:n]) > 0
        return np.nonzero(covered)[0].astype(np.int32)
