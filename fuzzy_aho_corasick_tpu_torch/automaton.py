"""The compiled, immutable fuzzy Aho-Corasick engine and its query facade
(reference: src/structs.rs:529-567 for the engine, src/query.rs for the API).

The engine owns the host automaton (built by
:class:`fuzzy_aho_corasick_tpu_torch.builder.FuzzyAhoCorasickBuilder`) plus
lazily built tables for the CUDA kernels, which live on the engine's torch
``device``. ``search_raw`` dispatches to the device path when the
configuration is kernel-eligible, and to the host oracle otherwise — both
produce identical match sets (differential-tested).

The port carries every device lane of the JAX package — exact, the DP
family (the uniform-budget fuzzy lane and the forbid, typed and mapped
lanes), the large-dictionary lane and the beam frontier — the native-C
host BFS for small haystacks, and every entry point above ``search_raw``:
the prefilter, streaming search and replace, and save / load.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import oracle
from .matches import FuzzyMatches
from .options import Order, Overlap, SearchOptions
from .structs import (
    FuzzyLimits,
    FuzzyMatch,
    FuzzyPenalties,
    Pattern,
    Segment,
    Similarity,
    f32,
)


class FuzzyAhoCorasick:
    """A compiled, immutable fuzzy Aho-Corasick automaton
    (reference src/structs.rs:522-567).

    Built once via :class:`FuzzyAhoCorasickBuilder`, then queried repeatedly;
    safe to share across threads/processes (all state is read-only after
    construction).
    """

    def __init__(
        self,
        nodes,
        patterns: List[Pattern],
        similarity: Similarity,
        limits: Optional[FuzzyLimits],
        penalties: FuzzyPenalties,
        case_insensitive: bool,
        has_pattern_limits: bool,
        max_edits_fast: int,
        mappings: dict,
        beam_width: Optional[int],
        auto_beam: Optional[Tuple[int, int]],
        min_symbol_similarity: np.float32,
    ):
        self.nodes = nodes
        self._patterns = patterns
        self.similarity = similarity
        self.limits = limits
        self.penalties = penalties
        self.case_insensitive = case_insensitive
        self.has_pattern_limits = has_pattern_limits
        self.max_edits_fast = max_edits_fast
        self.mappings = mappings
        self.beam_width = beam_width
        self.auto_beam = auto_beam
        self.min_symbol_similarity = min_symbol_similarity

        # Vectorized per-node prune coefficients (reference src/structs.rs:255-262),
        # as arrays so per-search ceilings are one fused numpy expression.
        self.prune_len_arr = np.array([n.prune_len for n in nodes], dtype=np.float32)
        self.prune_len_over_weight_arr = np.array(
            [n.prune_len_over_weight for n in nodes], dtype=np.float32
        )

        # Lazily-built dense tables (ops/dense.py) and device engine.
        self._dense = None
        self._device_eng = None
        #: Torch device of the kernel tables and the resident corpus.
        self.device = torch.device("cuda")
        # Policy knob: 'auto' uses the device path when eligible,
        # 'oracle'/'device' force one path (used by differential tests).
        self.backend = "auto"
        # Observability: per-search counters set by whichever path ran
        # (SURVEY §5 tracing/metrics; see oracle.search_raw and ops/*).
        self.last_stats: Optional[dict] = None

    # ------------------------------------------------------------------
    def patterns(self) -> List[Pattern]:
        """The patterns the automaton was built with (reference src/search.rs:171-175)."""
        return self._patterns

    @property
    def dense(self):
        """Dense device tables, compiled on first use."""
        if self._dense is None:
            from .ops.dense import DenseAutomaton

            self._dense = DenseAutomaton.from_engine(self)
        return self._dense

    def to(self, device) -> "FuzzyAhoCorasick":
        """Move the engine's device tables to ``device`` (a ``torch.device``
        or its name); returns ``self``. Asking for CUDA where there is none
        raises — the engine never carries on on the CPU in its place."""
        self.device = checked_device(device)
        self._packed_dev_consts = None  # exact lane's scan tables
        self._dp_dev_consts = None  # fuzzy scan tables, DP tables, node ceilings
        return self

    def _device_engine(self):
        if self._device_eng is None:
            from .ops.engine import DeviceEngine

            self._device_eng = DeviceEngine(self)
        return self._device_eng

    #: Below this haystack size the 'auto' backend stays on the host oracle —
    #: a device dispatch (plus possible compile) costs more than the scan.
    AUTO_DEVICE_MIN = 1 << 14

    # ------------------------------------------------------------------
    def search_raw(self, haystack: str, threshold: float) -> List[FuzzyMatch]:
        """Raw best-per-span matches (reference src/search.rs:187).

        Dispatches between the device kernel path and the host oracle;
        results are identical.
        """
        if self.backend == "oracle":
            return oracle.search_raw(self, haystack, threshold)
        if self.backend == "auto" and len(haystack) < self.AUTO_DEVICE_MIN:
            return self._host_search(haystack, threshold)
        dev = self._device_engine()
        if dev.supports(haystack):
            return dev.search_raw(haystack, threshold)
        if self.backend == "device":
            raise RuntimeError("device backend does not support this configuration")
        if len(haystack) >= (1 << 20):
            self._warn_host_cliff(len(haystack))
        return self._host_search(haystack, threshold)

    def _warn_host_cliff(self, nbytes: int) -> None:
        """One-time warning when a large haystack takes the host path because
        the configuration is outside every device lane's envelope —
        throughput drops orders of magnitude and the caller should know why."""
        if getattr(self, "_host_cliff_warned", False):
            return
        self._host_cliff_warned = True
        import warnings

        warnings.warn(
            f"search of a {nbytes >> 20} MiB haystack is running on the host "
            "(configuration outside the device lanes' envelope); expect "
            "orders-of-magnitude lower throughput than the device path",
            RuntimeWarning,
            stacklevel=3,
        )

    def _host_search(self, haystack: str, threshold: float) -> List[FuzzyMatch]:
        """Host path: the native-C BFS lane when the configuration fits its
        envelope (the reference's monomorphized hot loop in native code,
        src/search.rs:418-1119), else the pure-Python oracle. ``backend =
        "oracle"`` bypasses this so differential tests keep an independent
        reference implementation."""
        from .ops import native_bfs

        res = native_bfs.search_raw(self, haystack, threshold)
        if res is not None:
            return res
        return oracle.search_raw(self, haystack, threshold)

    def search(self, haystack: str, opts: SearchOptions) -> FuzzyMatches:
        """Search with ranking and overlap resolution per ``opts``
        (reference src/query.rs:30-38)."""
        opts = SearchOptions.coerce(opts)
        matches = FuzzyMatches(haystack, self.search_raw(haystack, opts.threshold))
        matches.apply(opts.order, opts.overlap)
        return matches

    def segmented(self, haystack: str, opts: SearchOptions) -> FuzzyMatches:
        """Deterministic non-overlapping match set for the segmentation helpers
        (reference src/query.rs:46-64): Unsorted is upgraded to Default order,
        Keep to NonOverlapping."""
        opts = SearchOptions.coerce(opts)
        order = Order.Default if opts.order == Order.Unsorted else opts.order
        overlap = Overlap.NonOverlapping if opts.overlap == Overlap.Keep else opts.overlap
        matches = FuzzyMatches(haystack, self.search_raw(haystack, opts.threshold))
        matches.apply(order, overlap)
        return matches

    # --- derived APIs (reference src/query.rs:86-201) ------------------
    def replace(
        self,
        text: str,
        opts: SearchOptions,
        callback: Callable[[FuzzyMatch], Optional[str]],
    ) -> str:
        """Fuzzy find-and-replace (reference src/query.rs:86-96)."""
        return self.segmented(text, opts).replace(callback)

    def strip_prefix(self, haystack: str, opts: SearchOptions) -> str:
        return self.segmented(haystack, opts).strip_prefix()

    def strip_suffix(self, haystack: str, opts: SearchOptions) -> str:
        return self.segmented(haystack, opts).strip_suffix()

    def split(self, haystack: str, opts: SearchOptions) -> Iterator[str]:
        return self.segmented(haystack, opts).split()

    def segment_iter(self, haystack: str, opts: SearchOptions) -> Iterator[Segment]:
        return self.segmented(haystack, opts).segment_iter()

    def segment_text(self, haystack: str, opts: SearchOptions) -> str:
        return self.segmented(haystack, opts).segment_text()

    # --- prefilter (reference src/prefilter.rs:95-119) ------------------
    def with_prefilter(self):
        from .prefilter import Prefiltered

        return Prefiltered(self)

    # --- streaming (reference src/stream.rs) ----------------------------
    def max_match_graphemes(self) -> int:
        """Upper bound (in graphemes) on the longest span one match can cover
        (reference src/stream.rs:206-253)."""
        max_pattern = max((p.grapheme_len for p in self._patterns), default=0)
        max_mapping_haystack = max(
            (len(mt.haystack) for mts in self.mappings.values() for mt in mts),
            default=1,
        )
        max_mapping_haystack = max(max_mapping_haystack, 1)

        def edits_of(lim: FuzzyLimits) -> int:
            if lim.edits_ is not None:
                return lim.edits_
            return (
                (lim.insertions_ or 0)
                + (lim.deletions_ or 0)
                + (lim.substitutions_ or 0)
                + (lim.swaps_ or 0)
            )

        max_edits = 0
        for p in self._patterns:
            lim = p.limits if p.limits is not None else self.limits
            if lim is not None:
                max_edits = max(max_edits, edits_of(lim))
        return max_pattern + max_edits * max_mapping_haystack

    def stream_overlap(self) -> int:
        """Grapheme overlap streaming windows carry (reference src/stream.rs:256-258)."""
        return self.max_match_graphemes() + 1

    def search_stream(self, reader, threshold: float, on_match) -> int:
        from .stream import search_stream

        return search_stream(self, reader, threshold, on_match)

    def stream_matches(self, reader, threshold: float):
        from .stream import StreamMatches

        return StreamMatches(self, reader, threshold)

    def search_stream_parallel(self, reader, threshold: float, shards: int, on_match) -> int:
        from .stream import search_stream_parallel

        return search_stream_parallel(self, reader, threshold, shards, on_match)

    def replace_stream(self, reader, writer, threshold: float, callback) -> int:
        from .stream import replace_stream

        return replace_stream(self, reader, writer, threshold, callback)

    def replace_stream_parallel(self, reader, writer, shards: int, threshold: float, callback) -> int:
        from .stream import replace_stream_parallel

        return replace_stream_parallel(self, reader, writer, shards, threshold, callback)

    # --- checkpointing (serialize.py) -------------------------------------
    def save(self, path: str) -> None:
        """Serialize the compiled automaton to a ``.npz`` in the JAX
        package's format (see serialize.save)."""
        from . import serialize

        serialize.save(self, path)

    @staticmethod
    def load(path: str, device="cuda") -> "FuzzyAhoCorasick":
        """Load an engine saved by either package; its device tables are
        built on ``device`` (see serialize.load)."""
        from . import serialize

        return serialize.load(path, device)

    def __repr__(self) -> str:
        bits = []
        if self.limits is not None:
            bits.append(f"limits={self.limits}")
        if self.case_insensitive:
            bits.append("case_insensitive=True")
        bits.append(f"patterns={[p.pattern for p in self._patterns]!r}")
        return f"FuzzyAhoCorasick({', '.join(bits)})"


def checked_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA on a host without it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain torch kernels"
        )
    return dev
