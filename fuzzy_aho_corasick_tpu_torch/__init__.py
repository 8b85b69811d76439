"""fuzzy_aho_corasick_tpu_torch — the PyTorch + CUDA port of
``fuzzy_aho_corasick_tpu``.

Same public surface as the JAX package for the parts ported so far: build an
engine, call ``search_raw`` / ``search`` / the segmentation helpers. Exact
search (the packed shift-AND lane, then a goto walk in torch for the
dictionaries that do not pack), the DP family of fuzzy searches (a uniform
edit budget, edit types switched off, per-type and per-pattern limits,
multi-character mappings) and fuzzy search over large dictionaries run on the
GPU through hand-written CUDA kernels (``csrc/*.cu``, built with ``nvcc`` at
first use); configurations whose device lanes are not ported yet (the beam
lanes, fuzzy corpora past ``RESIDENT_MAX``) raise ``NotImplementedError``.

The engine's device tables live on a torch device, ``cuda`` by default::

    from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, SearchOptions

    engine = (FuzzyAhoCorasickBuilder.new()
              .case_insensitive(True)
              .device("cuda")
              .build(["hello", "world"]))
    engine.backend = "device"
    for m in engine.search("Hello world", SearchOptions.new().with_threshold(0.5)):
        print(m.pattern.pattern, m.start, m.end, m.similarity)

``engine.to("cpu")`` runs the kernels' plain torch versions instead (tests,
hosts without a card). The package imports ``torch`` and ``numpy``; never
``jax`` nor the JAX package.
"""

from .automaton import FuzzyAhoCorasick
from .builder import FuzzyAhoCorasickBuilder
from .errors import HaystackTooLarge, SearchError
from .matches import FuzzyMatches
from .options import DEFAULT_THRESHOLD, Order, Overlap, SearchOptions
from .structs import (
    FuzzyLimits,
    FuzzyMatch,
    FuzzyPenalties,
    NumEdits,
    Pattern,
    PatternIndex,
    Segment,
    Similarity,
    UnmatchedSegment,
)

__version__ = "0.1.0"

__all__ = [
    "FuzzyAhoCorasick",
    "FuzzyAhoCorasickBuilder",
    "FuzzyLimits",
    "FuzzyMatch",
    "FuzzyMatches",
    "FuzzyPenalties",
    "HaystackTooLarge",
    "NumEdits",
    "Order",
    "Overlap",
    "Pattern",
    "PatternIndex",
    "SearchError",
    "SearchOptions",
    "Segment",
    "Similarity",
    "UnmatchedSegment",
    "DEFAULT_THRESHOLD",
]
