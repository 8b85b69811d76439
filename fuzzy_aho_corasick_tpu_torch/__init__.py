"""fuzzy_aho_corasick_tpu_torch — the PyTorch + CUDA port of
``fuzzy_aho_corasick_tpu``.

The JAX package's public surface: build an engine, call ``search_raw`` /
``search`` / the segmentation helpers, ``replace``, the prefilter
(``with_prefilter``, :class:`Prefiltered`), find-and-replace
(``build_replacer``, :class:`FuzzyReplacer`), streaming search and replace
over a byte reader of any length (``search_stream``, ``stream_matches``,
``search_stream_parallel``, ``replace_stream``, ``replace_stream_parallel``;
:class:`StreamMatch`, :class:`StreamMatches`) and ``save`` / ``load`` in the
JAX package's ``.npz`` format. Exact search (the packed shift-AND lane, then
a goto walk in torch for the dictionaries that do not pack), the DP family
of fuzzy searches (a uniform edit budget, edit types switched off, per-type
and per-pattern limits, multi-character mappings) and fuzzy search over
large dictionaries run on the GPU through hand-written CUDA kernels
(``csrc/*.cu``, built with ``nvcc`` at first use into ``build/kernels/``).
Fuzzy searches that those lanes decline (alphabets past 128 symbols,
patterns past 63 graphemes, one ``search_raw`` past ``RESIDENT_MAX``
graphemes) run the beam-frontier lanes, torch code on the same device
behind the packed scan's anchors or the seed filter, as in the JAX package.
Small haystacks (under ``AUTO_DEVICE_MIN``) run the native-C host BFS
(``native/fastpath.c``, built with ``gcc`` at first use into
``build/native/``; the pure-Python oracle where there is no ``gcc``).

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
from .prefilter import Prefiltered
from .replacer import FuzzyReplacer
from .stream import StreamMatch, StreamMatches
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
    "FuzzyReplacer",
    "HaystackTooLarge",
    "NumEdits",
    "Order",
    "Overlap",
    "Pattern",
    "PatternIndex",
    "Prefiltered",
    "SearchError",
    "SearchOptions",
    "Segment",
    "Similarity",
    "StreamMatch",
    "StreamMatches",
    "UnmatchedSegment",
    "DEFAULT_THRESHOLD",
]
