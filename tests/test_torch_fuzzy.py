"""The fuzzy DP slice end to end, and the device dispatcher's routing.

The port's fuzzy ``search_raw`` on the CPU is list-equal to the JAX
package's ``backend="device"`` result (its DP pipeline, Pallas in interpret
mode) and set-equal to the JAX oracle: pattern, start, end, f32 similarity
bits and per-type edit counts. The tolerance is exact.

The dispatcher claims an engine for a device lane exactly when the JAX
package does; where it does not, ``auto`` serves the oracle's matches."""

import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder as JaxBuilder
from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits
from fuzzy_aho_corasick_tpu import Pattern as JaxPattern
from fuzzy_aho_corasick_tpu import SearchOptions as JaxOptions
from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits, Pattern
from fuzzy_aho_corasick_tpu_torch import SearchOptions
from fuzzy_aho_corasick_tpu_torch.ops import verify_dp as tvd
from fuzzy_aho_corasick_tpu_torch.utils import device_corpus

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)

HEADLINE = [
    "tincidunt", "phaetra", "sollicitudin", "venenatis", "fringilla",
    "ullamcorper", "pellentesque", "sagittis", "condimentum", "habitasse",
    "malesuada", "scelerisque", "imperdiet", "vulputate", "ridiculus",
    "parturient",
]
FILLER = ["lorem", "ipsum", "dolor", "sit", "amet", "elit", "eros", "porta"]
CYRILLIC = ["привет", "мир", "москва", "ирина", "тест"]


def _edit(word: str, rng) -> str:
    i, op = int(rng.integers(1, len(word) - 1)), int(rng.integers(4))
    return [word[:i] + "x" + word[i + 1:], word[:i] + word[i + 1:],
            word[:i] + "q" + word[i:], word[:i] + word[i + 1] + word[i] + word[i + 2:]][op]


def _corpus(seed: int, size: int, needles, filler=FILLER, rate: int = 6) -> str:
    """Filler words with needles at 1 in ``rate``, each with 0-2 edits, up to
    ``size`` characters; mixed case."""
    rng = np.random.default_rng(seed)
    out, n = [], 0
    while n < size:
        if rng.integers(rate) == 0:
            w = needles[int(rng.integers(len(needles)))]
            for _ in range(int(rng.integers(0, 3))):
                w = _edit(w, rng) if len(w) > 3 else w
        else:
            w = filler[int(rng.integers(len(filler)))]
        if rng.integers(5) == 0:
            w = w.upper()
        out.append(w)
        n += len(w) + 1
    return " ".join(out)[:size]


def _tuples(matches):
    return [
        (m.pattern_index, m.start, m.end, np.float32(m.similarity).view(np.uint32).item(),
         m.insertions, m.deletions, m.substitutions, m.swaps)
        for m in matches
    ]


def _pair(configure, patterns):
    jax_e = configure(JaxBuilder.new(), JaxLimits).build(patterns)
    port_e = configure(FuzzyAhoCorasickBuilder.new(), FuzzyLimits).device("cpu").build(patterns)
    jax_e.backend = "device"
    port_e.backend = "device"
    return jax_e, port_e


def _check(jax_e, port_e, hay, thr, min_matches=1):
    got = _tuples(port_e.search_raw(hay, thr))
    assert port_e.last_stats["backend"] == "device-fuzzy-dp"
    want = _tuples(jax_e.search_raw(hay, thr))
    assert jax_e.last_stats["backend"] == "device-fuzzy-dp"
    assert got == want
    jax_e.backend = "oracle"
    assert sorted(got) == sorted(_tuples(jax_e.search_raw(hay, thr)))
    jax_e.backend = "device"
    assert len(got) >= min_matches
    return got


def _fuzzy1(b, L):
    return b.fuzzy(L.new().edits(1)).case_insensitive(True)


@pytest.fixture(scope="module")
def headline():
    return _pair(_fuzzy1, HEADLINE)


def test_headline_fuzzy1(headline):
    jax_e, port_e = headline
    hay = _corpus(41, 16000, HEADLINE)
    got = _check(jax_e, port_e, hay, 0.8, min_matches=150)
    kinds = {tuple(t[4:]) for t in got}
    assert {(0, 0, 0, 0), (1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1)} <= kinds
    stats = port_e.last_stats
    assert stats["slices"] == 1 and stats["matches"] == len(got)
    assert stats["candidates"] >= stats["hits"] > 0


@pytest.mark.parametrize(
    "configure,patterns,needles,filler,thr",
    [
        (lambda b, L: b.fuzzy(L.new().edits(1)), ["testing", "sting", "ing"],
         ["testing", "sting", "ing", "resting"], FILLER, 0.6),
        (lambda b, L: b.fuzzy(L.new().edits(1)).min_symbol_similarity(0.5),
         "weighted", ["tincidunt", "phaetra"], FILLER, 0.65),
        (_fuzzy1, HEADLINE, HEADLINE[:4], ["lörem", "ипсум", "dolor", "ßit", "amet"], 0.7),
        (_fuzzy1, CYRILLIC, CYRILLIC + ["прuвет", "мирр"], ["и", "мы", "тесты", "кафе", "она"], 0.6),
    ],
    ids=["suffix-outputs", "weights-and-floor", "unicode-corpus", "cyrillic-dead-end"],
)
def test_fuzzy_list_equal_to_jax_device(configure, patterns, needles, filler, thr):
    if patterns == "weighted":
        jax_e = configure(JaxBuilder.new(), JaxLimits).build(
            [JaxPattern("tincidunt").with_weight(0.9), JaxPattern("phaetra").with_weight(1.1)])
        port_e = configure(FuzzyAhoCorasickBuilder.new(), FuzzyLimits).device("cpu").build(
            [Pattern("tincidunt").with_weight(0.9), Pattern("phaetra").with_weight(1.1)])
        jax_e.backend = port_e.backend = "device"
    else:
        jax_e, port_e = _pair(configure, patterns)
    hay = _corpus(42, 12000, needles, filler, rate=4)
    _check(jax_e, port_e, hay, thr, min_matches=40)
    if patterns is CYRILLIC:
        assert port_e.dense.has_multibyte_edges  # the dead-end filter runs


def test_sliced_equals_unsliced(headline, monkeypatch):
    jax_e, port_e = headline
    slice_syms = 3000
    rng = np.random.default_rng(43)
    words = _corpus(44, 4 * slice_syms, ["phaetra"], rate=40)
    buf = list(words)
    for s in range(1, 4):  # a fuzzed needle straddling each slice edge
        at = s * slice_syms - 4
        w = _edit("tincidunt", rng)
        buf[at:at + len(w)] = list(w)
    hay = "".join(buf)
    device_corpus.clear()
    whole = _check(jax_e, port_e, hay, 0.8)
    monkeypatch.setattr(tvd, "SLICE_SYMS", slice_syms)
    device_corpus.clear()
    sliced = _tuples(port_e.search_raw(hay, 0.8))
    assert port_e.last_stats["slices"] == 4
    assert sliced == whole
    starts = {s for p, s, *_ in whole if p == 0}
    assert len({s // slice_syms for s in starts}) >= 3


def test_beamed_engine_served_by_dp_lane():
    jax_e, port_e = _pair(lambda b, L: _fuzzy1(b, L).beam_width(4), HEADLINE)
    hay = _corpus(45, 8000, HEADLINE)
    _check(jax_e, port_e, hay, 0.8, min_matches=40)


def test_search_sorted_non_overlapping(headline):
    jax_e, port_e = headline
    hay = _corpus(46, 8000, HEADLINE)
    j = _tuples(jax_e.search(hay, JaxOptions.new().with_threshold(0.8).sorted().non_overlapping()))
    p = _tuples(port_e.search(hay, SearchOptions.new().with_threshold(0.8).sorted().non_overlapping()))
    assert p == j and len(p) > 30


def test_similarity_tying_the_threshold(headline):
    jax_e, port_e = headline
    hay = "lorem tincdunt ipsum TINCIDUNT dolor tincidxnt amet tnicidunt " * 40
    # Every similarity below 1 that a match reaches, taken as the threshold
    # itself. The emission test keeps sim >= threshold in f32, but the
    # per-node prune ceiling, also f32, can fall just below the tied
    # penalty; the port must follow the reference either way.
    sims = {np.uint32(t[3]).view(np.float32) for t in _tuples(port_e.search_raw(hay, 0.8))}
    ties = sorted(x for x in sims if x < 1.0)
    assert len(ties) >= 3
    kept = 0
    for thr in (ties[0], ties[-1]):
        got = _check(jax_e, port_e, hay, float(thr))
        kept += np.float32(thr).view(np.uint32).item() in {t[3] for t in got}
    assert kept >= 1


# ---------------------------------------------------------------------------
# Routing: supports() and auto, equal to the JAX package
# ---------------------------------------------------------------------------

ROUTING = {
    "exact": (lambda b, L, P: b, ["hello", "world"]),
    "fuzzy": (lambda b, L, P: b.fuzzy(L.new().edits(1)), ["hello", "world"]),
    "edits-7": (lambda b, L, P: b.fuzzy(L.new().edits(7)), ["hello", "world"]),
    "per-pattern-limits": (
        lambda b, L, P: b.fuzzy(L.new().edits(1)),
        lambda L, P: [P("hello").fuzzy(L.new().edits(2)), P("world")]),
    "typed": (lambda b, L, P: b.fuzzy(L.new().insertions(1).deletions(1)), ["hello", "world"]),
    "forbid": (lambda b, L, P: b.fuzzy(L.new().edits(2).swaps(0)), ["hello", "world"]),
    "mapped-pb-over-3": (lambda b, L, P: b.fuzzy(L.new().edits(1)).mapping("x", "abcd"),
                         ["zzabcdzz", "hello"]),
    "mapped": (lambda b, L, P: b.fuzzy(L.new().edits(1)).mapping("ß", "ss"), ["strasse"]),
    "beamed": (lambda b, L, P: b.fuzzy(L.new().edits(1)).beam_width(8), ["hello", "world"]),
    "empty-pattern": (lambda b, L, P: b.fuzzy(L.new().edits(1)), ["", "hello"]),
}


def _routing_pair(name):
    configure, patterns = ROUTING[name]
    jp = patterns(JaxLimits, JaxPattern) if callable(patterns) else patterns
    tp = patterns(FuzzyLimits, Pattern) if callable(patterns) else patterns
    jax_e = configure(JaxBuilder.new(), JaxLimits, JaxPattern).build(jp)
    port_e = configure(FuzzyAhoCorasickBuilder.new(), FuzzyLimits, Pattern).device("cpu").build(tp)
    return jax_e, port_e


@pytest.mark.parametrize("name", list(ROUTING))
def test_supports_equal_to_jax(name):
    jax_e, port_e = _routing_pair(name)
    hay = "hello world strasse " * 1300
    want = jax_e._device_engine().supports(hay)
    assert port_e._device_engine().supports(hay) == want
    assert want == (name not in ("edits-7", "mapped-pb-over-3", "empty-pattern"))


def test_auto_serves_unclaimed_engine_on_the_oracle():
    jax_e, port_e = _routing_pair("edits-7")
    hay = _corpus(48, 24000, ["hello", "world", "helo", "wrold"], rate=5)
    assert len(hay) >= port_e.AUTO_DEVICE_MIN
    assert not port_e._device_engine().supports(hay)
    port_e.backend = "auto"
    jax_e.backend = "oracle"
    got = sorted(_tuples(port_e.search_raw(hay, 0.9)))
    assert got == sorted(_tuples(jax_e.search_raw(hay, 0.9)))
    assert len(got) > 100


def test_to_drops_the_device_tables(headline):
    _jax_e, port_e = headline
    port_e.search_raw("lorem tincidnt ipsum " * 20, 0.8)
    assert port_e._dp_dev_consts  # scan tables, DP tables, node ceilings
    port_e.to("cpu")
    assert port_e._dp_dev_consts is None
    assert port_e.search_raw("lorem tincidnt ipsum", 0.8)[0].pattern_index == 0
