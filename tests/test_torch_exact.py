"""The exact slice end to end: the port's ``search_raw`` on the CPU is
list-equal to the JAX package's ``backend="device"`` result (Pallas in
interpret mode) and match-set-equal to the oracle — pattern, start, end, f32
similarity bits, edits. The tolerance is exact: the work is integer and
bitwise, and similarities are pattern weights copied, not computed."""

import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder as JaxBuilder
from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits
from fuzzy_aho_corasick_tpu import SearchOptions as JaxOptions
from fuzzy_aho_corasick_tpu.ops import packed_bitap as jpb
from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits, SearchOptions
from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
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
FILLER = ["lorem", "ipsum", "dolor", "sit", "amet", "elit", "eros", "porta", "orci"]


def _corpus(seed: int, words: int, needles, case_mix: bool = True) -> str:
    """Filler words with needles at 1 in 7, space-joined; mixed case."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(words):
        w = FILLER[int(rng.integers(len(FILLER)))]
        if rng.integers(7) == 0:
            w = needles[int(rng.integers(len(needles)))]
        if case_mix and rng.integers(4) == 0:
            w = w.upper()
        out.append(w)
    return " ".join(out)


def _tuples(matches):
    return [
        (m.pattern_index, m.start, m.end,
         np.float32(m.similarity).view(np.uint32).item(), m.edits)
        for m in matches
    ]


def _engines(patterns, ci=True):
    jax_e = JaxBuilder.new().case_insensitive(ci).build(patterns)
    port_e = FuzzyAhoCorasickBuilder.new().case_insensitive(ci).device("cpu").build(patterns)
    jax_e.backend = "device"
    port_e.backend = "device"
    return jax_e, port_e


def _check(jax_e, port_e, hay, thr):
    got = _tuples(port_e.search_raw(hay, thr))
    assert port_e.last_stats["backend"] == "device-exact-packed"
    assert got == _tuples(jax_e.search_raw(hay, thr))
    port_e.backend = "oracle"
    assert sorted(got) == sorted(_tuples(port_e.search_raw(hay, thr)))
    port_e.backend = "device"
    return got


WEIGHTED = [("tincidunt", 0.4), ("phaetra", 0.9), ("sollicitudin", 0.6), "venenatis"]
CYRILLIC = ["привет", "мир", "Москва", "ирина", "тест"]


@pytest.mark.parametrize(
    "patterns,ci,hay,thr,want_min",
    [
        (HEADLINE, True, _corpus(11, 700, HEADLINE[:3] + ["fringilla"]), 0.5, 40),
        (HEADLINE + ["Lorem"], False, _corpus(12, 700, HEADLINE[:4]), 0.5, 20),
        (WEIGHTED, True, _corpus(13, 700, ["tincidunt", "phaetra", "sollicitudin"]), 0.5, 20),
        (CYRILLIC, True, _corpus(14, 500, ["привет", "МИР", "москва", "иРИНа"]), 0.5, 20),
        (HEADLINE, True, "", 0.5, 0),
    ],
    ids=["headline", "case-sensitive", "weights-below-threshold", "cyrillic", "empty"],
)
def test_search_raw_list_equal_to_jax_device(patterns, ci, hay, thr, want_min):
    jax_e, port_e = _engines(patterns, ci)
    got = _check(jax_e, port_e, hay, thr)
    assert len(got) >= want_min
    if patterns is WEIGHTED:  # tincidunt (0.4) never reaches 0.5
        assert {p for p, *_ in got} == {1, 2}


def test_streaming_branch_matches_resident(monkeypatch):
    needles = ["tincidunt", "phaetra", "sollicitudin"]
    words = _corpus(15, 800, needles).split(" ")
    # Matches straddling every 1024-symbol slice edge.
    hay = " ".join(words)
    for edge in (1024, 2048, 3072):
        hay = hay[: edge - 4] + "sollicitudin" + hay[edge + 8 :]
    jax_e, port_e = _engines(HEADLINE)
    resident = _tuples(port_e.search_raw(hay, 0.5))
    device_corpus.clear()
    for mod in (jpb, tpb):
        monkeypatch.setattr(mod, "RESIDENT_MAX", 1500)
        monkeypatch.setattr(mod, "STREAM_CHUNK", 1024)
    got = _check(jax_e, port_e, hay, 0.5)
    assert sorted(got) == sorted(resident)
    starts = {s for p, s, *_ in got if p == 2}
    assert {1020, 2044, 3068} <= starts


def test_search_sorted_non_overlapping():
    jax_e, port_e = _engines(HEADLINE + ["tinc", "dunt", "tincidun"])
    hay = _corpus(16, 600, ["tincidunt", "phaetra", "tincid", "dunt"])
    j_opts = JaxOptions.new().with_threshold(0.5).sorted().non_overlapping()
    p_opts = SearchOptions.new().with_threshold(0.5).sorted().non_overlapping()
    got = _tuples(port_e.search(hay, p_opts))
    assert got == _tuples(jax_e.search(hay, j_opts))
    assert len(got) > 10


def test_lanes_not_ported_raise_on_device_and_auto():
    big = _corpus(17, 4000, HEADLINE[:3])
    assert len(big) >= FuzzyAhoCorasickBuilder.new().build(["x"]).AUTO_DEVICE_MIN
    # Typed, mapped and forbid engines that the JAX package serves on its device.
    typed = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().insertions(1).deletions(1))
             .device("cpu").build(HEADLINE))
    mapped = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1))
              .mapping("ß", "ss").device("cpu").build(["strasse", "tincidunt"]))
    forbid = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(2).swaps(0))
              .device("cpu").build(HEADLINE))
    # The port serves all three on its DP lanes, under 'device' and 'auto',
    # with the JAX package's lane names, and equal to the oracle.
    mid = big[:5000] + " strase tincidnt phartra tincidutn pharetraa"
    for engine, lane in ((typed, "device-fuzzy-dp-typed"), (mapped, "device-fuzzy-dp-mapped"),
                         (forbid, "device-fuzzy-dp-forbid")):
        assert engine._device_engine().supports(big)
        served = []
        for backend in ("device", "auto"):
            engine.backend = backend
            served.append(sorted(_tuples(engine.search_raw(big, 0.8))))
            assert engine.last_stats["backend"] == lane
        assert served[0] == served[1] and len(served[0]) > 50
        engine.backend = "device"
        got = sorted(_tuples(engine.search_raw(mid, 0.8)))
        assert engine.last_stats["backend"] == lane
        engine.backend = "oracle"
        assert got == sorted(_tuples(engine.search_raw(mid, 0.8))) and len(got) > 10
    # Below AUTO_DEVICE_MIN 'auto' stays on the host, as in the JAX package.
    small = "tincidunt tinciduntt phaetr tincidnt"
    typed.backend = "auto"
    ref = JaxBuilder.new().fuzzy(JaxLimits.new().insertions(1).deletions(1)).build(HEADLINE)
    ref.backend = "oracle"
    want = sorted(_tuples(ref.search_raw(small, 0.8)))
    assert len(want) >= 3 and sorted(_tuples(typed.search_raw(small, 0.8))) == want
    # An exact engine that the packed lane cannot hold (field > 64): the
    # goto walk serves it under 'device' and 'auto', equal to the oracle.
    wide = FuzzyAhoCorasickBuilder.new().device("cpu").build(["a" * 70, "tincidunt"])
    hay = big[:3000] + " " + "a" * 75 + " " + big[3000:] + " " + "a" * 70
    served = []
    for backend in ("device", "auto"):
        wide.backend = backend
        served.append(_tuples(wide.search_raw(hay, 0.5)))
        assert wide.last_stats["backend"] == "device-exact"
    wide.backend = "oracle"
    want = sorted(_tuples(wide.search_raw(hay, 0.5)))
    assert sorted(served[0]) == sorted(served[1]) == want
    assert sum(p == 0 for p, *_ in want) == 7 and len(want) > 20


def _words(n: int, length: int, seed: int, alphabet: str = "abcdefghijklmnopqrstuvwxyz"):
    """``n`` distinct words of ``length`` letters, none a prefix of another:
    with 8 letters, 8 fields per packed limb."""
    rng = np.random.default_rng(seed)
    out = set()
    while len(out) < n:
        out.add("".join(alphabet[i] for i in rng.integers(len(alphabet), size=length)))
    return sorted(out)


def _planted(words, count: int, seed: int, filler=FILLER) -> str:
    """Filler with ``count`` of ``words`` planted, some upper-cased."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        w = words[int(rng.integers(len(words)))]
        out += [FILLER[int(rng.integers(len(FILLER)))], w.upper() if i % 5 == 0 else w]
    return " ".join(out)


_CJK = [chr(0x4E00 + 3 * i) for i in range(300)]
_LONG = "pellentesque" * 6  # 72 graphemes, past the packed lane's 64

#: name -> (patterns, haystack, threshold, port backend, limbs or None).
EXACT_CASES = {
    # The wide packed form (the JAX package walks them).
    "wide-9": (_words(72, 8, 21), None, 0.5, "device-exact-packed", 9),
    "wide-31": (_words(248, 8, 22), None, 0.5, "device-exact-packed", 31),
    "wide-64": (_words(512, 8, 23), None, 0.5, "device-exact-packed", 64),
    # The goto walk.
    "walk-field-70": (HEADLINE + [_LONG, "a" * 70], None, 0.5, "device-exact", None),
    "walk-classes-300": (["".join(_CJK[i:i + 5]) for i in range(0, 300, 5)] + ["привет", "мир"],
                         None, 0.5, "device-exact", None),
    "walk-limbs-75": (_words(600, 8, 24), None, 0.5, "device-exact", None),
    "walk-unicode": (CYRILLIC + ["".join(_CJK[i:i + 3]) for i in range(0, 150, 3)] + ["café"],
                     None, 0.5, "device-exact", None),
    # Weight 0.578 at threshold 0.578: the ceiling prunes the 5-grapheme
    # pattern (f32(5) - f32(5 / 0.578) * 0.578 < 0) and keeps the 6.
    "walk-prune-tie": ([("prune", 0.578), ("kepted", 0.578), _LONG, "tincidunt"],
                       None, np.float32(0.578), "device-exact", None),
}


def _exact_hay(name: str) -> str:
    pats = [p if isinstance(p, str) else p[0] for p in EXACT_CASES[name][0]]
    hay = _planted(pats, 120, 31)
    if name == "walk-field-70":
        hay += " " + "a" * 75 + " " + _LONG + _LONG[:20]
    if name in ("walk-classes-300", "walk-unicode"):
        hay = hay.replace(" lorem ", " naïve e\u0301t\u00e9 ") + " мИР привет"
    if name == "walk-prune-tie":
        hay += " prune kepted " + _LONG
    return hay


@pytest.mark.parametrize("name", list(EXACT_CASES))
def test_exact_lanes_equal_to_jax_and_oracle(monkeypatch, name):
    """Exact engines the narrow packed lane cannot hold: the wide packed
    form (W = 9..64; at 31 limbs also on the streaming branch) and the goto
    walk (a field past 64 graphemes, more than 128 symbol classes, more than
    64 limbs) equal the JAX package's device search (its goto walk) and the
    oracle, as (pattern, start, end, f32 similarity bits, edits)."""
    patterns, _hay, thr, backend, limbs = EXACT_CASES[name]
    hay = _exact_hay(name)
    jax_e, port_e = _engines(patterns)
    got = sorted(_tuples(port_e.search_raw(hay, thr)))
    assert port_e.last_stats["backend"] == backend
    assert port_e.last_stats.get("limbs") == limbs
    want = sorted(_tuples(jax_e.search_raw(hay, thr)))
    assert jax_e.last_stats["backend"] == "device-exact"
    port_e.backend = "oracle"
    assert got == want == sorted(_tuples(port_e.search_raw(hay, thr)))
    assert len(got) >= 60
    if name == "walk-prune-tie":
        found = {p for p, *_ in got}
        assert 1 in found and 0 not in found and "prune" in hay
    if name == "wide-31":  # slices of 256 symbols, overlapping by m_max - 1
        monkeypatch.setattr(tpb, "RESIDENT_MAX", 300)
        monkeypatch.setattr(tpb, "STREAM_CHUNK", 256)
        device_corpus.clear()
        port_e.backend = "device"
        assert sorted(_tuples(port_e.search_raw(hay, thr))) == got


def _prefilter(builder):
    engine = builder.new().case_insensitive(True).build(HEADLINE)
    hay = _corpus(18, 300, HEADLINE[:4])
    return [(m.pattern_index, m.start, m.end) for m in
            engine.with_prefilter().search(hay, engine_opts(builder).with_threshold(0.5))]


def _streaming(builder):
    engine = builder.new().case_insensitive(True).build(HEADLINE)
    data = _corpus(19, 400, HEADLINE[:4]).encode()
    got = []
    engine.search_stream(data, 0.5, lambda m: got.append((m.pattern_index, m.start, m.end)))
    return got


def _serialize(builder, tmp_path):
    engine = builder.new().case_insensitive(True).build(HEADLINE)
    path = str(tmp_path / f"{builder.__module__}.npz")
    engine.save(path)
    loaded = type(engine).load(path)
    hay = _corpus(20, 300, HEADLINE[:4])
    return [(m.pattern_index, m.start, m.end) for m in loaded.search_raw(hay, 0.5)]


def _replacer(builder):
    return builder.new().build_replacer({"abc": "b"}).replace(
        "xx abc yy abcabc zz abc", engine_opts(builder).with_threshold(0.5))


def engine_opts(builder):
    return JaxOptions.new() if builder is JaxBuilder else SearchOptions.new()


@pytest.mark.parametrize(
    "call",
    [
        lambda b, tmp: _prefilter(b),
        lambda b, tmp: _streaming(b),
        _serialize,
        lambda b, tmp: _replacer(b),
    ],
    ids=["prefilter", "streaming", "serialize", "replacer"],
)
def test_entry_points_not_ported_raise(call, tmp_path):
    """The four entry points that raised before the port carried them (the
    test keeps its name): each now returns what the JAX package returns."""
    got = call(FuzzyAhoCorasickBuilder, tmp_path)
    want = call(JaxBuilder, tmp_path)
    assert got == want
    assert len(got) > 10
