"""The port's host paths against the JAX package: the native-C BFS lane
(bit-equal to the JAX package's native BFS and to both oracles: match set,
f32 similarity bits, edit counts), the bit-parallel prefilter (``Prefiltered``
equal to the full search, the host bitap scans equal to each other and to the
JAX package's), the native library's build under ``build/`` and the transcode
it serves, and the device-corpus LRU under concurrent searches. Inputs are
seeded; tolerance: exact."""

import shutil
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder as JaxBuilder
from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits
from fuzzy_aho_corasick_tpu import FuzzyPenalties as JaxPenalties
from fuzzy_aho_corasick_tpu import SearchOptions as JaxOptions
from fuzzy_aho_corasick_tpu import oracle as jax_oracle
from fuzzy_aho_corasick_tpu.ops import bitap as jax_bitap
from fuzzy_aho_corasick_tpu.ops import native_bfs as jax_native_bfs
from fuzzy_aho_corasick_tpu_torch import (
    FuzzyAhoCorasickBuilder,
    FuzzyLimits,
    FuzzyPenalties,
    SearchOptions,
    oracle,
)
from fuzzy_aho_corasick_tpu_torch.ops import bitap, native_bfs
from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
from fuzzy_aho_corasick_tpu_torch.utils import device_corpus, native
from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)

ROOT = native._PKG.parent


def _lib():
    """The port's native library; it must load wherever ``gcc`` is found."""
    if shutil.which("gcc") is None:
        pytest.skip("no gcc on this host: the native library is not built")
    L = native.lib()
    assert L is not None, native.build_error()
    return L


def _key(m):
    return (m.pattern_index, m.start, m.end, np.float32(m.similarity).view(np.uint32).item(),
            m.insertions, m.deletions, m.substitutions, m.swaps)


def _pair(build):
    """``build(builder, limits, penalties)`` applied to both packages."""
    jax_e = build(JaxBuilder.new(), JaxLimits, JaxPenalties)
    port_e = build(FuzzyAhoCorasickBuilder.new().device("cpu"), FuzzyLimits, FuzzyPenalties)
    return jax_e, port_e


def _check(pair, hay, thr):
    """The port's native BFS against its oracle, the JAX oracle and (where
    the JAX package's library loaded) the JAX native BFS."""
    _lib()
    jax_e, port_e = pair
    res = native_bfs.search_raw(port_e, hay, thr)
    assert res is not None, "native lane declined an eligible config"
    got = [_key(m) for m in res]
    assert sorted(got) == sorted(map(_key, oracle.search_raw(port_e, hay, thr)))
    assert sorted(got) == sorted(map(_key, jax_oracle.search_raw(jax_e, hay, thr)))
    jax_res = jax_native_bfs.search_raw(jax_e, hay, thr)
    if jax_res is not None:
        assert got == [_key(m) for m in jax_res]
    return res


def test_native_library_builds_under_build_dir():
    L = _lib()
    path = native.library_path()
    assert path.is_file() and path.parent.parent == ROOT / "build" / "native"
    assert not list((ROOT / "fuzzy_aho_corasick_tpu_torch" / "native").glob("*.so*"))
    for name in ("transcode_u8", "transcode_i32", "bitap_scan", "bitap_scan_damerau",
                 "bfs_search", "bfs_search_h", "greedy_nonoverlap", "replace_emit_batch",
                 "replace_emit_table"):
        assert hasattr(L, name), name


_BUILD_CHILD = r"""
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from fuzzy_aho_corasick_tpu_torch.utils import native
native.BUILD_ROOT = Path(sys.argv[2])
L = native.lib()
print(native.library_path() if L is not None else native.build_error())
print(L.greedy_nonoverlap is not None if L is not None else "")
"""


def test_native_build_is_safe_across_processes(tmp_path):
    """Six processes building into one empty build directory at once (as
    six test workers collecting together do) all load one whole library."""
    import subprocess

    _lib()
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, str(ROOT), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _out, err in outs]
    lines = {out for out, _err in outs}
    assert len(lines) == 1, lines
    path = Path(lines.pop().split()[0])
    assert path.is_file() and path.parent.parent == tmp_path
    assert sorted(q.name for q in path.parent.iterdir()) == [".lock", "fastpath.so"]


def test_native_transcodes_equal_numpy_gather():
    _lib()
    rng = np.random.default_rng(2)
    data = bytes(rng.integers(0, 128, size=70_001, dtype=np.uint8))
    t8 = rng.integers(0, 40, size=256).astype(np.uint8)
    t32 = rng.integers(0, 400, size=256).astype(np.int32)
    raw = np.frombuffer(data, np.uint8)
    assert np.array_equal(native.transcode_bytes_u8(data, t8), t8[raw])
    assert np.array_equal(native.transcode_bytes_i32(data, t32), t32[raw])
    # The three callers: dense classes, packed exact symbols, prefilter ids.
    hay = data.decode("ascii")
    words = ["tincidunt", "phaetra", "Lorem", "ipsum"]
    engine = FuzzyAhoCorasickBuilder.new().case_insensitive(True).device("cpu").build(words)
    dense = engine.dense
    assert np.array_equal(dense.transcode_ascii(hay), dense.ascii_class_u8[raw])
    pk = tpb.packed_exact_of(engine)
    assert np.array_equal(pk.transcode(hay, view_of(hay, True), dense), pk.ascii_tbl[raw])
    filt = engine.with_prefilter().filter
    assert np.array_equal(filt.transcode(hay)[0], filt.ascii_id[raw])


def test_basic_fuzzy1():
    pair = _pair(lambda b, L, P: b.fuzzy(L.new().edits(1)).case_insensitive(True)
                 .build(["hello", "world", "help"]))
    assert len(_check(pair, "why hello there, wrold of helpful words", 0.7)) == 10


def test_exact_config():
    pair = _pair(lambda b, L, P: b.case_insensitive(True).build(["cat", "catalog", "dog"]))
    res = _check(pair, "the CATALOG of cats and dogs, cat!", 0.5)
    assert any(m.pattern_index == 1 for m in res)


def test_randomized_configs():
    rng = np.random.default_rng(42)
    alphabet = "abcdefgh"
    for _trial in range(60):
        n_pat = int(rng.integers(1, 6))
        pats = sorted({
            "".join(alphabet[i] for i in rng.integers(0, len(alphabet), size=int(m)))
            for m in rng.integers(2, 9, size=n_pat)
        })
        edits = int(rng.integers(1, 5))
        pens = None
        if rng.integers(2):
            pens = [float(x) for x in rng.uniform(0.2, 1.5, size=4)]
        ci = bool(rng.integers(2))
        min_sym = float(rng.uniform(0.0, 0.7)) if rng.integers(2) else None

        def build(b, L, P):
            b = b.fuzzy(L.new().edits(edits)).case_insensitive(ci)
            if pens is not None:
                b = b.penalties(P.default().with_insertion(pens[0]).with_deletion(pens[1])
                                .with_substitution(pens[2]).with_swap(pens[3]))
            if min_sym is not None:
                b = b.min_symbol_similarity(min_sym)
            return b.build(pats)

        hay = "".join(alphabet[i] if rng.integers(5) else " "
                      for i in rng.integers(0, len(alphabet), size=120))
        _check(_pair(build), hay, float(rng.uniform(0.3, 0.9)))


def test_similarity_map_chars():
    # Per-type limits: a typed config, outside the native envelope.
    typed = _pair(lambda b, L, P: b.fuzzy(L.new().edits(2).swaps(0)).case_insensitive(True)
                  .build(["oracle", "laser"]))[1]
    assert native_bfs.search_raw(typed, "oracle", 0.5) is None
    # The default similarity (vowel / consonant / OCR groups) prices
    # substitutions per class pair.
    pair = _pair(lambda b, L, P: b.fuzzy(L.new().edits(2)).case_insensitive(True)
                 .build(["oracle", "laser"]))
    _check(pair, "an 0racle and a l4ser and an oracel", 0.55)


def test_envelope_declines():
    _lib()
    mapped = FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1)) \
        .mapping("rn", "m").device("cpu").build(["modern"])
    assert native_bfs.search_raw(mapped, "modem times", 0.8) is None
    beamed = FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1)) \
        .beam_width(100).device("cpu").build(["hello"])
    assert native_bfs.search_raw(beamed, "helo", 0.7) is None
    plain = FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1)) \
        .device("cpu").build(["hello"])
    assert native_bfs.search_raw(plain, "héllo", 0.7) is None


def test_determinism_and_order():
    """Repeat runs are identical, and the output order is the device lanes'
    canonical (pattern, start, end) order, as in the JAX package."""
    pair = _pair(lambda b, L, P: b.fuzzy(L.new().edits(2)).case_insensitive(True)
                 .build(["abcde", "bcdef"]))
    hay = "xx abcdef abxcde bcdef zz"
    a = [_key(m) for m in _check(pair, hay, 0.5)]
    assert a == [_key(m) for m in native_bfs.search_raw(pair[1], hay, 0.5)]
    assert a == sorted(a, key=lambda k: (k[0], k[1], k[2]))


def test_routing_uses_native_lane():
    """The port's list, in its order, is the JAX oracle's tuples in the
    canonical (pattern, start, end) order, and the JAX native lane's list
    where the JAX package's own library loaded (its build into one shared
    ``fastpath.so.tmp`` can lose a race between test workers, and its
    ``search_raw`` then falls back to its oracle, whose order differs)."""
    _lib()
    jax_e, port_e = _pair(lambda b, L, P: b.fuzzy(L.new().edits(1)).case_insensitive(True)
                          .build(["hello"]))
    got = [_key(m) for m in port_e.search_raw("a hello b", 0.7)]
    assert port_e.last_stats["backend"] == "native-bfs"
    assert got == sorted(map(_key, jax_oracle.search_raw(jax_e, "a hello b", 0.7)))
    assert len(got) == 3
    jax_res = jax_native_bfs.search_raw(jax_e, "a hello b", 0.7)
    if jax_res is not None:
        assert got == [_key(m) for m in jax_res]
    # The forced oracle backend stays pure Python (an independent reference).
    port_e.backend = "oracle"
    port_e.search_raw("a hello b", 0.7)
    assert port_e.last_stats["backend"] == "oracle"


def test_concurrent_callers_are_correct():
    """Threads sharing one engine get the single-threaded results: the C
    scratch is thread-local and the row buffers are per thread."""
    _lib()
    engine = FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1)) \
        .case_insensitive(True).device("cpu").build(["hello", "world", "help"])
    hays = ["why hello there, wrold of helpful words", "helo wordl helq nothing",
            "xx hello world help yy" * 3]
    expect = [[_key(m) for m in native_bfs.search_raw(engine, h, 0.7)] for h in hays]
    errs = []

    def worker(tid):
        try:
            for i in range(200):
                got = [_key(m) for m in native_bfs.search_raw(engine, hays[(i + tid) % 3], 0.7)]
                assert got == expect[(i + tid) % 3]
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs


class Rng:
    """Deterministic xorshift (reference src/prefilter.rs:442-452)."""

    def __init__(self, seed):
        self.s = seed & 0xFFFFFFFFFFFFFFFF

    def next(self):
        x = self.s
        x ^= (x << 13) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 7
        x ^= (x << 17) & 0xFFFFFFFFFFFFFFFF
        self.s = x
        return x


def _pf_key(m):
    return (m.start, m.end, m.pattern_index, np.float32(m.similarity).view(np.uint32).item(),
            m.edits)


def _differential(seed, vocab, filler, trials):
    """``Prefiltered.search`` equals the full search in the port and the
    JAX package's ``Prefiltered.search`` across random configurations
    (reference src/prefilter.rs:467-529)."""
    rng = Rng(seed)
    for trial in range(trials):
        patterns = [vocab[rng.next() % len(vocab)] for _ in range(1 + rng.next() % 3)]
        edits = rng.next() % 3
        ci = rng.next() & 1 == 0
        pens = trial % 5 == 0

        def build(b, L, P):
            b = b.case_insensitive(ci)
            if edits > 0:
                b = b.fuzzy(L.new().edits(edits))
            if pens:
                b = b.penalties(P.default().with_swap(0.6).with_insertion(0.5).with_deletion(0.8))
            return b.build(patterns)

        jax_e, port_e = _pair(build)
        hay = []
        for _ in range(rng.next() % 40):
            if rng.next() % 7 == 0:
                hay += [patterns[rng.next() % len(patterns)], " "]
            else:
                hay.append(filler[rng.next() % len(filler)])
        hay = "".join(hay)
        thr = 0.6 + (rng.next() % 4) * 0.1
        full = sorted(map(_pf_key, port_e.search(hay, SearchOptions.new().with_threshold(thr))))
        got = sorted(map(_pf_key, port_e.with_prefilter().search(
            hay, SearchOptions.new().with_threshold(thr))))
        want = sorted(map(_pf_key, jax_e.with_prefilter().search(
            hay, JaxOptions.new().with_threshold(thr))))
        assert got == full == want, (trial, patterns, edits, ci, thr, hay)


def test_prefilter_matches_full_search_ascii():
    _differential(0x123456789ABCDEF1, ["hello", "world", "vestibulum", "abc", "lorem", "cell"],
                  ["a", "b", "c", "d", "e", " ", "1", "o", "0", "l"], 250)


def test_prefilter_matches_full_search_unicode():
    _differential(0xDEADBEEF0BADF00D, ["café", "naïve", "Ωμέγα", "Москва", "señor", "école"],
                  ["a", "é", "ñ", "ω", "м", " ", "o", "0", "é"], 250)


def test_falls_back_when_not_reducible():
    mapped = FuzzyAhoCorasickBuilder.new().mapping("ae", "æ").device("cpu").build(["caesar"])
    assert not mapped.with_prefilter().is_active()
    fuzzy = FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1)).device("cpu") \
        .build(["caesar"])
    assert fuzzy.with_prefilter().is_active()
    hay = "the caesar and caeser and ceasar"
    opts = SearchOptions.new().with_threshold(0.7)
    assert list(map(_pf_key, mapped.with_prefilter().search(hay, opts))) == \
        list(map(_pf_key, mapped.search(hay, opts)))


def _random_mask(rng, m, alphabet):
    mask = np.zeros(alphabet + 1, dtype=np.uint64)
    for i in range(m):
        mask[1 + rng.next() % alphabet] |= np.uint64(1) << np.uint64(i)
    return mask


@pytest.mark.parametrize("damerau", [False, True], ids=["plain", "damerau"])
def test_bitap_impls_agree(damerau):
    """Scalar, chunked and native scans give one window set, equal to the
    JAX package's scalar scan (the host form of the device scan's chunks
    with an ``m + k`` halo)."""
    _lib()
    rng = Rng(0xFACADE if damerau else 0xC0FFEE)
    for trial in range(40):
        m = (2 if damerau else 1) + rng.next() % (19 if damerau else 20)
        k = rng.next() % (3 if damerau else 4)
        alphabet = 1 + rng.next() % 6
        mask = _random_mask(rng, m, alphabet)
        ids = np.array([rng.next() % (alphabet + 1) for _ in range(500 + rng.next() % 2000)],
                       dtype=np.uint8)
        a, b, c, j = [], [], [], []
        bitap.bitap_windows(mask, m, k, ids, a, damerau=damerau)
        bitap.bitap_windows_chunked(mask, m, k, ids, b, chunk=256, damerau=damerau)
        bitap.bitap_windows_auto(mask, m, k, ids, c, damerau=damerau)
        jax_bitap.bitap_windows(mask, m, k, ids, j, damerau=damerau)
        assert sorted(set(a)) == sorted(set(b)) == sorted(set(c)) == sorted(set(j)), trial


def _damerau_distance(a: str, b: str) -> int:
    """Brute-force restricted Damerau-Levenshtein (optimal string alignment)."""
    d = [[i + j if i * j == 0 else 0 for j in range(len(b) + 1)] for i in range(len(a) + 1)]
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            d[i][j] = min(d[i - 1][j] + 1, d[i][j - 1] + 1,
                          d[i - 1][j - 1] + (a[i - 1] != b[j - 1]))
            if i > 1 and j > 1 and a[i - 1] == b[j - 2] and a[i - 2] == b[j - 1]:
                d[i][j] = min(d[i][j], d[i - 2][j - 2] + 1)
    return d[len(a)][len(b)]


def test_damerau_bitap_vs_bruteforce_dp():
    """Every substring within Damerau distance k of the pattern yields a scan
    hit at its end (the filter may over-admit, never under-admit)."""
    rng = Rng(0xB17A9)
    for trial in range(120):
        m = 2 + rng.next() % 8
        k = rng.next() % 3
        alphabet = 2 + rng.next() % 3
        pat = "".join(chr(97 + rng.next() % alphabet) for _ in range(m))
        mask = np.zeros(alphabet + 1, dtype=np.uint64)
        for i, ch in enumerate(pat):
            mask[ord(ch) - 96] |= np.uint64(1) << np.uint64(i)
        text = "".join(chr(97 + rng.next() % alphabet) for _ in range(60 + rng.next() % 100))
        ids = np.array([ord(c) - 96 for c in text], dtype=np.uint8)
        out = []
        bitap.bitap_windows_auto(mask, m, k, ids, out, damerau=True)
        hit_ends = {e for _, e in out}
        for end in range(1, len(text) + 1):
            best = min(_damerau_distance(pat, text[s:end])
                       for s in range(max(0, end - m - k), end + 1))
            if best <= k:
                assert end in hit_ends, (trial, pat, k, end)


def test_prefiltered_routes_to_device_on_large_inputs():
    """On an input the device serves, ``Prefiltered`` is the device path
    (the packed shift-AND scan fused into the DP pipeline), as in the JAX
    package."""
    jax_e, port_e = _pair(lambda b, L, P: b.fuzzy(L.new().edits(1)).case_insensitive(True)
                          .build(["needle", "pattern"]))
    hay = ("filler words here " * 40 + "nedle pattren ") * 60
    assert len(hay) >= port_e.AUTO_DEVICE_MIN
    pf = port_e.with_prefilter()
    assert pf.is_active()
    got = [_pf_key(m) for m in pf.search(hay, SearchOptions.new().with_threshold(0.8)
                                         .sorted().non_overlapping())]
    assert port_e.last_stats["backend"] == "device-fuzzy-dp"
    want = [_pf_key(m) for m in jax_e.with_prefilter().search(
        hay, JaxOptions.new().with_threshold(0.8).sorted().non_overlapping())]
    assert jax_e.last_stats["backend"].startswith("device")
    assert got == want and len(got) >= 60


def test_device_corpus_lru_holds_its_count_under_threads(monkeypatch):
    """Two threads searching different corpora at once, with a capacity that
    evicts on every insert, leave the cache's byte count equal to the bytes
    its entries hold."""
    import time

    device_corpus.clear()
    monkeypatch.setattr(device_corpus, "CAPACITY_BYTES", 3 * device_corpus.MIN_BUCKET)
    nbytes = device_corpus._nbytes

    def slow_nbytes(t):  # hands the GIL over inside every count update
        time.sleep(0.001)
        return nbytes(t)

    monkeypatch.setattr(device_corpus, "_nbytes", slow_nbytes)
    engine = FuzzyAhoCorasickBuilder.new().case_insensitive(True).device("cpu") \
        .build(["tincidunt", "phaetra"])
    engine.backend = "device"
    rng = np.random.default_rng(4)
    corpora = [[" ".join(["lorem", "tincidunt", "ipsum"][i] for i in rng.integers(0, 3, 3000))
                + f" {t}-{j}" for j in range(12)] for t in range(2)]
    want = [[len(engine.search_raw(h, 0.5)) for h in hs] for hs in corpora]
    errs = []

    def worker(t):
        try:
            for _ in range(3):
                assert [len(engine.search_raw(h, 0.5)) for h in corpora[t]] == want[t]
        except Exception as e:  # pragma: no cover
            errs.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    counted, held = device_corpus.held_bytes()
    assert counted == held > 0
    assert counted <= device_corpus.CAPACITY_BYTES
    device_corpus.clear()
    assert device_corpus.held_bytes() == (0, 0)


def test_view_cache_holds_its_caps_under_threads():
    """Eight threads look up and register views of their own haystacks at
    once (as the parallel streams' workers and producer do): no lookup
    raises, and both view caches stay within their caps."""
    from fuzzy_aho_corasick_tpu_torch.utils import graphemes

    hays = [[f"thread {t} haystack {j} " * (j + 1) for j in range(12)] for t in range(8)]
    errs = []

    def worker(t):
        try:
            for _ in range(20):
                for h in hays[t]:
                    view = view_of(h, True)
                    assert view.haystack == h
                    graphemes.register_view(view)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        graphemes.clear_registered_views()
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert len(graphemes._VIEW_LRU) <= graphemes._VIEW_LRU_MAX
