"""Streaming search and replace in the port against the JAX package: the
same seeded inputs through both packages' entry points give identical match
tuples (start, end, pattern, f32 similarity bits, edit counts, text) and
identical replaced bytes, at shards 1, 2 and 8, with windows made small in
both packages so that a 64-256 KiB input spans several windows and batches.
The port's parallel streams join windows into superwindows that its device
path (the kernels' plain torch versions on the CPU) serves; the JAX side's
small windows run its host BFS. Also the native streaming helpers (greedy
non-overlap, the table emit per window and per batch) against the Python
fallbacks and against the JAX package's library. Tolerance: exact."""

import bisect
import io

import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder as JaxBuilder
from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits
from fuzzy_aho_corasick_tpu import stream as jax_stream
from fuzzy_aho_corasick_tpu.utils import native as jax_native
from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits, SearchOptions
from fuzzy_aho_corasick_tpu_torch import stream as port_stream
from fuzzy_aho_corasick_tpu_torch.stream import _ReplaceCursor
from fuzzy_aho_corasick_tpu_torch.utils import native

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)

#: Both packages' window target in these tests (bytes).
WINDOW = 8 << 10


@pytest.fixture(autouse=True)
def small_windows(monkeypatch):
    monkeypatch.setattr(jax_stream, "DEFAULT_WINDOW", WINDOW)
    monkeypatch.setattr(port_stream, "DEFAULT_WINDOW", WINDOW)


class _Chunked:
    """A reader that hands out at most ``step`` bytes per ``read`` (so a
    window holds about ``WINDOW`` bytes, and multi-byte code points split
    across reads)."""

    def __init__(self, data: bytes, step: int = 4093):
        self.buf = io.BytesIO(data)
        self.step = step

    def read(self, n):
        return self.buf.read(min(n, self.step))


def _engines(patterns, edits=1, ci=True):
    jax_e = JaxBuilder.new().fuzzy(JaxLimits.new().edits(edits)).case_insensitive(ci).build(patterns)
    port_e = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(edits))
              .case_insensitive(ci).device("cpu").build(patterns))
    return jax_e, port_e


def _key(m):
    return (m.start, m.end, m.pattern_index, np.float32(m.similarity).view(np.uint32).item(),
            m.insertions, m.deletions, m.substitutions, m.swaps, m.edits, m.text)


def _multi_window_input(size: int, seed: int = 5) -> str:
    """Filler with ``needle`` and 1-edit variants of it at seeded places."""
    rng = np.random.default_rng(seed)
    words = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog"]
    needles = ["needle", "neeedle", "nedle", "NEEDLE", "needel", "needle!"]
    out, n = [], 0
    while n < size:
        w = needles[int(rng.integers(len(needles)))] if rng.integers(9) == 0 \
            else words[int(rng.integers(len(words)))]
        out.append(w)
        n += len(w) + 1
    return " ".join(out)


def _jax_stream(engine, data: bytes, thr: float):
    got = []
    engine.search_stream(_Chunked(data), thr, lambda m: got.append(_key(m)))
    return got


def _port_streams(engine, data: bytes, thr: float, shards=(1, 2, 8)):
    """Every port search stream over ``data``: name -> tuples in emission
    order."""
    out = {}
    got = []
    n = engine.search_stream(_Chunked(data), thr, lambda m: got.append(_key(m)))
    assert n == len(data)
    out["search_stream"] = got
    out["stream_matches"] = [_key(m) for m in engine.stream_matches(_Chunked(data), thr)]
    for s in shards:
        got = []
        engine.search_stream_parallel(_Chunked(data), thr, s, lambda m: got.append(_key(m)))
        out[f"parallel[{s}]"] = got
    return out


def test_streaming_apis_match_whole_input():
    jax_e, port_e = _engines(["needle"])
    text = _multi_window_input(160_000)
    data = text.encode()
    want = _jax_stream(jax_e, data, 0.8)
    assert len(want) > 300
    for name, got in _port_streams(port_e, data, 0.8).items():
        assert got == want, name
    # Each window resolves overlaps on its own (a match owned by one window
    # may overlap one owned by the next), so the stream is a subset of the
    # whole input's raw matches, not its resolved set.
    raw = {_key(m) for m in port_e.search_raw(text, 0.8)}
    assert set(want) <= raw
    for s, e, *_rest, mtext in want:
        assert data[s:e].decode() == mtext
    # The parallel stream's superwindows ran the port's device path.
    port_e.search_stream_parallel(_Chunked(data), 0.8, 8, lambda m: None)
    assert port_e.last_stats["backend"] == "device-fuzzy-dp"


def test_streaming_empty_input():
    jax_e = JaxBuilder.new().build(["x"])
    port_e = FuzzyAhoCorasickBuilder.new().device("cpu").build(["x"])
    for e in (jax_e, port_e):
        hits = []
        assert (e.search_stream(b"", 0.8, hits.append), hits) == (0, [])
        assert list(e.stream_matches(b"", 0.8)) == []
    out = io.BytesIO()
    assert port_e.replace_stream_parallel(b"", out, 4, 0.8, lambda m: "X") == 0


@pytest.mark.parametrize("inp", ["a needle b", "needle b", "a needle", "needle needle",
                                 "a neeedle b", "nothing here"])
def test_replace_stream_small_cases(inp):
    jax_e, port_e = _engines(["needle"])
    outs = []
    for e in (jax_e, port_e):
        out = io.BytesIO()
        n = e.replace_stream(inp.encode(), out, 0.8, lambda m: "X")
        assert n == len(out.getvalue())
        outs.append(out.getvalue())
        out = io.BytesIO()
        e.replace_stream(inp.encode(), out, 0.8, lambda m: None)
        assert out.getvalue() == inp.encode()
    assert outs[0] == outs[1]
    assert (b"X" in outs[1]) == (inp != "nothing here")


def test_replace_stream_matches_whole_input():
    jax_e, port_e = _engines(["needle", "fox"])
    text = _multi_window_input(200_000, seed=6)
    data = text.encode()
    cb = lambda m: f"<{m.pattern_index}>"
    want = io.BytesIO()
    assert jax_e.replace_stream(_Chunked(data), want, 0.8, cb) == len(want.getvalue())
    want = want.getvalue()
    assert b"<0>" in want and b"<1>" in want
    assert want.decode() == port_e.replace(text, SearchOptions.new().with_threshold(0.8), cb)
    out = io.BytesIO()
    assert port_e.replace_stream(_Chunked(data), out, 0.8, cb) == len(want)
    assert out.getvalue() == want
    for shards in (1, 2, 8):
        # The callback form and the table form (the no-objects emit lane).
        for how in (cb, ["<0>", "<1>"]):
            out = io.BytesIO()
            n = port_e.replace_stream_parallel(_Chunked(data), out, shards, 0.8, how)
            assert (n, out.getvalue()) == (len(want), want), (shards, how)


def test_replace_stream_parallel_env_switches(monkeypatch, capsys):
    """``FAC_REPLACE_WORKERS`` (two search workers, so two searches share
    the corpus cache at once), ``FAC_PRIME_DIV`` (a small first batch) and
    ``FAC_TIME`` (the stage split) change no byte, as in the JAX package."""
    jax_e, port_e = _engines(["needle", "fox"])
    data = _multi_window_input(120_000, seed=9).encode()
    want = io.BytesIO()
    jax_e.replace_stream(_Chunked(data), want, 0.8, lambda m: "<X>")
    monkeypatch.setenv("FAC_REPLACE_WORKERS", "2")
    monkeypatch.setenv("FAC_PRIME_DIV", "3")
    monkeypatch.setenv("FAC_TIME", "1")
    out = io.BytesIO()
    n = port_e.replace_stream_parallel(_Chunked(data), out, 2, 0.8, ["<X>", "<X>"])
    assert (n, out.getvalue()) == (len(want.getvalue()), want.getvalue())
    stats = port_e.last_stats
    assert stats["backend"] == "replace-stream-parallel" and stats["written"] == n
    assert all(stats[k] >= 0 for k in ("wait_ms", "post_ms", "emit_ms"))
    assert "[FAC_TIME replace] wait=" in capsys.readouterr().err


@pytest.mark.parametrize("inp,shards", [("a needle b", 8), ("needle needle", 4),
                                        ("a neeedle b", 2), ("nothing here", 4), ("", 4)])
def test_replace_stream_parallel_small_cases(inp, shards):
    jax_e, port_e = _engines(["needle"])
    outs = []
    for e in (jax_e, port_e):
        out = io.BytesIO()
        e.replace_stream_parallel(inp.encode(), out, shards, 0.8, lambda m: "X")
        outs.append(out.getvalue())
    assert outs[0] == outs[1] == inp.replace("neeedle", "X").replace("needle", "X").encode()


def test_fuzzy_replacer_replace_stream():
    pairs = [("hello", "hi"), ("world", "earth")]
    jax_r = JaxBuilder.new().case_insensitive(True).fuzzy(JaxLimits.new().edits(1)) \
        .build_replacer(pairs)
    port_r = FuzzyAhoCorasickBuilder.new().case_insensitive(True) \
        .fuzzy(FuzzyLimits.new().edits(1)).device("cpu").build_replacer(pairs)
    assert port_r.engine().patterns()[1].pattern == "world"
    text = "hell0 w0rld! " * 3000
    outs = []
    for r in (jax_r, port_r):
        out = io.BytesIO()
        r.replace_stream(b"hell0 w0rld!", out, 0.8)
        assert out.getvalue() == b"hi earth!"
        out = io.BytesIO()
        r.replace_stream(_Chunked(text.encode()), out, 0.8)
        outs.append(out.getvalue())
    assert outs[0] == outs[1] == ("hi earth! " * 3000).encode()
    opts = SearchOptions.new().with_threshold(0.8)
    assert port_r.replace(text, opts) == outs[1].decode()
    out = io.BytesIO()
    port_r.replace_stream_parallel(_Chunked(text.encode()), out, 4, 0.8)
    assert out.getvalue() == outs[1]


def test_stream_unicode_boundary():
    """Multi-byte code points split across reads must not break windows."""
    jax_e, port_e = _engines(["café"])
    text = ("x" * 100 + "café " + "ωμέγα " + "cafe ") * 300
    data = text.encode()
    want = _jax_stream(jax_e, data, 0.9)
    assert len(want) >= 300
    for name, got in _port_streams(port_e, data, 0.9, shards=(2,)).items():
        assert got == want, name
    # The same stream on the port's device path, window by window.
    port_e.backend = "device"
    assert _port_streams(port_e, data, 0.9, shards=())["search_stream"] == want


def test_stream_io_error_propagates_once():
    """Reader IO errors propagate once from the lazy iterator, then
    iteration ends (reference src/stream.rs:165-204)."""

    class FlakyReader:
        def __init__(self):
            self.calls = 0

        def read(self, n):
            self.calls += 1
            if self.calls > 2:
                raise OSError("disk on fire")
            return b"pad needle pad " * 200

    for e in _engines(["needle"]):
        it = e.stream_matches(FlakyReader(), 0.8)
        with pytest.raises(OSError, match="disk on fire"):
            for _m in it:
                pass
        assert it.errored
        assert list(it) == []
    port_e = _engines(["needle"])[1]
    with pytest.raises(OSError, match="disk on fire"):
        port_e.replace_stream_parallel(FlakyReader(), io.BytesIO(), 2, 0.8, ["X"])


def test_parallel_stream_identity_multibatch():
    """Parallel streaming equals sequential across several batches, including
    matches straddling window commits (reference src/tests.rs:1186-1237), in
    the port and against the JAX package."""
    jax_e, port_e = _engines(["needle"])
    data = _multi_window_input(240_000, seed=8).encode()
    want = _jax_stream(jax_e, data, 0.8)
    port_e.backend = "device"
    streams = _port_streams(port_e, data, 0.8)
    for name, got in streams.items():
        assert got == want, name
    out_seq = io.BytesIO()
    jax_e.replace_stream(_Chunked(data), out_seq, 0.8, lambda m: "<X>")
    for shards in (1, 2, 8):
        out_par = io.BytesIO()
        n = port_e.replace_stream_parallel(_Chunked(data), out_par, shards, 0.8,
                                           lambda m: "<X>")
        assert out_par.getvalue() == out_seq.getvalue()
        assert n == len(out_par.getvalue())


def test_parallel_stream_batches_under_resident_max(monkeypatch):
    """``search_stream_parallel`` joins at most the windows one
    ``search_raw`` may take (``stream._windows_per_search``, from
    ``packed_bitap.RESIDENT_MAX``): with ``RESIDENT_MAX`` lowered to two
    windows' worth, 8 shards over 20 windows run in batches of two, and the
    stream equals the JAX package's stream at the same windows (its
    ``search_stream``, which its ``search_stream_parallel`` equals)."""
    from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb

    jax_e, port_e = _engines(["needle", "haystack"])
    data = _multi_window_input(170_000, seed=9).encode()
    sep = port_e.max_match_graphemes() + 1
    monkeypatch.setattr(tpb, "RESIDENT_MAX", 2 * (WINDOW + port_stream.READ_MIN + sep))
    assert port_stream._windows_per_search(WINDOW, sep) == 2
    want = _jax_stream(jax_e, data, 0.8)
    texts = []
    search_raw = port_e.search_raw
    port_e.search_raw = lambda text, thr: texts.append(text) or search_raw(text, thr)
    port_e.backend = "device"
    got = []
    n = port_e.search_stream_parallel(_Chunked(data), 0.8, 8, lambda m: got.append(_key(m)))
    assert n == len(data)
    assert got == want and len(want) > 100
    windows = len(data) // WINDOW
    assert len(texts) >= windows // 2 >= 8
    assert all(len(t) <= tpb.RESIDENT_MAX for t in texts)


def test_parallel_stream_separator_isolation():
    """Patterns containing control chars must not break the batched-window
    separator (a different dead char is chosen automatically)."""
    jax_e = JaxBuilder.new().fuzzy(JaxLimits.new().edits(1)).build(["a\x00b", "needle"])
    port_e = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1)).device("cpu")
              .build(["a\x00b", "needle"]))
    data = (("pad " * 50 + "a\x00b " + "pad " * 50 + "nedle ") * 160).encode()
    want = _jax_stream(jax_e, data, 0.7)
    assert len(want) >= 300
    for s in (2, 4):
        got = []
        port_e.search_stream_parallel(_Chunked(data), 0.7, s, lambda m: got.append(_key(m)))
        assert got == want
    assert port_stream._separator_char(port_e) == "\x01"


def _lib():
    """The port's native library; it must load wherever ``gcc`` is found."""
    import shutil

    if shutil.which("gcc") is None:
        pytest.skip("no gcc on this host: the native helpers are not built")
    L = native.lib()
    assert L is not None, native.build_error()
    return L


def _greedy_ref(s, e):
    """The bisect-loop fallback of stream._post_replace_batch (one window:
    global coordinates are window coordinates)."""
    keep = np.zeros(len(s), dtype=bool)
    starts, ends = [], []
    for r in range(len(s)):
        ss, ee = int(s[r]), int(e[r])
        p = bisect.bisect_left(starts, ss)
        if (p == 0 or ends[p - 1] <= ss) and (p == len(starts) or starts[p] >= ee):
            starts.insert(p, ss)
            ends.insert(p, ee)
            keep[r] = True
    return keep


def test_greedy_nonoverlap_matches_bisect_fallback():
    _lib()
    rng = np.random.default_rng(3)
    for _trial in range(50):
        n = int(rng.integers(1, 200))
        span = int(rng.integers(50, 2000))
        s = rng.integers(0, span - 1, size=n).astype(np.int64)
        e = np.minimum(s + rng.integers(1, 30, size=n).astype(np.int64), span)
        keep = native.greedy_nonoverlap(s, e, span)
        np.testing.assert_array_equal(keep, _greedy_ref(s, e))
        if jax_native.lib() is not None:
            np.testing.assert_array_equal(keep, jax_native.greedy_nonoverlap(s, e, span))


def test_greedy_touching_intervals_do_not_clash():
    _lib()
    # Half-open spans: e1 == s2 is not an overlap (reference src/matches.rs:97-103).
    keep = native.greedy_nonoverlap(np.array([0, 5, 10], np.int64),
                                    np.array([5, 10, 15], np.int64), 20)
    assert keep.all()


def _emit(cursor_emitted, table, data, commit, sb, eb, pat, rt=None, cursor_cls=_ReplaceCursor):
    out = io.BytesIO()
    c = cursor_cls()
    c.emitted = cursor_emitted
    c.emit_window_table(out, table, 0, data, commit, sb, eb, pat, rt=rt)
    return out.getvalue(), c.emitted, c.written


def test_replace_emit_table_matches_python_cursor():
    _lib()
    rng = np.random.default_rng(11)
    table = [b"<x>", None, b"", b"LONGREPLACEMENT"]
    rt = native.ReplacementTable(table)
    checked = 0
    for _trial in range(40):
        nb = int(rng.integers(40, 400))
        data = bytes(rng.integers(97, 123, size=nb, dtype=np.uint8))
        commit = int(rng.integers(nb // 2, nb + 1))
        # Sorted non-overlapping spans with random pattern ids (some past the
        # table's length: keep the original).
        cuts = np.sort(rng.choice(nb, size=min(nb, 12), replace=False))
        spans = [(int(cuts[i]), int(cuts[i + 1])) for i in range(0, len(cuts) - 1, 2)
                 if cuts[i + 1] <= commit + 5]
        if not spans:
            continue
        sb = np.array([a for a, _ in spans], dtype=np.int64)
        eb = np.array([b for _, b in spans], dtype=np.int64)
        pat = rng.integers(0, 6, size=len(spans)).astype(np.int32)
        start_cur = int(rng.integers(0, 3))  # an earlier window got here
        py = _emit(start_cur, table, data, commit, sb, eb, pat)
        c = _emit(start_cur, table, data, commit, sb, eb, pat, rt=rt)
        jx = _emit(start_cur, table, data, commit, sb, eb, pat,
                   rt=jax_native.ReplacementTable(table), cursor_cls=jax_stream._ReplaceCursor)
        assert c == py == jx, (spans, pat)
        checked += 1
    assert checked > 20


def test_replace_emit_table_overhang_past_commit_capacity():
    """A keep-original match may end far past commit (ownership only needs
    start < commit): the output outgrows (commit - cur) + n * max_len + 1."""
    _lib()
    table = [None, None]
    rt = native.ReplacementTable(table)
    assert rt.max_len == 0
    data = bytes(range(48, 48 + 64)) * 4
    sb, eb, pat = (np.array([90], np.int64), np.array([220], np.int64), np.array([0], np.int32))
    out, new_cur = native.replace_emit_table(data, 0, 100, sb, eb, pat, rt)
    assert (bytes(out), new_cur) == (data[:220], 220)
    assert _emit(0, table, data, 100, sb, eb, pat, rt=rt) == \
        _emit(0, table, data, 100, sb, eb, pat) == (data[:220], 220, 220)


def test_replace_emit_batch_matches_per_window_emit():
    """The whole-batch C emit is byte-identical to the per-window emits,
    including a keep-original match overhanging its window's commit into the
    next window (the cross-window cursor rule)."""
    _lib()
    rng = np.random.default_rng(29)
    table = [b"<x>", None, b"", b"LONGREPLACEMENT"]
    rt = native.ReplacementTable(table)
    for trial in range(30):
        nwin = int(rng.integers(1, 6))
        doff, base, commit, datas, rows = [], [], [], [], []
        pos_abs = off = 0
        for _w in range(nwin):
            nb = int(rng.integers(60, 300))
            cm = int(rng.integers(nb // 2, nb + 1))
            datas.append(bytes(rng.integers(97, 123, size=nb, dtype=np.uint8)))
            doff.append(off)
            base.append(pos_abs)
            commit.append(cm)
            cuts = np.sort(rng.choice(nb, size=min(nb, 10), replace=False))
            spans = [(int(cuts[i]), int(cuts[i + 1])) for i in range(0, len(cuts) - 1, 2)
                     if cuts[i] < cm]
            rows.append((spans, rng.integers(0, 6, size=len(spans)).astype(np.int32)))
            off += nb + 3  # the separator gap
            pos_abs += cm
        data = b"".join(d + b"\0\0\0" for d in datas)
        ref = io.BytesIO()
        cursor = _ReplaceCursor()
        for w in range(nwin):
            spans, pats = rows[w]
            cursor.emit_window_table(ref, table, base[w], datas[w], commit[w],
                                     np.array([a for a, _ in spans], np.int64),
                                     np.array([b for _, b in spans], np.int64), pats, rt=rt)
        flat = [(a, b, p, w) for w in range(nwin) for (a, b), p in zip(*rows[w])]
        cols = [np.array([r[i] for r in flat], dt)
                for i, dt in enumerate((np.int64, np.int64, np.int32, np.int32))]
        mv, emitted = native.replace_emit_batch(data, 0, doff, base, commit, *cols, rt)
        assert (bytes(mv), emitted) == (ref.getvalue(), cursor.emitted), trial


def test_greedy_nonoverlap_declines_zero_length_rows():
    # Zero-length rows diverge between the C occupancy pass and the bisect
    # fallback; the wrapper routes them to the fallback (returns None).
    _lib()
    assert native.greedy_nonoverlap(np.array([5, 0], np.int64),
                                    np.array([5, 10], np.int64), 20) is None
