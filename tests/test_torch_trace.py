"""The spans and wait counters of the device search path (``utils/trace``),
on the CPU (the kernels' plain versions): without ``FAC_TIME=1`` no span is
recorded but ``host_waits`` is counted; with it the spans form one tree
under ``search``, each child inside its parent, a ``hit_list`` and a
``step`` a chunk or slice, ``host_waits`` the count of ``host_wait``
spans, and the stage keys their spans' durations; under ``torch.profiler``
each span is a ``fac:`` range inside the caller's."""

import json
import threading

import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits
from fuzzy_aho_corasick_tpu_torch.ops import many, verify_dp
from fuzzy_aho_corasick_tpu_torch.utils import trace

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)

WORDS = ["tincidunt", "phaetra", "sollicitudin", "venenatis", "fringilla", "malesuada"]
LETTERS = "abcdefghijklmnopqrstuvwxyz"
STAGE_KEYS = {"dispatch_ms", "readback_ms", "decode_ms", "result_buf_kib"}
TRACE_KEYS = {"spans", "search_id", "prepare_us", "host_wait_us"}


def _many_words(count: int):
    rng = np.random.default_rng(7)
    return sorted({"".join(LETTERS[i] for i in rng.integers(0, 26, int(m)))
                   for m in rng.integers(6, 12, count)})


def _text(words, seed: int, chars: int) -> str:
    rng = np.random.default_rng(seed)
    out = []
    while sum(map(len, out)) + len(out) < chars:
        w = words[int(rng.integers(len(words)))] if rng.integers(5) == 0 else "lorem"
        if len(w) > 5 and rng.integers(2):
            at = int(rng.integers(1, len(w) - 1))
            w = w[:at] + "x" + w[at + 1:]
        out.append(w)
    return " ".join(out)[:chars]


#: case -> (dictionary, builder step, threshold, backend, module patches,
#: the last_stats key that counts the hit_list and step spans)
CASES = {
    "exact": (WORDS, lambda b: b, 0.5, "device-exact-packed", {}, None),
    "dp": (WORDS, lambda b: b.fuzzy(FuzzyLimits.new().edits(1)), 0.8, "device-fuzzy-dp", {},
           "slices"),
    "dp-sliced": (WORDS, lambda b: b.fuzzy(FuzzyLimits.new().edits(1)), 0.8, "device-fuzzy-dp",
                  {(verify_dp, "SLICE_SYMS"): 2048}, "slices"),
    "mapped": (["summer", "hammer", "lorem"],
               lambda b: b.fuzzy(FuzzyLimits.new().edits(1)).mapping("m", "rn"), 0.8,
               "device-fuzzy-dp-mapped", {(verify_dp, "SLICE_SYMS"): 4096}, "slices"),
    "many": (_many_words(120), lambda b: b.fuzzy(FuzzyLimits.new().edits(1)), 0.82,
             "device-fuzzy-many", {}, "chunks"),
    "many-chunks": (_many_words(300), lambda b: b.fuzzy(FuzzyLimits.new().edits(1)), 0.82,
                    "device-fuzzy-many", {(many, "FOLD"): False}, "chunks"),
}


def _run(case, monkeypatch, timed: bool):
    words, step, thr, backend, patches, _ = CASES[case]
    for (mod, name), value in patches.items():
        monkeypatch.setattr(mod, name, value)
    engine = step(FuzzyAhoCorasickBuilder.new().device("cpu")).build(words)
    engine.backend = "device"
    text = _text(words, 3, 8000)
    if timed:
        monkeypatch.setenv("FAC_TIME", "1")
    else:
        monkeypatch.delenv("FAC_TIME", raising=False)
    got = [(m.pattern_index, m.start, m.end, np.float32(m.similarity).item(), m.insertions,
            m.deletions, m.substitutions, m.swaps) for m in engine.search_raw(text, thr)]
    stats = dict(engine.last_stats)
    assert stats["backend"] == backend and len(got) > 20
    return got, stats


@pytest.mark.parametrize("case", list(CASES))
def test_switch_off_counts_waits_and_records_no_span(case, monkeypatch, capsys):
    plain, stats = _run(case, monkeypatch, timed=False)
    assert not (STAGE_KEYS | TRACE_KEYS) & set(stats)
    assert isinstance(stats["host_waits"], int) and stats["host_waits"] >= 2
    timed, stats_t = _run(case, monkeypatch, timed=True)
    assert timed == plain and stats_t["host_waits"] == stats["host_waits"]
    out = capsys.readouterr()
    assert out.out + out.err == ""


@pytest.mark.parametrize("case", list(CASES))
def test_spans_form_one_tree(case, monkeypatch):
    _, stats = _run(case, monkeypatch, timed=True)
    spans = stats["spans"]
    root = spans[0]
    assert root[0] == "search" and root[1] == -1 and root[4]["lane"] == stats["backend"]
    assert isinstance(stats["search_id"], int)
    for i, (name, parent, t0, t1, attrs) in enumerate(spans[1:], 1):
        assert 0 <= parent < i, name
        assert spans[parent][2] <= t0 <= t1 <= spans[parent][3], name
    # The root's children tile it but for the lane's few lines between them.
    kids = sum(s[3] - s[2] for s in spans if s[1] == 0)
    assert kids >= 0.9 * (root[3] - root[2])
    per = CASES[case][-1]
    for name in ("hit_list", "step"):
        got = [s[4] for s in spans if s[0] == name]
        assert [a["slice"] for a in got] == list(range(stats[per] if per else 1))
        assert all(s[1] == 0 for s in spans if s[0] == name)
    hits = [s[4]["hits"] for s in spans if s[0] == "hit_list"]
    if per:
        assert sum(hits) == stats["hits"]
        assert sum(s[4]["candidates"] for s in spans if s[0] == "step") == stats["candidates"]
        assert sum(s[4]["rows"] for s in spans if s[0] == "step") == stats["emissions"]
    waits = [s for s in spans if s[0] == "host_wait"]
    assert stats["host_waits"] == len(waits)
    assert {s[4]["what"] for s in waits} >= {"hit_count", "rows"}
    assert stats["host_wait_us"] == sum(s[3] - s[2] for s in waits) / 1e3
    (prepare,) = [s for s in spans if s[0] == "prepare"]
    assert prepare[1] == 0 and stats["prepare_us"] == (prepare[3] - prepare[2]) / 1e3
    first = min(s[2] for s in spans if s[0] in ("hit_list", "step"))
    assert prepare[3] <= first
    assert all(s[1] == spans.index(prepare) for s in spans if s[0] == "residency")
    if per is None:
        assert not STAGE_KEYS & set(stats)
        return
    # The stage keys: their spans' durations, rounded to 0.1 ms as before.
    ms = lambda ns: round(ns / 1e6, 1)
    (sync,) = [s for s in spans if s[0] == "timing_sync"]
    (decode,) = [s for s in spans if s[0] == "decode"]
    assert stats["dispatch_ms"] == ms(sync[3] - first)
    assert stats["readback_ms"] == ms(sum(s[3] - s[2] for s in waits
                                          if s[4]["what"] == "rows"))
    assert stats["decode_ms"] == ms(decode[3] - decode[2])
    assert stats["result_buf_kib"] == sum(s[4]["bytes"] for s in waits
                                          if s[4]["what"] == "rows") >> 10
    assert [s[0] for s in spans if s[1] == spans.index(decode)] == [
        "decode:filter", "decode:sort", "decode:offsets", "decode:build"]


@pytest.mark.parametrize("timed", [True, False], ids=["on", "off"])
def test_profiler_ranges(timed, monkeypatch, tmp_path):
    """Under the CPU profiler a traced search's spans are ``fac:`` ranges
    (``user_annotation``), each inside the caller's ``search`` range; an
    untraced one makes none."""
    engine = FuzzyAhoCorasickBuilder.new().device("cpu").fuzzy(
        FuzzyLimits.new().edits(1)).build(WORDS)
    engine.backend = "device"
    text = _text(WORDS, 4, 6000)
    if timed:
        monkeypatch.setenv("FAC_TIME", "1")
    else:
        monkeypatch.delenv("FAC_TIME", raising=False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("search"):
            engine.search_raw(text, 0.8)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (outer,) = [e for e in events if e["name"] == "search"]
    fac = [e for e in events if e["name"].startswith("fac:")]
    if not timed:
        assert fac == [] and "spans" not in engine.last_stats
        return
    spans = engine.last_stats["spans"]
    assert sorted(e["name"] for e in fac) == sorted("fac:" + s[0] for s in spans)
    for e in fac:
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    (root,) = [e for e in fac if e["name"] == "fac:search"]
    assert all(root["ts"] <= e["ts"] <= e["ts"] + e["dur"] <= root["ts"] + root["dur"]
               for e in fac)


def test_span_sites_outside_a_search():
    """Outside a search every site is the shared null context and costs no
    state but the wait count; a nested root records nothing of its own."""
    assert trace.span("step") is trace.NULL and not trace.NULL
    before = trace._TLS.waits
    with trace.wait("rows", 8) as w:
        assert w is trace.NULL
    assert trace._TLS.waits == before + 1
    trace.launch()
    trace.timing_sync("cpu")
    assert trace.mark() == 0 and trace.stage_stats(0, []) == {}


def test_evented_spans_time_their_launches(monkeypatch):
    """Under the profiler a ``timed`` block on a CUDA device records an
    event pair on the device's stream, and ``device_ms`` of the span it sits
    in is the stream's time between them; a span without one, a block on
    another device or outside the profiler, or a pair whose end has not
    completed, gives none."""
    clock = iter(range(0, 1000, 10))

    class Event:
        def __init__(self, enable_timing=False):
            self.t, self.done = None, True

        def record(self, stream):
            assert stream == ("stream", cuda)
            self.t = next(clock)

        def query(self):
            return self.done

        def elapsed_time(self, other):
            return float(other.t - self.t)

    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(trace.torch.cuda, "Event", Event)
    monkeypatch.setattr(trace.torch.cuda, "current_stream", lambda dev: ("stream", dev))
    rec = trace._Recorder(1, profile=True)
    monkeypatch.setattr(trace._TLS, "rec", rec)
    with trace.span("hit_list"):
        with trace.timed(cuda):                         # events at 0 and 10
            pass
        with trace.wait("hit_count"):
            assert trace.timed(torch.device("cpu")) is trace.NULL
    with trace.span("step"):
        pass
    with trace.span("hit_list"):
        with trace.timed(cuda):                         # events at 20 and 30
            pass
    hits, wait, step, late = 0, 1, 2, 3
    rec.events[late][1].done = False
    rec.device_times()
    assert rec.spans[hits][4] == {"slice": 0, "device_ms": 10.0}
    assert rec.spans[wait][4] == {"what": "hit_count"}
    assert rec.spans[step][4] == {"slice": 0} and rec.spans[late][4] == {"slice": 1}
    assert rec.events == {}
    monkeypatch.setattr(trace._TLS, "rec", trace._Recorder(2, profile=False))
    assert trace.timed(cuda) is trace.NULL


def test_each_thread_traces_its_own_search(monkeypatch):
    monkeypatch.setenv("FAC_TIME", "1")
    engines = [FuzzyAhoCorasickBuilder.new().device("cpu").fuzzy(
        FuzzyLimits.new().edits(1)).build(WORDS) for _ in range(2)]
    texts = [_text(WORDS, s, 5000) for s in (5, 6)]
    for e in engines:
        e.backend = "device"
    out = [None, None]

    def go(i):
        for _ in range(3):
            engines[i].search_raw(texts[i], 0.8)
        out[i] = engines[i].last_stats

    threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out[0]["search_id"] != out[1]["search_id"]
    for stats in out:
        spans = stats["spans"]
        assert [s[1] for s in spans].count(-1) == 1
        assert stats["host_waits"] == sum(s[0] == "host_wait" for s in spans)
    assert trace._TLS.rec is None
