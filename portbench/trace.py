"""The traced run's window: the profiler over a fixed number of searches,
the layer spans the harness puts around the port's functions, the port's
launch counters and ``FAC_TIME=1`` stage times, and their reduction to a
``Trace`` that the per-layer readers (``metrics/<name>.py``) read.

The spans are the harness's own (``spans.json``): each names a function of
the port, which is wrapped, for the traced run only, in a profiler range
``stage:<stage>``. The port records no spans of its own yet.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import stats

#: Searches one traced run profiles (fewer where ``--seconds`` runs out).
TRACE_SEARCHES = 24
#: Device operations that count as busy.
BUSY = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def layer_spans(span_list):
    saved = []
    try:
        for sp in span_list:
            mod = importlib.import_module(sp["module"])
            fn = getattr(mod, sp["attr"])

            def wrapped(*a, _fn=fn, _name="stage:" + sp["stage"], **k):
                with torch.profiler.record_function(_name):
                    return _fn(*a, **k)

            setattr(mod, sp["attr"], wrapped)
            saved.append((mod, sp["attr"], fn))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


@contextlib.contextmanager
def scan_log(log, current):
    """Records the tables of every scan launch: (search, table id, W, k,
    Damerau, wide)."""
    from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as pb

    fn = pb.scan_bits

    def wrapped(ids, T, halo, chunk=None):
        out = fn(ids, T, halo, chunk)
        log.append({"search": current[0], "table": id(T), "W": T.W, "k": T.k,
                    "damerau": T.notlast is not None, "wide": pb._wide(T)})
        return out

    pb.scan_bits = wrapped
    try:
        yield
    finally:
        pb.scan_bits = fn


def traced_window(engine, text: str, thr: float, seconds: float, span_list, workdir: Path):
    from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as pb

    os.environ["FAC_TIME"] = "1"
    run_stats, calls, current, outputs = [], [], [0], []
    before = dict(pb.LAUNCHES)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with layer_spans(span_list), scan_log(calls, current), \
            torch.profiler.profile(activities=acts) as prof:
        deadline = time.perf_counter() + seconds
        while len(run_stats) < TRACE_SEARCHES and (not run_stats or time.perf_counter() < deadline):
            current[0] = len(run_stats)
            with torch.profiler.record_function("search"):
                out = engine.search_raw(text, thr)
            run_stats.append(dict(engine.last_stats))
            outputs.append(out)
        torch.cuda.synchronize()
    os.environ.pop("FAC_TIME", None)
    launches = {k: pb.LAUNCHES[k] - before.get(k, 0) for k in pb.LAUNCHES}
    path = workdir / f"trace-{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink()
    return reduce(events, run_stats, calls, launches, len(text.encode())), outputs


def reduce(events, run_stats, calls, launches, corpus_bytes: int):
    """The ``Trace`` of a traced window from the profiler's chrome-trace
    events (``ts`` and ``dur`` in us)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    searches = [(e["ts"], e["ts"] + e["dur"]) for e in xs
                if e.get("cat") == "user_annotation" and e["name"] == "search"]
    stages = [(e["ts"], e["ts"] + e["dur"], e["name"][len("stage:"):]) for e in xs
              if e.get("cat") == "user_annotation" and e["name"].startswith("stage:")]
    busy = [(e["ts"], e["ts"] + e["dur"]) for e in xs if e.get("cat") in BUSY]
    kernels = [(e["name"], e["dur"] * 1e-6) for e in xs if e.get("cat") == "kernel"]
    ops = {}
    for e in xs:
        if e.get("cat") in BUSY:
            name = e["name"].replace("(anonymous namespace)::", "").replace("void ", "", 1)
            name = name.split("(")[0].strip()
            ops[name] = ops.get(name, 0.0) + e["dur"] * 1e-6
    lo, hi = min(a for a, _ in searches), max(b for _, b in searches)
    # Each idle stretch, cut where a span begins or ends, is named by the
    # innermost span the host was in.
    cuts = sorted({x for s in stages for x in s[:2]} | {x for s in searches for x in s})
    idle = {}
    for a, b in stats.gaps(busy, lo, hi):
        edges = [a] + [x for x in cuts if a < x < b] + [b]
        for p, q in zip(edges, edges[1:]):
            mid = (p + q) / 2
            inside = [s for s in stages if s[0] <= mid < s[1]]
            if inside:
                name = min(inside, key=lambda s: s[1] - s[0])[2]
            elif any(s <= mid < e for s, e in searches):
                name = "search_other_host"
            else:
                name = "between_searches"
            idle[name] = idle.get(name, 0.0) + (q - p) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return SimpleNamespace(
        searches=len(run_stats), window_s=(hi - lo) * 1e-6,
        busy_s=stats.union_s(busy, lo, hi) * 1e-6, kernels=kernels, launches=launches,
        stats=run_stats, scan_calls=calls, corpus_bytes=corpus_bytes,
        breakdown={"device_ops": top(ops), "idle_gaps": top(idle)})
