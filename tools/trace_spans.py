#!/usr/bin/env python3
"""Where a search's time goes, by the port's own spans (``utils/trace``),
for one cell of ``BENCHMARK.json`` on one CUDA card:

    python tools/trace_spans.py --workload <cell> --seed <n> [--searches 24]
        [--out <file.json>]

Set-up as ``portbench/run.py``'s (the cell's dictionary and corpus from the
seed, the engine, the upload, two warm-up searches); then ``--searches``
untraced searches (their wall), and as many with ``FAC_TIME=1`` under
``torch.profiler``, each inside a ``search`` range, as the benchmark's
traced run makes them (after one more, left out: the profiler's first range
costs it ms). From the spans in ``last_stats``: each span's host time a
search, self time (its own, less its children's), and how much of the root
the root's children cover. From the profiler's chrome trace: the card's
idle time in the ``search`` ranges, each idle stretch put down to the
innermost ``fac:`` range the host was in (``outside`` where it was in
none); each kernel's device time put down to the span its launch was made
in; and the scan side of the hit lists (the kernels launched in a
``hit_list`` range before its count's read) beside the ``hit_list`` spans'
CUDA-event ``device_ms``, which time the same launches.

The report is one JSON object (``--out``, and the last line of standard
output). No JAX module is imported.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Device operations that count as busy.
BUSY = ("kernel", "gpu_memcpy", "gpu_memset")


def setup(name: str, seed: int):
    import torch

    from fuzzy_aho_corasick_tpu_torch.ops import _cuda_build
    from portbench import manifest, run, traffic

    torch.cuda.init()
    _cuda_build.load()
    man = manifest.Manifest(ROOT)
    cell = man.cell(name)
    config = man.config(cell["config"])
    words = traffic.dictionary(config, seed)
    text = traffic.text(man.traffic(cell["traffic"]), words, seed)
    engine = run.build_engine(config, words, "cuda")
    for _ in range(2):
        engine.search_raw(text, config["threshold"])
    torch.cuda.synchronize()
    return engine, text, config["threshold"]


def traced(engine, text, thr, searches: int):
    """(per-search stats, host walls s, chrome-trace events) of ``searches``
    traced searches under the profiler."""
    import torch

    os.environ["FAC_TIME"] = "1"
    stats, walls, outputs = [], [], []
    try:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(searches + 1):
                t = time.perf_counter()
                with torch.profiler.record_function("search"):
                    out = engine.search_raw(text, thr)
                walls.append(time.perf_counter() - t)
                stats.append(dict(engine.last_stats))
                # Kept, as the benchmark keeps them: a result freed inside
                # the next ``search`` range would be host time of no span.
                outputs.append(out)
            torch.cuda.synchronize()
    finally:
        os.environ.pop("FAC_TIME", None)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    # The first search of a profile also pays the profiler's first range.
    return stats[1:], walls[1:], events


def host_by_span(stats) -> dict:
    """Mean host ms a search by span name, self time, and the share of the
    root that its children cover."""
    self_ms, total_ms, cover = {}, {}, []
    for s in stats:
        spans = s["spans"]
        child = [0] * len(spans)
        for name, parent, t0, t1, _ in spans:
            if parent >= 0:
                child[parent] += t1 - t0
        for i, (name, parent, t0, t1, _) in enumerate(spans):
            self_ms[name] = self_ms.get(name, 0.0) + (t1 - t0 - child[i]) / 1e6
            total_ms[name] = total_ms.get(name, 0.0) + (t1 - t0) / 1e6
        root = spans[0][3] - spans[0][2]
        cover.append(child[0] / root)
    n = len(stats)
    return {"self_ms": {k: v / n for k, v in sorted(self_ms.items(), key=lambda kv: -kv[1])},
            "total_ms": {k: v / n for k, v in total_ms.items()},
            "children_cover_root": [min(cover), statistics.median(cover)]}


def innermost(ranges, t):
    inside = [r for r in ranges if r[0] <= t < r[1]]
    return min(inside, key=lambda r: r[1] - r[0])[2] if inside else None


def device_by_span(events, stats) -> dict:
    """Idle ms a search by innermost ``fac:`` range; device ms a search by
    the span of each kernel's launch (the profiler's clock); and the hit
    lists' scan side, by the profiler and by the ``hit_list`` spans' event
    pairs."""
    from portbench import stats as st

    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ann = [e for e in xs if e.get("cat") == "user_annotation"]
    searches = sorted((e["ts"], e["ts"] + e["dur"]) for e in ann if e["name"] == "search")[1:]
    fac = [(e["ts"], e["ts"] + e["dur"], e["name"][4:]) for e in ann
           if e["name"].startswith("fac:")]
    busy = [(e["ts"], e["ts"] + e["dur"]) for e in xs if e.get("cat") in BUSY]
    n = len(searches)
    cuts = sorted({x for r in fac for x in r[:2]})
    idle, window_ms, busy_ms = {}, 0.0, 0.0
    for lo, hi in searches:
        window_ms += (hi - lo) / 1e3
        busy_ms += st.union_s(busy, lo, hi) / 1e3
        for a, b in st.gaps(busy, lo, hi):
            edges = [a] + [x for x in cuts if a < x < b] + [b]
            for p, q in zip(edges, edges[1:]):
                name = innermost(fac, (p + q) / 2) or "outside"
                idle[name] = idle.get(name, 0.0) + (q - p) / 1e3
    # Each hit list's scan side: from the range's start to its first wait.
    hit_lists = [(lo, hi) for lo, hi, name in fac if name == "hit_list"]
    waits = [lo for lo, _, name in fac if name == "host_wait"]
    scan_side = [(lo, min([w for w in waits if lo <= w < hi], default=hi)) for lo, hi in hit_lists
                 if any(a <= lo < b for a, b in searches)]
    launch_at = {e["args"]["correlation"]: e["ts"] for e in xs
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    dev, scan_ms = {}, 0.0
    for e in xs:
        if e.get("cat") not in BUSY:
            continue
        at = launch_at.get(e.get("args", {}).get("correlation"), e["ts"])
        if not any(lo <= at < hi for lo, hi in searches):
            continue
        key = innermost(fac, at) or "outside"
        dev[key] = dev.get(key, 0.0) + e["dur"] / 1e3
        if any(lo <= at < w for lo, w in scan_side):
            scan_ms += e["dur"] / 1e3
    evented = [a["device_ms"] for s in stats for name, _, _, _, a in s["spans"]
               if name == "hit_list" and "device_ms" in a]
    per = lambda d: {k: v / n for k, v in sorted(d.items(), key=lambda kv: -kv[1])}
    return {"searches_in_trace": n, "window_ms": window_ms / n, "busy_ms": busy_ms / n,
            "idle_ms_by_innermost_span": per(idle),
            "profiler_device_ms_by_launch_span": per(dev),
            "scan_side_ms": {"profiler": scan_ms / n, "events": sum(evented) / len(stats),
                             "hit_lists": len(scan_side) / n, "evented": len(evented) / len(stats)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--searches", type=int, default=24)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    engine, text, thr = setup(args.workload, args.seed)
    report = {"workload": args.workload, "seed": args.seed, "card": torch.cuda.get_device_name(0)}
    untraced = []
    for _ in range(args.searches):
        t = time.perf_counter()
        engine.search_raw(text, thr)
        untraced.append((time.perf_counter() - t) * 1e3)
    stats, walls, events = traced(engine, text, thr, args.searches)
    report["wall_ms"] = {"untraced_median": statistics.median(untraced),
                         "traced_median": statistics.median(walls) * 1e3}
    keys = ("host_waits", "prepare_us", "host_wait_us", "dispatch_ms", "decode_ms")
    report["stats_median"] = {k: statistics.median(s[k] for s in stats) for k in keys
                              if all(k in s for s in stats)}
    report["host"] = host_by_span(stats)
    report["device"] = device_by_span(events, stats)
    line = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
