"""Runs one cell of ``BENCHMARK.json`` once, on the card:

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): the port's
import and kernel load, the cell's dictionary and text from ``--seed``, the
engine, the corpus's upload and two warm-up searches. The window: one
client calls ``engine.search_raw(text, threshold)`` back to back (a closed
loop) over a corpus that stays resident on the device, for ``--seconds``;
the host clock around each call covers the whole search, its match list on
the host. With ``--trace 1`` the window is profiled instead (``trace.py``)
and the per-layer metrics are reported.

Once the window has closed and the port's state is freed, a sample of the
window's outputs, drawn from the seed, is compared match for match with
the plain reference (``reference.py``, run on the same card), and the
match count of every search with the reference's. The last line of
standard output is the result's JSON; the numbers compared, each with its
limit, are the last lines of standard error and the result's last key.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import compare, manifest, reference, stats, traffic  # noqa: E402

#: Top-level modules that no process of the benchmark may hold: JAX and the
#: JAX package (whose name the port's begins with: names compare whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "fuzzy_aho_corasick_tpu")
#: Window outputs compared in whole with the reference.
SAMPLE = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (``sys.modules``)."""
    names = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def build_engine(config: dict, words: list, device):
    from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits

    b = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(config["limits"]["edits"]))
         .case_insensitive(config["case_insensitive"]).device(device))
    for a, c, score in config["mappings"]:
        b = b.mapping_scored(a, c, score)
    engine = b.build(words)
    engine.backend = "device"
    return engine


def problem_of(config: dict, words: list):
    return reference.Problem(words, config["limits"]["edits"], config["threshold"],
                             [tuple(m) for m in config["mappings"]], config["case_insensitive"])


def window(engine, text: str, thr: float, seconds: float, rng):
    """The closed loop: (latencies s, first start, last end, match counts,
    {search index: output} of a reservoir sample of ``SAMPLE``)."""
    lat, counts, kept = [], [], {}
    first = time.perf_counter()
    deadline = first + seconds
    end = first
    while not lat or end < deadline:
        t = time.perf_counter()
        out = engine.search_raw(text, thr)
        end = time.perf_counter()
        lat.append(end - t)
        counts.append(len(out))
        i = len(lat) - 1
        if i < SAMPLE:
            kept[i] = out
        else:
            j = int(rng.integers(0, i + 1))
            if j < SAMPLE:
                del kept[sorted(kept)[j]]
                kept[i] = out
        del out
    return lat, first, end, counts, kept


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"
    return out.splitlines()[0] if out else "not measured"


def run_cell(man, name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             scale: float = 1.0, t0: float = T0) -> dict:
    """One run of cell ``name``; returns the result's JSON object.
    ``device="cpu"`` and ``scale`` are for the CPU tests (the port's plain
    versions, a smaller text)."""
    import numpy as np
    import torch

    from fuzzy_aho_corasick_tpu_torch.utils import device_corpus

    seed = int(seed) % (1 << 64)
    marks = [("import", time.perf_counter())]
    if device == "cuda":
        from fuzzy_aho_corasick_tpu_torch.ops import _cuda_build

        torch.cuda.init()
        _cuda_build.load()
        marks.append(("kernels", time.perf_counter()))
    cell = man.cell(name)
    config = man.config(cell["config"])
    mix = man.traffic(cell["traffic"])
    thr = config["threshold"]
    words = traffic.dictionary(config, seed)
    text = traffic.text(mix, words, seed, scale)
    nbytes = len(text.encode())
    marks.append(("inputs", time.perf_counter()))
    engine = build_engine(config, words, device)
    marks.append(("engine", time.perf_counter()))
    for _ in range(2):
        warm = engine.search_raw(text, thr)
    lane = engine.last_stats.get("backend")
    if lane != config["lane"]:
        raise RuntimeError(f"{name}: the search ran lane {lane!r}, the configuration's is "
                           f"{config['lane']!r}")
    if device == "cuda":
        torch.cuda.synchronize()
    marks.append(("upload and warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    split = ", ".join(f"{k} {b - a:.3f}" for (_, a), (k, b) in zip([("", t0)] + marks, marks))
    log(f"{name}: seed {seed}, {len(words)} patterns, {nbytes} bytes, lane {lane}, "
        f"{len(warm)} matches a search, set-up {setup_s:.3f} s ({split})")
    del warm
    rng = np.random.default_rng(traffic.stream(seed, traffic.SAMPLE))
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if trace:
        from portbench import trace as tracing

        tr, outs = tracing.traced_window(engine, text, thr, seconds, man.spans(),
                                         Path(tempfile.gettempdir()))
        counts = [len(o) for o in outs]
        picks = sorted(rng.choice(len(outs), size=min(SAMPLE, len(outs)), replace=False).tolist())
        kept = {i: outs[i] for i in picks}
        del outs
        lanes = {s.get("backend") for s in tr.stats}
        for m in man.per_layer(name):
            got = man.reader(m["name"])(tr)
            if isinstance(got, tuple):
                got, note = got
                log(note)
            if got is not None:
                result["metrics"][m["name"]] = {"value": got, "unit": m["unit"]}
        result["breakdown"] = tr.breakdown
        result["attempted"] = tr.searches
        log(f"traced: {tr.searches} searches, window {tr.window_s:.6f} s, busy {tr.busy_s:.6f} s, "
            f"launches {tr.launches}")
    else:
        lat, first, last, counts, kept = window(engine, text, thr, seconds, rng)
        window_s = last - first
        lanes = {engine.last_stats.get("backend")}
        result["attempted"] = len(lat)
        ends = {"search_MBps": stats.rate_mbps(nbytes, len(lat), window_s),
                "search_ms_p95": stats.p95_ms(lat), "setup_s": setup_s}
        for m in man.end_to_end(name):
            result["metrics"][m["name"]] = {"value": ends[m["name"]], "unit": m["unit"]}
        log(f"window: {len(lat)} searches in {window_s:.6f} s; ms: first {lat[0] * 1e3:.4f}, "
            f"median {sorted(lat)[len(lat) // 2] * 1e3:.4f}, max {max(lat) * 1e3:.4f}")
    if device == "cuda":
        peak = torch.cuda.max_memory_allocated()
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": 1, "memory_peak_bytes": peak}
        if trace:
            result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    rows = {i: compare.output_rows(o) for i, o in kept.items()}
    del kept, engine
    device_corpus.clear()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref_stats = {}
    ref = reference.match_set(problem_of(config, words), text, device, stats=ref_stats)
    log(f"reference: {len(ref)} matches from {ref_stats['candidates']} candidate starts, "
        f"{time.perf_counter() - t:.3f} s (filter {ref_stats['filter_s']:.3f} s, exact "
        f"{ref_stats['exact_s']:.3f} s); tied matches (more than one breakdown reaches the "
        f"best similarity): {compare.tied(ref)}")
    checks = {k: 0 for k in compare.LIMITS}
    failed = set()
    for i, r in sorted(rows.items()):
        got = compare.compare(r, ref)
        log(f"search {i}: {len(r)} matches; " + ", ".join(f"{k} {v}" for k, v in got.items()))
        for k, v in got.items():
            checks[k] += v
        if any(got.values()):
            failed.add(i)
    other = [i for i, c in enumerate(counts) if c != len(ref)]
    checks["searches_with_other_count"] = len(other)
    failed.update(other)
    if lanes != {config["lane"]}:
        raise RuntimeError(f"{name}: lanes {lanes} in the window")
    result["failed"] = len(failed)
    result["correct"] = all(checks[k] <= lim for k, lim in compare.LIMITS.items())
    result["power_limit"] = power_limit() if device == "cuda" else "not measured"
    result["checks"] = {k: {"value": checks[k], "limit": lim} for k, lim in compare.LIMITS.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    man = manifest.Manifest(ROOT)
    cell = man.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(man, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the process holds forbidden modules: {bad}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
