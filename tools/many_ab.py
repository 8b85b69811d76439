#!/usr/bin/env python3
"""Time the many1k searches of ``chip_smoke.py`` phase 4f on one CUDA card.

For the checkout at ``--root`` (default: the one this script is in): the
1,000-word ``edits(1)`` engine at 0.82 over the 24 MiB many1k corpus, with
the folded layout and with the plain chunking, each searched through
``search_raw`` twice to warm up, then ``--reps`` times (3) on the host
clock (the best and all of them), then three times under torch.profiler
(device busy ms, kernel launches, copies and host waits per search, and
the device ms of the many lane's step kernels by name). Prints one JSON
line.

To compare two checkouts, unpack one with ``git archive`` into a directory
that ``.gitignore`` lists and run this script on both in turns in one
session on the card, e.g. a, b, b, a:

    python3 tools/many_ab.py --root build/parent
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import torch

    if not torch.cuda.is_available():
        print("many_ab: no CUDA card", file=sys.stderr)
        return 2
    os.chdir(root)
    sys.path.insert(0, root)
    from types import SimpleNamespace

    import numpy as np

    import chip_smoke as cs
    from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits, Pattern, oracle
    from fuzzy_aho_corasick_tpu_torch.ops import _cuda_build, many
    from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
    from fuzzy_aho_corasick_tpu_torch.ops import verify_dp as vdp

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    _cuda_build.load()
    build_s = time.perf_counter() - t0
    ctx = SimpleNamespace(torch=torch, np=np, tpb=tpb, vdp=vdp, many=many,
                          dev=torch.device("cuda"), oracle=oracle,
                          Builder=FuzzyAhoCorasickBuilder, Limits=FuzzyLimits, Pattern=Pattern)
    corpus = cs.build_corpus(cs.CORPUS_BYTES, cs.SEED)
    text = cs.many_corpus(corpus[: cs.MANY_BYTES], cs.many_words(1000, 7))
    engine = cs.recipe_engine(ctx, "many1k")
    thr = cs.MANY_THRESHOLD
    out = {"root": args.label or root, "card": smi, "build_s": build_s}
    saved = many.FOLD
    try:
        for fold in (True, False):
            many.FOLD = fold
            for _ in range(2):
                got = engine.search_raw(text, thr)
            times = []
            for _ in range(args.reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = engine.search_raw(text, thr)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            prof = cs.profile_search(torch, lambda: engine.search_raw(text, thr), 3)
            step = {k: v for k, v in prof["by_event"].items()
                    if any(name in k for name in ("many_step", "many_expand", "dp_list"))}
            out["folded" if fold else "plain"] = {
                "matches": len(got), "folded": engine.last_stats["folded"],
                "best_ms": min(times), "all_ms": times, "busy_ms": prof["busy"],
                "launches": prof["kernels"], "copies": prof["copies"], "waits": prof["waits"],
                "step_device_ms": sum(step.values()),
                "step_kernels": {k[:90]: v for k, v in step.items()}}
    finally:
        many.FOLD = saved
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
