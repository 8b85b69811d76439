#!/usr/bin/env python3
"""Time the wide scan's kernels at their main-path shapes on one CUDA card.

For the checkout at ``--root`` (default: the one this script is in), at the
two shapes ``chip_smoke.py`` drives them at: exact-wide (phase 4g: the
first 300 many1k words, exact, over the 24 MiB many1k corpus with 4,000
copies planted; W = 43, k = 0) and the many1k folded chunk (phase 4f: W =
31, k = 1 with the Damerau rows). For ``scan_bits_wide`` and
``hit_words_wide`` at each: CUDA events around 10 back-to-back calls,
events around one call after a synchronise, and the profiler's device ms
per launch with its event count beside the launches counted
(``chip_smoke.wide_kernel_detail``); the bound from these inputs; the
instance the call ran, its registers (``ptxas -v``) and, for the scan, the
SASS of its main loop (``cuobjdump -sass``). Prints one JSON line.

The helpers come from the ``chip_smoke.py`` beside this script, the package
from ``--root``, so one copy of this script times two checkouts: unpack one
with ``git archive`` into a directory that ``.gitignore`` lists and run
both in turns in one run on the card, e.g. a, b, b, a:

    python3 tools/wide_times.py --root build/parent
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import torch

    if not torch.cuda.is_available():
        print("wide_times: no CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    os.chdir(root)
    sys.path.insert(0, root)
    from types import SimpleNamespace

    import numpy as np

    from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits, Pattern
    from fuzzy_aho_corasick_tpu_torch.ops import _cuda_build, many
    from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    kern = _cuda_build.load()
    out = {"root": args.label or root, "card": smi, "build_s": time.perf_counter() - t0}
    ctx = SimpleNamespace(torch=torch, np=np, tpb=tpb, many=many, dev=torch.device("cuda"),
                          Builder=FuzzyAhoCorasickBuilder, Limits=FuzzyLimits, Pattern=Pattern)
    corpus = cs.build_corpus(cs.CORPUS_BYTES, cs.SEED)
    words1k = cs.many_words(1000, 7)
    many_text = cs.many_corpus(corpus[: cs.MANY_BYTES], words1k)
    exact_text = cs.plant_words(many_text, cs.SEED + 11, cs.MANY_TYPOS, words1k[:300])
    shapes = {"exact-wide": cs.exact_wide_inputs(ctx, cs.make_exact(ctx, words1k[:300]),
                                                 exact_text)}
    engine = cs.recipe_engine(ctx, "many1k")
    view = view_of(many_text, True)
    run = many.many_inputs(engine, many.many_spec_of(engine, fold=True), many_text,
                           cs.MANY_THRESHOLD, view, len(view))
    shapes["many1k folded"] = (run.ids_pf, run.chunks[0].T_scan, run.halo)
    # The instance table: this checkout's mirror of it where it has one,
    # else the one table every width and k had before it.
    instance = getattr(tpb, "wide_scan_instance", None) or (
        lambda W, k: (2, 8) if W <= 16 else (4, 8) if W <= 32 else (4, 16))
    for tag, (ids, T, halo) in shapes.items():
        out[tag] = cs.wide_kernel_detail(ctx, kern, ids, T, halo, instance)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
