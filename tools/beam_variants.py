#!/usr/bin/env python3
"""Time the beam frontier of ``chip_smoke.py`` phase 4j's cells on one CUDA
card, for one checkout, with or without settings of its ``ops/fuzzy``.

The cells are 4j's: (a) the headline dictionary with ``edits(1)`` at 0.8
over the 96 MiB corpus twice, joined by a space (the E = 1 pool over the
packed anchors); (b) ``cjk1`` and (c) ``cjk2`` over 24 MiB of CJK filler
(the pool, and the sorted E = 2 beam, over the seed filter's starts); (d)
``a`` x 70 and ``hello`` over the many1k corpus with 64 a-runs (the pool
over the seed filter's starts). For the checkout at ``--root`` (default: the
one this script is in; its own ``chip_smoke.py`` builds the texts and
engines), per cell, after one warm search:

* the frontier wrapper (``fuzzy.pool_frontier`` / ``fuzzy.sorted_frontier``)
  over the cell's first run of starts as the count grid of the first
  design sized it (``2^27 // (4 T nchunk)`` chunks of the JAX package's
  size): CUDA events around 3 calls (the wrapper's ms), and one call under
  torch.profiler: each device event in launch order (the count launch, the
  write launch, the order kernel, ``block_offsets``) and their sum, with a
  digest of the emissions and overflow flags, which two checkouts must
  share;
* the whole frontier of one search (``fuzzy.beam_emissions`` over every
  candidate start): best of ``--reps`` wall ms on the host clock around a
  synchronised call, and one call under torch.profiler: wall, device busy
  ms, the device ms of the ``beam_*`` kernels, kernel launches, copies, host
  waits and the runs;
* ptxas's registers and spill bytes of every frontier kernel in the build.

``--set NAME=VALUE`` (repeatable) sets an integer attribute of the
checkout's ``ops/fuzzy`` first (e.g. ``RUN_BYTES``). ``--define NAME=VALUE``
(repeatable) times a variant of the kernels: it copies the checkout's
package under ``<root>/build/variants/``, sets ``constexpr int NAME`` in
the copy's ``csrc/beam.cu`` and the same attribute of its ``ops/fuzzy``
(the mirror the library's constants are checked against), and times the
copy: ``TABLES_SMEM_MAX=0`` leaves the tables in global memory,
``THREAD_POOL_WALKS``, ``POOL_CHIP_WALKS`` and ``SORT_CHIP_KEYS`` size the
walks or keys a thread or warp keeps on chip. Prints one JSON line (the
card's name and power limit in it) and a log line per cell on stderr.

To compare two checkouts on one card, unpack the other with ``git archive``
into a directory that ``.gitignore`` lists and run both in one command, in
turns (parent, change, change, parent):

    python3 tools/beam_variants.py --root build/parent --label parent
    python3 tools/beam_variants.py --label change
"""

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

#: cell -> (engine recipe, text, threshold name or value).
CELLS = {"a": "fuzzy1", "b": "cjk1", "c": "cjk2", "d": "long"}


def log(msg: str) -> None:
    print(f"beam_variants: {msg}", file=sys.stderr, flush=True)


def device_events(torch, fn):
    """One call of ``fn`` under torch.profiler: [(kernel name, device us)]
    in launch order, and the wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    evs.sort(key=lambda e: e.time_range.start)
    waits = sum(1 for e in prof.events()
                if e.device_type == DeviceType.CPU and "Synchronize" in e.name)
    return [(e.name, e.time_range.elapsed_us()) for e in evs], wall, waits


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def frontier_ptxas(log_text: str) -> dict:
    """ptxas's (registers, spill-store bytes) of every ``beam_*`` kernel."""
    out, name = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            name = name if "beam_" in name else None
            spill = None
        elif name and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in line and "registers" in line:
            short = re.search(r"beam_\w+?_kernel(I\w*?E)?(?=EvN|Ev|$)", name)
            out[short.group(0) if short else name] = (
                int(line.split("Used")[1].split("registers")[0]), spill)
            name = None
    return out


def variant_root(root: str, defines) -> str:
    """A copy of ``root``'s package and ``chip_smoke.py`` under
    ``root/build/variants/`` with each ``NAME=VALUE`` of ``defines`` set in
    its ``csrc/beam.cu`` (``constexpr int NAME = ...;``) and its
    ``ops/fuzzy.py`` (``NAME = ...``)."""
    tag = hashlib.sha256(" ".join(sorted(defines)).encode()).hexdigest()[:12]
    dst = os.path.join(root, "build", "variants", tag)
    pkg = "fuzzy_aho_corasick_tpu_torch"
    shutil.rmtree(os.path.join(dst, pkg), ignore_errors=True)  # its build/ stays
    shutil.copytree(os.path.join(root, pkg), os.path.join(dst, pkg),
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    shutil.copy(os.path.join(root, "chip_smoke.py"), dst)
    for item in defines:
        name, value = item.split("=")
        for rel, pattern, repl in (
                ("csrc/beam.cu", rf"(constexpr int {name} = )[^;]+;", rf"\g<1>{int(value)};"),
                ("ops/fuzzy.py", rf"^({name} = ).*$", rf"\g<1>{int(value)}")):
            path = os.path.join(dst, pkg, rel)
            text = open(path).read()
            text, k = re.subn(pattern, repl, text, count=1, flags=re.M)
            if k != 1:
                raise SystemExit(f"{rel} has no {name} to set")
            open(path, "w").write(text)
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    ap.add_argument("--cells", nargs="*", default=list(CELLS), choices=list(CELLS))
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE")
    ap.add_argument("--define", action="append", default=[], metavar="NAME=VALUE")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if args.define:
        root = variant_root(root, args.define)
    import torch

    if not torch.cuda.is_available():
        print("beam_variants: no CUDA card", file=sys.stderr)
        return 2
    os.chdir(root)
    sys.path.insert(0, root)
    from types import SimpleNamespace

    import numpy as np

    import chip_smoke as cs
    from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits, Pattern, oracle
    from fuzzy_aho_corasick_tpu_torch.ops import _cuda_build, many
    from fuzzy_aho_corasick_tpu_torch.ops import fuzzy as fz
    from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
    from fuzzy_aho_corasick_tpu_torch.ops import verify_dp as vdp
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    for item in args.set:
        name, value = item.split("=")
        if not hasattr(fz, name):
            raise SystemExit(f"ops/fuzzy has no {name}")
        setattr(fz, name, int(value))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    kern = _cuda_build.load()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    ctx = SimpleNamespace(torch=torch, np=np, tpb=tpb, vdp=vdp, many=many, dev=dev, oracle=oracle,
                          Builder=FuzzyAhoCorasickBuilder, Limits=FuzzyLimits, Pattern=Pattern)
    out = {"root": args.label or root, "card": smi, "build_s": build_s, "sets": args.set,
           "defines": args.define,
           "ptxas": frontier_ptxas(kern.log), "cells": {}}
    t0 = time.perf_counter()
    texts = {}
    if {"a", "d"} & set(args.cells):
        corpus = cs.build_corpus(cs.CORPUS_BYTES, cs.SEED)
        if "a" in args.cells:
            texts["a"] = corpus + " " + corpus
        if "d" in args.cells:
            texts["d"] = cs.arun_text(cs.many_corpus(corpus[: cs.MANY_BYTES],
                                                     cs.many_words(1000, 7)))
        del corpus
    for i, name in enumerate(("cjk1", "cjk2")):
        cell = "bc"[i]
        if cell in args.cells:
            texts[cell] = cs.cjk_corpus(cs.MANY_BYTES, cs.SEED + 21 + i, cs.beam_words(name),
                                        cs.CJK_FILLER_LEN[name])
    log(f"{args.label or root}: texts {time.perf_counter() - t0:.1f} s, build {build_s:.1f} s")
    for cell in args.cells:
        name = CELLS[cell]
        text = texts[cell]
        thr = 0.8 if cell == "a" else cs.BEAM_THRESHOLD[name]
        engine = cs.recipe_engine(ctx, name)
        engine.search_raw(text, thr)  # uploads, the seed filter, JIT of nothing: warm
        thr32 = np.float32(thr)
        view = view_of(text, engine.case_insensitive)
        n = len(view)
        ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr32)
        cand = fz._candidate_starts(engine, text, view, n, thr32)
        tabs, prm, ids, nchunk = cs.frontier_inputs(ctx, engine, text, thr)
        first = max(1, (1 << 27) // (4 * prm.T * nchunk)) * nchunk
        starts = cand[:first].contiguous()
        if prm.E == 1:
            call = lambda: fz.pool_frontier(starts, tabs, prm, ids, nchunk)
        else:
            call = lambda: fz.sorted_frontier(starts, tabs, prm, ids, nchunk, 32 + 24 * prm.E)
        res = call()
        torch.cuda.synchronize()
        em, ov = res[0], (res[1] if prm.E >= 2 else None)
        wrapper_ms = cs.event_ms(torch, call, 3)
        evs, _w, _waits = device_events(torch, call)
        beam_evs = [(k, us) for k, us in evs if "beam_" in k or "block_offsets" in k]

        def frontier():
            return fz.beam_emissions(engine, text, view, n, cand, thr32, ceil)

        frontier()
        walls = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            frontier()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        before = dict(tpb.LAUNCHES)
        s_evs, s_wall, s_waits = device_events(torch, frontier)
        counted = {k: v - before[k] for k, v in tpb.LAUNCHES.items() if v != before[k]}
        kernels = [(k, us) for k, us in s_evs if not k.startswith(("Memcpy", "Memset"))]
        rec = {
            "starts": int(cand.numel()), "first_run_starts": int(starts.numel()), "T": prm.T,
            "nchunk": nchunk, "emissions": int(em[0].numel()),
            "digest": digest(list(em) + [ov]),
            "stats": list(res[-1]) if res[-1] is not None else None,
            "wrapper_ms": wrapper_ms,
            "first_run_events_us": beam_evs,
            "first_run_frontier_kernel_us": [us for k, us in beam_evs
                                             if "beam_pool" in k or "beam_sorted" in k],
            "first_run_device_us": sum(us for _k, us in beam_evs),
            "search_wall_ms": walls, "search_profiled_wall_ms": s_wall,
            "search_busy_ms": sum(us for _k, us in s_evs) / 1e3,
            "search_beam_kernels_ms": sum(us for k, us in s_evs if "beam_" in k) / 1e3,
            "search_frontier_kernel_ms": sum(us for k, us in s_evs
                                             if "beam_pool" in k or "beam_sorted" in k) / 1e3,
            "search_launches": len(kernels), "search_copies": len(s_evs) - len(kernels),
            "search_waits": s_waits, "search_counted": counted,
        }
        out["cells"][cell] = rec
        log(f"({cell}) {name}: {rec['starts']} starts, first run {rec['first_run_starts']}, "
            f"{rec['emissions']} emissions (digest {rec['digest']}), wrapper "
            f"{wrapper_ms:.4f} ms, device events {[(k[:24], round(us, 1)) for k, us in beam_evs]}; "
            f"search: best {min(walls):.3f} ms, busy {rec['search_busy_ms']:.4f} ms, beam "
            f"kernels {rec['search_beam_kernels_ms']:.4f} ms, {rec['search_launches']} launches, "
            f"{rec['search_copies']} copies, {s_waits} waits, counted {counted}")
        del engine
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
