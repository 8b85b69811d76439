#!/usr/bin/env python3
"""Time the DP step of the forbid2, fuzzy2, mapped, mapped4, typed, typed14
and fuzzy1 cells, and variants of its kernel, on one CUDA card.

The cells are ``chip_smoke.py``'s phases 4c, 4c', 4e, 4e'', 4d, 4d' and 4b: the
headline dictionary with ``edits(2).swaps(0)`` at 0.62 over the 96 MiB
corpus (forbid2), with ``edits(2)`` at 0.62 (fuzzy2), the headline dictionary + ``modern`` with rn <-> m,
``edits(1)``, at 0.8 over the corpus with every 50th ``commodo`` a
``modem`` (mapped), 16 two-word names with rn <-> m, ``edits(4)``, at 0.8
over the corpus with 4,000 copies planted (mapped4: the list step's DP past
32 cells, ``count_dp_rows_kernel``), the typed engine at 0.8 over the
corpus (typed: the typed step), the headline dictionary with
``edits(2).substitutions(1)`` at 0.62 over the corpus (typed14: the typed
step's DP past 32 cells, ``typed_dp_rows_kernel``), and the headline
dictionary with ``edits(1)`` at 0.8 over the corpus (fuzzy1). For the checkout at
``--root`` (default: the one this script is in; a checkout whose list
step is ``csrc/dp_list.cu``), per cell, with every slice's hit list made once on the
card:

* the whole search (``search_raw``): best of 3 wall ms, host clock around a
  synchronised search, and the host-clock stages of one search
  (``chip_smoke.stage_breakdown``, best of 3 per stage: the step's host
  stage is its "dp_pipeline");

* the step (``verify_dp.dp_pipeline``, whichever kernels that checkout
  routes the cell to) over every slice of one search: CUDA events around
  5 searches' steps, and the profiler's device ms per search and per launch
  of each kernel;
* slice 1's rows and candidate count against ``dp_pipeline_torch``;
* each variant of ``VARIANTS`` whose texts all occur in the checkout's
  ``csrc/dp_pipeline.cu`` (where the cell runs on ``dp_pipeline_kernel``,
  two passes around ``block_offsets``), ``csrc/dp_list.cu`` (where it
  runs the list step, or the typed step's emission) or ``csrc/dp_typed.cu``
  (the expansion of the list and the typed step, the typed DP): that
  source with the texts replaced, built alone with the checkout's nvcc
  flags (all variants in parallel) and routed into the wrapper in place of
  the main library's ``fac_dp_pipeline*``, ``fac_count_*`` or
  ``fac_typed_*`` entries (the expansion's tile,
  ``verify_dp.TYPED_EXPAND_ITEMS``, read from the variant); per variant the
  step as above with ptxas's
  registers and spill bytes and, for ``dp_pipeline_kernel``, on slice 1
  the count pass and the write pass alone (CUDA events around 20 launches
  of each);
* "list step at E = 1": a cell that runs ``dp_pipeline_kernel`` (fuzzy1)
  routed to the list step instead (``verify_dp._list_step`` patched), timed
  as above;
* per variant the peak of the card's allocated bytes over slice 1's step
  (``torch.cuda.max_memory_allocated`` above what was allocated before it);
* with ``--range-peak``, the step over one range of ``step_max_hits`` random
  hits in slice 1's window (random match words: an unselective search, the
  most candidates a range can hold): its peak bytes, candidates, rows and
  CUDA-event ms.

Also ptxas's registers and spill bytes of every DP kernel instance the
checkout's library holds (``dp_pipeline_kernel``, ``count_dp_kernel``, ...),
from its build log. Prints one JSON line (the card's name and power limit
in it) and a log line per measurement on stderr.

To compare two checkouts on one card, unpack the other with ``git archive``
into a directory that ``.gitignore`` lists and run both in one command,
in turns:

    python3 tools/dp_variants.py --root build/parent --label parent
    python3 tools/dp_variants.py --label change
"""

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

#: (name, same, source, ((old text, new text), ...)). ``same``: the
#: variant returns what the kernel returns; ``source``: the file of csrc/ it
#: patches (``dp_pipeline.cu``, routed in place of ``fac_dp_pipeline*``,
#: ``dp_list.cu``, in place of ``fac_count_*``, or ``dp_typed.cu``, in place
#: of ``fac_typed_*``). A variant applies where every old text occurs in
#: that checkout's source.
_DP_CALL = "    dp_body<E, DEADEND, MAPS, Sym>(a.core, s_sim, sim_smem, f, s, emit_pen, emit_cnt);\n"
_NO_DP = ("#pragma unroll\n    for (int b = 0; b < B; ++b)\n#pragma unroll\n"
          "      for (int e = 0; e < NE; ++e) {\n"
          "        emit_pen[b][e] = __int_as_float(0x7f800000);\n"
          "        emit_cnt[b][e] = 0;\n      }\n")
_PIPE, _LIST, _TYPED = "dp_pipeline.cu", "dp_list.cu", "dp_typed.cu"
VARIANTS = (
    ("as is", True, None, ()),
    # The expansion, the idle lanes, the ballots and the row counts alone:
    # no live item runs its DP, in either pass.
    ("no DP", False, _PIPE, ((_DP_CALL, _NO_DP),)),
    # The write pass without its second DP (it then writes no row): the
    # count pass's DP is the only one.
    ("no DP in the write pass", False, _PIPE, (("  if (alive) {\n    float emit_pen[B][NE];",
                                                "  if (alive && !write) {\n    float emit_pen[B][NE];"),)),
    # The list step: its DP kernel without the DP (staging and decisions
    # only), with 8 blocks of 256 threads an SM asked of the register
    # allocator, without the similarity table in shared memory, and with
    # the grid over the list's bound instead of capped.
    ("list: no DP", False, _LIST, (("    count_dp_lanes<G, MAPS>(a, s_sim, st, f, d, gl, gm, pen, cnt);",
                                    "    pen = __int_as_float(0x7f800000);\n    cnt = 0;"),)),
    ("list: 8 blocks an SM", True, _LIST, (("__launch_bounds__(CL_THREADS) count_dp_kernel",
                                            "__launch_bounds__(CL_THREADS, 8) count_dp_kernel"),)),
    ("list: similarity table not staged", True, _LIST, (
        ("  const size_t sim = sim_smem_bytes(a.core.C, rest);", "  const size_t sim = 0;"),)),
    ("list: grid over the list's bound", True, _LIST, (("  if (blocks > cap) blocks = cap;", ""),)),
    ("list: swap unguarded", True, _LIST, (
        ("      if (hc == pc_prev && hc_jm1 == pc) {\n        const bool ok_sw = !no_swap",
         "      {\n        const bool ok_sw = hc == pc_prev && hc_jm1 == pc && !no_swap"),)),
    ("list: rows unrolled by 2", True, _LIST, (
        ("#pragma unroll 1\n  for (int i = 1; i <= d; ++i) {\n    const int pc = st.cls[i - 1];\n",
         "#pragma unroll 2\n  for (int i = 1; i <= d; ++i) {\n    const int pc = st.cls[i - 1];\n"),)),
    ("list: 6 blocks an SM", True, _LIST, (("__launch_bounds__(CL_THREADS) count_dp_kernel",
                                            "__launch_bounds__(CL_THREADS, 6) count_dp_kernel"),)),
    ("list: grid of resident blocks", True, _LIST, (
        ("  const long long cap = (long long)sm_count() * BLOCKS_PER_SM;",
         "  int per_sm = 0;\n  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads, shm);\n"
         "  const long long cap = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);"),)),
    ("list: no early exit", True, _LIST, (("    if (!__any_sync(gm, fin(prev_pen)", "    if (false && !__any_sync(gm, fin(prev_pen)"),)),
    # The rows DP (E >= 4) without its early stop: every group runs its
    # candidate's rows to the depth.
    ("rows: no early stop", True, _LIST, (("    if (!__any_sync(gm, live)) break;",
                                           "    if (false && !__any_sync(gm, live)) break;"),)),
    # The one-pass expansion with smaller tiles: 1,024 items a block, and 256
    # (one item a thread, the first one-pass design).
    ("expand: 1,024 items a block", True, _TYPED, (("constexpr int TE_ITEMS = 8;",
                                                    "constexpr int TE_ITEMS = 4;"),)),
    ("expand: 256 items a block", True, _TYPED, (("constexpr int TE_ITEMS = 8;",
                                                  "constexpr int TE_ITEMS = 1;"),)),
    # The typed DP past 32 cells without its early stop: every group runs
    # its candidate's rows to the depth.
    ("typed rows: no early stop", True, _TYPED, (("    if (!__any_sync(gm, lo < INF)) return false;",
                                                  "    if (false && !__any_sync(gm, lo < INF)) return false;"),)),
    # ... without its decisions (no row: the DP, the staging and the dec
    # stores alone), and with a grid of one and of 16 waves of the resident
    # blocks (4 kept).
    ("typed rows: no decisions", False, _TYPED, (
        ("      const int2 out = any ? typed_decision(a, ebuf, node, d, start, ce) : make_int2(0, -1);",
         "      const int2 out = make_int2(0, -1);"),)),
    ("typed rows: one wave of resident blocks", True, _TYPED, (
        ("constexpr int TR_WAVES = 4;", "constexpr int TR_WAVES = 1;"),)),
    ("typed rows: 16 waves", True, _TYPED, (
        ("constexpr int TR_WAVES = 4;", "constexpr int TR_WAVES = 16;"),)),
)
#: The routing variant: E = 1 without forbid flags or mappings on the list step.
_ROUTED = "list step at E = 1"
#: The DP kernels whose ptxas lines the report lists.
_DP_KERNELS = (r"(dp_pipeline_kernel|count_dp_\w*kernel|count_emit_kernel|typed_expand_kernel"
               r"|typed_dp_\w*kernel)")


def _build(nvcc, flags, include, src_text, out_dir, name):
    src = os.path.join(out_dir, f"{name}.cu")
    with open(src, "w") as fh:
        fh.write(src_text)
    so = os.path.join(out_dir, f"{name}.so")
    cmd = [nvcc, *flags, "-I", include, "-shared", "-o", so, src]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_dp(log_text: str) -> dict:
    """{demangled-ish instance: (registers, spill-store bytes)} of the DP
    kernels in a ``ptxas -v`` report."""
    out, cur = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = name if re.search(_DP_KERNELS, name) else None
            if cur is not None:
                out[cur] = [None, None]
        elif cur is not None and "spill stores" in line:
            out[cur][1] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif cur is not None and "Used" in line and "registers" in line:
            out[cur][0] = int(line.split("Used")[1].split("registers")[0])
    return {_label(k): tuple(v) for k, v in out.items()}


def _label(mangled: str) -> str:
    m = re.search(r"dp_pipeline_kernelILi(\d)ELb([01])ELb([01])E([hi])", mangled)
    if m:
        kind = "MAPS" if m.group(3) == "1" else "DEADEND" if m.group(2) == "1" else "plain"
        return f"dp_pipeline<E={m.group(1)},{kind},{'u8' if m.group(4) == 'h' else 'int32'}>"
    m = re.search(r"(count_dp_\w*?kernel)(?:ILi(\d+)ELb([01])E)?", mangled)
    if m:
        param = "E" if "rows" in m.group(1) else "G"
        return m.group(1) + (f"<{param}={m.group(2)},MAPS={m.group(3)}>" if m.group(2) else "")
    m = re.search(r"typed_dp_rows_kernelILi(\d)ELi(\d)ELi(\d+)E", mangled)
    if m:
        return f"typed_dp_rows_kernel<E={m.group(1)},S={m.group(2)},G={m.group(3)}>"
    m = re.search(r"typed_dp_kernelILi(\d+)E", mangled)
    if m:
        return f"typed_dp_kernel<G={m.group(1)}>"
    m = re.search(r"(count_emit_kernel|typed_expand_kernel)", mangled)
    return m.group(1) if m else mangled


#: The entries a variant of each source takes over, and the launch counters
#: of which one shows the cell ran on it.
_ROUTE = {_PIPE: ("fac_dp_pipeline", ("dp_pipeline",)),
          _LIST: ("fac_count_", ("count_dp", "typed_emit")),
          _TYPED: ("fac_typed_", ("typed_expand",))}
#: The cells by name: (``recipe_engine`` name, threshold).
_CELLS = {"forbid2": ("forbid", 0.62), "fuzzy2": ("fuzzy2", 0.62), "mapped": ("mapped", 0.8),
          "mapped4": ("mapped4", 0.8), "typed": ("typed", 0.8), "typed14": ("typed14", 0.62),
          "fuzzy1": ("fuzzy1", 0.8)}


class _Routed:
    """The main library with the entries starting ``prefix`` taken from
    another."""

    def __init__(self, base, lib, prefix):
        self._base, self._lib, self._prefix = base, lib, prefix

    def __getattr__(self, name):
        return getattr(self._lib if name.startswith(self._prefix) else self._base, name)


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--label", default=None)
    ap.add_argument("--only", nargs="*", default=None, help="the variants to run, by name")
    ap.add_argument("--cells", nargs="*", default=["forbid2", "mapped", "mapped4", "typed"],
                    choices=sorted(_CELLS))
    ap.add_argument("--range-peak", action="store_true",
                    help="the peak bytes of one range of step_max_hits random hits")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import torch

    if not torch.cuda.is_available():
        print("dp_variants: no CUDA card", file=sys.stderr)
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
    from fuzzy_aho_corasick_tpu_torch.ops import _cuda_build
    from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
    from fuzzy_aho_corasick_tpu_torch.ops import verify_dp as vdp

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    label = args.label or root
    out_dir = os.path.join(root, "build", "dp_variants")
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(root, "fuzzy_aho_corasick_tpu_torch", "csrc")
    sources = {name: open(os.path.join(csrc, name)).read()
               for name in (_PIPE, _LIST, _TYPED) if os.path.exists(os.path.join(csrc, name))}
    t0 = time.perf_counter()
    nvcc = _cuda_build._nvcc()
    jobs = []
    for i, (name, same, src, subs) in enumerate(VARIANTS):
        if not subs or src not in sources or not all(old in sources[src] for old, _n in subs) or (
                args.only is not None and name not in args.only):
            continue
        text = sources[src]
        for old, new in subs:
            text = text.replace(old, new)
        jobs.append((name, same, src, *_build(nvcc, _cuda_build.NVCC_FLAGS, csrc, text, out_dir,
                                              f"v{i}")))
    kern = _cuda_build.load()
    built, out_failed = [("as is", True, None, None, ptxas_dp(kern.log))], []
    for name, same, src, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"dp_variants: {name} did not build:\n{log[-4000:]}", file=sys.stderr)
            out_failed.append(name)
            continue
        lib = ctypes.CDLL(so)
        for fn, argtypes in _cuda_build._SIGNATURES.items():
            if fn.startswith(_ROUTE[src][0]):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        built.append((name, same, src, lib, ptxas_dp(log)))
    out = {"root": label, "card": smi, "build_s": time.perf_counter() - t0,
           "nvcc_s": kern.build_seconds, "ptxas": built[0][4], "cells": {},
           "did_not_build": out_failed}
    print(f"dp_variants {label}: built in {out['build_s']:.1f} s (the library's nvcc "
          f"{kern.build_seconds:.1f} s)", file=sys.stderr, flush=True)
    for inst, (regs, spill) in sorted(built[0][4].items()):
        print(f"  ptxas {inst}: {regs} registers, {spill} bytes spill stores", file=sys.stderr)
    if args.only is None or _ROUTED in args.only:
        built.append((_ROUTED, True, None, None, None))

    ctx = SimpleNamespace(torch=torch, np=np, tpb=tpb, vdp=vdp, dev=torch.device("cuda"),
                          Builder=FuzzyAhoCorasickBuilder, Limits=FuzzyLimits, Pattern=Pattern)
    corpus = cs.build_corpus(cs.CORPUS_BYTES, cs.SEED)
    texts = {"mapped": lambda: cs.sparse_modem(corpus),
             "mapped4": lambda: cs.plant_phrases(corpus, cs.SEED + 23, cs.MAPPED4_COPIES,
                                                 cs.MAPPED4_WORDS)[0]}
    base, list_step, expand_items = kern.lib, vdp._list_step, vdp.TYPED_EXPAND_ITEMS
    for cell in args.cells:
        name, thr = _CELLS[cell]
        text = texts.get(cell, lambda: corpus)()
        engine = cs.recipe_engine(ctx, name)
        wall, stages = search_walls(torch, cs, tpb, vdp, engine, text, thr)
        print(f"dp_variants {label} {cell}: search best of 3 {min(wall):.3f} ms (all "
              f"{', '.join(f'{t:.3f}' for t in wall)}); stages {stages}", file=sys.stderr,
              flush=True)
        plan, run = cs.lane_inputs(vdp, engine, text, thr, cell)
        slices = []
        for part in run.parts:
            _h, pos, words = tpb.packed_hits(part.ids_pf, run.T_scan, run.halo)
            slices.append(cs.pipeline_args(vdp, np, plan, run, part, pos, words, thr))
        rows_p, cand_p = vdp.dp_pipeline_torch(*slices[0])
        rec = {"slices": len(slices), "E": plan.E, "variant": cs.variant_name(run),
               "slice1_hits": int(slices[0][0].numel()), "slice1_candidates": cand_p,
               "slice1_rows": int(rows_p.shape[0]), "n_combo": plan.n_combo,
               "MO": int(run.T.out_list.shape[1]), "search_ms": wall,
               "search_best_ms": min(wall), "stages_ms": stages, "variants": {}}
        pipeline_cell = not list_step(plan.E, run.variant) and run.variant.typed is None

        def step():
            for a in slices:
                vdp.dp_pipeline(*a)

        for vname, same, src, lib, regs in built:
            if vname == _ROUTED and not pipeline_cell:
                continue
            if lib is not None:
                kern.lib = _Routed(base, lib, _ROUTE[src][0])
                if src == _TYPED:  # the variant's tile sizes the grid
                    vdp.TYPED_EXPAND_ITEMS = lib.fac_typed_expand_items()
            if vname == _ROUTED:
                vdp._list_step = lambda E, variant: variant.typed is None
            try:
                for k in tpb.LAUNCHES:
                    tpb.LAUNCHES[k] = 0
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                rows_k, cand_k = vdp.dp_pipeline(*slices[0])
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - before
                launched = {k: v for k, v in tpb.LAUNCHES.items() if v}
                if lib is not None and not any(launched.get(k) for k in _ROUTE[src][1]):
                    continue  # the cell does not run on the patched kernel
                ms = cs.event_ms(torch, step, 5)
                prof = cs.profile_search(torch, step, 5, tpb.LAUNCHES)
                passes = {}
                if launched.get("dp_pipeline"):
                    launch, counts, nch, nunits = vdp._count_pass(*slices[0][:-1])
                    offsets = tpb.block_offsets(counts)
                    n_rows = int(offsets[nch * nunits])
                    rows = torch.empty((max(n_rows, 1), 5), dtype=torch.int32, device=ctx.dev)
                    passes = {"count_ms": cs.event_ms(torch, lambda: launch(0, None, None), 20),
                              "write_ms": cs.event_ms(torch, lambda: launch(1, offsets, rows), 20)}
            finally:
                kern.lib, vdp._list_step = base, list_step
                vdp.TYPED_EXPAND_ITEMS = expand_items
            kernels = {k: {"ms_per_search": prof["by_event"][k],
                           "ms_per_launch": cs.launch_ms(prof, k),
                           "events_per_search": prof["events"][k] / prof["reps"]}
                       for k in prof["events"] if "Memcpy" not in k and "Memset" not in k}
            equal = bool(torch.equal(rows_k, rows_p) and cand_k == cand_p)
            rec["variants"][vname] = {
                "events_ms_per_search": ms, "device_ms_per_search": sum(
                    v["ms_per_search"] for v in kernels.values()),
                "kernels": kernels, "launched_slice1": launched, "slice1_passes": passes,
                "slice1_peak_bytes": peak, "equal_to_plain": equal,
                "ptxas": regs if lib is not None else None}
            print(f"dp_variants {label} {cell} {vname}: events {ms:.4f} ms per search, device "
                  f"{rec['variants'][vname]['device_ms_per_search']:.4f} ms per search, slice 1 "
                  f"passes {passes}, peak {peak} bytes, equal {equal}; per launch "
                  + ", ".join(f"{k[:40]} {v['ms_per_launch']:.4f}" for k, v in kernels.items()),
                  file=sys.stderr, flush=True)
            if same and not equal:
                print(f"dp_variants: {cell} {vname} differs from the plain version",
                      file=sys.stderr)
                out["cells"][cell] = rec
                print(json.dumps(out))
                return 1
        if args.range_peak and not pipeline_cell:
            rec["range_peak"] = range_peak(torch, cs, vdp, slices[0], plan, run)
            print(f"dp_variants {label} {cell} one range of random hits: {rec['range_peak']}",
                  file=sys.stderr, flush=True)
        out["cells"][cell] = rec
    print(json.dumps(out))
    return 0


def search_walls(torch, cs, tpb, vdp, engine, text: str, thr: float):
    """Best-of-3 material of the whole search: the wall ms of 3 synchronised
    ``search_raw`` calls after a warm-up, and the host-clock stages of one
    search (``chip_smoke.stage_breakdown``), each stage's least of 3."""
    engine.search_raw(text, thr)
    wall = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.search_raw(text, thr)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    stages = {}
    for _ in range(3):
        ms, _n = cs.stage_breakdown(torch, tpb, vdp, engine, text, thr)
        stages = {k: min(v, stages.get(k, v)) for k, v in ms.items()}
    return wall, stages


def range_peak(torch, cs, vdp, args, plan, run) -> dict:
    """The list step over one range of ``step_max_hits`` random hits in the
    window of slice 1 (``args``, its arguments of ``dp_pipeline``): random
    ascending positions and random match words (a bit set where two random
    words both have it), made on the card from a seed. Returns the range's
    hits and items, its candidates and rows, the peak of the allocated bytes
    above what was allocated before, that peak per item, and the CUDA-event
    ms of the step."""
    window = args[2]
    MO = int(run.T.out_list.shape[1])
    H = min(vdp.step_max_hits(plan.n_combo, MO, plan.E, run.variant),
            window.start_hi - window.start_lo)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    pos = torch.randperm(window.start_hi - window.start_lo, generator=g, device="cuda")[:H]
    pos = torch.sort(pos).values.to(torch.int64) + window.start_lo
    W2 = args[1].shape[1]
    words = (torch.randint(0, 1 << 32, (H, W2), generator=g, device="cuda", dtype=torch.int64)
             & torch.randint(0, 1 << 32, (H, W2), generator=g, device="cuda", dtype=torch.int64))
    rest = args[2:]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    rows, n_cand = vdp.dp_pipeline(pos, words, *rest)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    items = H * plan.n_combo
    ms = cs.event_ms(torch, lambda: vdp.dp_pipeline(pos, words, *rest), 2)
    return {"hits": H, "items": items, "candidates": n_cand, "rows": int(rows.shape[0]),
            "peak_bytes": peak, "peak_bytes_per_item": peak / items,
            "step_range_bytes": vdp.STEP_RANGE_BYTES, "ms": ms}


if __name__ == "__main__":
    sys.exit(main())
