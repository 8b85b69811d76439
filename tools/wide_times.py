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
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

#: (name, same, ((file of csrc/, old text, new text), ...)): variants of the
#: deep replay. ``same``: the variant returns what the kernel returns. A
#: variant applies where every old text occurs in the checkout's file.
DEEP_VARIANTS = (
    ("as is", True, ()),
    # The positions step alone: each block returns once its positions are
    # written.
    ("positions only", False, (
        ("scan_wide.cu", "\n  mine.positions(base, pos, s_warp, s_pos, HIT_CACHE);\n",
         "\n  mine.positions(base, pos, s_warp, s_pos, HIT_CACHE);\n  if (K > MAX_K) return;\n"),)),
    # The one-thread replay with no match read but the last symbol's: the
    # rows' match words ANDed once, after the replay.
    ("match rows read once", True, (
        ("packed_bitap.cuh", "      uint64_t acc = n0 & s_match[w];\n",
         "      uint64_t acc = K > MAX_K ? 0ull : n0 & s_match[w];\n"),
        ("packed_bitap.cuh", "          acc |= nd & s_match[d * stride + w];\n",
         "          acc |= K > MAX_K ? 0ull : nd & s_match[d * stride + w];\n"),
        ("scan_wide.cu", "      if (j0 + t < halo) nfa.step_row(bc + t, &st, &nl, mt, k, &out, stride);\n  }\n  return out;\n",
         "      if (j0 + t < halo) nfa.step_row(bc + t, &st, &nl, mt, k, &out, stride);\n  }\n"
         "  if constexpr (K > MAX_K) {\n    out = 0ull;\n#pragma unroll\n"
         "    for (int d = 0; d <= K; ++d)\n      if (d <= k) out |= nfa.r[d][0] & __ldg(mt + d * stride);\n"
         "  }\n  return out;\n"),)),
    # The deep replay's batch: 4 and 12 symbols.
    ("deep batch 4", True, (("scan_wide.cu", "constexpr int DEEP_BATCH = 8;",
                             "constexpr int DEEP_BATCH = 4;"),)),
    ("deep batch 12", True, (("scan_wide.cu", "constexpr int DEEP_BATCH = 8;",
                              "constexpr int DEEP_BATCH = 12;"),)),
)


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--label", default=None)
    ap.add_argument("--deep", action="store_true",
                    help="the deep replay's variants at mapped4's shape instead")
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
    if args.deep:
        from fuzzy_aho_corasick_tpu_torch.ops import verify_dp as vdp

        ctx.vdp = vdp
        out["mapped4"] = deep_replay(cs, ctx, kern, root, corpus)
        print(json.dumps(out))
        return 0
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


class _Routed:
    """The main library with ``fac_hit_words_wide`` taken from another."""

    def __init__(self, base, lib):
        self._base, self._lib = base, lib

    def __getattr__(self, name):
        return getattr(self._lib if name == "fac_hit_words_wide" else self._base, name)


def _global_loads(so_path: str, mangled: str) -> dict:
    """The global loads in the SASS of kernel ``mangled`` (``cuobjdump
    -sass``): {opcode: count}, and the instruction count."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", "-fun", mangled, so_path], capture_output=True,
                          text=True, timeout=300).stdout
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", text)
    loads = {}
    for op in ops:
        if op.startswith(("LDG", "LD.", "LDS", "LDC")):
            loads[op] = loads.get(op, 0) + 1
    return {"instructions": len(ops), "loads": loads}


def deep_replay(cs, ctx, kern, root: str, corpus: str) -> dict:
    """The deep replay's variants at mapped4's shape (see the module's
    note): {"shape": ..., "variants": {name: {...}}}."""
    from fuzzy_aho_corasick_tpu_torch.ops import _cuda_build

    torch, tpb, vdp = ctx.torch, ctx.tpb, ctx.vdp
    csrc = os.path.join(root, "fuzzy_aho_corasick_tpu_torch", "csrc")
    out_dir = os.path.join(root, "build", "deep_variants")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _cuda_build._nvcc()
    jobs = []
    for i, (name, same, subs) in enumerate(DEEP_VARIANTS):
        if not subs:
            continue
        files = {f: open(os.path.join(csrc, f)).read() for f in ("scan_wide.cu", "packed_bitap.cuh")}
        if not all(old in files[f] for f, old, _new in subs):
            cs.log(f"  deep variant {name}: its texts are not in this checkout")
            continue
        d = os.path.join(out_dir, f"v{i}")
        os.makedirs(d, exist_ok=True)
        for f, old, new in subs:
            files[f] = files[f].replace(old, new)
        for f, text in files.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        so = os.path.join(d, "v.so")
        cmd = [nvcc, *_cuda_build.NVCC_FLAGS, "-shared", "-o", so, os.path.join(d, "scan_wide.cu")]
        jobs.append((name, same, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True)))
    built = [("as is", True, None, str(kern.path), kern.log)]
    for name, same, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.log(f"  deep variant {name} did not build:\n{log[-3000:]}")
            continue
        lib = ctypes.CDLL(so)
        lib.fac_hit_words_wide.argtypes = _cuda_build._SIGNATURES["fac_hit_words_wide"]
        lib.fac_hit_words_wide.restype = ctypes.c_int
        built.append((name, same, lib, so, log))

    text = cs.plant_phrases(corpus, cs.SEED + 23, cs.MAPPED4_COPIES, cs.MAPPED4_WORDS)[0]
    engine = cs.recipe_engine(ctx, "mapped4")
    plan, run = cs.lane_inputs(vdp, engine, text, cs.MAPPED4_THRESHOLD, "mapped4")
    T, halo = run.T_scan, run.halo
    slices = []
    for part in run.parts:
        bits, counts = tpb.scan_bits(part.ids_pf, T, halo)
        offs = tpb.block_offsets(counts)
        slices.append((part.ids_pf, bits, offs, int(offs[-1])))
    ids, bits, offs, hits = slices[0]
    want = tpb.hit_words_torch(ids, bits, offs, hits, T, halo)
    N = ids.numel()
    K, dam = cs.replay_template(tpb, T.k), int(T.damerau)
    mangled_pat = f"hit_words_wide_kernelILi{K}ELb{dam}E"
    bound = cs.bound_ms(N / 8 + 4 * offs.numel() + hits * (halo + 8 + 16 * T.W),
                        cs.scan_instr(T.W, T.k, T.damerau) * hits * halo, cs.INT_RATE)
    rec = {"n": N, "W": T.W, "k": T.k, "damerau": T.damerau, "A": T.A, "halo": halo,
           "hits": hits, "slices": len(slices), "hits_per_slice": [s[3] for s in slices],
           "bound": bound, "variants": {}}
    base = kern.lib
    for name, same, lib, so, log in built:
        if lib is not None:
            kern.lib = _Routed(base, lib)
        try:
            got = tpb.hit_words(ids, bits, offs, hits, T, halo)
            equal = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
            x = cs.three_way_ms(torch, lambda: tpb.hit_words(ids, bits, offs, hits, T, halo),
                                "hit_words_wide", tpb.LAUNCHES)

            def search():
                for s_ids, s_bits, s_offs, s_hits in slices:
                    tpb.hit_words(s_ids, s_bits, s_offs, s_hits, T, halo)

            prof = cs.profile_search(torch, search, 5, tpb.LAUNCHES)
            x["device_ms_per_search"] = cs.search_ms(prof, "hit_words_wide")
            # A call's kernels (the deep replay may launch two), device ms
            # per call each.
            one = cs.profile_search(torch, lambda: tpb.hit_words(ids, bits, offs, hits, T, halo),
                                    10, tpb.LAUNCHES)
            x["kernels_ms_per_call"] = {k[:70]: v for k, v in one["by_event"].items()
                                        if "hit_words_wide" in k}
            x["device_ms_per_call"] = sum(x["kernels_ms_per_call"].values())
        finally:
            kern.lib = base
        entry = cs.ptxas_entry(log, mangled_pat)
        if entry is not None:
            x["registers"], x["spill"] = entry[1], entry[2]
            x["sass"] = _global_loads(so, entry[0])
        x["equal_to_plain"] = equal
        x["share_of_bound"] = bound[0] / max(x["device_ms_per_call"], 1e-9)
        rec["variants"][name] = x
        cs.log(f"  deep replay {name}: mapped4 slice 1 ({N} symbols, W={T.W}, k={T.k}, halo "
               f"{halo}, {hits} hits): events {x['events_ms']:.4f} ms, single {x['single_ms']:.4f}, "
               f"profiler {x['device_ms_per_call']:.4f} ms a call ({x['kernels_ms_per_call']}), "
               f"{x['device_ms_per_search']:.4f} device ms per search; bound {bound[0]:.4g} by "
               f"{bound[1]}; {x.get('registers')} registers, {x.get('spill')} spilled; SASS "
               f"{x.get('sass')}; equal to the plain version {equal}")
        if same and not equal:
            raise RuntimeError(f"deep variant {name} differs from hit_words_torch")
    return rec


if __name__ == "__main__":
    sys.exit(main())
