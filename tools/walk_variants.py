#!/usr/bin/env python3
"""Time variants of the goto walk's kernels at exact1k's shape on one CUDA card.

exact1k (``chip_smoke.py`` phase 4h): the 1,000 many1k words, exact,
threshold 0.5, over the 24 MiB many1k corpus with 4,000 exact copies
planted; 25,165,824 u8 symbols, a 7,093 x 30 goto table. For the checkout at
``--root`` (default: the one this script is in), each variant of ``VARIANTS``
whose texts all occur in that checkout's ``csrc/goto_walk.cu`` is that
source with the texts replaced, built alone with the checkout's nvcc flags
into its own library (all variants in parallel) and routed into the
checkout's wrapper (``exact.goto_walk``) in place of the main library's
``fac_goto_walk*`` entries. Per variant: CUDA events around 10 walks, the
profiler's mean device ms per launch of each kernel, the arrivals and the
alive counts, and whether they equal the plain version's (a variant marked
``same=False`` changes what the walk returns and is timed only). Prints one
JSON line; the card's name and power limit in it.

The variants are text patches so that one script times the kernel of any
checkout: unpack an earlier commit with ``git archive`` into a directory
that ``.gitignore`` lists and pass it as ``--root``; ``--only`` names the
variants to run.

    python3 tools/walk_variants.py --root build/parent
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time

#: (name, same, ((old text, new text), ...)). ``same``: the variant returns
#: what the kernel returns. A variant applies where every old text occurs.
_FIRST_ATOMIC = ("      if (span <= ALIVE_SMEM) {\n        atomicAdd(&s_alive[span - 1], 1);\n",
                "      if (span <= ALIVE_SMEM) {\n")
# An opaque compare in place of the emits gather: no arrival, but the walk
# keeps a use of every node it visits, so nothing is optimised away.
_FIRST_EMITS = ("      hits += __ldg(a.emits + node);\n",
               "      hits += node == a.C + 0x7fff0000;\n")
VARIANTS = (
    ("as is", True, ()),
    # The count kernel of the first hand kernel pair (one shared atomic
    # per step for the alive counts, the emits flag a second gather).
    ("no alive atomics", False, (_FIRST_ATOMIC,)),
    ("no emits gather", False, (_FIRST_EMITS,)),
    ("neither", False, (_FIRST_ATOMIC, _FIRST_EMITS)),
    # The redesign: no straight-line spans 1-3 (every start walks the
    # generic loop, as past 64 classes), one block per tile instead of
    # persistent blocks, and the walks past span 3 finished after each tile
    # instead of once the block's list is full.
    ("no straight-line spans", True, (("if (sizeof(SymT) == 1 && has_pair(a.C)) {",
                                       "if (false) {"),)),
    ("a block per tile", True, (("<<<min(a.tiles, held), ", "<<<a.tiles, "),)),
    ("deep walks a tile at a time", True, (("if (s_ndeep > DEEP_MAX - WALK_TILE) finish_deep();",
                                            "if (s_ndeep > 0) finish_deep();"),)),
    # Where the count pass's time goes: without the walks (the tiles staged
    # and the blocks synchronised only), and with the walks cut after span
    # 1, 2 or 3.
    ("no walks", False, (("for (int q = tid; 4 * q < n; q += WALK_THREADS) {",
                          "for (int q = tid; 4 * q < 0; q += WALK_THREADS) {"),)),
    ("span 1 only", False, (("const bool ok2 = ok1 && last[j] >= 2 && e2[j] >= 0;",
                             "const bool ok2 = false;"), ("e3[j] = ok2 ? next(",
                                                          "e3[j] = false ? next("))),
    ("spans 1-2 only", False, (("e3[j] = ok2 ? next(", "e3[j] = false ? next("),)),
    ("spans 1-3 only", False, (("if (ok3 && last[j] >= 4) {", "if (false) {"),)),
)


def _build(nvcc, flags, src_text, out_dir, name):
    src = os.path.join(out_dir, f"{name}.cu")
    with open(src, "w") as fh:
        fh.write(src_text)
    so = os.path.join(out_dir, f"{name}.so")
    cmd = [nvcc, *flags, "-shared", "-o", so, src]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


class _Routed:
    """The main library with the goto walk's entries taken from another."""

    def __init__(self, base, walk):
        self._base, self._walk = base, walk

    def __getattr__(self, name):
        return getattr(self._walk if name.startswith("fac_goto_walk") else self._base, name)


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--label", default=None)
    ap.add_argument("--only", nargs="*", default=None, help="the variants to run, by name")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import torch

    if not torch.cuda.is_available():
        print("walk_variants: no CUDA card", file=sys.stderr)
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
    from fuzzy_aho_corasick_tpu_torch.ops import _cuda_build, exact
    from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
    from fuzzy_aho_corasick_tpu_torch.utils import device_corpus
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    label = args.label or root
    out_dir = os.path.join(root, "build", "walk_variants")
    os.makedirs(out_dir, exist_ok=True)
    source = open(os.path.join(root, "fuzzy_aho_corasick_tpu_torch", "csrc",
                               "goto_walk.cu")).read()
    t0 = time.perf_counter()
    nvcc = _cuda_build._nvcc()
    jobs = []
    for i, (name, same, subs) in enumerate(VARIANTS):
        if not all(old in source for old, _new in subs) or (
                args.only is not None and name not in args.only):
            continue
        text = source
        for old, new in subs:
            text = text.replace(old, new)
        jobs.append((name, same, *_build(nvcc, _cuda_build.NVCC_FLAGS, text, out_dir, f"v{i}")))
    kern = _cuda_build.load()
    built, out_failed = [], []
    for name, same, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"walk_variants: {name} did not build:\n{log[-4000:]}", file=sys.stderr)
            out_failed.append(name)
            continue
        lib = ctypes.CDLL(so)
        for fn, argtypes in _cuda_build._SIGNATURES.items():
            if fn.startswith("fac_goto_walk"):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        built.append((name, same, lib, regs))
    out = {"root": label, "card": smi, "build_s": time.perf_counter() - t0, "variants": {},
           "did_not_build": out_failed}
    ctx = SimpleNamespace(torch=torch, np=np, tpb=tpb, dev=torch.device("cuda"),
                          Builder=FuzzyAhoCorasickBuilder, Limits=FuzzyLimits, Pattern=Pattern)
    corpus = cs.build_corpus(cs.CORPUS_BYTES, cs.SEED)
    words1k = cs.many_words(1000, 7)
    many_text = cs.many_corpus(corpus[: cs.MANY_BYTES], words1k)
    exact_text = cs.plant_words(many_text, cs.SEED + 11, cs.MANY_TYPOS, words1k[:300])
    engine = cs.make_exact(ctx, words1k)
    dense = engine.dense
    ids, n = device_corpus.resident(
        exact_text, ("dense", tpb._space_token(engine)),
        lambda h: np.ascontiguousarray(dense.transcode(h, view_of(h, True)), dtype=np.uint8),
        ctx.dev)
    # (goto, emits) before the folded table, (goto, emits, folded) after.
    tables = exact.walk_tables(engine, 0.5, ctx.dev)
    walk_args = (ids, n, n, tables[0], tables[1], max(dense.max_depth, 1))
    walk_kw = {"folded": tables[2]} if len(tables) > 2 else {}
    p_found, p_alive = exact.goto_walk_torch(*walk_args)
    base = kern.lib
    for name, same, lib, regs in built:
        kern.lib = _Routed(base, lib)
        try:
            found, alive = exact.goto_walk(*walk_args, **walk_kw)
            torch.cuda.synchronize()
            ms = cs.event_ms(torch, lambda: exact.goto_walk(*walk_args, **walk_kw), 10)
            prof = cs.profile_search(torch, lambda: exact.goto_walk(*walk_args, **walk_kw), 10,
                                     tpb.LAUNCHES)
        finally:
            kern.lib = base
        per_launch = {key: cs.launch_ms(prof, key) for key in prof["events"]
                      if "Memcpy" not in key and "Memset" not in key}
        equal = bool(cs.int_err(found, p_found) == 0 and alive == p_alive)
        out["variants"][name] = {
            "events_ms_per_walk": ms, "device_ms_per_launch": per_launch,
            "arrivals": int(found.shape[1]), "alive": alive[:4], "equal_to_plain": equal,
            "registers": regs}
        print(f"walk_variants: {name}: {ms:.4f} ms per walk, equal {equal}, per launch "
              f"{per_launch}", file=sys.stderr, flush=True)
        if same and not equal:
            print(f"walk_variants: {name} differs from the plain version", file=sys.stderr)
            print(json.dumps(out))
            return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
