#!/usr/bin/env python3
"""Smoke run of the torch port on one CUDA card.

Drives the port's exact-search main path once at full size, through the
entry points a user calls (build an engine, ``search_raw``), and checks the
CUDA kernels it runs against their plain torch versions. Phases:

1. card: ``nvidia-smi`` name and power limit, CUDA version, device name;
2. build: compile ``csrc/packed_bitap.cu`` with nvcc (sm_90a) from the
   checkout, report build seconds and ptxas registers / spills;
3. kernel vs plain on the card, bit for bit: the headline dictionary's
   exact tables over a 4 MiB slice, and k=1 Damerau / k=2 tables over a
   corpus with planted 1- and 2-edit occurrences;
4. main path: the headline 16-word case-insensitive dictionary searched
   exact (threshold 0.5) over a 96 MiB seeded corpus, two warm-up searches
   then best of three; the match set must equal an independent
   ``str.find`` count; the kernels' launch counters must be > 0;
5. parity: device vs the port's oracle on a 64 KiB prefix; the streaming
   branch vs the resident branch on 8 MiB;
6. times: CUDA-event times of each kernel and of its plain version at the
   main path's shapes, and their agreement there.

Any failed phase raises, so the script exits non-zero. It prints one JSON
line of kernel results before the last line, and as the last line
``{"ok": true, "device": {...}}``. Run from the repository root:

    python3 chip_smoke.py
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "fuzzy_aho_corasick_tpu_torch"

HEADLINE = [
    "tincidunt", "phaetra", "sollicitudin", "venenatis", "fringilla",
    "ullamcorper", "pellentesque", "sagittis", "condimentum", "habitasse",
    "malesuada", "scelerisque", "imperdiet", "vulputate", "ridiculus",
    "parturient",
]
FILLER = [
    "lorem", "ipsum", "dolor", "sit", "amet", "consectetur", "adipiscing",
    "elit", "vestibulum", "eros", "commodo", "accumsan", "porta", "orci",
]
NEEDLES = ["tincidunt", "phaetra", "sollicitudin"]
CORPUS_BYTES = 96 << 20
SEED = 42


def log(msg: str) -> None:
    print(msg, flush=True)


def build_corpus(size: int, seed: int) -> str:
    """The headline corpus recipe: filler words with one of three needles
    at 1 in 997, space-joined, drawn vectorised from a seeded generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = FILLER + NEEDLES
    mean = sum(len(w) + 1 for w in FILLER) / len(FILLER)
    count = int(size / mean * 1.02) + 1024
    idx = rng.integers(len(FILLER), size=count)
    needle = rng.integers(997, size=count) == 0
    idx[needle] = len(FILLER) + rng.integers(len(NEEDLES), size=int(needle.sum()))
    lens = np.array([len(w) + 1 for w in vocab])[idx]
    keep = int(np.searchsorted(np.cumsum(lens), size)) + 2
    return " ".join([vocab[i] for i in idx[:keep].tolist()])[:size]


def plant(text: str, seed: int, count: int, edits=(1, 2)) -> str:
    """``text`` with ``count`` headline words planted, each with a number of
    edits drawn from ``edits`` (substitution, deletion, insertion, adjacent
    swap)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    buf = bytearray(text.encode())
    for at in rng.integers(0, len(buf) - 32, size=count).tolist():
        w = HEADLINE[int(rng.integers(len(HEADLINE)))]
        for _ in range(int(rng.integers(edits[0], edits[1] + 1))):
            i, op = int(rng.integers(1, len(w) - 2)), int(rng.integers(4))
            w = [w[:i] + "x" + w[i + 1:], w[:i] + w[i + 1:], w[:i] + "q" + w[i:],
                 w[:i] + w[i + 1] + w[i] + w[i + 2:]][op]
        buf[at:at + len(w)] = w.encode()
    return buf.decode()


def fuzzy_tables(tpb, words, k, damerau, device):
    """k >= 1 tables for ``words`` from the numpy mask helpers, plus the
    byte -> symbol table (case-folded). Returns (tables, lut, halo)."""
    import numpy as np

    alphabet = sorted(set("".join(words)))
    sym = {c: i + 1 for i, c in enumerate(alphabet)}
    A = len(alphabet) + 1
    ms = [len(w) for w in words]
    offs = tpb._pack_fields(ms)
    W = max(lw for lw, _ in offs) + 1
    limb = np.zeros((A, W), np.uint64)
    for w, (lw, lo) in zip(words, offs):
        for i, c in enumerate(w):
            limb[sym[c], lw] |= np.uint64(1) << np.uint64(lo + i)
    match, init, kk = tpb.fuzzy_masks(offs, ms, W, [k] * len(words))
    notlast = tpb.notlast_mask(offs, ms, W) if damerau else None
    T = tpb.tables_from_numpy(tpb._word_table(limb, A, W), tpb._starts_mask(offs, W),
                              match, init, notlast, device=device)
    lut = np.zeros(256, np.uint8)
    for c, s in sym.items():
        lut[ord(c)] = lut[ord(c.upper())] = s
    return T, lut, max(ms) + kk


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def compare(tpb, torch, ids, T, halo, what):
    """Kernel vs plain version of both kernels on ``ids``; returns the hit
    positions and the largest absolute difference seen (0 when bit-equal)."""
    fk = tpb.scan_flags(ids, T, halo)
    fp = tpb.scan_flags_torch(ids, T, halo)
    pos = tpb.compact_indices(fp)
    wk = tpb.replay_words(ids, pos, T, halo)
    wp = tpb.replay_words_torch(ids, pos, T, halo)
    torch.cuda.synchronize()
    err_scan = int((fk.to(torch.int16) - fp.to(torch.int16)).abs().max()) if fk.numel() else 0
    err_replay = int((wk - wp).abs().max()) if wk.numel() else 0
    log(f"  {what}: n={ids.numel()} hits={pos.numel()} "
        f"scan max_abs_err={err_scan} replay max_abs_err={err_replay}")
    require(err_scan == 0 and err_replay == 0, f"{what}: kernel disagrees with plain version")
    require(pos.numel() > 0, f"{what}: no hits to compare")
    return pos, err_scan, err_replay


def event_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def ptxas_summary(log_text: str):
    """(per-kernel lines for the main path's W=3, k=0 kernels, number of
    instantiations, number of them with spills, max registers)."""
    entries, cur = [], None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            cur = {"name": line.split("'")[1]}
            entries.append(cur)
        elif cur is not None and "spill stores" in line:
            cur["spill"] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif cur is not None and "Used" in line and "registers" in line:
            cur["regs"] = int(line.split("Used")[1].split("registers")[0])
    main = [f"{'scan' if 'scan_flags' in e['name'] else 'replay'}<W=3,K=0>: "
            f"{e.get('regs')} registers, {e.get('spill')} bytes spill stores"
            for e in entries if "ILi3ELi0ELb0E" in e["name"]]
    spills = sum(1 for e in entries if e.get("spill", 0) > 0)
    regs = max((e.get("regs", 0) for e in entries), default=0)
    return main, len(entries), spills, regs


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, PKG, "csrc")):
        print(f"chip_smoke: {PKG}/ is not beside this script; run it from the "
              "repository root", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder
    from fuzzy_aho_corasick_tpu_torch.ops import _cuda_build
    from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
    from fuzzy_aho_corasick_tpu_torch.utils import device_corpus
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("phase 1 card:")
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
        f"count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    kern = _cuda_build.load()
    main_lines, n_inst, n_spill, max_regs = ptxas_summary(kern.log)
    log(f"phase 2 build: {kern.path.relative_to(HERE)} nvcc {kern.build_seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s); {n_inst} kernel instantiations, "
        f"{n_spill} with spills, max {max_regs} registers")
    for line in main_lines:
        log(f"  ptxas {line}")

    # 3. kernel vs plain on the card
    log("phase 3 kernel vs plain:")
    corpus = build_corpus(CORPUS_BYTES, SEED)
    require(len(corpus) == CORPUS_BYTES, "corpus size")
    engine = (FuzzyAhoCorasickBuilder.new().case_insensitive(True).device(dev)
              .build(HEADLINE))
    engine.backend = "device"
    pk = tpb.packed_exact_of(engine)
    require((pk.W, pk.A, pk.m_max) == (3, 21, 12), f"headline tables W/A/m_max {pk.W}/{pk.A}/{pk.m_max}")
    T, cols, shs = tpb._exact_consts(engine, pk, dev)
    slice4 = corpus[: 4 << 20]
    ids4 = torch.from_numpy(pk.transcode(slice4, view_of(slice4, True), engine.dense)).to(dev)
    compare(tpb, torch, ids4, T, pk.m_max, "exact k=0 W=3 A=21, 4 MiB")
    edited = plant(slice4, SEED + 1, 4000)
    for k, dam in ((1, True), (2, False)):
        TF, lut, halo = fuzzy_tables(tpb, HEADLINE, k, dam, dev)
        fids = torch.from_numpy(lut[np.frombuffer(edited.encode(), np.uint8)]).to(dev)
        compare(tpb, torch, fids, TF, halo,
                f"k={k} {'Damerau' if dam else 'plain'} W={TF.W}, 4 MiB planted edits")

    # 4. main path, full size
    log("phase 4 main path:")
    for key in tpb.LAUNCHES:
        tpb.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    got = engine.search_raw(corpus, 0.5)
    first_s = time.perf_counter() - t0
    engine.search_raw(corpus, 0.5)
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = engine.search_raw(corpus, 0.5)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    launches = dict(tpb.LAUNCHES)
    log(f"  {len(corpus)} bytes, first search {first_s:.3f} s (transcode + upload), "
        f"best of 3 {best * 1e3:.3f} ms = {len(corpus) / best / 1e9:.3f} GB/s, "
        f"{len(got)} matches, launches {launches}")
    require(launches["scan"] > 0 and launches["replay"] > 0, "main path did not launch both kernels")
    require(engine.last_stats["backend"] == "device-exact-packed", "main path backend")
    dev_set = {(m.pattern_index, m.start, m.end) for m in got}
    require(all(m.similarity == 1.0 and m.edits == 0 for m in got), "exact matches carry weight 1.0")
    low = corpus.lower()
    want = set()
    for pi, w in enumerate(HEADLINE):
        at = low.find(w)
        while at >= 0:
            want.add((pi, at, at + len(w)))
            at = low.find(w, at + 1)
    log(f"  independent str.find count {len(want)}; equal: {dev_set == want}")
    require(len(got) == len(dev_set) and dev_set == want, "main path disagrees with str.find")
    require(len(want) > 1000, "too few matches to be a real check")

    # Where the time goes (host clock around synchronised stages).
    ids_dev, _n = device_corpus.resident(
        corpus, ("pk-exact", tpb._space_token(engine)),
        lambda h: pk.transcode(h, view_of(h, True), engine.dense), dev)
    dev_s = event_ms(torch, lambda: tpb._run_exact_kernel(ids_dev, T, pk.m_max, cols, shs), 5)
    scan_only = event_ms(torch, lambda: tpb.scan_flags(ids_dev, T, pk.m_max), 20)
    log(f"  breakdown: search_raw {best * 1e3:.3f} ms; device pass + readback "
        f"{dev_s:.3f} ms (scan kernel {scan_only:.3f} ms); host rest "
        f"{best * 1e3 - dev_s:.3f} ms")

    # 5. parity
    log("phase 5 parity:")
    key = lambda m: (m.pattern_index, m.start, m.end,
                     np.float32(m.similarity).view(np.uint32).item(), m.edits)
    prefix = corpus[: 64 << 10]
    for what, text in (("64 KiB prefix", prefix),
                       ("64 KiB prefix + 400 planted words", plant(prefix, SEED + 2, 400, (0, 0)))):
        dev_r = sorted(map(key, engine.search_raw(text, 0.5)))
        engine.backend = "oracle"
        ora_r = sorted(map(key, engine.search_raw(text, 0.5)))
        engine.backend = "device"
        log(f"  {what}, device vs oracle: {len(dev_r)} vs {len(ora_r)} matches, "
            f"equal {dev_r == ora_r}")
        require(dev_r == ora_r and len(dev_r) > 0, "device disagrees with the oracle")
    part = corpus[: 8 << 20]
    resident_r = sorted(map(key, engine.search_raw(part, 0.5)))
    saved = tpb.RESIDENT_MAX, tpb.STREAM_CHUNK
    tpb.RESIDENT_MAX, tpb.STREAM_CHUNK = 1 << 22, 1 << 21
    stream_r = sorted(map(key, engine.search_raw(part, 0.5)))
    tpb.RESIDENT_MAX, tpb.STREAM_CHUNK = saved
    log(f"  8 MiB streaming (2 MiB slices) vs resident: {len(stream_r)} vs "
        f"{len(resident_r)} matches, equal {stream_r == resident_r}")
    require(stream_r == resident_r and len(stream_r) > 0, "streaming disagrees with resident")

    # 6. times and agreement at the main path's shapes
    log("phase 6 times at main-path shapes:")
    halo = pk.m_max
    flags_k = tpb.scan_flags(ids_dev, T, halo)
    flags_p = tpb.scan_flags_torch(ids_dev, T, halo)
    pos = tpb.compact_indices(flags_k)
    words_k = tpb.replay_words(ids_dev, pos, T, halo)
    words_p = tpb.replay_words_torch(ids_dev, pos, T, halo)
    torch.cuda.synchronize()
    err_scan = int((flags_k.to(torch.int16) - flags_p.to(torch.int16)).abs().max())
    err_replay = int((words_k - words_p).abs().max())
    require(err_scan == 0 and err_replay == 0, "kernels disagree at main-path shapes")
    scan_ms = event_ms(torch, lambda: tpb.scan_flags(ids_dev, T, halo), 20)
    scan_plain_ms = event_ms(torch, lambda: tpb.scan_flags_torch(ids_dev, T, halo), 3)
    replay_ms = event_ms(torch, lambda: tpb.replay_words(ids_dev, pos, T, halo), 20)
    replay_plain_ms = event_ms(torch, lambda: tpb.replay_words_torch(ids_dev, pos, T, halo), 5)
    log(f"  scan_flags: {ids_dev.numel()} symbols, kernel {scan_ms:.4f} ms, plain "
        f"{scan_plain_ms:.4f} ms, max_abs_err {err_scan}")
    log(f"  replay_words: {pos.numel()} hits, kernel {replay_ms:.4f} ms, plain "
        f"{replay_plain_ms:.4f} ms, max_abs_err {err_replay}")
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    src = f"{PKG}/csrc/packed_bitap.cu"
    print(json.dumps({"kernels": [
        {"name": "scan_flags", "route": "cuda", "source": src,
         "replaces": "fuzzy_aho_corasick_tpu/ops/packed_bitap.py:534",
         "launches": launches["scan"], "max_abs_err": err_scan,
         "ms": scan_ms, "plain_ms": scan_plain_ms},
        {"name": "replay_words", "route": "cuda", "source": src,
         "replaces": "fuzzy_aho_corasick_tpu/ops/packed_bitap.py:620",
         "launches": launches["replay"], "max_abs_err": err_replay,
         "ms": replay_ms, "plain_ms": replay_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
