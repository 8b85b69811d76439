#!/usr/bin/env python3
"""Smoke run of the torch port on one CUDA card.

Drives the port's two main paths once at full size, through the entry
points a user calls (build an engine, ``search_raw``), and checks every CUDA
kernel they run against its plain torch version. Phases:

1. card: ``nvidia-smi`` name and power limit, CUDA version, device name;
2. build: compile ``csrc/packed_bitap.cu`` and ``csrc/banded_dp.cu`` with
   nvcc (sm_90a, one process per source, in parallel) from the checkout;
   report build seconds and ptxas registers / spills;
3. kernel vs plain on the card, bit for bit: the scan and replay kernels on
   the headline dictionary's exact tables over a 4 MiB slice and on k=1
   Damerau / k=2 tables over planted 1- and 2-edit words; the banded DP
   kernel on the candidates of the headline ``edits(1)`` engine and of an
   ``edits(2)`` engine over the same planted slice, and of a dictionary with
   multi-byte edges (the dead-end filter) over a Unicode corpus;
4. exact main path: the headline 16-word case-insensitive dictionary
   searched exact (threshold 0.5) over a 96 MiB seeded corpus, two warm-up
   searches then best of three; the match set must equal an independent
   ``str.find`` count; the scan and replay launch counters must be > 0;
4b. fuzzy main path: the same dictionary with ``edits(1)`` at threshold 0.8
   over the same corpus, timed the same way; the plain versions are locked
   out during the run and the scan, replay and DP launch counters must be
   > 0; the match set must equal an independent one built by the port's
   oracle over each distinct word context (no scan, no DP, no slicing);
5. parity: device vs the port's oracle on 64 KiB (exact) and 32 KiB with
   planted edits (fuzzy); the exact streaming branch vs the resident one on
   8 MiB; the fuzzy sliced pipeline (1 MiB slices) vs unsliced on 8 MiB;
6. times: CUDA-event times of each kernel and of its plain version at the
   main paths' shapes, and their agreement there.

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
#: A dictionary with multi-byte trie edges (the DP's dead-end filter) and
#: the words of its Unicode corpus.
UNICODE_WORDS = ["привет", "москва", "ирина", "тест", "café", "naïve", "straße"]
UNICODE_FILLER = ["и", "мы", "тесты", "кафе", "она", "дом", "cafe", "weiter", "über"]
#: Characters a word context carries past its word's trailing space: with
#: E = 1 a match spans at most Lmax + E = 13 characters.
CONTEXT_TAIL = 14


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


def edit(w: str, rng) -> str:
    """One substitution, deletion, insertion or adjacent swap inside ``w``."""
    i, op = int(rng.integers(1, len(w) - 2)), int(rng.integers(4))
    return [w[:i] + "x" + w[i + 1:], w[:i] + w[i + 1:], w[:i] + "q" + w[i:],
            w[:i] + w[i + 1] + w[i] + w[i + 2:]][op]


def plant(text: str, seed: int, count: int, edits=(1, 2)) -> str:
    """``text`` (ASCII) with ``count`` headline words planted, each with a
    number of edits drawn from ``edits``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    buf = bytearray(text.encode())
    for at in rng.integers(0, len(buf) - 32, size=count).tolist():
        w = HEADLINE[int(rng.integers(len(HEADLINE)))]
        for _ in range(int(rng.integers(edits[0], edits[1] + 1))):
            w = edit(w, rng)
        buf[at:at + len(w)] = w.encode()
    return buf.decode()


def unicode_corpus(words: int, seed: int) -> str:
    """Unicode filler with ``UNICODE_WORDS`` at 1 in 4, half of them with one
    edit; mixed case."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(words):
        if rng.integers(4) == 0:
            w = UNICODE_WORDS[int(rng.integers(len(UNICODE_WORDS)))]
            w = edit(w, rng) if rng.integers(2) else w
        else:
            w = UNICODE_FILLER[int(rng.integers(len(UNICODE_FILLER)))]
        out.append(w.upper() if rng.integers(5) == 0 else w)
    return " ".join(out)


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


def compare_dp(vdp, torch, engine, text: str, thr: float, what: str):
    """DP kernel vs ``banded_dp_torch`` on the candidates the lane builds for
    ``text`` (its first slice), bit for bit. Returns the max_abs_err."""
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    view = view_of(text, engine.case_insensitive)
    n = len(view)
    plan = vdp.dp_plan(engine, thr, n)
    require(plan is not None, f"{what}: the DP lane declined")
    run = vdp.dp_inputs(engine, text, plan, view, n)
    part = run.parts[0]
    hits, cf, cs = vdp.dp_candidates(run, part)
    args = (cf, cs, part.ids_de, part.local_n, run.T, run.pens, plan.E, run.deadend)
    pen_k, cnt_k = vdp.banded_dp(*args)
    pen_p, cnt_p = vdp.banded_dp_torch(*args)
    torch.cuda.synchronize()
    equal = (torch.equal(pen_k.view(torch.int32), pen_p.view(torch.int32))
             and torch.equal(cnt_k, cnt_p))
    both = torch.isfinite(pen_k) & torch.isfinite(pen_p)
    err = max(float((pen_k - pen_p)[both].abs().max()) if bool(both.any()) else 0.0,
              float((cnt_k - cnt_p).abs().max()) if cnt_k.numel() else 0.0)
    live = int(torch.isfinite(pen_p).sum())
    log(f"  {what}: E={plan.E} k={plan.k} damerau={plan.dam} dead-end={run.deadend} "
        f"C={run.T.C} {'u8' if part.ids_de.dtype == torch.uint8 else 'int32'} ids, "
        f"n={n} hits={hits} candidates={cf.numel()} live channels={live}; "
        f"bit-equal {equal}, max_abs_err {err}")
    require(equal, f"{what}: DP kernel disagrees with banded_dp_torch")
    require(cf.numel() > 0 and live > 0, f"{what}: nothing to compare")
    return err


def ptxas_summary(log_text: str):
    """(lines for the main paths' instantiations: the W=3 scan and replay at
    k=0 and at k<=2 with Damerau rows, and every banded DP instantiation;
    number of instantiations, number of them with spills, max registers)."""
    import re

    entries, cur = [], None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            cur = {"name": line.split("'")[1]}
            entries.append(cur)
        elif cur is not None and "spill stores" in line:
            cur["spill"] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif cur is not None and "Used" in line and "registers" in line:
            cur["regs"] = int(line.split("Used")[1].split("registers")[0])
    main = []
    for e in entries:
        name = e["name"]
        dp = re.search(r"banded_dp_kernelILi(\d)ELb([01])E([hi])", name)
        if dp:
            label = (f"banded_dp<E={dp.group(1)},deadend={dp.group(2)},"
                     f"{'u8' if dp.group(3) == 'h' else 'int32'}>")
        elif "ILi3ELi0ELb0E" in name or "ILi3ELi2ELb1E" in name:
            kind = "scan" if "scan_flags" in name else "replay"
            label = f"{kind}<W=3,{'K=0' if 'ILi3ELi0ELb0E' in name else 'K<=2,Damerau'}>"
        else:
            continue
        main.append(f"{label}: {e.get('regs')} registers, {e.get('spill')} bytes spill stores")
    spills = sum(1 for e in entries if e.get("spill", 0) > 0)
    regs = max((e.get("regs", 0) for e in entries), default=0)
    return main, len(entries), spills, regs


class plain_locked:
    """Within the block, the plain versions of the kernels raise: a main
    path that reached one would fail instead of running on it."""

    def __init__(self, *modules_and_names):
        self.targets = modules_and_names

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n in self.targets]

        def refuse(*_a, **_k):
            raise AssertionError("a plain version ran on the main path")

        for m, n, _f in self.saved:
            setattr(m, n, refuse)

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)
        return False


def profile_search(torch, fn, reps: int):
    """torch.profiler over ``reps`` calls of ``fn``: (wall ms per call,
    device ms per call summed over the device's own events (kernels and
    copies), lines of the top device events, {event name: device ms per
    call})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU:
            continue  # host ops also carry the time of the kernels they launched
        rows.append((ev.self_device_time_total / reps / 1e3, ev.count // reps, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    lines = [f"{ms:9.4f} ms x{cnt:<4d} {key[:90]}" for ms, cnt, key in rows[:12]]
    return wall, busy, lines, {key: ms for ms, _cnt, key in rows}


def stage_breakdown(torch, vdp, engine, corpus: str, thr: float):
    """Host-clock ms of each stage of one fuzzy search, each stage ended by a
    synchronise: plan and device inputs (cache lookups), then per slice the
    scan, compaction, replay and expansion, the DP, the emission with its
    readback, and the host decode."""
    import numpy as np

    from fuzzy_aho_corasick_tpu_torch.ops.emit import decode_matches
    from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

    ms = dict.fromkeys(("view, plan, inputs", "scan + replay + expand", "banded_dp",
                        "emit + readback", "decode"), 0.0)

    def lap(name, t0):
        torch.cuda.synchronize()
        ms[name] += (time.perf_counter() - t0) * 1e3
        return time.perf_counter()

    torch.cuda.synchronize()
    t = time.perf_counter()
    view = view_of(corpus, engine.case_insensitive)
    plan = vdp.dp_plan(engine, thr, len(view))
    run = vdp.dp_inputs(engine, corpus, plan, view, len(view))
    t = lap("view, plan, inputs", t)
    rows = []
    for part in run.parts:
        _h, cf, cs = vdp.dp_candidates(run, part)
        t = lap("scan + replay + expand", t)
        pen, cnt = vdp.banded_dp(cf, cs, part.ids_de, part.local_n, run.T, run.pens,
                                 plan.E, run.deadend)
        t = lap("banded_dp", t)
        r = vdp.emit_rows(pen, cnt, cf, cs, run.T, part.local_n, np.float32(thr),
                          plan.E).cpu().numpy()
        r[:, 0] += part.base
        rows.append(r)
        t = lap("emit + readback", t)
    r = np.concatenate(rows)
    out = decode_matches(engine, view, corpus, len(view), r[:, 0], r[:, 2], r[:, 3],
                         np.ascontiguousarray(r[:, 1]).view(np.float32), r[:, 4],
                         np.float32(thr))
    lap("decode", t)
    return ms, len(out)


def context_oracle_set(oracle, engine, corpus: str, thr: float, key):
    """The match set of ``engine`` over ``corpus`` (ASCII, single-space
    separated words), built by the port's oracle without the scan, the DP
    or the slicing: one oracle search per distinct context "word, its
    trailing space, and the next ``CONTEXT_TAIL`` characters", keeping the
    matches that start inside the word or its space, shifted to every
    occurrence of that context. Returns (set, number of contexts)."""
    import numpy as np

    n = len(corpus)
    spaces = np.flatnonzero(np.frombuffer(corpus.encode(), np.uint8) == 32)
    starts = np.concatenate([[0], spaces + 1]).tolist()
    ends = np.minimum(np.concatenate([spaces + 1 + CONTEXT_TAIL, [n]]), n).tolist()
    groups = {}
    for s, e in zip(starts, ends):
        if s < e:
            groups.setdefault(corpus[s:e], []).append(s)
    want = set()
    for ctx, occ in groups.items():
        own = ctx.find(" ") + 1 or len(ctx)
        for m in oracle.search_raw(engine, ctx, thr):
            if m.start < own:
                p, st, en, *rest = key(m)
                want.update((p, s + st, s + en, *rest) for s in occ)
    return want, len(groups)


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

    from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits, oracle
    from fuzzy_aho_corasick_tpu_torch.ops import _cuda_build
    from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
    from fuzzy_aho_corasick_tpu_torch.ops import verify_dp as vdp
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
    _pos, err_scan_all, err_replay_all = compare(tpb, torch, ids4, T, pk.m_max,
                                                 "exact k=0 W=3 A=21, 4 MiB")
    edited = plant(slice4, SEED + 1, 4000)
    for k, dam in ((1, True), (2, False)):
        TF, lut, halo = fuzzy_tables(tpb, HEADLINE, k, dam, dev)
        fids = torch.from_numpy(lut[np.frombuffer(edited.encode(), np.uint8)]).to(dev)
        _pos, es, er = compare(tpb, torch, fids, TF, halo,
                               f"k={k} {'Damerau' if dam else 'plain'} W={TF.W}, 4 MiB planted edits")
        err_scan_all, err_replay_all = max(err_scan_all, es), max(err_replay_all, er)

    def fuzzy_engine(words, edits):
        eng = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(edits))
               .case_insensitive(True).device(dev).build(words))
        eng.backend = "device"
        return eng

    fuzzy = fuzzy_engine(HEADLINE, 1)
    uni = fuzzy_engine(UNICODE_WORDS, 1)
    require(uni.dense.has_multibyte_edges, "the Unicode dictionary has multi-byte edges")
    err_dp_all = 0.0
    for eng, text, thr, what in (
        (fuzzy, edited, 0.8, "DP headline edits(1), 4 MiB planted edits"),
        (fuzzy_engine(HEADLINE, 2), edited, 0.8, "DP headline edits(2), 4 MiB planted edits"),
        (uni, unicode_corpus(40000, SEED + 3), 0.6, "DP multi-byte edges (dead-end), Unicode"),
    ):
        err_dp_all = max(err_dp_all, compare_dp(vdp, torch, eng, text, thr, what))

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

    # 4b. fuzzy main path, full size
    log("phase 4b fuzzy main path:")
    t_phase = time.perf_counter()
    for k in tpb.LAUNCHES:
        tpb.LAUNCHES[k] = 0
    with plain_locked((tpb, "scan_flags_torch"), (tpb, "replay_words_torch"),
                      (vdp, "banded_dp_torch")):
        t0 = time.perf_counter()
        got_f = fuzzy.search_raw(corpus, 0.8)
        first_f = time.perf_counter() - t0
        fuzzy.search_raw(corpus, 0.8)
        best_f = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got_f = fuzzy.search_raw(corpus, 0.8)
            torch.cuda.synchronize()
            best_f = min(best_f, time.perf_counter() - t0)
    launches_f = dict(tpb.LAUNCHES)
    stats = dict(fuzzy.last_stats)
    log(f"  {len(corpus)} bytes, first search {first_f:.3f} s (transcode + upload), "
        f"best of 3 {best_f * 1e3:.3f} ms = {len(corpus) / best_f / 1e9:.3f} GB/s, "
        f"{len(got_f)} matches, launches {launches_f}")
    log(f"  last_stats {stats}")
    require(stats["backend"] == "device-fuzzy-dp", "fuzzy main path backend")
    require(all(launches_f[k] > 0 for k in ("scan", "replay", "dp")),
            "fuzzy main path did not launch all three kernels")
    keyf = lambda m: (m.pattern_index, m.start, m.end,
                      np.float32(m.similarity).view(np.uint32).item(),
                      m.insertions, m.deletions, m.substitutions, m.swaps)
    dev_f = {keyf(m) for m in got_f}
    require(len(dev_f) == len(got_f), "fuzzy main path repeats a match")
    t0 = time.perf_counter()
    want_f, n_ctx = context_oracle_set(oracle, fuzzy, corpus, 0.8, keyf)
    log(f"  independent context oracle: {n_ctx} contexts, {len(want_f)} matches, "
        f"{time.perf_counter() - t0:.1f} s; equal: {dev_f == want_f}")
    require(dev_f == want_f, "fuzzy main path disagrees with the context oracle")
    require(len(want_f) > 1000, "too few fuzzy matches to be a real check")
    log(f"  fuzzy matches {len(got_f)} = 3 x exact matches ({len(got)}): "
        f"{len(got_f) == 3 * len(got)}")
    wall_f, busy_f, prof_lines, by_event = profile_search(
        torch, lambda: fuzzy.search_raw(corpus, 0.8), 3)
    log(f"  torch.profiler over 3 searches: wall {wall_f:.3f} ms per search, device busy "
        f"{busy_f:.3f} ms ({busy_f / wall_f:.3f} of wall)")
    for line in prof_lines:
        log(f"    {line}")
    for name in ("scan_flags_kernel", "replay_words_kernel", "banded_dp_kernel"):
        dev_ms = sum(v for k, v in by_event.items() if name in k)
        log(f"    {name}: {dev_ms:.4f} ms device time per search")
    stages, n_stage = stage_breakdown(torch, vdp, fuzzy, corpus, 0.8)
    require(n_stage == len(got_f), "stage breakdown found other matches")
    log(f"  stages (host clock, synchronised, ms per search): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; sum {sum(stages.values()):.3f}")
    log(f"  phase 4b {time.perf_counter() - t_phase:.1f} s")

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
    text = plant(corpus[: 32 << 10], SEED + 4, 300)
    dev_r = sorted(map(keyf, fuzzy.search_raw(text, 0.8)))
    require(fuzzy.last_stats["backend"] == "device-fuzzy-dp", "fuzzy parity backend")
    fuzzy.backend = "oracle"
    ora_r = sorted(map(keyf, fuzzy.search_raw(text, 0.8)))
    fuzzy.backend = "device"
    log(f"  fuzzy 32 KiB prefix + 300 planted 1-2 edit words, device vs oracle: "
        f"{len(dev_r)} vs {len(ora_r)} matches, equal {dev_r == ora_r}")
    require(dev_r == ora_r and len(dev_r) > 100, "fuzzy device disagrees with the oracle")
    whole_r = sorted(map(keyf, fuzzy.search_raw(part, 0.8)))
    require(fuzzy.last_stats["slices"] == 1, "8 MiB runs as one slice")
    saved = vdp.SLICE_SYMS
    vdp.SLICE_SYMS = 1 << 20
    try:
        sliced_r = sorted(map(keyf, fuzzy.search_raw(part, 0.8)))
        n_slices = fuzzy.last_stats["slices"]
    finally:
        vdp.SLICE_SYMS = saved
    log(f"  fuzzy 8 MiB in {n_slices} slices of 1 MiB vs unsliced: {len(sliced_r)} vs "
        f"{len(whole_r)} matches, equal {sliced_r == whole_r}")
    require(n_slices == 8 and sliced_r == whole_r and len(whole_r) > 0,
            "sliced fuzzy search disagrees with unsliced")

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

    # The fuzzy path's shapes: one slice of the main path (k = 1 Damerau
    # scan and replay, then the DP over that slice's candidates).
    view = view_of(corpus, True)
    plan = vdp.dp_plan(fuzzy, 0.8, len(view))
    run = vdp.dp_inputs(fuzzy, corpus, plan, view, len(view))
    fpart = run.parts[0]
    ids_f, T_f, halo_f = fpart.ids_pf, run.T_scan, run.halo
    flags_k = tpb.scan_flags(ids_f, T_f, halo_f)
    flags_p = tpb.scan_flags_torch(ids_f, T_f, halo_f)
    pos_f = tpb.compact_indices(flags_k)
    words_k = tpb.replay_words(ids_f, pos_f, T_f, halo_f)
    words_p = tpb.replay_words_torch(ids_f, pos_f, T_f, halo_f)
    hits_f, cf, cs = vdp.dp_candidates(run, fpart)
    dp_args = (cf, cs, fpart.ids_de, fpart.local_n, run.T, run.pens, plan.E, run.deadend)
    pen_k, cnt_k = vdp.banded_dp(*dp_args)
    pen_p, cnt_p = vdp.banded_dp_torch(*dp_args)
    torch.cuda.synchronize()
    err_scan_f = int((flags_k.to(torch.int16) - flags_p.to(torch.int16)).abs().max())
    err_replay_f = int((words_k - words_p).abs().max())
    require(err_scan_f == 0 and err_replay_f == 0, "k=1 Damerau kernels disagree at main-path shapes")
    require(torch.equal(pen_k.view(torch.int32), pen_p.view(torch.int32))
            and torch.equal(cnt_k, cnt_p), "DP kernel disagrees at main-path shapes")
    both = torch.isfinite(pen_k)
    err_dp = max(float((pen_k - pen_p)[both].abs().max()) if bool(both.any()) else 0.0,
                 float((cnt_k - cnt_p).abs().max()))
    scan_f_ms = event_ms(torch, lambda: tpb.scan_flags(ids_f, T_f, halo_f), 20)
    scan_f_plain_ms = event_ms(torch, lambda: tpb.scan_flags_torch(ids_f, T_f, halo_f), 3)
    replay_f_ms = event_ms(torch, lambda: tpb.replay_words(ids_f, pos_f, T_f, halo_f), 20)
    replay_f_plain_ms = event_ms(torch, lambda: tpb.replay_words_torch(ids_f, pos_f, T_f, halo_f), 5)
    dp_ms = event_ms(torch, lambda: vdp.banded_dp(*dp_args), 20)
    dp_plain_ms = event_ms(torch, lambda: vdp.banded_dp_torch(*dp_args), 3)
    log(f"  fuzzy slice 1 of {len(run.parts)}: {fpart.local_n} symbols "
        f"({ids_f.numel()} padded), k={plan.k} damerau={plan.dam} halo={halo_f}")
    log(f"  scan_flags k=1 Damerau: kernel {scan_f_ms:.4f} ms, plain {scan_f_plain_ms:.4f} ms, "
        f"max_abs_err {err_scan_f}")
    log(f"  replay_words k=1 Damerau: {pos_f.numel()} hits, kernel {replay_f_ms:.4f} ms, "
        f"plain {replay_f_plain_ms:.4f} ms, max_abs_err {err_replay_f}")
    log(f"  banded_dp E={plan.E}: {cf.numel()} candidates, "
        f"{int(torch.isfinite(pen_k).sum())} live channels, kernel {dp_ms:.4f} ms, "
        f"plain {dp_plain_ms:.4f} ms, max_abs_err {err_dp}")
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    src = f"{PKG}/csrc/packed_bitap.cu"
    print(json.dumps({"kernels": [
        {"name": "scan_flags", "route": "cuda", "source": src,
         "replaces": "fuzzy_aho_corasick_tpu/ops/packed_bitap.py:534",
         "launches": launches["scan"] + launches_f["scan"],
         "max_abs_err": max(err_scan, err_scan_f, err_scan_all),
         "ms": scan_ms, "plain_ms": scan_plain_ms,
         "fuzzy_ms": scan_f_ms, "fuzzy_plain_ms": scan_f_plain_ms},
        {"name": "replay_words", "route": "cuda", "source": src,
         "replaces": "fuzzy_aho_corasick_tpu/ops/packed_bitap.py:620",
         "launches": launches["replay"] + launches_f["replay"],
         "max_abs_err": max(err_replay, err_replay_f, err_replay_all),
         "ms": replay_ms, "plain_ms": replay_plain_ms,
         "fuzzy_ms": replay_f_ms, "fuzzy_plain_ms": replay_f_plain_ms},
        {"name": "banded_dp", "route": "cuda", "source": f"{PKG}/csrc/banded_dp.cu",
         "replaces": "fuzzy_aho_corasick_tpu/ops/verify_dp.py:292",
         "launches": launches_f["dp"], "max_abs_err": max(err_dp, err_dp_all),
         "ms": dp_ms, "plain_ms": dp_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
