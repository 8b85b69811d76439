"""The beam frontier's kernel wrappers (``ops/fuzzy.pool_frontier``,
``sorted_frontier`` and ``order_emissions``, ``csrc/beam.cu``) and the
arithmetic around their launches, on the CPU.

On CPU tensors the wrappers run the plain versions (``_pool_chunk``,
``_beam_chunk`` and ``order_emissions_torch``; ``tests/test_torch_beam.py``
holds the first two against the JAX package); here they are held bit-equal
to them on that file's inputs, and the pieces of the card's pass that run in
Python are checked against the plain output: one count a start, scanned by
the plain ``block_offsets``, stages each start's emissions at its offset, and
the order kernel's plain version puts every emission at its own index; a
run's per-start arrays stay within ``RUN_BYTES``; the workspace and table
sizing take the global scratch, or leave the tables in global memory,
exactly where they stop fitting on chip. A scalar mirror of the kernels'
loops (at E = 1 a thread a start, the starts whose pool outgrows a
thread's walks handed to a warp a start; at E >= 2 a warp a start and its
sort network; the write launch over the starts that emit; the order
kernel's counting sort) is held bit-equal to the plain versions. The kernels
themselves run on the card (``chip_smoke.py`` phase 4j (e)). No JAX function
runs here."""

import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits
from fuzzy_aho_corasick_tpu_torch.ops import fuzzy as tfuzzy
from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of
from test_torch_beam import _cjk1, _long, _overflow

torch.set_num_threads(1)

#: name -> (dictionary and text, edit budget, threshold, starts per chunk):
#: the inputs of ``tests/test_torch_beam.py``'s cases of the same names,
#: with chunks small enough that each run spans several.
CASES = {
    "cjk-e1-seeds": (_cjk1, 1, 0.8, 1024),
    "long-pattern-every-position": (_long, 1, 0.8, 256),
    "e2-overflow-every-position": (_overflow, 2, 0.6, 64),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    make, E, thr, nchunk = CASES[request.param]
    words, hay = make()
    engine = FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(E)).device(
        "cpu").build(words)
    thr = np.float32(thr)
    view = view_of(hay, False)
    n = len(view)
    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr)
    dense = engine.dense
    ids = torch.from_numpy(np.ascontiguousarray(
        dense.transcode(hay, view), dtype=np.uint8 if dense.num_classes <= 256 else np.int32))
    return dict(name=request.param, engine=engine, E=E, nchunk=nchunk, ids=ids,
                starts=tfuzzy._candidate_starts(engine, hay, view, n, thr),
                tabs=tfuzzy.beam_tables(engine, torch.device("cpu")),
                prm=tfuzzy.beam_params(engine, thr, ceil, n, torch.device("cpu")))


def _plain(c, starts, nchunk=None):
    nchunk = nchunk or c["nchunk"]
    if c["E"] == 1:
        return tfuzzy._pool_chunk(starts, c["tabs"], c["prm"], c["ids"], nchunk), None
    return tfuzzy._beam_chunk(starts, c["tabs"], c["prm"], c["ids"], nchunk, 32 + 24 * c["E"])


def _wrapper(c, starts):
    if c["E"] == 1:
        em, stats = tfuzzy.pool_frontier(starts, c["tabs"], c["prm"], c["ids"], c["nchunk"])
        return (em, None), stats
    em, ov, stats = tfuzzy.sorted_frontier(starts, c["tabs"], c["prm"], c["ids"], c["nchunk"],
                                           32 + 24 * c["E"])
    return (em, ov), stats


def _rounds_of_plain(c, starts, monkeypatch):
    """The plain output of ``starts`` with each emission's start index and
    round, captured from its order keys: (emissions, overflow, si, round),
    the overflowed starts' emissions left out."""
    seen = []
    order_key = tfuzzy._order_key

    def capture(si, t, slot, o, *args):
        key = order_key(si, t, slot, o, *args)
        seen.append((si, torch.full_like(si, t), key))
        return key

    monkeypatch.setattr(tfuzzy, "_order_key", capture)
    em, ov = _plain(c, starts)
    monkeypatch.undo()
    si, rd, key = (torch.cat(x) for x in zip(*seen))
    if ov is not None:
        keep = ~ov[si]
        si, rd, key = si[keep], rd[keep], key[keep]
    order = torch.argsort(key)
    return em, ov, si[order], rd[order]


def test_wrappers_on_cpu_equal_to_plain(case):
    """On CPU tensors the wrappers return the plain versions' emissions and
    overflow flags bit for bit, launch nothing and report no kernel stats."""
    starts = case["starts"][:5 * case["nchunk"] + 7]
    before = dict(tpb.LAUNCHES)
    (em, ov), stats = _wrapper(case, starts)
    assert tpb.LAUNCHES == before and stats is None
    want_em, want_ov = _plain(case, starts)
    assert len(em) == 5 and em[0].numel() > 20
    for a, b in zip(em, want_em):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if case["E"] >= 2:
        assert ov.dtype == torch.bool and torch.equal(ov, want_ov)
        assert int(ov.sum()) > 0  # the overflow input overflows starts


def test_wrappers_refuse_other_devices(case):
    """A tensor on neither the CPU nor a CUDA device raises: no plain
    fallback for a device without the kernels."""
    starts = torch.zeros(3, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no frontier kernel"):
        _wrapper(case, starts)
    staged = torch.zeros((3, tfuzzy.STAGED_FIELDS), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no order kernel"):
        tfuzzy.order_emissions(staged, torch.zeros(4, dtype=torch.int32, device="meta"), 3, 2, 5)


def _stage(em, si, rd, n):
    """(counts int32 [n], staged int32 [total, STAGED_FIELDS] start-major at
    the plain ``block_offsets`` of the counts, offsets) of emissions ``em``
    in the JAX order with start index ``si`` and round ``rd`` each."""
    counts = torch.bincount(si, minlength=n).to(torch.int32)
    offsets = tpb.block_offsets(counts)
    # Start-major: a stable sort by start keeps (round, slot, output).
    by_start = torch.argsort(si, stable=True)
    head = torch.ones(si.numel(), dtype=torch.bool)
    s_sorted = si[by_start]
    head[1:] = s_sorted[1:] != s_sorted[:-1]
    idx = torch.arange(si.numel())
    rank = idx - torch.cummax(torch.where(head, idx, 0), dim=0).values
    at = offsets[s_sorted].long() + rank
    assert sorted(at.tolist()) == list(range(si.numel()))  # every index once
    staged = torch.zeros((si.numel(), tfuzzy.STAGED_FIELDS), dtype=torch.int32)
    cols = (si, em[1], em[2], em[4], em[3].view(torch.int32).long(), rd)
    for k, col in enumerate(cols):
        staged[at, k] = col[by_start].to(torch.int32)
    return counts, staged, offsets


def test_count_grid_places_each_emission(case, monkeypatch):
    """The card's placement: each start's emissions counted once (the
    overflowed starts' left at 0), scanned by the plain ``block_offsets``,
    staged start-major at their start's offset with their round, and put in
    order by the order kernel's plain version, give every emission of the
    plain output its own index, across several chunks (the last one short)."""
    nchunk = case["nchunk"]
    starts = case["starts"][:3 * nchunk + 5]
    n = starts.numel()
    em, ov, si, rd = _rounds_of_plain(case, starts, monkeypatch)
    assert torch.equal(si, em[0]) and si.numel() > 20
    counts, staged, offsets = _stage(em, si, rd, n)
    assert int(offsets[-1]) == si.numel() and counts.numel() == n
    if ov is not None:
        assert int(ov.sum()) > 0 and not counts[ov].any()
    got = tfuzzy.order_emissions(staged, offsets, n, nchunk, case["prm"].T)
    for a, b in zip(got, em):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # The staged order is not the JAX order where a chunk emits in two
    # rounds from two starts: the order kernel has work to do.
    assert not torch.equal(staged[:, 0].long(), em[0]) or case["name"] == "cjk-e1-seeds"


@pytest.mark.parametrize("T,nchunk,n", [(5, 8192, 100_000), (71, 1024, 2_294_196),
                                        (13, 8192, 511_810), (300, 4096, 9_000), (2, 64, 1)])
def test_run_len_keeps_the_count_grid_under_its_cap(T, nchunk, n, monkeypatch):
    """The kernels' runs: whole chunks, each run's per-start arrays
    (``RUN_START_BYTES`` a start, whatever T) within ``RUN_BYTES``, every start
    in exactly one run, and phase 4j's cells in one run each (4j (d): 2.29 M
    starts in chunks of 1,024); the plain runs keep the ``GROUP_CANDIDATES``
    sizing."""
    tabs = tfuzzy.BeamTables(*([None] * 14))._replace(
        et_full=torch.zeros((1, 40)), et_deep=torch.zeros((1, 3)))
    full = tfuzzy.RUN_BYTES
    for cap in (full, 1 << 16):
        monkeypatch.setattr(tfuzzy, "RUN_BYTES", cap)
        run = tfuzzy.run_len(1, tabs, nchunk, T, True)
        assert run % nchunk == 0 and run >= nchunk
        assert run * tfuzzy.RUN_START_BYTES <= cap or run == nchunk
        assert run == max(1, cap // (tfuzzy.RUN_START_BYTES * nchunk)) * nchunk
        covered = np.zeros(n, dtype=np.int64)
        for g0 in range(0, n, run):
            covered[g0:g0 + run] += 1
            assert min(run, n - g0) * tfuzzy.RUN_START_BYTES <= max(
                cap, nchunk * tfuzzy.RUN_START_BYTES)
        assert (covered == 1).all()
        if cap == full:
            assert run >= n  # one run
    plain = tfuzzy.run_len(2, tabs, nchunk, T, False)
    assert plain == max(1, tfuzzy.GROUP_CANDIDATES // (80 * 9 * nchunk)) * nchunk


@pytest.mark.parametrize("E", [2, 3, 4, 5, 6])
def test_sorted_workspace_takes_scratch_past_the_block(E):
    """The sorted kernel's warp keeps its beam (B = 32 + 24 E states) and up
    to ``SORT_CHIP_KEYS`` candidates on chip, 16 bytes each, eight warps a
    block; it takes a region of the global scratch (the round's most
    candidates, max(2 Df + 3, B (2 Dd + 3))) exactly where those pass the
    keys on chip."""
    B = 32 + 24 * E
    chip = tfuzzy.SORT_CHIP_KEYS
    for dd in range(0, 60):
        lay = tfuzzy.frontier_workspace(E, 5, dd, 10)
        most = max(13, B * (2 * dd + 3))
        assert lay.units == tfuzzy.SORT_THREADS // 32 and lay.light_chip == lay.light_ws == 0
        assert lay.chip == min(chip, most)
        assert lay.ws == lay.units * 16 * (B + lay.chip) <= tfuzzy.FRONTIER_SMEM_MAX
        assert lay.spill == (16 * most if most > chip else 0)
    assert tfuzzy.frontier_workspace(E, 5, 1, 10).spill == 16 * B * 5  # every E: past 128
    # The root round's width counts where it is the wider.
    lay = tfuzzy.frontier_workspace(E, 20_000, 1, 10)
    assert lay.spill == 16 * (2 * 20_000 + 3)
    # ... exactly from the first Df whose 2 Df + 3 candidates pass B (2 Dd + 3).
    wide = next(Df for Df in range(1, 2000) if 2 * Df + 3 > 5 * B)
    assert tfuzzy.frontier_workspace(E, wide, 1, 10).spill == 16 * (2 * wide + 3)
    assert tfuzzy.frontier_workspace(E, wide - 1, 1, 10).spill == 16 * 5 * B


def test_pool_workspace_takes_scratch_past_the_block():
    """The pool's thread path keeps ``THREAD_POOL_WALKS`` walks a thread on
    chip (16 bytes each, ``POOL_THREADS`` threads a block); its warp path keeps
    up to ``POOL_CHIP_WALKS`` walks a warp, eight warps a block, and takes a
    region of the global scratch (the pool's most walks, P = S0 + (T - 1) Sd)
    exactly where P passes them."""
    Df, Dd = 12, 3
    P = lambda T: (2 * Df + 2) + (T - 1) * (2 * Dd + 2)
    for T in range(1, 200):
        lay = tfuzzy.frontier_workspace(1, Df, Dd, T)
        assert lay.units == tfuzzy.POOL_THREADS // 32
        assert lay.chip == min(tfuzzy.POOL_CHIP_WALKS, P(T))
        assert lay.ws == lay.units * 16 * lay.chip
        assert lay.spill == (16 * P(T) if P(T) > tfuzzy.POOL_CHIP_WALKS else 0)
        assert lay.light_chip == tfuzzy.THREAD_POOL_WALKS
        assert lay.light_ws == tfuzzy.POOL_THREADS * 16 * tfuzzy.THREAD_POOL_WALKS
    first = next(T for T in range(1, 200) if tfuzzy.frontier_workspace(1, Df, Dd, T).spill)
    assert P(first) > tfuzzy.POOL_CHIP_WALKS >= P(first - 1)
    # The thread path's bytes are the same at every shape.
    assert tfuzzy.frontier_workspace(1, 57, 2, 5).light_ws == \
        tfuzzy.frontier_workspace(1, Df, Dd, 9).light_ws


@pytest.mark.parametrize("E,side", [(1, "at"), (1, "past"), (2, "at"), (2, "past")])
def test_tables_bytes_on_each_side_of_the_chip_limit(E, side):
    """The tables' byte mirror (``csrc/beam.cu`` ``tables_layout`` and
    ``layout_of``): every table from a 16-byte boundary; for u8 ids the
    tables go on chip up to ``TABLES_SMEM_MAX`` bytes (beside the block's
    workspace) and stay in global memory one table row past it; for int32
    ids they always stay there."""
    r16 = lambda b: -(-b // 16) * 16
    C, Df, MO, npat = 16, 3, 1, 5
    per = lambda N: (r16(4 * N * C) + r16(4 * C * C) + 2 * r16(4 * N * Df) + 2 * r16(4 * N)
                     + r16(4 * N * MO) + 2 * r16(4 * npat) + r16(N * C))
    N = max(N for N in range(1, 4000) if per(N) <= tfuzzy.TABLES_SMEM_MAX)
    if side == "past":
        N += 1
    tb = tfuzzy.tables_bytes(N, C, Df, MO, npat)
    assert tb == per(N) and tb % 16 == 0
    lay = tfuzzy.frontier_workspace(E, Df, 1, 20)
    assert tfuzzy.tables_on_chip(tb, lay, 1) == (side == "at")
    assert not tfuzzy.tables_on_chip(tb, lay, 4)
    assert tb + max(lay.ws, lay.light_ws) <= tfuzzy.FRONTIER_SMEM_MAX or side == "past"
    # Each table, sb of one byte a cell too, rounds up on its own.
    assert tfuzzy.tables_bytes(1, 1, 0, 1, 1) == 16 * 8  # eight tables, no edge


@pytest.mark.parametrize("T", [5, 384, 385])
def test_order_histograms_on_chip_up_to_their_limit(T):
    """The order kernel's round histograms (``ORDER_WARPS`` x T int32 a
    block) stay on chip up to ``ORDER_SMEM`` (T = 384 at 32 warps), past it
    in a global scratch."""
    assert tfuzzy.order_hist_on_chip(T) == (4 * tfuzzy.ORDER_WARPS * T <= tfuzzy.ORDER_SMEM)
    assert tfuzzy.order_hist_on_chip(T) == (T <= 384)


def test_beam_emissions_on_cpu_reports_no_kernel_stats(case):
    """``beam_emissions`` takes the plain versions on CPU tensors: the list
    it is given for the kernels' stats stays empty."""
    engine = case["engine"]
    words_hay = CASES[case["name"]][0]()
    hay = words_hay[1][:2000]
    view = view_of(hay, False)
    n = len(view)
    thr = np.float32(CASES[case["name"]][2])
    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr)
    cand = tfuzzy._candidate_starts(engine, hay, view, n, thr)
    stats = []
    em, _over = tfuzzy.beam_emissions(engine, hay, view, n, cand, thr, ceil, stats=stats)
    assert stats == [] and em[0].numel() > 0


# ---------------------------------------------------------------------------
# A scalar mirror of csrc/beam.cu's loops
# ---------------------------------------------------------------------------

F32 = np.float32
INF_KEY = ((1 << 64) - 1, (1 << 64) - 1)


class _Tabs:
    """The kernels' tables and scalars as numpy values."""

    def __init__(self, c):
        tabs, prm, k32 = c["tabs"], c["prm"], c["tabs"].k32
        self.C = tabs.C
        self.go, self.sb = k32.goto.numpy(), k32.sb.numpy()
        self.et = (k32.et_full.numpy(), k32.et_deep.numpy())
        self.ec = (k32.ec_full.numpy(), k32.ec_deep.numpy())
        self.sim = tabs.sim.numpy().reshape(self.C, self.C)
        self.out_count, self.out_list = k32.out_count.numpy(), k32.out_list.numpy()
        self.pat_len, self.pat_weight = tabs.pat_len.numpy(), tabs.pat_weight.numpy()
        self.ceil = prm.ceil.numpy()
        (self.max_pen, self.p_sub, self.p_ins, self.p_del, self.p_swap, self.floor,
         self.slack) = (F32(x) for x in prm.host)
        self.E, self.T, self.limit = prm.E, prm.T, prm.limit
        self.ids = c["ids"].numpy()
        self.Df, self.Dd = self.et[0].shape[1], self.et[1].shape[1]

    def sym(self, pos):
        return int(self.ids[pos]) if pos < self.limit else 0

    def ctx(self, pos0, st):
        node, j, me, counts, pen = st
        edits = sum((counts >> s) & 0xFF for s in (0, 8, 16, 24))
        c = dict(st=st, can_edit=edits < self.E)
        c["is_last"] = c["can_edit"] and edits + 1 >= self.E
        pos = pos0 + j
        c["in1"], c["in2"] = pos < self.limit, pos + 1 < self.limit
        c["s0"] = self.sym(pos) if c["in1"] else 0
        c["s1"] = self.sym(pos + 1) if c["in2"] else 0
        c["rem"] = F32(self.max_pen - pen)
        c["ex"] = int(self.go[node, c["s0"]]) if c["in1"] else -1
        return c

    def candidate(self, c, col, root):
        """``candidate()``: column col of the expansion, node -1 where a
        guard fails."""
        et, ec = self.et[0 if root else 1], self.ec[0 if root else 1]
        D = et.shape[1]
        node, j, me, counts, pen = c["st"]
        oj = ome = j + 1
        oc, op, valid, cn = counts, pen, False, -1
        if col == 0:
            valid, cn = c["in1"], c["ex"]
        elif col <= D:
            tn = int(et[node, col - 1])
            cn = tn
            if tn >= 0 and c["in1"] and c["can_edit"] and tn != c["ex"]:
                sm = self.sim[int(ec[node, col - 1]), c["s0"]]
                pnl = F32(self.p_sub * F32(F32(1.0) - sm))
                valid = not sm < self.floor and not pnl > c["rem"]
                if valid and c["is_last"]:
                    valid = self.out_count[tn] > 0 or (c["in2"] and self.sb[tn, c["s1"]] != 0)
                oc, op = counts + 0x10000, F32(pen + pnl)
        elif col == D + 1:
            mid = int(self.go[node, c["s1"]]) if c["in2"] else -1
            cn = int(self.go[mid, c["s0"]]) if mid >= 0 else -1
            valid = c["in2"] and self.p_swap <= c["rem"] and c["can_edit"] and cn >= 0
            oj = ome = j + 2
            oc, op = counts + 0x1000000, F32(pen + self.p_swap)
        elif col == D + 2:
            cn = node
            valid = (c["in1"] and (me != 0 or j != 0) and self.p_ins <= c["rem"] and c["can_edit"]
                     and not (c["is_last"] and self.out_count[node] == 0
                              and not (c["in2"] and self.sb[node, c["s1"]] != 0)))
            ome, oc, op = me, counts + 1, F32(pen + self.p_ins)
        else:
            tn = int(et[node, col - D - 3])
            cn = tn
            valid = (tn >= 0 and c["can_edit"] and self.p_del <= c["rem"]
                     and not (c["is_last"] and self.out_count[tn] == 0
                              and not (c["in1"] and self.sb[tn, c["s0"]] != 0)))
            oj, ome, oc, op = j, me, counts + 0x100, F32(pen + self.p_del)
        ok = valid and cn >= 0 and not op > self.ceil[cn]
        return (cn if ok else -1, oj, ome, oc, op)

    def emits(self, st):
        """The patterns ``emit_write`` stages for state st, in output order."""
        node, _j, _me, _counts, pen = st
        if node < 0 or self.out_count[node] <= 0:
            return []
        out = []
        for p in self.out_list[node]:
            if p < 0:
                continue
            total = self.pat_len[p]
            if F32(F32(F32(total - pen) / total) * self.pat_weight[p]) >= self.slack:
                out.append(int(p))
        return out


class _Queue:
    """``refill()`` / ``take()``: batch b of a launch's work counter holds
    items b, b + NB, ... (NB = ceil(items / bs)), each a start (or an entry of
    the handed-off list); the write launch keeps the starts whose count is not
    0 and that ``skip`` does not flag."""

    def __init__(self, items, bs, counts=None, skip=None):
        self.items, self.bs, self.counts, self.skip = list(items), bs, counts, skip
        self.nb = -(-len(self.items) // bs)
        self.cursor, self.taken = 0, []

    def batch(self):
        """The next batch's starts that run (None when the counter has run
        out)."""
        b = self.cursor
        self.cursor += 1
        if b >= self.nb:
            return None
        out = [self.items[i] for i in range(b, len(self.items), self.nb)][:self.bs]
        out = [s for s in out if (self.counts is None or self.counts[s] != 0)
               and (self.skip is None or not self.skip[s])]
        self.taken += out
        return out


def _pool_start(tb, pos0, limit_walks, si, staged=None, at=0):
    """One start of the pool kernels, rounds in slot order: the pool's exact
    steps (a walk that stays emits), the 0-edit walk's expansion (its exact
    column the next s0, the rest spawn; a spawn past ``limit_walks`` walks
    hands the start on: None), then the spawns' and s0's emissions, staged
    from ``at`` where ``staged`` is given. Returns (emissions, states
    expanded, rounds, the most walks the pool held)."""
    pool, rd, s0, em, states, most = [], 0, (0, 0), 0, 0, 0
    zero = F32(0.0)

    def emit(w):
        nonlocal em
        for pat in tb.emits(w):
            if staged is not None:
                staged[at + em] = (si, w[2], pat, w[3], w[4], rd)
            em += 1

    while True:
        kept = []
        for node, j, _me, cnt, pen in pool:
            pos = pos0 + j
            nxt = int(tb.go[node, tb.sym(pos)]) if pos < tb.limit else -1
            if nxt < 0 or pen > tb.ceil[nxt]:
                continue
            kept.append((nxt, j + 1, j + 1, cnt, pen))
            emit(kept[-1])
        pool = kept
        n_old = len(pool)
        if s0[0] >= 0:
            root = rd == 0
            c = tb.ctx(pos0, (s0[0], s0[1], s0[1], 0, zero))
            nxt0 = None
            for col in range(2 * (tb.Df if root else tb.Dd) + 3):
                o = tb.candidate(c, col, root)
                if col == 0:
                    nxt0 = o
                elif o[0] >= 0:
                    if len(pool) == limit_walks:
                        return None
                    pool.append(o)
            s0 = (nxt0[0], nxt0[1])
            states += 1
        most = max(most, len(pool))
        for w in pool[n_old:]:
            emit(w)
        emit((s0[0], s0[1], s0[1], 0, zero))
        rd += 1
        if rd >= tb.T or (not pool and s0[0] < 0):
            return em, states, rd, most


def _pool_mirror(tb, starts, light, chip, counts=None, offsets=None, flags=None, handed=None):
    """``beam_pool_thread_kernel`` then ``beam_pool_kernel``: the thread path
    takes batches of 32 starts, a lane each, and hands on (flags, and appends
    to the handed-off list) a start whose pool would pass ``light`` walks; the
    warp path takes the handed-off list, a warp a start, its pool past
    ``chip`` walks marked spilled. The count launch (``counts`` None) returns
    (counts, flags, handed list, stats, the two queues); the write launch
    the staged emissions and the two queues."""
    write = counts is not None
    n = len(starts)
    staged = [None] * (int(offsets[-1]) if write else 0)
    out_counts = np.zeros(n, dtype=np.int32)
    out_flags = np.zeros(n, dtype=bool)
    out_handed = []
    stats = dict(em=0, states=0, rounds=0, spill=0, handed=0)
    q1 = _Queue(range(n), tfuzzy.FRONTIER_BATCH, counts, flags if write else None)
    while (batch := q1.batch()) is not None:
        for s in batch:
            at = int(offsets[s]) if write else 0
            got = _pool_start(tb, int(starts[s]), light, s, staged if write else None, at)
            if write:
                assert got is not None and got[0] == counts[s]
            elif got is None:
                out_flags[s] = True
                out_handed.append(s)
                stats["handed"] += 1
            else:
                out_counts[s] = got[0]
                stats["em"] += got[0]
                stats["states"] += got[1]
                stats["rounds"] = max(stats["rounds"], got[2])
    q2 = _Queue(handed if write else out_handed, 1, counts)
    while (batch := q2.batch()) is not None:
        for s in batch:
            at = int(offsets[s]) if write else 0
            em, states, rd, most = _pool_start(tb, int(starts[s]), 1 << 30, s,
                                               staged if write else None, at)
            if not write:
                out_counts[s] = em
                stats["em"] += em
                stats["states"] += states
                stats["rounds"] = max(stats["rounds"], rd)
                stats["spill"] += most > chip
    if write:
        return staged, (q1, q2)
    return out_counts, out_flags, out_handed, stats, (q1, q2)


def _key(st):
    node, j, me, counts, pen = st
    b = int(np.float32(pen).view(np.uint32))
    return ((node << 32) | (j << 16) | me, (counts << 32) | ((~b & 0xFFFFFFFF) if b >> 31
                                                              else b | 0x80000000))


def _decode(key):
    hi, lo = key
    k = lo & 0xFFFFFFFF
    bits = (k & 0x7FFFFFFF) if k >> 31 else (~k & 0xFFFFFFFF)
    return (hi >> 32, (hi >> 16) & 0xFFFF, hi & 0xFFFF, lo >> 32,
            np.uint32(bits).view(np.float32))


def _new(key, prev):
    return key[0] != prev[0] or (key[1] >> 32) != (prev[1] >> 32)


def _sort_dedup_small(keys, B):
    """``sort_dedup_small``: 64 elements, element i = lane + 32 e, the
    bitonic network of ``cmpx`` (partner i ^ j in lane ^ j; j = 32 in a
    lane), then the first-of-each flags and their ballot ranks."""
    m = len(keys)
    el = list(keys) + [INF_KEY] * (64 - m)
    k = 2
    while k <= 64:
        j = k >> 1
        while j > 0:
            if j == 32:
                for lane in range(32):
                    if el[lane + 32] < el[lane]:
                        el[lane], el[lane + 32] = el[lane + 32], el[lane]
            else:
                new = list(el)
                for i in range(64):
                    p = i ^ j
                    up, low = (i & k) == 0, (i & j) == 0
                    if (el[p] < el[i]) if low == up else (el[i] < el[p]):
                        new[i] = el[p]
                el = new
            j >>= 1
        k <<= 1
    assert el[:m] == sorted(keys)
    flags = [i < m and (i == 0 or _new(el[i], el[i - 1])) for i in range(64)]
    kept = [el[i] for i in range(64) if flags[i]]
    return kept[:B], len(kept)


def _sort_dedup_memory(keys, B):
    """``warp_sort`` (the mirrored-comparator bitonic network over the next
    power of two, comparators past m skipped) and ``dedup``."""
    m = len(keys)
    a = list(keys)
    np2 = 1
    while np2 < m:
        np2 <<= 1
    k = 2
    while k <= np2:
        half = k >> 1
        for i in range(np2 >> 1):
            blk, off = divmod(i, half)
            x, y = blk * k + off, blk * k + k - 1 - off
            if y < m and a[y] < a[x]:
                a[x], a[y] = a[y], a[x]
        j = half >> 1
        while j > 0:
            for i in range(np2 >> 1):
                x = 2 * j * (i // j) + i % j
                if x + j < m and a[x + j] < a[x]:
                    a[x], a[x + j] = a[x + j], a[x]
            j >>= 1
        k <<= 1
    assert a == sorted(keys)
    kept = [a[i] for i in range(m) if i == 0 or _new(a[i], a[i - 1])]
    return kept[:B], len(kept)


def _sorted_mirror(tb, starts, chip, counts=None, offsets=None):
    """``beam_sorted_kernel``'s loop, a warp a start: the expansion in
    passes of 32 lanes appended by ballot (a round past ``chip`` keys marked
    spilled), the register sort up to ``WARP_SORT_KEYS`` candidates, else the
    memory sort; the count launch (``counts`` None) returns (counts, overflow,
    stats, queue), the write launch the staged emissions and its queue."""
    write = counts is not None
    n, B = len(starts), 32 + 24 * tb.E
    q = _Queue(range(n), 2, counts)
    out_counts = np.zeros(n, dtype=np.int32)
    overflow = np.zeros(n, dtype=bool)
    staged = [None] * (int(offsets[-1]) if write else 0)
    stats = dict(em=0, states=0, rounds=0, over=0, spill=0, memsort=0)
    todo = []
    while True:
        if not todo:
            batch = q.batch()
            if batch is None:
                break
            todo = list(batch)
            continue
        s = todo.pop(0)
        pos0 = int(starts[s])
        at = int(offsets[s]) if write else 0
        beam = [_key((0, 0, 0, 0, F32(0.0)))]
        rd, over, spilled = 0, False, False
        em = 0
        while rd < tb.T and beam:
            root = rd == 0
            W = 2 * (tb.Df if root else tb.Dd) + 3
            stats["states"] += len(beam)
            cands, kcap = [], chip
            for i0 in range(0, len(beam) * W, 32):
                live = []
                for i in range(i0, min(i0 + 32, len(beam) * W)):
                    b = i // W
                    o = tb.candidate(tb.ctx(pos0, _decode(beam[b])), i - b * W, root)
                    if o[0] >= 0:
                        live.append(_key(o))
                if len(cands) + len(live) > kcap:
                    spilled, kcap = True, 1 << 62
                cands += live
            if len(cands) <= tfuzzy.WARP_SORT_KEYS:
                beam, kept = _sort_dedup_small(cands, B)
            else:
                stats["memsort"] += 1
                beam, kept = _sort_dedup_memory(cands, B)
            if kept > B:
                over = True
                rd += 1
                break
            for key in beam:
                st = _decode(key)
                for pat in tb.emits(st):
                    if write:
                        staged[at] = (s, st[2], pat, st[3], st[4], rd)
                    at += 1
                    em += 1
            rd += 1
        if not write:
            out_counts[s] = 0 if over else em
            overflow[s] = over
            stats["over"] += over
            stats["em"] += 0 if over else em
            stats["rounds"] = max(stats["rounds"], rd)
            stats["spill"] += spilled
    return (staged, (q,)) if write else (out_counts, overflow, stats, (q,))


def _order_mirror(staged, offsets, n, nchunk, T, warps=tfuzzy.ORDER_WARPS):
    """``beam_order_kernel``: per chunk, each warp's share counted by round,
    the counts scanned round-major (warp-minor) in tiles of 32 rounds, each
    share placed in passes of 32 ranked among equal rounds."""
    out = [None] * len(staged)
    for c in range(-(-n // nchunk)):
        lo, hi = int(offsets[c * nchunk]), int(offsets[min(n, (c + 1) * nchunk)])
        m = hi - lo
        if m == 0:
            continue
        part = -(-m // warps)
        shares = [(lo + min(m, w * part), lo + min(m, (w + 1) * part)) for w in range(warps)]
        hist = [[0] * T for _ in range(warps)]
        for w, (a, b) in enumerate(shares):
            for i in range(a, b):
                hist[w][staged[i][5]] += 1
        carry = 0
        for r0 in range(0, T, 32):
            tots = []
            for rr in range(r0, r0 + 32):
                tot = 0
                if rr < T:
                    for w in range(warps):
                        hist[w][rr], tot = tot, tot + hist[w][rr]
                tots.append(tot)
            incl = np.cumsum(tots)
            for lane, rr in enumerate(range(r0, min(r0 + 32, T))):
                for w in range(warps):
                    hist[w][rr] += carry + int(incl[lane]) - tots[lane]
            carry += int(incl[-1])
        for w, (a, b) in enumerate(shares):
            for i0 in range(a, b, 32):
                seen = {}
                for i in range(i0, min(i0 + 32, b)):
                    rr = staged[i][5]
                    out[lo + hist[w][rr] + seen.get(rr, 0)] = staged[i]
                    seen[rr] = seen.get(rr, 0) + 1
                for rr, k in seen.items():
                    hist[w][rr] += k
    assert all(x is not None for x in out)
    return out


#: name -> (the run of starts the mirror takes, starts per chunk, walks a
#: pool thread keeps, walks or keys a warp keeps on chip): runs that span
#: several chunks (the last short), reach the a-runs of the long pattern
#: (handed on from the thread path, their pools past a warp's walks),
#: overflowing starts and rounds past a sorted warp's keys.
MIRROR = {
    "cjk-e1-seeds": (slice(0, 3 * 64 + 5), 64, (8,), 16),
    "long-pattern-every-position": (slice(-(3 * 128 + 5), None), 128, (8, 2), 8),
    "e2-overflow-every-position": (slice(None), 64, (0,), 16),
}


def test_kernel_mirror_equal_to_plain(case):
    """The kernels' loops, run in Python one scalar lane at a time (count
    launch, the plain ``block_offsets``, write launch over the starts that
    emit, the order kernel), give the plain versions' emissions and overflow
    flags bit for bit, and the stats the card's wrappers return."""
    tb = _Tabs(case)
    run, nchunk, lights, chip = MIRROR[case["name"]]
    starts = case["starts"][run]
    n = starts.numel()
    want_em, want_ov = _plain(case, starts, nchunk)
    for light in lights:
        if case["E"] == 1:
            counts, flags, handed, stats, queues = _pool_mirror(tb, starts.numpy(), light, chip)
            # The thread path takes every start; the warp path the ones handed on.
            assert sorted(queues[0].taken) == list(range(n))
            assert sorted(queues[1].taken) == sorted(handed) == list(np.flatnonzero(flags))
        else:
            counts, flags, stats, queues = _sorted_mirror(tb, starts.numpy(), chip)
            assert flags.any() and torch.equal(torch.from_numpy(flags), want_ov)
            assert sorted(queues[0].taken) == list(range(n))
        offsets = tpb.block_offsets(torch.from_numpy(counts))
        total = int(offsets[-1])
        assert stats["em"] == total == want_em[0].numel() > 0
        # The long pattern's a-runs pass a thread's walks and a warp's; the
        # CJK words' budget affords no edit at 0.8, so their pools stay empty.
        if case["name"] == "long-pattern-every-position":
            assert stats["handed"] > 0 and stats["spill"] > 0
        elif case["E"] == 1:
            assert stats["handed"] == 0 and stats["spill"] == 0
        else:
            assert stats["spill"] > 0 and stats["memsort"] > 0
        if case["E"] == 1:
            staged, queues = _pool_mirror(tb, starts.numpy(), light, chip, counts=counts,
                                          offsets=offsets.numpy(), flags=flags, handed=handed)
            # The write launch runs the starts that emit, and no other.
            assert sorted(queues[0].taken) == [s for s in range(n) if counts[s] and not flags[s]]
            assert sorted(queues[1].taken) == sorted(s for s in handed if counts[s])
            taken = queues[0].taken + queues[1].taken
        else:
            staged, queues = _sorted_mirror(tb, starts.numpy(), chip, counts=counts,
                                            offsets=offsets.numpy())
            taken = queues[0].taken
        emitting = [s for s in range(n) if counts[s]]
        assert sorted(taken) == emitting and 0 < len(emitting) < n
        assert all(x is not None for x in staged)
        ordered = _order_mirror(staged, offsets.numpy(), n, nchunk, tb.T)
        got = (torch.tensor([x[0] for x in ordered]), torch.tensor([x[1] for x in ordered]),
               torch.tensor([x[2] for x in ordered]),
               torch.tensor(np.array([x[4] for x in ordered], dtype=np.float32)),
               torch.tensor([x[3] for x in ordered]))
        for a, b in zip(got, want_em):
            assert torch.equal(a.to(b.dtype), b)
        # The order kernel's plain version agrees with its mirror.
        st = torch.tensor([[x[0], x[1], x[2], x[3], int(np.float32(x[4]).view(np.int32)), x[5]]
                           for x in staged], dtype=torch.int32)
        for a, b in zip(tfuzzy.order_emissions(st, offsets, n, nchunk, tb.T), want_em):
            assert torch.equal(a, b)
