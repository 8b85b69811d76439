"""The beam frontier's kernel wrappers (``ops/fuzzy.pool_frontier`` and
``sorted_frontier``, ``csrc/beam.cu``) and the arithmetic around their
launches, on the CPU.

On CPU tensors the wrappers run the plain versions (``_pool_chunk`` and
``_beam_chunk``, which ``tests/test_torch_beam.py`` holds against the JAX
package); here they are held bit-equal to them on that file's inputs, and
the pieces of the card's pass that run in Python are checked against the
plain output: the count grid's layout (``grid_index``), scanned by the
plain ``block_offsets``, puts every emission at its own index; a run's
count grid stays within ``COUNT_GRID_BYTES``; the workspace sizing takes the
global scratch exactly where a block's keys pass the shared memory a block
may hold. The kernels themselves run on the card (``chip_smoke.py`` phase
4j (e)). No JAX function runs here."""

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


def _plain(c, starts):
    if c["E"] == 1:
        return tfuzzy._pool_chunk(starts, c["tabs"], c["prm"], c["ids"], c["nchunk"]), None
    return tfuzzy._beam_chunk(starts, c["tabs"], c["prm"], c["ids"], c["nchunk"], 32 + 24 * c["E"])


def _wrapper(c, starts):
    if c["E"] == 1:
        em, stats = tfuzzy.pool_frontier(starts, c["tabs"], c["prm"], c["ids"], c["nchunk"])
        return (em, None), stats
    em, ov, stats = tfuzzy.sorted_frontier(starts, c["tabs"], c["prm"], c["ids"], c["nchunk"],
                                           32 + 24 * c["E"])
    return (em, ov), stats


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


def test_count_grid_places_each_emission(case, monkeypatch):
    """The card's placement: each (chunk, round, start)'s emissions counted
    at ``grid_index`` (the overflowed starts' left at 0), scanned by the
    plain ``block_offsets``, put every emission of the plain output at its
    own index, across several chunks (the last one short), in the
    emissions' (slot, output) order within each (start, round)."""
    nchunk, T = case["nchunk"], case["prm"].T
    starts = case["starts"][:3 * nchunk + 5]
    n = starts.numel()
    seen = []
    order_key = tfuzzy._order_key

    def capture(si, t, slot, o, *args):
        key = order_key(si, t, slot, o, *args)
        seen.append((si, torch.full_like(si, t), key))
        return key

    monkeypatch.setattr(tfuzzy, "_order_key", capture)
    em, ov = _plain(case, starts)
    si, rd, key = (torch.cat(x) for x in zip(*seen))
    if ov is not None:
        keep = ~ov[si]
        si, rd, key = si[keep], rd[keep], key[keep]
    order = torch.argsort(key)
    si, rd = si[order], rd[order]
    assert torch.equal(si, em[0]) and si.numel() > 20

    grid = tfuzzy.grid_index(si, rd, n, nchunk, T)
    all_g = tfuzzy.grid_index(torch.arange(n).repeat_interleave(T), torch.arange(T).repeat(n),
                              n, nchunk, T)
    assert sorted(all_g.tolist()) == list(range(n * T))  # every entry one (start, round)
    counts = torch.bincount(grid, minlength=n * T).to(torch.int32)
    offsets = tpb.block_offsets(counts)
    assert int(offsets[-1]) == si.numel()
    # Within a (start, round) the emissions keep their order: the rank is
    # the position after the group's first.
    first = torch.ones_like(grid, dtype=torch.bool)
    first[1:] = grid[1:] != grid[:-1]
    idx = torch.arange(grid.numel())
    rank = idx - torch.cummax(torch.where(first, idx, 0), dim=0).values
    assert torch.equal(offsets[grid].long() + rank, idx)
    assert (torch.diff(grid) >= 0).all()  # the grid's order is the emission order
    if ov is not None:
        assert int(ov.sum()) > 0


@pytest.mark.parametrize("T,nchunk,n", [(5, 8192, 100_000), (71, 8192, 2_294_196),
                                        (13, 1024, 511_810), (300, 4096, 9_000), (2, 64, 1)])
def test_run_len_keeps_the_count_grid_under_its_cap(T, nchunk, n, monkeypatch):
    """The kernels' runs: whole chunks, each run's grid (T int32 a start)
    within ``COUNT_GRID_BYTES``, every start in exactly one run; the plain
    runs keep the ``GROUP_CANDIDATES`` sizing."""
    tabs = tfuzzy.BeamTables(*([None] * 14))._replace(
        et_full=torch.zeros((1, 40)), et_deep=torch.zeros((1, 3)))
    for cap in (tfuzzy.COUNT_GRID_BYTES, 1 << 22):
        monkeypatch.setattr(tfuzzy, "COUNT_GRID_BYTES", cap)
        run = tfuzzy.run_len(1, tabs, nchunk, T, True)
        assert run % nchunk == 0 and run >= nchunk
        assert run * T * 4 <= cap or run == nchunk
        covered = np.zeros(n, dtype=np.int64)
        for g0 in range(0, n, run):
            covered[g0:g0 + run] += 1
            assert min(run, n - g0) * T * 4 <= max(cap, nchunk * T * 4)
        assert (covered == 1).all()
    plain = tfuzzy.run_len(2, tabs, nchunk, T, False)
    assert plain == max(1, tfuzzy.GROUP_CANDIDATES // (80 * 9 * nchunk)) * nchunk


@pytest.mark.parametrize("E", [2, 3, 4, 5, 6])
def test_sorted_workspace_takes_scratch_past_the_block(E):
    """The sorted kernel keeps a block's keys (B (2 D + 3) candidates and B
    beam states, 16 bytes each, beside its counters) in shared memory up to
    the deep width where they pass ``FRONTIER_SMEM_MAX``, and in the global
    scratch from there on."""
    B = 32 + 24 * E
    limit = tfuzzy.FRONTIER_SMEM_MAX - tfuzzy.FRONTIER_MISC_BYTES
    on = [tfuzzy.frontier_workspace(E, 5, dd, 10) for dd in range(0, 200)]
    first = next(dd for dd, (_ws, chip) in enumerate(on) if not chip)
    assert all(chip for _ws, chip in on[:first]) and not any(chip for _ws, chip in on[first:])
    assert 16 * (B * (2 * first + 3) + B) > limit >= 16 * (B * (2 * first + 1) + B)
    assert on[first][0] == 16 * (B * (2 * first + 3) + B)
    # The root round's width counts where it is the wider.
    ws, chip = tfuzzy.frontier_workspace(E, 20_000, 1, 10)
    assert ws == 16 * (2 * 20_000 + 3 + B) and not chip


def test_pool_workspace_takes_scratch_past_the_block():
    """The pool kernel's block holds ``POOL_WARPS`` pools of P = S0 + (T - 1)
    Sd walks, 16 bytes each: shared memory up to ``FRONTIER_SMEM_MAX``, the
    global scratch past it."""
    Df, Dd = 12, 3
    P = lambda T: (2 * Df + 2) + (T - 1) * (2 * Dd + 2)
    sizes = [tfuzzy.frontier_workspace(1, Df, Dd, T) for T in range(2, 2000)]
    first = next(i for i, (_ws, chip) in enumerate(sizes) if not chip) + 2
    assert tfuzzy.POOL_WARPS * 16 * P(first) > tfuzzy.FRONTIER_SMEM_MAX
    assert tfuzzy.POOL_WARPS * 16 * P(first - 1) <= tfuzzy.FRONTIER_SMEM_MAX
    assert all(chip for _ws, chip in sizes[:first - 2])
    assert all(ws == tfuzzy.POOL_WARPS * 16 * P(T) for T, (ws, _c) in zip(range(2, 2000), sizes))


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
