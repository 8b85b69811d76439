"""The count-channel list step (``typed_expand`` -> ``count_dp`` -> one
read of the rows' and candidates' totals -> ``count_emit``), port against
the JAX package on the CPU.

(a) For the forbid lane (each forbid flag, ``edits(2)`` and ``edits(3)``
    without swaps, ``edits(4)`` without swaps), ``edits(2)`` with swaps, the
    mapped lane (rn <-> m, ß <-> ss and æ <-> ae with drift +1 and -1, a
    scored mapping, ``edits(2)`` mapped) and a dictionary with multi-byte
    edges (the dead-end filter) at ``edits(2)`` and ``edits(4)`` (the cases
    at E = 4 reach the rows form of the DP, ``count_dp_rows_kernel`` on the
    card): per slice, the step's pieces, each its
    plain version on CPU tensors (``count_dp_torch``, ``count_emit_torch``),
    give the rows the JAX ``_dp_pipeline_jit`` (``FORBID`` / ``MAPS`` /
    ``DEADEND``; its scan in Pallas interpret mode) returns, in the same
    order, with the same hit and candidate counts; the decisions and the
    per-tile row counts agree with ``banded_dp_torch`` and the emission;
    the rows and tags equal ``dp_pipeline_torch``'s; the whole search
    equals the JAX device search.
(b) A threshold that a match's similarity ties exactly.
(c) Random hit lists: the step equals ``dp_pipeline_torch`` with a first
    hit h0 = 1 and tags, and in three ranges equals one range.
(d) The routing (which calls take the list step) and the int32 bound.
(e) The byte bound of a range (``step_max_hits``), and a search cut by it
    into many ranges equal to the JAX search.
(f) The mapped lane past six scan rows (``edits(4)`` with ß <-> ss, k = 8;
    ``edits(3)`` with sch <-> sh, k = 9): served on the card's lane, the
    list equal to the JAX device search's; ``edits(6)`` (k = 12) equal to
    the host oracle; ``dp_plan`` serving every mapped budget up to 24.
(h) The emission's grid (a block per (channel, tile) pair, placed by the
    running sum of the pairs' row counts) modelled in numpy, and the rows'
    total the DP keeps beside the candidates', at a tile's edges.
(g) The expansion's list (``typed_expand_torch``, the plain version of the
    one-pass ``typed_expand_kernel``): equal to the JAX
    ``_expand_candidates`` in item order with its total, and at h0 = 1 the
    same list without the first hit's candidates, over a hit run in which
    every item past the run's first hit but the b = 0 copies is a duplicate.

Both sides get the same inputs, made from a seed. The tolerance is exact
equality everywhere: equal int32 rows and equal f32 bits (the DP replays the
JAX package's f32 operations in the same order; everything else is
integer)."""

import functools

import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder as JaxBuilder
from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits
from fuzzy_aho_corasick_tpu.ops import packed_bitap as jpb
from fuzzy_aho_corasick_tpu.ops import verify_dp as jvd
from fuzzy_aho_corasick_tpu.utils import device_corpus as jax_corpus
from fuzzy_aho_corasick_tpu.utils.graphemes import view_of
from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits
from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
from fuzzy_aho_corasick_tpu_torch.ops import verify_dp as tvd
from fuzzy_aho_corasick_tpu_torch.utils import device_corpus

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)

WORDS = ["tincidunt", "phaetra", "sagittis", "venenatis", "condim"]
FILLER = ["lorem", "ipsum", "dolor", "sit", "amet", "elit", "eros", "porta"]
CYRILLIC = ["привет", "москва", "ирина", "тест"]
GERMAN = ["strasse", "weiss", "fussball", "aether"]
GERMAN_TEXT = ["der", "die", "und", "straße", "strasse", "weiß", "wiess", "fußball", "æther",
               "aether", "strase", "grosze", "größe", "fusball", "aeter"]


def _edit(word: str, rng) -> str:
    i, op = int(rng.integers(1, len(word) - 1)), int(rng.integers(4))
    return [word[:i] + "x" + word[i + 1:], word[:i] + word[i + 1:],
            word[:i] + "q" + word[i:], word[:i] + word[i + 1] + word[i] + word[i + 2:]][op]


def _corpus(seed: int, size: int, needles, filler=FILLER, rate: int = 3,
            max_edits: int = 3) -> str:
    """Filler words with needles at 1 in ``rate``, each with up to
    ``max_edits`` edits, cut to ``size`` characters."""
    rng = np.random.default_rng(seed)
    out, n = [], 0
    while n < size:
        if rng.integers(rate) == 0:
            w = needles[int(rng.integers(len(needles)))]
            for _ in range(int(rng.integers(0, max_edits + 1))):
                w = _edit(w, rng) if len(w) > 3 else w
        else:
            w = filler[int(rng.integers(len(filler)))]
        out.append(w)
        n += len(w) + 1
    return " ".join(out)[:size]


def _words(words, count, seed):
    rng = np.random.default_rng(seed)
    return " ".join(words[i] for i in rng.integers(len(words), size=count).tolist())


#: name -> (engine configuration, patterns, haystack, threshold, lane).
CASES = {
    "forbid-swaps-e2": (lambda b, L: b.fuzzy(L.new().edits(2).swaps(0)), WORDS,
                        _corpus(71, 3000, WORDS), 0.62, "forbid"),
    "forbid-insertions": (lambda b, L: b.fuzzy(L.new().edits(2).insertions(0)), WORDS,
                          _corpus(72, 2500, WORDS), 0.62, "forbid"),
    "forbid-deletions": (lambda b, L: b.fuzzy(L.new().edits(2).deletions(0)), WORDS,
                         _corpus(73, 2500, WORDS), 0.62, "forbid"),
    "forbid-substitutions": (lambda b, L: b.fuzzy(L.new().edits(2).substitutions(0)), WORDS,
                             _corpus(74, 2500, WORDS), 0.62, "forbid"),
    "forbid-swaps-e3": (lambda b, L: b.fuzzy(L.new().edits(3).swaps(0)), WORDS[:3],
                        _corpus(75, 2000, WORDS[:3]), 0.5, "forbid"),
    "fast-e2": (lambda b, L: b.fuzzy(L.new().edits(2)), WORDS, _corpus(76, 3000, WORDS), 0.62,
                "dp"),
    "mapped-rn-m": (lambda b, L: b.fuzzy(L.new().edits(1)).mapping("rn", "m"),
                    ["modern", "tincidunt"],
                    ("pad " * 30) + "modem and modern and moderm and tincidnut rnodem " * 12,
                    0.5, "mapped"),
    "mapped-eszett": (lambda b, L: b.fuzzy(L.new().edits(1)).mapping("ß", "ss").mapping("æ", "ae"),
                      GERMAN, _words(GERMAN_TEXT, 300, 5), 0.45, "mapped"),
    "mapped-scored": (lambda b, L: b.fuzzy(L.new().edits(1)).mapping_scored("ou", "o", 0.6),
                      ["color", "honor"],
                      ("pad " * 30) + "colour and color and coluor honour honr " * 10, 0.5,
                      "mapped"),
    "mapped-edits2": (lambda b, L: b.fuzzy(L.new().edits(2)).mapping("ß", "ss"),
                      ["strasse", "grosse"],
                      ("pad " * 30) + "straße grosze straze größe strasse gröse " * 8, 0.4,
                      "mapped"),
    "deadend-e2": (lambda b, L: b.fuzzy(L.new().edits(2)), CYRILLIC,
                   _corpus(77, 2000, CYRILLIC + ["прuвет", "мирр"],
                           ["и", "мы", "тесты", "кафе", "она"]), 0.6, "dp"),
    # E = 4: the rows form of the DP (past 32 cells), without mappings.
    "forbid-swaps-e4": (lambda b, L: b.fuzzy(L.new().edits(4).swaps(0)), WORDS[:2],
                        _corpus(78, 1500, WORDS[:2]), 0.5, "forbid"),
    "deadend-e4": (lambda b, L: b.fuzzy(L.new().edits(4)), CYRILLIC,
                   _corpus(79, 1200, CYRILLIC + ["прuвет", "мирр"],
                           ["и", "мы", "тесты", "кафе", "она"], max_edits=4), 0.3, "dp"),
}
#: The cases whose DP runs at E = 4, and whether with the dead-end filter.
ROWS_FORM = {"forbid-swaps-e4": False, "deadend-e4": True}
BACKEND = {"dp": "device-fuzzy-dp", "forbid": "device-fuzzy-dp-forbid",
           "mapped": "device-fuzzy-dp-mapped"}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """The configuration built by both packages (case-insensitive), cached:
    the JAX side compiles its pipeline once per engine."""
    configure, patterns, _hay, _thr, _lane = CASES[name]
    jax_e = configure(JaxBuilder.new(), JaxLimits).case_insensitive(True).build(patterns)
    port_e = (configure(FuzzyAhoCorasickBuilder.new(), FuzzyLimits).case_insensitive(True)
              .device("cpu").build(patterns))
    jax_e.backend = port_e.backend = "device"
    return jax_e, port_e


def _tuples(matches):
    return [
        (m.pattern_index, m.start, m.end, np.float32(m.similarity).view(np.uint32).item(),
         m.insertions, m.deletions, m.substitutions, m.swaps)
        for m in matches
    ]


def _seed_jax_caps(jax_e, counts):
    """Start the JAX lane at the capacities its retry loop converges to:
    ``counts`` {bucket length: (hits, candidates, rows)} of the slices, as
    the port counts them. Its results do not depend on them; one compile of
    ``_dp_pipeline_jit`` then serves the search (an overflow would compile
    it again at grown capacities, a later search at the tightened ones)."""
    caps = jpb._cap_cache(jax_e)
    for nb, (hits, cands, rows) in counts.items():
        for key, n in (("dp-KH", hits), ("dp-CAND", cands), ("dp-KG", rows)):
            caps[(key, nb)] = max(caps.get((key, nb), 0), jvd._fine_cap(n))


def _port_counts(port_e, hay, thr):
    """{bucket length: (hits, candidates, rows)} of the port's slices of
    ``hay`` (plain versions), the most over the slices of a bucket."""
    plan, run = _lane_inputs(port_e, hay, thr)
    out = {}
    for part in run.parts:
        _h, pos, words = tpb.packed_hits(part.ids_pf, run.T_scan, run.halo)
        rows, n_cand = tvd.dp_pipeline_torch(
            pos, words, tvd.DpWindow(part.lo, part.hi, part.local_n), part.ids_de, part.local_n,
            run.T, run.pens, np.float32(thr), plan.E, run.deadend, run.statics, run.variant)
        nb = part.ids_pf.numel()
        got = (pos.numel(), n_cand, rows.shape[0])
        out[nb] = tuple(max(a, b) for a, b in zip(out.get(nb, got), got))
    return out


def _jax_pipeline_rows(monkeypatch, jax_e, hay, thr, lane):
    """What ``_dp_pipeline_jit`` returned for each slice of the JAX search:
    {(limit, start_lo, start_hi, the slice's symbols): (hits, candidates,
    rows [total, 5])}, the 12-byte rows unpacked to (start, penalty bits,
    span, pattern, counts); and the JAX search's matches."""
    real = jvd._dp_pipeline_jit
    seen = {}

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        limit = int(args[15])
        key = (limit, int(args[16]), int(args[17]),
               np.asarray(args[0]).reshape(-1)[:limit].tobytes())
        seen[key] = (np.asarray(out), kwargs.get("FORBID"), kwargs.get("MAPS"),
                     kwargs.get("DEADEND"))
        return out

    monkeypatch.setattr(jvd, "_dp_pipeline_jit", spy)
    jax_corpus.clear()
    matches = jax_e.search_raw(hay, thr)
    assert jax_e.last_stats["backend"] == BACKEND[lane]
    monkeypatch.setattr(jvd, "_dp_pipeline_jit", real)
    out = {}
    for key, (buf, forbid, maps, deadend) in seen.items():
        assert (forbid is not None) == (lane == "forbid") and (maps is not None) == (
            lane == "mapped")
        hits, cands, total = (int(x) for x in buf[0])
        body = buf[1:1 + total].astype(np.int64)
        col2 = body[:, 2]
        c12 = col2 & 0xFFF
        cnt = ((c12 & 7) | (((c12 >> 3) & 7) << 8) | (((c12 >> 6) & 7) << 16)
               | (((c12 >> 9) & 7) << 24))
        rows = np.stack([body[:, 0], body[:, 1], (col2 >> 24) & 0xFF, (col2 >> 12) & 0xFFF, cnt],
                        axis=1)
        out[key] = (hits, cands, rows, bool(deadend))
    return out, matches


def _lane_inputs(port_e, hay, thr):
    view = view_of(hay, True)
    n = len(view)
    specs = tvd.lane_specs_of(port_e)
    plan = tvd.dp_plan(port_e, thr, n, *specs)
    device_corpus.clear()
    return plan, tvd.dp_inputs(port_e, hay, plan, view, n, *specs)


def _step(plan, run, part, thr, ids=None, hit_list=None):
    """The list step's pieces on one slice: (hits, cands, dec, row_counts,
    rows, tags, the arguments of ``dp_pipeline`` after the hits, pos,
    words); ``hit_list`` the slice's ``packed_hits``, where already made."""
    hits, pos, words = hit_list or tpb.packed_hits(part.ids_pf, run.T_scan, run.halo)
    window = tvd.DpWindow(part.lo, part.hi, part.local_n)
    ids = part.ids_de if ids is None else ids
    E, v = plan.E, run.variant
    assert tvd._list_step(E, v)
    n_combo = tvd._combos(E, *run.statics).shape[1]
    cands = tvd.typed_expand(pos, words, window, E, run.statics)
    dec, row_counts = tvd.count_dp(cands, ids, part.local_n, run.T, run.pens, np.float32(thr), E,
                                   run.deadend, v.forbid, v.maps)
    n_rows, n_cand = row_counts[-2:].tolist()
    rows, tags = tvd.count_emit(dec, row_counts, cands, run.T, E, n_combo, n_rows, n_cand,
                                tags=True)
    args = (window, ids, part.local_n, run.T, run.pens, np.float32(thr), E, run.deadend,
            run.statics, v)
    return hits, cands, dec, row_counts, rows, tags, args, pos, words


@pytest.mark.parametrize("name", list(CASES))
def test_list_step_rows_equal_to_jax(monkeypatch, name):
    _c, _p, hay, thr, lane = CASES[name]
    jax_e, port_e = _pair(name)
    plan, run = _lane_inputs(port_e, hay, thr)
    E, T = plan.E, run.T
    if name in ROWS_FORM:
        assert E == 4 and run.deadend == ROWS_FORM[name]
    MO = T.out_list.shape[1]
    nce = (2 * E + 1) * MO
    # The port's pieces per slice and ids form first (the slice's hit list
    # made once), then the JAX search, started at the capacities they give.
    steps, counts = {}, {}
    for part in run.parts:
        hit_list = tpb.packed_hits(part.ids_pf, run.T_scan, run.halo)
        for ids in (part.ids_de, part.ids_de.int()):
            before = dict(tpb.LAUNCHES)
            steps[id(part), ids.dtype] = _step(plan, run, part, thr, ids, hit_list)
            assert tpb.LAUNCHES == before  # CPU tensors run the plain versions
        hits, cands, _d, _rc, rows = steps[id(part), torch.uint8][:5]
        counts[part.ids_pf.numel()] = (hits, int(cands.total[0]), rows.shape[0])
    _seed_jax_caps(jax_e, counts)
    want, jax_matches = _jax_pipeline_rows(monkeypatch, jax_e, hay, thr, lane)
    assert sorted(want) == sorted(
        (p.local_n, p.lo, p.hi, p.ids_pf.numpy()[:p.local_n].tobytes()) for p in run.parts)
    total = 0
    for part in run.parts:
        key = (part.local_n, part.lo, part.hi, part.ids_pf.numpy()[:part.local_n].tobytes())
        w_hits, w_cands, w_rows, w_dead = want[key]
        assert w_dead == run.deadend
        for ids in (part.ids_de, part.ids_de.int()):
            hits, cands, dec, row_counts, rows, tags, args, pos, words = steps[id(part), ids.dtype]
            M = int(cands.total[0])
            assert (hits, M) == (w_hits, w_cands)
            assert rows.numpy().astype(np.int64).tolist() == w_rows.tolist()
            # The decisions are the emission's on banded_dp_torch's channels.
            ntile = -(-cands.items // tvd.TYPED_TILE)
            assert dec.shape == (nce, cands.items, 2)
            assert row_counts.shape == (nce * (ntile + 1) + 2,)
            assert row_counts[-2:].tolist() == [rows.shape[0], M] and (dec[:, M:, 1] == -1).all()
            cf, cs = cands.field[:M], cands.start[:M]
            pen, cnt = tvd.banded_dp_torch(cf, cs, ids, part.local_n, T, run.pens, E, run.deadend,
                                           run.variant.forbid, run.variant.maps)
            assert torch.equal(dec[:, :M], tvd.count_decisions_torch(
                pen, cnt, cf, cs, T, part.local_n, np.float32(thr), E))
            per_tile = torch.zeros((nce, ntile * tvd.TYPED_TILE), dtype=torch.int64)
            per_tile[:, :M] = (dec[:, :M, 1] >= 0).long()
            assert torch.equal(row_counts[:nce * ntile].long(),
                               per_tile.reshape(nce, ntile, -1).sum(2).reshape(-1))
            assert torch.equal(row_counts[nce * ntile:-2].long(),
                               per_tile.reshape(nce, -1).sum(1))
            # The old composition, and the routed wrapper.
            p_rows, p_n, p_tags = tvd.dp_pipeline_torch(pos, words, *args, tags=True)
            assert torch.equal(rows, p_rows) and torch.equal(tags, p_tags) and p_n == M
            got = tvd.dp_pipeline(pos, words, *args, tags=True)
            assert torch.equal(got[0], rows) and got[1] == M and torch.equal(got[2], tags)
        total += len(w_rows)
    assert total >= 10
    got = _tuples(port_e.search_raw(hay, thr))
    assert port_e.last_stats["backend"] == BACKEND[lane]
    assert got == _tuples(jax_matches) and len(got) > 0
    if lane == "mapped":
        assert any(t[6] >= 1 for t in got)


def test_list_step_at_a_tied_threshold(monkeypatch):
    """A threshold that a match's similarity ties exactly (the first
    similarity, from the top, that is kept at itself): the rows equal the
    JAX pipeline's and the old composition's, and the search keeps the tied
    match, as the JAX package's does."""
    name = "forbid-swaps-e2"
    _c, _p, hay, _thr, lane = CASES[name]
    jax_e, port_e = _pair(name)
    sims = sorted({np.float32(m.similarity) for m in port_e.search_raw(hay, 0.62)
                   if m.similarity < 1}, reverse=True)
    tie = next(t for t in sims if any(np.float32(m.similarity) == t
                                      for m in port_e.search_raw(hay, float(t))))
    _seed_jax_caps(jax_e, _port_counts(port_e, hay, float(tie)))
    want, jax_matches = _jax_pipeline_rows(monkeypatch, jax_e, hay, float(tie), lane)
    plan, run = _lane_inputs(port_e, hay, float(tie))
    part, = run.parts
    key = (part.local_n, part.lo, part.hi, part.ids_pf.numpy()[:part.local_n].tobytes())
    _h, _c, _d, _r, rows, tags, args, pos, words = _step(plan, run, part, float(tie))
    assert rows.numpy().astype(np.int64).tolist() == want[key][2].tolist()
    p_rows, _n, p_tags = tvd.dp_pipeline_torch(pos, words, *args, tags=True)
    assert torch.equal(rows, p_rows) and torch.equal(tags, p_tags)
    got = _tuples(port_e.search_raw(hay, float(tie)))
    assert got == _tuples(jax_matches)
    assert tie.view(np.uint32).item() in {t[3] for t in got}


def _random_hits(run, n: int, count: int, seed: int):
    """``count`` ascending hit positions below ``n`` (every third one a run
    of consecutive positions) with random match words over the scan's
    pattern bits."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(n - 4, size=count // 2, replace=False))
    pos = np.unique(np.concatenate([starts, starts[::3] + 1, starts[::3] + 2]))[:count]
    W2 = 2 * run.T_scan.W
    words = rng.integers(0, 1 << 32, size=(pos.size, W2), dtype=np.int64)
    words &= rng.integers(0, 1 << 32, size=(pos.size, W2), dtype=np.int64)
    return torch.from_numpy(pos.astype(np.int64)), torch.from_numpy(words)


@pytest.mark.parametrize("name", ["forbid-swaps-e2", "mapped-eszett", "deadend-e2"])
def test_list_step_on_random_hit_lists(monkeypatch, name):
    """On random hit lists the list step equals ``dp_pipeline_torch`` with a
    first hit h0 = 1 and tags, and run in three ranges (each handed its
    preceding hit, the rows put back by their tags) equals one range."""
    _c, _p, hay, thr, _lane = CASES[name]
    _jax_e, port_e = _pair(name)
    plan, run = _lane_inputs(port_e, hay, thr)
    part = run.parts[0]
    pos, words = _random_hits(run, part.local_n, 600, 11)
    window = tvd.DpWindow(part.lo, part.hi, part.local_n)
    args = (window, part.ids_de, part.local_n, run.T, run.pens, np.float32(thr), plan.E,
            run.deadend, run.statics, run.variant)
    got = tvd.dp_pipeline(pos, words, *args, h0=1, tags=True)
    want = tvd.dp_pipeline_torch(pos, words, *args, h0=1, tags=True)
    assert torch.equal(got[0], want[0]) and got[1] == want[1] and torch.equal(got[2], want[2])
    assert got[0].shape[0] > 20 and got[1] > got[0].shape[0] // 4
    one, n_one = tvd.dp_pipeline(pos, words, *args)
    calls = []
    real = tvd.dp_pipeline
    monkeypatch.setattr(tvd, "dp_pipeline",
                        lambda *a, **k: calls.append(k.get("h0", 0)) or real(*a, **k))
    three, n_three = tvd.dp_pipeline_ranges(pos, words, -(-pos.numel() // 3), *args)
    assert calls == [0, 1, 1]
    assert torch.equal(three, one) and n_three == n_one


def test_list_step_routing_and_bounds():
    """Which count-channel calls take the list step: E >= 2, forbidden edit
    types or mapping arrivals; E = 1 without either stays on
    ``dp_pipeline_kernel``, the typed lane on its own step. The step's
    candidates, rows, decisions and row counts stay inside int32 at
    ``pipeline_max_hits``; the emission refuses row counts that disagree
    with its decisions."""
    _jax_e, mapped_e = _pair("mapped-rn-m")
    maps = tvd.mapped_spec_of(mapped_e)
    assert maps is not None
    _plan, mrun = _lane_inputs(mapped_e, CASES["mapped-rn-m"][2], 0.5)
    TT = tvd.TypedTables(*(torch.zeros(1, dtype=torch.int32),) * 5)
    assert not tvd._list_step(1, tvd.FAST)
    assert all(tvd._list_step(E, tvd.FAST) for E in range(2, tvd.MAX_E + 1))
    assert tvd._list_step(1, tvd.DpVariant(forbid=(False, False, False, True)))
    assert tvd._list_step(1, mrun.variant) and mrun.variant.maps is not None
    assert not tvd._list_step(2, tvd.DpVariant(typed=TT))
    for n_c, MO, E in ((48, 1, 2), (80, 16, 2), (600, 40, 3), (1, 1, 6)):
        most = tvd.pipeline_max_hits(n_c, MO, E)
        nce = (2 * E + 1) * MO
        items = most * n_c
        assert items * (nce + 1) < 1 << 31
        assert items * nce + (-(-items // tvd.TYPED_TILE) + 1) * nce + 2 < 1 << 31
    # The emission refuses row counts that give another row total.
    name = "forbid-swaps-e2"
    _c, _p, hay, thr, _lane = CASES[name]
    plan, run = _lane_inputs(_pair(name)[1], hay, thr)
    _h, cands, dec, row_counts, rows, _t, _a, _p, _w = _step(plan, run, run.parts[0], thr)
    n_combo = tvd._combos(plan.E, *run.statics).shape[1]
    M = int(cands.total[0])
    with pytest.raises(ValueError, match="rows decided"):
        tvd.count_emit(dec, row_counts, cands, run.T, plan.E, n_combo, rows.shape[0] + 1, M)
    again, no_tags = tvd.count_emit(dec, row_counts, cands, run.T, plan.E, n_combo,
                                    rows.shape[0], M)
    assert torch.equal(again, rows) and no_tags is None


def _pair_placement(dec, row_counts, cands, T, E: int, n_combo: int):
    """The emission's grid in numpy: one block per (channel, tile) pair of
    the candidates' tiles, in (channel, tile) order, each placing the rows
    of its pair's candidates (ascending) at the running sum of the pairs'
    counts before it. Returns (rows [total, 5], tags [total], pairs)."""
    M = int(cands.total[0])
    nce, items = dec.shape[0], cands.items
    ntile, live_tiles = -(-items // tvd.TYPED_TILE), -(-M // tvd.TYPED_TILE)
    MO = T.out_list.shape[1]
    counts = row_counts.numpy()
    dec_np = dec.numpy()
    field, start, combo = (x.numpy() for x in (cands.field, cands.start, cands.combo))
    depth, node, out_list = T.depth.numpy(), T.node.numpy(), T.out_list.numpy()
    rows, tags, base = [], [], 0
    for p in range(tvd.emit_pairs(M, E, MO)):
        ce, t = divmod(p, live_tiles)
        c = int(counts[ce * ntile + t])
        m = np.arange(t * tvd.TYPED_TILE, min((t + 1) * tvd.TYPED_TILE, M))
        m = m[dec_np[ce, m, 1] >= 0]
        assert m.size == c and len(rows) == base  # the pair's count, its first row
        b, o = divmod(ce, MO)
        f = field[m]
        for j, mm in enumerate(m):
            rows.append([start[mm], dec_np[ce, mm, 0], depth[f[j]] + b - E,
                         out_list[node[f[j]], o], dec_np[ce, mm, 1]])
            tags.append(ce * n_combo + combo[mm])
        base += c
    return (np.asarray(rows, np.int64).reshape(-1, 5), np.asarray(tags, np.int64),
            tvd.emit_pairs(M, E, MO))


@pytest.mark.parametrize("name", ["forbid-swaps-e2", "mapped-eszett", "forbid-swaps-e4"])
def test_emission_grid_and_rows_total(name):
    """The list step's emission as its kernel is laid out (a block per
    (channel, tile) pair, placed by the running sum of the pairs' row
    counts) equals ``count_emit_torch``, and the DP's row counts end with
    the rows of each channel, the rows' total and the candidates' total,
    on random hit lists cut to 1
    candidate, one whole tile (1,024), a tile and one, and all of them, and
    with the rows of two pairs taken out (pairs without a row between pairs
    with rows). ``emit_pairs`` counts (2E + 1) MO channels of ceil(M /
    1,024) tiles. Exact equality."""
    _c, _p, hay, thr, _lane = CASES[name]
    plan, run = _lane_inputs(_pair(name)[1], hay, thr)
    part = run.parts[0]
    E, T = plan.E, run.T
    MO = T.out_list.shape[1]
    assert [tvd.emit_pairs(m, E, MO) for m in (0, 1, 1024, 1025, 2048)] == [
        0, (2 * E + 1) * MO, (2 * E + 1) * MO, 2 * (2 * E + 1) * MO, 2 * (2 * E + 1) * MO]
    pos, words = _random_hits(run, part.local_n, 900, 23)
    window = tvd.DpWindow(part.lo, part.hi, part.local_n)
    full = tvd.typed_expand(pos, words, window, E, run.statics)
    M_all = int(full.total[0])
    assert M_all > tvd.TYPED_TILE + 1
    n_combo = tvd._combos(E, *run.statics).shape[1]
    dp = (part.ids_de, part.local_n, T, run.pens, np.float32(thr), E, run.deadend,
          run.variant.forbid, run.variant.maps)
    seen = set()
    for M in (1, tvd.TYPED_TILE, tvd.TYPED_TILE + 1, M_all, -1):
        cut = full._replace(total=torch.full_like(full.total, M if M > 0 else M_all))
        dec, row_counts = tvd.count_dp(cut, *dp)
        m = int(cut.total[0])
        nce, ntile = dec.shape[0], -(-cut.items // tvd.TYPED_TILE)
        if M < 0:  # the rows of channel 0 in tile 0 and the last channel's last tile out
            live = dec[:, :m].clone()
            last = (m - 1) // tvd.TYPED_TILE
            live[0, :tvd.TYPED_TILE, 1] = -1
            live[nce - 1, last * tvd.TYPED_TILE:, 1] = -1
            live[..., 0] = torch.where(live[..., 1] >= 0, live[..., 0], 0)
            dec, row_counts = tvd._tiled(live, cut, True)
            pairs = row_counts[:nce * ntile].reshape(nce, ntile)[:, :last + 1]
            assert (pairs == 0).sum() >= 2 and (pairs > 0).any()
        n_rows = int((dec[:, :m, 1] >= 0).sum())
        assert row_counts.shape == (nce * (ntile + 1) + 2,)
        tiles = row_counts[:nce * ntile].reshape(nce, ntile)
        assert torch.equal(row_counts[nce * ntile:-2], tiles.sum(1).to(torch.int32))
        assert row_counts[-2:].tolist() == [n_rows, m] == [int(tiles.sum()), m]
        rows, tags = tvd.count_emit(dec, row_counts, cut, T, E, n_combo, n_rows, m, tags=True)
        want_rows, want_tags, n_pairs = _pair_placement(dec, row_counts, cut, T, E, n_combo)
        assert rows.numpy().astype(np.int64).tolist() == want_rows.tolist()
        assert tags.numpy().astype(np.int64).tolist() == want_tags.tolist()
        seen.add((M, m, n_rows > 0, n_pairs))
    assert len(seen) == 5


def test_step_ranges_bounded_by_bytes(monkeypatch):
    """``step_max_hits``: the int32 bound alone for ``dp_pipeline_kernel``
    (E = 1 without forbid flags or mappings), and for the list and typed
    steps also the hits whose items' candidate list and decisions fit
    ``STEP_RANGE_BYTES``. With that budget cut to a few hits' worth, a
    forbid search runs in many ranges and equals the JAX search."""
    TT = tvd.TypedTables(*(torch.zeros(1, dtype=torch.int32),) * 5)
    forbid = tvd.DpVariant(forbid=(False, False, False, True))
    for n_c, MO, E in ((48, 1, 1), (80, 16, 2), (600, 40, 3), (1, 1, 6), (10 ** 6, 4, 2)):
        most = tvd.pipeline_max_hits(n_c, MO, E)
        per_hit = (12 + 8 * (2 * E + 1) * MO) * n_c
        for v in (forbid, tvd.DpVariant(typed=TT)) + ((tvd.FAST,) if E >= 2 else ()):
            got = tvd.step_max_hits(n_c, MO, E, v)
            assert 1 <= got <= most
            assert got * per_hit <= tvd.STEP_RANGE_BYTES or got == 1
            assert got == most or (got + 1) * per_hit > tvd.STEP_RANGE_BYTES
    assert tvd.step_max_hits(48, 1, 1, tvd.FAST) == tvd.pipeline_max_hits(48, 1, 1)
    name = "forbid-swaps-e2"
    _c, _p, hay, thr, lane = CASES[name]
    jax_e, port_e = _pair(name)
    _seed_jax_caps(jax_e, _port_counts(port_e, hay, thr))
    jax_corpus.clear()
    want = _tuples(jax_e.search_raw(hay, thr))
    plan, run = _lane_inputs(port_e, hay, thr)
    per_hit = (12 + 8 * (2 * plan.E + 1) * run.T.out_list.shape[1]) * plan.n_combo
    monkeypatch.setattr(tvd, "STEP_RANGE_BYTES", 5 * per_hit)
    calls = []
    real = tvd.dp_pipeline
    monkeypatch.setattr(tvd, "dp_pipeline",
                        lambda *a, **k: calls.append(k.get("h0", 0)) or real(*a, **k))
    device_corpus.clear()
    got = _tuples(port_e.search_raw(hay, thr))
    assert port_e.last_stats["backend"] == BACKEND[lane]
    assert got == want and len(got) > 0
    assert len(calls) == -(-port_e.last_stats["hits"] // 5) and set(calls) == {0, 1}


#: Mapped engines whose scan budget E x max(2, longest side) passes the
#: one-thread scan's six rows: name -> (edits, mapping, patterns, haystack,
#: threshold, scan budget, whether the JAX device search is the reference;
#: past E = 4 its compile takes minutes, and the host oracle is).
PAST_SIX = {
    "edits4-eszett": (4, ("ß", "ss"), ["strasse", "grosse"],
                      ("pad " * 10) + "straße grosze strasse gröse " * 3, 0.5, 8, True),
    "edits3-sch-sh": (3, ("sch", "sh"), ["schiff", "fisch"],
                      ("pad " * 10) + "shiff fish schif fisch shif fsh " * 3, 0.5, 9, True),
    "edits6-eszett": (6, ("ß", "ss"), ["strassenbahnhof", "grossmutter"],
                      ("pad " * 10) + "straßenbahnhof großmuter strasenbahnhof grosmutter " * 2,
                      0.5, 12, False),
}


@pytest.mark.parametrize("name", list(PAST_SIX))
def test_mapped_lane_serves_past_six_scan_rows(name):
    """A mapped engine whose scan budget passes six rows (the wide kernels'
    deep instances on the card; ``count_dp_rows_kernel`` with mapping
    arrivals past E = 3) runs the mapped lane: at ``edits(4)`` (k = 8) and
    ``edits(3)`` with a 3-symbol side (k = 9) its list equals the JAX
    device search's, tuple for tuple and in order, both on
    ``device-fuzzy-dp-mapped``; at ``edits(6)`` (k = 12) its match set
    equals the host oracle's."""
    E, (a, b), patterns, hay, thr, k, vs_jax = PAST_SIX[name]
    port_e = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(E)).mapping(a, b)
              .case_insensitive(True).device("cpu").build(patterns))
    port_e.backend = "device"
    spec = tvd.mapped_spec_of(port_e)
    assert spec is not None and spec.k == k > tpb.MAX_K
    plan = tvd.dp_plan(port_e, thr, len(view_of(hay, True)), None, spec)
    assert plan is not None and plan.k == k and not plan.dam and plan.E == E
    device_corpus.clear()
    got = _tuples(port_e.search_raw(hay, thr))
    assert port_e.last_stats["backend"] == BACKEND["mapped"]
    assert any(t[6] >= 1 for t in got)
    if vs_jax:
        jax_e = (JaxBuilder.new().fuzzy(JaxLimits.new().edits(E)).mapping(a, b)
                 .case_insensitive(True).build(patterns))
        jax_e.backend = "device"
        _seed_jax_caps(jax_e, _port_counts(port_e, hay, thr))
        jax_corpus.clear()
        assert got == _tuples(jax_e.search_raw(hay, thr))
        assert jax_e.last_stats["backend"] == BACKEND["mapped"]
    else:
        port_e.backend = "oracle"
        assert sorted(got) == sorted(_tuples(port_e.search_raw(hay, thr)))


@pytest.mark.parametrize("E", range(1, 7))
def test_dp_plan_serves_every_mapped_budget(E):
    """``dp_plan`` returns a plan for every mapped budget the spec allows:
    sch <-> tsch (a 4-symbol side) at E = 1..6 gives k = 4E, up to
    ``MAX_USEFUL_K`` = 24; the plan scans with it and no Damerau rows."""
    port_e = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(E))
              .mapping("sch", "tsch").case_insensitive(True).device("cpu")
              .build(["schiffsschraube", "fischmarkt"]))
    spec = tvd.mapped_spec_of(port_e)
    assert spec is not None and spec.k == 4 * E <= tpb.MAX_SCAN_K
    plan = tvd.dp_plan(port_e, 0.5, 1000, None, spec)
    assert plan is not None and plan.k == spec.k and plan.ks == (spec.k,) * 2 and not plan.dam


def test_typed_expand_list_equal_to_jax():
    """``typed_expand`` on CPU tensors (``typed_expand_torch``, the plain
    version of the one-pass ``typed_expand_kernel``) over a random hit list
    and a run of consecutive hits with every bit set: a ``TypedCands`` of
    (field, start, combo, total, items) whose (field, start) list and total
    equal the JAX ``_expand_candidates``, in item order (combo-major, hits
    ascending, each combo's field); past the run's first hit only the b = 0
    copies stay; with h0 = 1 the list is the h0 = 0 list without the first
    hit's candidates, hit 0 still feeding hit 1's dedup."""
    import jax
    import jax.numpy as jnp

    name = "forbid-swaps-e2"
    _c, _p, hay, thr, _lane = CASES[name]
    plan, run = _lane_inputs(_pair(name)[1], hay, thr)
    E, (BITS, P2F, DEPTHS) = plan.E, run.statics
    combos = tvd._combos(E, BITS, P2F, DEPTHS)
    n_combo = combos.shape[1]
    rng = np.random.default_rng(17)
    W2 = 2 * run.T_scan.W
    pos = 100 + np.cumsum(rng.integers(1, 4, 300))
    words = (rng.integers(0, 1 << 32, (300, W2), dtype=np.int64)
             & rng.integers(0, 1 << 32, (300, W2), dtype=np.int64))
    run_len = 20
    pos = np.concatenate([pos, pos[-1] + 10 + np.arange(run_len)])
    words = np.concatenate([words, np.full((run_len, W2), 0xFFFFFFFF, dtype=np.int64)])
    K = pos.size
    window = tvd.DpWindow(0, 1 << 20, 1 << 20)
    pos_t, words_t = torch.from_numpy(pos.astype(np.int64)), torch.from_numpy(words)
    before = dict(tpb.LAUNCHES)
    full = tvd.typed_expand(pos_t, words_t, window, E, run.statics)
    ranged = tvd.typed_expand(pos_t, words_t, window, E, run.statics, h0=1)
    assert tpb.LAUNCHES == before  # CPU tensors run the plain version
    assert type(full)._fields == ("field", "start", "combo", "total", "items")
    M = int(full.total[0])
    assert full.total.dtype == torch.int32 and full.total.shape == (1,)
    assert full.items == K * n_combo and ranged.items == (K - 1) * n_combo
    assert all(t.dtype == torch.int32 and t.numel() == M for t in full[:3])
    count, jf, js = jax.jit(jvd._expand_candidates, static_argnames=(
        "E", "CAND", "BITS", "P2F", "DEPTHS"))(
        jnp.asarray(pos.astype(np.int32)), jnp.asarray(words.astype(np.uint32)),
        np.int32(window.start_lo), np.int32(window.start_hi), np.int32(window.pos_hi),
        E=E, CAND=1 << 16, BITS=BITS, P2F=P2F, DEPTHS=DEPTHS)
    assert int(count) == M > 0
    assert np.array_equal(full.field.numpy(), np.asarray(jf)[:M])
    assert np.array_equal(full.start.numpy(), np.asarray(js)[:M])
    # Item order: combos ascending, each combo's field, its hits ascending.
    c = full.combo.numpy().astype(np.int64)
    assert (np.diff(c) >= 0).all() and (full.field.numpy() == combos[2][c]).all()
    h = np.searchsorted(pos, full.start.numpy() + combos[3][c] - 1)
    assert (pos[h] == full.start.numpy() + combos[3][c] - 1).all()
    assert all((np.diff(h[c == k]) > 0).all() for k in np.unique(c))
    # The run: its first hit keeps every combo, the rest only b == 0.
    in_run = h >= K - run_len
    first = combos[4][c] == 1
    assert in_run.sum() == n_combo + (run_len - 1) * int(combos[4].sum())
    assert (first[in_run & (h > K - run_len)]).all()
    # h0 = 1: the same list without hit 0's candidates.
    keep = h != 0
    assert int(ranged.total[0]) == int(keep.sum()) < M
    for a, b in zip(ranged[:3], full[:3]):
        assert np.array_equal(a.numpy(), b.numpy()[keep])
