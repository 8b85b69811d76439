"""The forbid, mapped and typed DP lanes, port against the JAX package on the
CPU.

(a) ``banded_dp_torch`` with forbid flags and with mapping arrivals equals
    the JAX ``_banded_dp`` (``FORBID`` / ``MAPS``), and
    ``banded_dp_typed_torch`` the JAX ``_banded_dp_typed``, bit for bit (f32
    bit patterns of every channel, packed edit counts) on the same
    candidates; the port's tables go through ``map_tables_from_spec`` and
    ``typed_tables_from_numpy`` from the numpy arrays the JAX side reads.
(b) ``emit_rows_typed`` equals the JAX ``_emit_rows_typed``: the same rows in
    the same order.
(c) Whole searches (``backend = "device"`` and ``"auto"``) equal the JAX
    package's device search and the oracle: pattern, start, end, f32
    similarity bits and the four edit counts; ``last_stats["backend"]``
    carries the JAX package's lane names.
(d) The fallbacks: a haystack with a combining mark, a mapped engine with
    multi-byte edges, a typed budget past the channel bound.
(e) A similarity that ties the threshold on a typed engine.

Both sides get the same inputs, made from a seed. The tolerance is exact
equality everywhere: the DP replays the JAX package's f32 operations in the
same order, and everything else is integer."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder as JaxBuilder
from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits
from fuzzy_aho_corasick_tpu import Pattern as JaxPattern
from fuzzy_aho_corasick_tpu.ops import verify_dp as jvd
from fuzzy_aho_corasick_tpu.utils.graphemes import view_of
from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits, Pattern
from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
from fuzzy_aho_corasick_tpu_torch.ops import verify_dp as tvd
from fuzzy_aho_corasick_tpu_torch.utils import device_corpus

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)


def _variants(variants, reps):
    """The reference tests' corpus: filler with one variant per repetition."""
    parts = []
    for i in range(reps):
        parts += ["lorem ipsum dolor " * (1 + i % 3), variants[i % len(variants)], " "]
    return "".join(parts)


def _words(words, count, seed):
    rng = np.random.default_rng(seed)
    return " ".join(words[i] for i in rng.integers(len(words), size=count).tolist())


GERMAN_TEXT = ["der", "die", "und", "mit", "straße", "strasse", "weiß", "wiess", "fußball",
               "æther", "aether", "wei", "ss", "ß", "strase", "grosze", "größe"]

#: name -> (engine configuration, patterns, haystack, thresholds, lane).
#: ``patterns`` may be a function of (Limits, Pattern) where a pattern
#: carries its own limits.
CONFIGS = {
    # tests/test_typed_limits.py
    "typed-substitutions": (
        lambda b, L: b.fuzzy(L.new().substitutions(1)), ["needle", "pattern"],
        _variants(["needle", "needlz", "nedle", "neeedle", "enedle", "pattern", "pXttern"], 90),
        (0.7,), "typed"),
    "typed-ins-del": (
        lambda b, L: b.fuzzy(L.new().insertions(1).deletions(1)), ["needle", "haystack"],
        _variants(["needle", "neeedle", "nedle", "needlz", "nedlee", "haystack", "hystack"], 90),
        (0.55,), "typed"),
    "typed-per-pattern": (
        lambda b, L: b.fuzzy(L.new().edits(1)),
        lambda L, P: [P.of(("strict", 1.0, 0)), "needle"],
        _variants(["strict", "strlct", "needle", "nedle"], 80), (0.55,), "typed"),
    "typed-counts": (
        lambda b, L: b.fuzzy(L.new().insertions(2).substitutions(1)), ["needle"],
        _variants(["needle", "neeedle", "needlz", "neeedlz"], 60), (0.5,), "typed"),
    "typed-total-sub-cap": (
        lambda b, L: b.fuzzy(L.new().edits(2).substitutions(1)), ["nedle", "patrn"],
        _variants(["nedle", "nexle", "nxdlx", "ndle", "neddle", "patrn", "ptarn", "paXrn"], 60),
        (0.5,), "typed"),
    "forbid-swaps": (
        lambda b, L: b.fuzzy(L.new().edits(2).swaps(0)), ["needle"],
        _variants(["needle", "enedle", "nedl", "needlz", "neXdlz"], 90), (0.5,), "forbid"),
    "forbid-insertions": (
        lambda b, L: b.fuzzy(L.new().edits(2).insertions(0)), ["pattern", "needle"],
        _words(["patern", "pattern", "nedle", "neelde", "filler", "der", "neeedle", "pattXrn"],
               300, 3), (0.6,), "forbid"),
    "forbid-del-sub": (
        lambda b, L: b.fuzzy(L.new().edits(2).deletions(0).substitutions(0)),
        ["pattern", "needle"],
        _words(["patern", "patttern", "nedle", "neelde", "filler", "neeedle", "pattXrn", "needle"],
               300, 4), (0.6,), "forbid"),
    # tests/test_mapped_device.py
    "mapped-eszett": (
        lambda b, L: b.fuzzy(L.new().edits(1)).mapping("ß", "ss").mapping("æ", "ae"),
        ["strasse", "weiss", "fussball", "aether"], _words(GERMAN_TEXT, 400, 5),
        (0.45, 0.75), "mapped"),
    "mapped-rn-m": (
        lambda b, L: b.fuzzy(L.new().edits(1)).mapping("rn", "m"), ["modern"],
        ("pad " * 50) + "modem and modern and moderm " * 6, (0.5, 0.8), "mapped"),
    "mapped-scored": (
        lambda b, L: b.fuzzy(L.new().edits(1)).mapping_scored("ou", "o", 0.6), ["color"],
        ("pad " * 50) + "colour and color and coluor " * 6, (0.5,), "mapped"),
    "mapped-edits2": (
        lambda b, L: b.fuzzy(L.new().edits(2)).mapping("ß", "ss"), ["strasse", "grosse"],
        ("pad " * 50) + "straße grosze straze größe strasse " * 4, (0.4, 0.8), "mapped"),
}
BACKEND = {"typed": "device-fuzzy-dp-typed", "forbid": "device-fuzzy-dp-forbid",
           "mapped": "device-fuzzy-dp-mapped"}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """The configuration built by both packages (case-insensitive), cached:
    the JAX side compiles its DP once per engine."""
    configure, patterns, _hay, _thrs, _lane = CONFIGS[name]
    jp = patterns(JaxLimits, JaxPattern) if callable(patterns) else patterns
    tp = patterns(FuzzyLimits, Pattern) if callable(patterns) else patterns
    jax_e = configure(JaxBuilder.new(), JaxLimits).case_insensitive(True).build(jp)
    port_e = (configure(FuzzyAhoCorasickBuilder.new(), FuzzyLimits).case_insensitive(True)
              .device("cpu").build(tp))
    jax_e.backend = port_e.backend = "device"
    return jax_e, port_e


def _tuples(matches):
    return [
        (m.pattern_index, m.start, m.end, np.float32(m.similarity).view(np.uint32).item(),
         m.insertions, m.deletions, m.substitutions, m.swaps)
        for m in matches
    ]


def _specs(mod, engine, lane):
    """(typed, maps, forbid) of ``engine`` from the package ``mod``."""
    if lane == "mapped":
        return None, mod.mapped_spec_of(engine), None
    if lane == "forbid":
        return None, None, mod.forbid_spec_of(engine)
    return mod.typed_spec_of(engine), None, None


def _candidates(name, thr):
    """The port's lane inputs for the configuration's haystack and its
    candidates, with extra ones at position 0, at and near the limit, and
    dead slots; the zero-padded ids both sides read."""
    _c, _p, hay, _t, lane = CONFIGS[name]
    jax_e, port_e = _pair(name)
    view = view_of(hay, True)
    n = len(view)
    specs = _specs(tvd, port_e, lane)
    plan = tvd.dp_plan(port_e, thr, n, *specs)
    run = tvd.dp_inputs(port_e, hay, plan, view, n, *specs)
    part = run.parts[0]
    _count, cf, cs = tvd.dp_candidates(run, part)
    assert cf.numel() > 20
    F = plan.vf.num_fields
    rng = np.random.default_rng(7)
    extra_f = np.concatenate([np.arange(F), np.arange(F), rng.integers(F, size=32), [-1, -1]])
    extra_s = np.concatenate([np.zeros(F), np.full(F, n), rng.integers(n - 20, n + 1, size=32),
                              [0, n]])
    cand_field = torch.cat([cf, torch.from_numpy(extra_f.astype(np.int32))])
    cand_start = torch.cat([cs, torch.from_numpy(extra_s.astype(np.int32))])
    ids = np.zeros(-(-(n + 128) // 32) * 32, np.uint8)
    ids[:n] = part.ids_de.numpy()[:n]
    return jax_e, port_e, plan, run, n, cand_field, cand_start, ids


# ---------------------------------------------------------------------------
# (a) the DP variants
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("E", "Lmax", "C", "MAPS", "FORBID"))
def _jax_dp(cand_field, cand_start, path_cls, path_node, depth, ids_pad, limit, sim, node_ceil,
            max_pen, p_sub, p_ins, p_del, p_swap, floor, E, Lmax, C, MAPS, FORBID):
    return jvd._banded_dp(
        cand_field, cand_start, path_cls, path_node, depth, ids_pad, limit, sim, node_ceil,
        max_pen, p_sub, p_ins, p_del, p_swap, floor, E, Lmax, C, MAPS=MAPS, FORBID=FORBID)


@pytest.mark.parametrize("name", [n for n, c in CONFIGS.items() if c[4] != "typed"])
def test_banded_dp_forbid_and_maps_bit_equal_to_jax(name):
    thr = CONFIGS[name][3][0]
    lane = CONFIGS[name][4]
    jax_e, port_e, plan, run, n, cand_field, cand_start, ids = _candidates(name, thr)
    _typed, jmaps, jforbid = _specs(jvd, jax_e, lane)
    vf, dense = plan.vf, port_e.dense
    if lane == "mapped":
        # The port's table comes from the JAX package's spec, through the
        # numpy -> torch function.
        maps = tvd.map_tables_from_spec(jmaps.maps, vf.num_fields, vf.max_depth)
        assert maps.entries == tvd.mapped_spec_of(port_e).maps and len(maps.entries) > 0
        forbid = None
    else:
        maps, forbid = None, tuple(jforbid[1:])
        assert forbid == run.variant.forbid and any(forbid)
    got_pen, got_cnt = tvd.banded_dp_torch(cand_field, cand_start, torch.from_numpy(ids), n,
                                           run.T, run.pens, plan.E, False, forbid, maps)
    # Without mappings a large unrolled body takes the JAX function's
    # row-loop form (path tables padded past its unroll bound of 24 rows),
    # which compiles in a fraction of the time; mapping arrivals need the
    # unrolled form.
    Lj = vf.max_depth if lane == "mapped" else 25
    pad = lambda a: np.pad(a, ((0, 0), (0, Lj - a.shape[1]))).reshape(-1)
    want_pen, want_cnt = _jax_dp(
        jnp.asarray(cand_field.numpy()), jnp.asarray(cand_start.numpy()),
        pad(vf.path_cls), pad(vf.path_node), vf.depth, jnp.asarray(ids), np.int32(n),
        dense.sim.reshape(-1), plan.ceil.astype(np.float32),
        *(np.float32(x) for x in run.pens), E=plan.E, Lmax=Lj, C=dense.num_classes,
        MAPS=None if jmaps is None else jmaps.maps, FORBID=forbid)
    want_pen, want_cnt = np.asarray(want_pen), np.asarray(want_cnt)
    assert got_pen.shape == want_pen.shape
    assert np.array_equal(got_pen.numpy().view(np.uint32), want_pen.view(np.uint32))
    assert np.array_equal(got_cnt.numpy(), want_cnt)
    live = np.isfinite(want_pen)
    assert live.sum() > 10
    cnt = want_cnt[live]
    if lane == "mapped":
        assert ((cnt >> 16) & 0xFF).max() >= 1  # a mapping or substitution arrived
    else:
        for shift, off in zip((0, 8, 16, 24), forbid):
            assert not off or ((cnt >> shift) & 0xFF).max() == 0
    # The wrapper takes the plain version for CPU tensors and counts nothing.
    before = dict(tpb.LAUNCHES)
    pen2, cnt2 = tvd.banded_dp(cand_field, cand_start, torch.from_numpy(ids), n, run.T,
                               run.pens, plan.E, False, forbid, maps)
    assert tpb.LAUNCHES == before
    assert torch.equal(pen2.view(torch.int32), got_pen.view(torch.int32))
    assert torch.equal(cnt2, got_cnt)


@functools.partial(jax.jit, static_argnames=("E", "Lmax", "C", "TYPED"))
def _jax_dp_typed(cand_field, cand_start, path_cls, path_node, depth, node_caps, ids_pad, limit,
                  sim, node_ceil, max_pen, p_sub, p_ins, p_del, p_swap, floor, E, Lmax, C, TYPED):
    return jvd._banded_dp_typed(
        cand_field, cand_start, path_cls, path_node, depth, node_caps, ids_pad, limit, sim,
        node_ceil, max_pen, p_sub, p_ins, p_del, p_swap, floor, E, Lmax, C, TYPED=TYPED)


def _typed_tables(spec):
    """The port's typed tables from a (JAX package) spec's numpy arrays."""
    return tvd.typed_tables_from_numpy(
        spec.vecs, spec.sub_src, spec.ins_src, spec.del_src, spec.swap_src, spec.cnts,
        spec.root_caps, spec.node_caps, spec.limcls, spec.adm)


@functools.lru_cache(maxsize=None)
def _typed_dp(name):
    """Both packages' typed DP on the configuration's candidates."""
    thr = CONFIGS[name][3][0]
    jax_e, port_e, plan, run, n, cand_field, cand_start, ids = _candidates(name, thr)
    spec = jvd.typed_spec_of(jax_e)
    TT = _typed_tables(spec)
    vf, dense = plan.vf, port_e.dense
    got = tvd.banded_dp_typed_torch(cand_field, cand_start, torch.from_numpy(ids), n, run.T,
                                    run.pens, plan.E, TT)
    want = np.asarray(_jax_dp_typed(
        jnp.asarray(cand_field.numpy()), jnp.asarray(cand_start.numpy()),
        vf.path_cls.reshape(-1), vf.path_node.reshape(-1), vf.depth,
        np.ascontiguousarray(spec.node_caps.reshape(-1)), jnp.asarray(ids), np.int32(n),
        dense.sim.reshape(-1), plan.ceil.astype(np.float32),
        *(np.float32(x) for x in run.pens), E=plan.E, Lmax=vf.max_depth, C=dense.num_classes,
        TYPED=(spec.vecs, spec.sub_src, spec.ins_src, spec.del_src, spec.swap_src,
               spec.root_caps)))
    return spec, TT, plan, run, n, cand_field, cand_start, ids, got, want


TYPED_DP = ["typed-substitutions", "typed-ins-del", "typed-per-pattern", "typed-counts"]


@pytest.mark.parametrize("name", TYPED_DP)
def test_banded_dp_typed_torch_bit_equal_to_jax(name):
    spec, TT, plan, run, n, cand_field, cand_start, ids, got, want = _typed_dp(name)
    assert plan.E == spec.E and TT.nch == len(spec.vecs)
    assert got.shape == want.shape == ((2 * plan.E + 1) * TT.nch, cand_field.numel())
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    live = np.isfinite(want).reshape(2 * plan.E + 1, TT.nch, -1)
    assert live[:, 0].any() and live[:, 1:].any()  # the zero vector and edit channels
    before = dict(tpb.LAUNCHES)
    again = tvd.banded_dp_typed(cand_field, cand_start, torch.from_numpy(ids), n, run.T,
                                run.pens, plan.E, TT)
    assert tpb.LAUNCHES == before
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))


# ---------------------------------------------------------------------------
# (b) the typed emission
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("E", "MO", "CAND", "KG", "TYPED_EMIT"))
def _jax_emit_typed(pen, cand_field, cand_start, depth, node, out_list, pat_len, pat_weight,
                    limcls, limit, thr, E, MO, CAND, KG, TYPED_EMIT):
    return jvd._emit_rows_typed(pen, cand_field, cand_start, depth, node, out_list, pat_len,
                                pat_weight, limcls, limit, thr, E, MO, CAND, KG,
                                TYPED_EMIT=TYPED_EMIT)


@pytest.mark.parametrize("name", TYPED_DP)
def test_emit_rows_typed_equal_to_jax(name):
    spec, TT, plan, run, n, cand_field, cand_start, _ids, got_pen, want_pen = _typed_dp(name)
    thr = np.float32(CONFIGS[name][3][0])
    port_e = _pair(name)[1]
    dense, vf = port_e.dense, plan.vf
    rows = tvd.emit_rows_typed(got_pen, cand_field, cand_start, run.T, TT, n, thr, plan.E).numpy()
    M = cand_field.numel()
    KG = 1 << 14
    total, packed = _jax_emit_typed(
        jnp.asarray(want_pen), jnp.asarray(cand_field.numpy()), jnp.asarray(cand_start.numpy()),
        vf.depth, vf.node, dense.out_list, dense.pat_len, dense.pat_weight, spec.limcls,
        np.int32(n), thr, E=plan.E, MO=dense.max_out, CAND=M, KG=KG,
        TYPED_EMIT=(spec.vecs, spec.cnts, spec.adm))
    total = int(total)
    assert 10 < total < KG and rows.shape == (total, 5)
    packed = np.asarray(packed)[:total].astype(np.int64)
    col2 = packed[:, 2]
    c12 = col2 & 0xFFF  # the JAX rows pack span, pattern and 3-bit counts in one word
    counts = (c12 & 7) | ((c12 >> 3) & 7) << 8 | ((c12 >> 6) & 7) << 16 | ((c12 >> 9) & 7) << 24
    want = np.stack([packed[:, 0], packed[:, 1], col2 >> 24, (col2 >> 12) & 0xFFF, counts], axis=1)
    assert np.array_equal(rows.astype(np.int64), want)
    if name == "typed-per-pattern":
        # The exact-only pattern emits no row with an edit.
        strict = rows[rows[:, 3] == 0]
        assert len(strict) > 0 and not strict[:, 4].any()
        assert rows[rows[:, 3] == 1][:, 4].any()


# ---------------------------------------------------------------------------
# (b') the typed step's pieces: expansion, DP with decisions, emission
# ---------------------------------------------------------------------------

#: name -> (limits, patterns (a function of Limits, Pattern), haystack,
#: threshold, channels, limits classes). Engines of 2, 5, 14 and 55 channels;
#: ``five-three-classes`` has an exact-only and a substitutions(1) pattern
#: beside edits(1).
TYPED_STEP = {
    "two": (lambda L: L.new().substitutions(1), lambda L, P: ["needle", "pattern"],
            _variants(["needle", "needlz", "nedle", "pXttern", "pattern"], 60), 0.7, 2, 1),
    "five-three-classes": (
        lambda L: L.new().edits(1),
        lambda L, P: [P.of(("strict", 1.0, 0)), P.of("needle").fuzzy(L.new().substitutions(1)),
                      "pattern"],
        _variants(["strict", "strlct", "needle", "nedle", "needlz", "patern", "pattern"], 70),
        0.55, 5, 3),
    "fourteen": (lambda L: L.new().edits(2).substitutions(1), lambda L, P: ["nedle", "patrn"],
                 CONFIGS["typed-total-sub-cap"][2], 0.5, 14, 1),
    "fifty-five": (lambda L: L.new().edits(4).substitutions(1),
                   lambda L, P: ["needles", "patterns"],
                   _variants(["needles", "nedles", "needlesxx", "ptterns", "patterns"], 30),
                   0.4, 55, 1),
}


@functools.lru_cache(maxsize=None)
def _typed_step_case(name):
    limits, patterns, hay, thr, nch, nlc = TYPED_STEP[name]
    port_e = (FuzzyAhoCorasickBuilder.new().fuzzy(limits(FuzzyLimits)).case_insensitive(True)
              .device("cpu").build(patterns(FuzzyLimits, Pattern)))
    view = view_of(hay, True)
    spec = tvd.typed_spec_of(port_e)
    assert spec is not None and tvd.lane_specs_of(port_e)[0] is spec
    plan = tvd.dp_plan(port_e, thr, len(view), typed=spec)
    run = tvd.dp_inputs(port_e, hay, plan, view, len(view), typed=spec)
    TT = run.variant.typed
    assert (TT.nch, TT.adm.shape[0]) == (nch, nlc)
    part = run.parts[0]
    _count, pos, words = tpb.packed_hits(part.ids_pf, run.T_scan, run.halo)
    assert pos.numel() > 4
    window = tvd.DpWindow(part.lo, part.hi, part.local_n)
    return port_e, hay, thr, plan, run, part, pos, words, window


@pytest.mark.parametrize("name", list(TYPED_STEP))
def test_typed_step_pieces_equal_to_plain_and_jax(name):
    """``typed_expand`` (the candidate list), ``typed_dp`` (decisions and
    row counts: per (channel, tile), per channel, the rows' total and the
    candidates' total) and ``typed_emit`` (rows and tags, placed by those
    totals), each its plain version on CPU tensors, bit for bit against
    ``dp_pipeline_torch`` and, on the same candidates and penalties, the
    JAX ``_emit_rows_typed``; u8 and int32 ids; the whole step with a first
    hit ``h0`` and tags."""
    port_e, hay, thr, plan, run, part, pos, words, window = _typed_step_case(name)
    TT, E, T = run.variant.typed, plan.E, run.T
    MO = T.out_list.shape[1]
    nce = (2 * E + 1) * MO
    n_combo = tvd._combos(E, *run.statics).shape[1]
    for ids in (part.ids_de, part.ids_de.int()):
        cands = tvd.typed_expand(pos, words, window, E, run.statics)
        cf, cs, cc = tvd.expand_candidates(pos, words, *window, E, *run.statics, combos=True)
        M = cf.numel()
        assert int(cands.total[0]) == M > 4 and cands.items == pos.numel() * n_combo
        assert all(torch.equal(a[:M], b) for a, b in zip(cands[:3], (cf, cs, cc)))
        dec, row_counts = tvd.typed_dp(cands, ids, part.local_n, T, run.pens, thr, E, TT)
        ntile = -(-cands.items // tvd.TYPED_TILE)
        assert dec.shape == (nce, cands.items, 2)
        assert row_counts.shape == (nce * (ntile + 1) + 2,)
        assert int(row_counts[-1]) == M and (dec[:, M:, 1] == -1).all()
        pen = tvd.banded_dp_typed_torch(cf, cs, ids, part.local_n, T, run.pens, E, TT)
        live = dec[:, :M]
        assert torch.equal(live, tvd.typed_decisions_torch(pen, cf, cs, T, TT, part.local_n, thr,
                                                           E))
        per_tile = torch.zeros((nce, ntile * tvd.TYPED_TILE), dtype=torch.int64)
        per_tile[:, :M] = (live[..., 1] >= 0).long()
        tiles = per_tile.reshape(nce, ntile, -1).sum(2)
        assert torch.equal(row_counts[:nce * ntile].long(), tiles.reshape(-1))
        assert torch.equal(row_counts[nce * ntile:-2].long(), tiles.sum(1))
        n_rows, n_cand = row_counts[-2:].tolist()
        assert n_rows == int(tiles.sum()) and n_cand == M
        rows, tags = tvd.typed_emit(dec, row_counts, cands, T, TT, E, n_combo, n_rows, n_cand,
                                    tags=True)
        want_rows, want_n, want_tags = tvd.dp_pipeline_torch(
            pos, words, window, ids, part.local_n, T, run.pens, thr, E, False, run.statics,
            run.variant, tags=True)
        assert torch.equal(rows, want_rows) and torch.equal(tags, want_tags) and want_n == M
        assert n_rows > 4
        # The rows' channels are the winning channels' (packed counts).
        assert set(rows[:, 4].tolist()) <= set(TT.graph[:, 9].tolist())
        # The JAX emission on the same candidates and penalties.
        spec = tvd.typed_spec_of(port_e)
        KG = 1 << 14
        total, packed = _jax_emit_typed(
            jnp.asarray(pen.numpy()), jnp.asarray(cf.numpy()), jnp.asarray(cs.numpy()),
            plan.vf.depth, plan.vf.node, port_e.dense.out_list, port_e.dense.pat_len,
            port_e.dense.pat_weight, spec.limcls, np.int32(part.local_n), np.float32(thr),
            E=E, MO=port_e.dense.max_out, CAND=M, KG=KG,
            TYPED_EMIT=(spec.vecs, spec.cnts, spec.adm))
        assert int(total) == n_rows < KG
        assert np.array_equal(_unpack_jax_rows(np.asarray(packed)[:n_rows]),
                              rows.numpy().astype(np.int64))
    # The whole step with a first hit and tags (a range of a longer list),
    # as dp_pipeline runs it on CPU tensors.
    h0 = 2
    args = (window, part.ids_de, part.local_n, T, run.pens, thr, E, False, run.statics,
            run.variant)
    got = tvd.dp_pipeline(pos[h0 - 1:], words[h0 - 1:], *args, h0=1, tags=True)
    want = tvd.dp_pipeline_torch(pos[h0 - 1:], words[h0 - 1:], *args, h0=1, tags=True)
    assert torch.equal(got[0], want[0]) and got[1] == want[1] and torch.equal(got[2], want[2])


@pytest.mark.parametrize("name", ["fourteen", "fifty-five"])
def test_typed_emission_grid_edges_equal_to_jax(name):
    """The typed emission (``typed_emit``, its plain version on CPU tensors)
    at the edges of its kernel's grid of (channel, tile of 1,024) pairs,
    against the JAX ``_emit_rows_typed`` on the same candidates and
    penalties, at 14 and 55 channels: the case's candidate list repeated
    past two tiles (the JAX emission runs once on the list, at the shape of
    ``test_typed_step_pieces_equal_to_plain_and_jax``; a repeated candidate
    has its rows again), cut to 1 candidate, 1,024, 1,025 and all of them,
    and whole with the rows of channel 0 in tile 0 and of the last channel
    in the last tile taken out (pairs without a row beside pairs with
    rows). The row counts hold the rows per (channel, tile), per channel,
    the rows' and the candidates' total. Exact equality."""
    port_e, hay, thr, plan, run, part, pos, words, window = _typed_step_case(name)
    TT, E, T = run.variant.typed, plan.E, run.T
    tile = tvd.TYPED_TILE
    n_combo = tvd._combos(E, *run.statics).shape[1]
    cf, cs, cc = tvd.expand_candidates(pos, words, *window, E, *run.statics, combos=True)
    M = cf.numel()
    pen = tvd.banded_dp_typed_torch(cf, cs, part.ids_de, part.local_n, T, run.pens, E, TT)
    base = tvd.typed_decisions_torch(pen, cf, cs, T, TT, part.local_n, thr, E)
    spec = tvd.typed_spec_of(port_e)
    total, packed = _jax_emit_typed(
        jnp.asarray(pen.numpy()), jnp.asarray(cf.numpy()), jnp.asarray(cs.numpy()),
        plan.vf.depth, plan.vf.node, port_e.dense.out_list, port_e.dense.pat_len,
        port_e.dense.pat_weight, spec.limcls, np.int32(part.local_n), np.float32(thr),
        E=E, MO=port_e.dense.max_out, CAND=M, KG=1 << 14,
        TYPED_EMIT=(spec.vecs, spec.cnts, spec.adm))
    # The JAX rows come in (channel, candidate) order: channel ce's are those
    # of its candidates with a row, ascending.
    has = (base[..., 1] >= 0).numpy()
    assert int(total) == int(has.sum()) > 4
    groups = np.split(_unpack_jax_rows(np.asarray(packed)[:int(total)]),
                      np.cumsum(has.sum(1))[:-1])
    jax_row = [dict(zip(np.flatnonzero(has[ce]).tolist(), g.tolist()))
               for ce, g in enumerate(groups)]
    reps = -(-(2 * tile + 1) // M)
    L = reps * M
    full = tvd.TypedCands(cf.repeat(reps), cs.repeat(reps), cc.repeat(reps),
                          torch.tensor([L], dtype=torch.int32), L)
    of = np.arange(L) % M  # the case's candidate at each place of the list
    nce, ntile = base.shape[0], -(-L // tile)
    seen = []
    for cut in (1, tile, tile + 1, L, -1):
        m = abs(cut) if cut > 0 else L
        live = base[:, torch.from_numpy(of[:m])].clone()
        if cut < 0:  # the rows of channel 0 in tile 0 and the last channel's last tile out
            last = (m - 1) // tile
            live[0, :tile, 1] = -1
            live[nce - 1, last * tile:, 1] = -1
            live[..., 0] = torch.where(live[..., 1] >= 0, live[..., 0], 0)
        lst = full._replace(total=torch.tensor([m], dtype=torch.int32))
        dec, row_counts = tvd._tiled(live, lst, True)
        tiles = row_counts[:nce * ntile].reshape(nce, ntile)
        if cut < 0:
            pairs = tiles[:, :last + 1]
            assert (pairs == 0).sum() >= 2 and (pairs > 0).any()
        n_rows, n_cand = row_counts[-2:].tolist()
        assert torch.equal(row_counts[nce * ntile:-2], tiles.sum(1).to(torch.int32))
        assert n_rows == int(tiles.sum()) == int((live[..., 1] >= 0).sum()) and n_cand == m
        rows, tags = tvd.typed_emit(dec, row_counts, lst, T, TT, E, n_combo, n_rows, n_cand,
                                    tags=True)
        keep = (live[..., 1] >= 0).numpy()
        want = [(jax_row[ce][of[i]], ce * n_combo + int(cc[of[i]]))
                for ce in range(nce) for i in np.flatnonzero(keep[ce]).tolist()]
        assert rows.numpy().astype(np.int64).tolist() == [r for r, _t in want]
        assert tags.tolist() == [t for _r, t in want]
        seen.append((m, n_rows, tvd.emit_pairs(m, E, T.out_list.shape[1])))
    assert len({s[:2] for s in seen}) == 5 and all(s[1] > 0 for s in seen)


def test_typed_step_scans_no_row_counts(monkeypatch):
    """The typed step reads the rows' and the candidates' totals that its
    DP keeps: ``dp_pipeline`` calls ``typed_expand``, ``typed_dp`` and
    ``typed_emit`` once each and neither ``block_offsets`` nor its plain
    version (the CPU route's counters), and its rows and tags equal
    ``dp_pipeline_torch``'s."""
    port_e, hay, thr, plan, run, part, pos, words, window = _typed_step_case("fourteen")
    calls = {}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapper)

    for mod, name in ((tpb, "block_offsets"), (tpb, "block_offsets_torch"),
                      (tvd, "typed_expand"), (tvd, "typed_dp"), (tvd, "typed_emit")):
        counted(mod, name)
    args = (pos, words, window, part.ids_de, part.local_n, run.T, run.pens, np.float32(thr),
            plan.E, False, run.statics, run.variant)
    got = tvd.dp_pipeline(*args, tags=True)
    assert calls == {"typed_expand": 1, "typed_dp": 1, "typed_emit": 1}
    want = tvd.dp_pipeline_torch(*args, tags=True)
    assert torch.equal(got[0], want[0]) and got[1] == want[1] and torch.equal(got[2], want[2])
    assert got[0].shape[0] > 4


def _unpack_jax_rows(packed):
    """The JAX typed rows (span, pattern and 3-bit counts packed in one
    word) as the port's five columns."""
    packed = packed.astype(np.int64)
    col2 = packed[:, 2]
    c12 = col2 & 0xFFF
    counts = (c12 & 7) | ((c12 >> 3) & 7) << 8 | ((c12 >> 6) & 7) << 16 | ((c12 >> 9) & 7) << 24
    return np.stack([packed[:, 0], packed[:, 1], col2 >> 24, (col2 >> 12) & 0xFFF, counts], axis=1)


def test_typed_step_tied_threshold_and_no_hits():
    """The typed step at a threshold that a match's similarity ties, and on
    a slice without hits: rows equal ``dp_pipeline_torch``'s."""
    port_e, hay, thr, plan, run, part, pos, words, window = _typed_step_case(
        "five-three-classes")
    sims = {np.float32(m.similarity) for m in port_e.search_raw(hay, thr) if m.similarity < 1}
    tie = float(min(sims))
    args = (window, part.ids_de, part.local_n, run.T, run.pens, np.float32(tie), plan.E, False,
            run.statics, run.variant)
    got, n_got = tvd.dp_pipeline(pos, words, *args)
    want, n_want = tvd.dp_pipeline_torch(pos, words, *args)
    assert torch.equal(got, want) and n_got == n_want
    tie_bits = np.float32(tie).view(np.int32)
    pats = got[:, 3].numpy()
    pl = port_e.dense.pat_len[pats]
    sims_got = ((pl - got[:, 1].numpy().view(np.float32)) / pl) * port_e.dense.pat_weight[pats]
    assert (sims_got.astype(np.float32).view(np.int32) == tie_bits).any()
    empty_pos = pos[:0]
    rows, n = tvd.dp_pipeline(empty_pos, words[:0], *args)
    assert rows.shape == (0, 5) and n == 0
    # A hit list whose hits expand to no candidate.
    far = tvd.DpWindow(0, 1, 1)
    rows, n = tvd.dp_pipeline(pos, words, far, *args[1:])
    assert rows.shape == (0, 5) and n == 0


# ---------------------------------------------------------------------------
# The numpy -> torch table functions and the wrappers' checks
# ---------------------------------------------------------------------------

def test_map_tables_from_spec():
    _jax_e, port_e = _pair("mapped-rn-m")
    spec = tvd.mapped_spec_of(port_e)
    vf = tvd.verify_fields_of(port_e)
    mt = tvd.map_tables_from_spec(spec.maps, vf.num_fields, vf.max_depth)
    assert mt.ph == spec.ph and mt.table.shape == (len(spec.maps), tvd.MAP_COLS)
    shapes = set()
    for row, fields, (i_to, pb, drift, hay_cls, pen, flds) in zip(
            mt.table.tolist(), mt.fields.tolist(), spec.maps):
        ha = len(hay_cls)
        assert row[:4] == [i_to, pb, drift, ha]
        assert row[4:4 + ha] == list(hay_cls[::-1]) and row[4 + ha:8] == [-2] * (4 - ha)
        assert np.int32(row[8]).view(np.float32) == np.float32(pen)
        assert [f for f in range(vf.num_fields) if fields[f >> 5] >> (f & 31) & 1] == list(flds)
        shapes.add((pb, ha))
    assert shapes == {(2, 1), (1, 2)}  # rn -> m and m -> rn
    ptr = mt.row_ptr.tolist()
    for i in range(vf.max_depth + 1):
        assert [e[0] for e in spec.maps[ptr[i]:ptr[i + 1]]] == [i] * (ptr[i + 1] - ptr[i])
    assert ptr[-1] == len(spec.maps)
    with pytest.raises(ValueError, match="outside the DP's model"):
        tvd.map_tables_from_spec(((1, 4, 0, (1, 2, 3, 4), 0.0, (0,)),), 1, 8)
    with pytest.raises(ValueError, match="outside the DP's model"):
        tvd.map_tables_from_spec(spec.maps[::-1], vf.num_fields, vf.max_depth)
    with pytest.raises(ValueError, match="names field"):
        tvd.map_tables_from_spec(((1, 1, 0, (1,), 0.0, (3,)),), 2, 8)


def test_typed_tables_and_wrappers_refuse_bad_inputs():
    spec, TT, plan, run, n, cf, cs, ids, _got, _want = _typed_dp("typed-per-pattern")
    assert TT.graph.shape == (5, tvd.TYPED_COLS) and TT.adm.shape == (spec.n_limcls, 5)
    assert TT.graph[:, 4].tolist() == [sum(v) for v in spec.vecs]
    assert TT.root_caps.tolist() == list(spec.root_caps)
    with pytest.raises(ValueError, match="typed channels"):
        tvd.typed_tables_from_numpy(
            spec.vecs[1:], spec.sub_src[1:], spec.ins_src[1:], spec.del_src[1:],
            spec.swap_src[1:], spec.cnts[1:], spec.root_caps, spec.node_caps, spec.limcls,
            [a[1:] for a in spec.adm])
    ids_t = torch.from_numpy(ids)
    bad = tvd.TypedTables(TT.graph, TT.node_caps[:-1], TT.root_caps, TT.limcls, TT.adm)
    with pytest.raises(ValueError, match="node caps"):
        tvd.banded_dp_typed(cf, cs, ids_t, n, run.T, run.pens, plan.E, bad)
    bad = tvd.TypedTables(TT.graph.long(), TT.node_caps, TT.root_caps, TT.limcls, TT.adm)
    with pytest.raises(ValueError, match="int32"):
        tvd.banded_dp_typed(cf, cs, ids_t, n, run.T, run.pens, plan.E, bad)
    _count, pos, words = tpb.packed_hits(run.parts[0].ids_pf, run.T_scan, run.halo)
    window = tvd.DpWindow(0, n, n)
    args = (pos, words, window, run.parts[0].ids_de, n, run.T, run.pens, 0.55, plan.E)
    with pytest.raises(ValueError, match="typed DP takes no"):
        tvd.dp_pipeline(*args, True, run.statics, run.variant)
    with pytest.raises(ValueError, match="forbid is"):
        tvd.dp_pipeline(*args, False, run.statics, tvd.DpVariant(forbid=(True, False)))
    _j, mapped_e = _pair("mapped-eszett")  # deeper fields than this engine's
    vf = tvd.verify_fields_of(mapped_e)
    other = tvd.map_tables_from_spec(tvd.mapped_spec_of(mapped_e).maps, vf.num_fields,
                                     vf.max_depth)
    with pytest.raises(ValueError, match="another Lmax"):
        tvd.banded_dp(cf, cs, ids_t, n, run.T, run.pens, plan.E, False, None, other)
    with pytest.raises(ValueError, match="no dead-end filter"):
        tvd.banded_dp(cf, cs, ids_t, n, run.T, run.pens, plan.E, True, None, other)


# ---------------------------------------------------------------------------
# (c) whole searches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_search_equal_to_jax_device_and_oracle(name):
    _c, _p, hay, thrs, lane = CONFIGS[name]
    jax_e, port_e = _pair(name)
    dev = port_e._device_engine()
    assert (dev._mapped_ok, dev._typed_ok) == ((True, False) if lane == "mapped" else (False, True))
    for thr in thrs:
        got = _tuples(port_e.search_raw(hay, thr))
        stats = port_e.last_stats
        assert stats["backend"] == BACKEND[lane]
        want = _tuples(jax_e.search_raw(hay, thr))
        assert jax_e.last_stats["backend"] == BACKEND[lane]
        assert sorted(got) == sorted(want)
        jax_e.backend = port_e.backend = "oracle"
        ora = sorted(_tuples(jax_e.search_raw(hay, thr)))
        assert sorted(got) == ora == sorted(_tuples(port_e.search_raw(hay, thr)))
        jax_e.backend = port_e.backend = "device"
        assert len(got) >= 4
    assert stats["slices"] == 1 and stats["candidates"] >= stats["hits"] > 0
    raw = hay.encode()  # match offsets are bytes
    texts = {raw[s:e].decode() for _p, s, e, *_ in got}
    if name == "typed-substitutions":
        assert {"needlz", "pXttern"} <= texts and not {"nedle", "neeedle"} & texts
    if name == "typed-per-pattern":
        assert {"strict", "nedle"} <= texts and "strlct" not in texts
    if name == "forbid-swaps":
        assert "nedl" in texts and all(t[7] == 0 for t in got)
    if name == "mapped-eszett":
        exact = {raw[s:e].decode() for _p, s, e, sim, *_ in got
                 if sim == np.float32(1).view(np.uint32)}
        assert {"straße", "strasse", "weiß", "fußball", "æther"} <= exact
    if name == "mapped-rn-m":  # the mapping counts as one substitution
        assert any(hay[t[1]:t[2]] == "modem" and t[4:] == (0, 0, 1, 0) for t in got)


def test_auto_backend_serves_the_lanes(monkeypatch):
    for name in ("typed-ins-del", "forbid-swaps", "mapped-eszett"):
        _c, _p, hay, thrs, lane = CONFIGS[name]
        _jax_e, port_e = _pair(name)
        want = _tuples(port_e.search_raw(hay, thrs[0]))
        monkeypatch.setattr(type(port_e), "AUTO_DEVICE_MIN", 64)
        port_e.backend = "auto"
        try:
            assert _tuples(port_e.search_raw(hay, thrs[0])) == want
            assert port_e.last_stats["backend"] == BACKEND[lane]
        finally:
            port_e.backend = "device"


def test_sliced_forbid_equals_unsliced(monkeypatch):
    _jax_e, port_e = _pair("forbid-swaps")
    hay = CONFIGS["forbid-swaps"][2]
    whole = _tuples(port_e.search_raw(hay, 0.5))
    monkeypatch.setattr(tvd, "SLICE_SYMS", 900)
    device_corpus.clear()
    sliced = _tuples(port_e.search_raw(hay, 0.5))
    assert port_e.last_stats["slices"] >= 4
    assert port_e.last_stats["backend"] == "device-fuzzy-dp-forbid"
    assert sliced == whole and len(whole) > 50


def _draw_limits(rng):
    """(total, ((setter, cap), ...)): a total budget of 1-2 edits with each
    per-type cap set one time in three."""
    total = 1 + int(rng.integers(2))
    caps = tuple((setter, int(rng.integers(total + 1)))
                 for setter in ("insertions", "deletions", "substitutions", "swaps")
                 if rng.integers(3) == 0)
    return total, caps


def _limits(L, drawn):
    lim = L.new().edits(drawn[0])
    for setter, cap in drawn[1]:
        lim = getattr(lim, setter)(cap)
    return lim


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_typed_lane_random_configs(seed):
    """Random per-type caps and per-pattern limits (a reduced
    tests/test_fuzz_lanes.py::test_typed_lane_random_configs)."""
    vocab = ["hello", "world", "lorem", "cell", "holder"]
    rng = np.random.default_rng(seed)
    for _draw in range(60):
        pats = sorted({vocab[int(i)] for i in rng.integers(len(vocab), size=3)})
        own = [_draw_limits(rng) if rng.integers(3) == 0 else None for _ in pats]
        glob = _draw_limits(rng)

        def build(B, L, P):
            specs = [p if lim is None else P.of(p).fuzzy(_limits(L, lim))
                     for p, lim in zip(pats, own)]
            return B.new().fuzzy(_limits(L, glob)).build(specs)

        port_e = build(FuzzyAhoCorasickBuilder, FuzzyLimits, Pattern).to("cpu")
        # Typed or forbid engines only, and no body the JAX side compiles
        # for minutes.
        if port_e._device_engine()._typed_ok and len(tvd.typed_spec_of(port_e).vecs) <= 12:
            break
    else:
        pytest.fail("no typed configuration drawn")
    jax_e = build(JaxBuilder, JaxLimits, JaxPattern)
    words = vocab + ["helo", "wrld", "lorme", "cel", "hodler", "a", "xx", "holdder"]
    hay = _words(words, 160, seed)
    thr = float(rng.choice([0.55, 0.65, 0.75]))
    jax_e.backend = port_e.backend = "device"
    got = sorted(_tuples(port_e.search_raw(hay, thr)))
    lane = port_e.last_stats["backend"]
    assert lane in ("device-fuzzy-dp-typed", "device-fuzzy-dp-forbid")
    assert got == sorted(_tuples(jax_e.search_raw(hay, thr)))
    assert jax_e.last_stats["backend"] == lane
    port_e.backend = "oracle"
    assert got == sorted(_tuples(port_e.search_raw(hay, thr))) and len(got) > 0


@pytest.mark.parametrize("seed", [21, 22])
def test_mapped_lane_random_configs(seed):
    """Random mapping tables, multi-char and scored (a reduced
    tests/test_fuzz_lanes.py::test_mapped_lane_random_configs)."""
    pool = [("rn", "m", None), ("cl", "d", None), ("vv", "w", None), ("oo", "0", 0.8),
            ("nn", "m", 0.7), ("ii", "u", None)]
    vocab = ["modern", "world", "clean", "wood", "dinner", "suit"]
    rng = np.random.default_rng(seed)
    chosen = [pool[int(i)] for i in rng.choice(len(pool), size=3, replace=False)]
    pats = sorted({vocab[int(i)] for i in rng.choice(len(vocab), size=3, replace=False)})

    def build(B, L):
        b = B.new().fuzzy(L.new().edits(1))
        for a, c, score in chosen:
            b = b.mapping(a, c) if score is None else b.mapping_scored(a, c, score)
        return b.build(pats)

    jax_e = build(JaxBuilder, JaxLimits)
    port_e = build(FuzzyAhoCorasickBuilder, FuzzyLimits).to("cpu")
    assert port_e._device_engine()._mapped_ok
    hay = _words(vocab + ["modem", "wean", "dimer", "w00d", "vvorld", "dean", "suut", "wor1d"],
                 200, seed)
    thr = float(rng.choice([0.5, 0.6, 0.7]))
    jax_e.backend = port_e.backend = "device"
    got = sorted(_tuples(port_e.search_raw(hay, thr)))
    assert port_e.last_stats["backend"] == "device-fuzzy-dp-mapped"
    assert got == sorted(_tuples(jax_e.search_raw(hay, thr)))
    port_e.backend = "oracle"
    assert got == sorted(_tuples(port_e.search_raw(hay, thr))) and len(got) > 10


# ---------------------------------------------------------------------------
# (d) fallbacks, (e) ties
# ---------------------------------------------------------------------------

def test_combining_mark_haystack_falls_back_to_the_oracle():
    build = lambda B, L: (B.new().fuzzy(L.new().edits(1)).case_insensitive(True)
                          .mapping("é", "e").build(["cafe"]))
    jax_e = build(JaxBuilder, JaxLimits)
    port_e = build(FuzzyAhoCorasickBuilder, FuzzyLimits).to("cpu")
    hay = ("pad " * 40) + "café and cafe"  # 'é' as e + combining acute
    assert port_e._device_engine()._mapped_ok
    jax_e.backend = port_e.backend = "device"
    got = sorted(_tuples(port_e.search_raw(hay, 0.5)))
    assert "device" not in port_e.last_stats["backend"]  # the oracle served it
    assert got == sorted(_tuples(jax_e.search_raw(hay, 0.5))) and len(got) >= 2
    # With every grapheme one code point the lane serves the same engine.
    port_e.search_raw(("pad " * 40) + "café and cafe", 0.5)
    assert port_e.last_stats["backend"] == "device-fuzzy-dp-mapped"
    assert port_e.search_raw("", 0.5) == []


def test_mapped_engine_with_multibyte_edges_declines():
    build = lambda B, L: (B.new().fuzzy(L.new().edits(1)).case_insensitive(True)
                          .mapping("æ", "ae").build(["encyclopædia"]))
    jax_e = build(JaxBuilder, JaxLimits)
    port_e = build(FuzzyAhoCorasickBuilder, FuzzyLimits).to("cpu")
    assert jvd.mapped_spec_of(jax_e) is None and tvd.mapped_spec_of(port_e) is None
    hay = "x" * 100
    assert not port_e._device_engine().supports(hay)
    assert not jax_e._device_engine().supports(hay)
    port_e.backend = "auto"
    got = port_e.search_raw(("x " * 40) + "encyclopaedia", 0.9)
    assert len(got) == 1 and _tuples(got) == _tuples(jax_e.search_raw(("x " * 40) + "encyclopaedia", 0.9))


def test_typed_budget_past_the_channel_bound_declines(monkeypatch):
    build = lambda B, L: (B.new().fuzzy(L.new().insertions(2).deletions(2).substitutions(2)
                                        .swaps(2)).case_insensitive(True).build(["pattern"]))
    jax_e = build(JaxBuilder, JaxLimits)
    port_e = build(FuzzyAhoCorasickBuilder, FuzzyLimits).to("cpu")
    assert jvd.typed_spec_of(jax_e) is None and tvd.typed_spec_of(port_e) is None
    assert not port_e._device_engine().supports("x" * 100)
    got = _tuples(port_e.search_raw("the pattren and pttern here", 0.6))
    assert len(got) >= 2 and sorted(got) == sorted(_tuples(
        jax_e.search_raw("the pattren and pttern here", 0.6)))
    # More hits than one call of the pipeline takes: the lane runs them in
    # ranges (one hit each here) and serves the same matches on the device.
    _jax_t, typed_e = _pair("typed-ins-del")
    hay = CONFIGS["typed-ins-del"][2][:600]
    served = _tuples(typed_e.search_raw(hay, 0.55))
    assert typed_e.last_stats["backend"] == "device-fuzzy-dp-typed"
    monkeypatch.setattr(tvd, "pipeline_max_hits", lambda *a, **k: 1)
    ranged = _tuples(typed_e.search_raw(hay, 0.55))
    assert typed_e.last_stats["backend"] == "device-fuzzy-dp-typed"
    assert ranged == served and len(served) > 0


def test_to_drops_the_lane_tables():
    for name, key in (("typed-per-pattern", "typed"), ("mapped-rn-m", "maps")):
        _jax_e, port_e = _pair(name)
        port_e.search_raw(CONFIGS[name][2], CONFIGS[name][3][0])
        assert any(k[0] == key for k in port_e._dp_dev_consts)
        port_e.to("cpu")
        assert port_e._dp_dev_consts is None
        assert len(port_e.search_raw(CONFIGS[name][2], CONFIGS[name][3][0])) > 0


def test_similarity_tying_the_threshold_on_a_typed_engine():
    jax_e, port_e = _pair("typed-per-pattern")
    hay = "lorem nedle ipsum NEEDLE dolor needlx amet enedle strict strlct " * 30
    sims = {np.uint32(t[3]).view(np.float32) for t in _tuples(port_e.search_raw(hay, 0.55))}
    ties = sorted(x for x in sims if x < 1.0)
    assert len(ties) >= 2
    kept = 0
    for thr in (ties[0], ties[-1]):
        got = _tuples(port_e.search_raw(hay, float(thr)))
        assert port_e.last_stats["backend"] == "device-fuzzy-dp-typed"
        assert got == _tuples(jax_e.search_raw(hay, float(thr)))
        jax_e.backend = "oracle"
        assert sorted(got) == sorted(_tuples(jax_e.search_raw(hay, float(thr))))
        jax_e.backend = "device"
        kept += np.float32(thr).view(np.uint32).item() in {t[3] for t in got}
    assert kept >= 1


def test_typed_lane_declines_past_its_count_bytes(monkeypatch):
    """The typed step keeps one decision per (candidate, emission channel)
    and counts its rows per tile of candidates, so nothing of it grows with
    a per-warp unit: its hit bound is the count-channel lanes' int32 bound,
    ``pipeline_max_hits`` with the same arguments. Past the bound the lane
    does not decline: it runs the hit list in ranges and serves the same
    matches on the device."""
    for n_c, MO, E in ((48, 1, 1), (48, 16, 1), (600, 40, 3), (1, 1, 1)):
        most = tvd.pipeline_max_hits(n_c, MO, E)
        nce = (2 * E + 1) * MO
        # candidates and rows, the decisions and the row counts stay in int32
        assert most * n_c * (nce + 1) < 1 << 31
        assert most * n_c * nce + -(-most * n_c // tvd.TYPED_TILE) * nce < 1 << 31
        assert (most + 1) * n_c * (nce + 1) >= 1 << 31
    assert not hasattr(tvd, "TYPED_COUNT_BYTES") and not hasattr(tvd, "TYPED_UNIT")
    _jax_t, typed_e = _pair("typed-ins-del")
    hay = CONFIGS["typed-ins-del"][2][:600]
    view = view_of(hay, True)
    spec = tvd.typed_spec_of(typed_e)
    served = _tuples(typed_e.search_raw(hay, 0.55))
    stats = dict(typed_e.last_stats)
    assert stats["backend"] == "device-fuzzy-dp-typed" and stats["hits"] > 1
    plan = tvd.dp_plan(typed_e, 0.55, len(view), typed=spec)
    # The lane asks for the count-channel lanes' bound, as the forbid lane does.
    asked, real = [], tvd.pipeline_max_hits
    monkeypatch.setattr(tvd, "pipeline_max_hits", lambda *a, **k: asked.append((a, k)) or real(*a))
    assert _tuples(typed_e.search_raw(hay, 0.55)) == served
    assert asked == [((plan.n_combo, typed_e.dense.max_out, plan.E), {})]
    _jax_f, forbid_e = _pair("forbid-swaps")
    assert len(forbid_e.search_raw(CONFIGS["forbid-swaps"][2], CONFIGS["forbid-swaps"][3][0])) > 0
    assert forbid_e.last_stats["backend"] == "device-fuzzy-dp-forbid"
    assert len(asked) == 2 and len(asked[1][0]) == 3 and asked[1][1] == {}
    # Room for one hit fewer than the scan finds in the one slice: ranges.
    monkeypatch.setattr(tvd, "pipeline_max_hits", lambda *a, **k: stats["hits"] - 1)
    ranged = _tuples(tvd.fuzzy_search_dp(typed_e, hay, 0.55, view, len(view), typed=spec))
    # Called below ``DeviceEngine.search_raw``, the lane counts no waits.
    lane_stats = {k: v for k, v in stats.items() if k != "host_waits"}
    assert ranged == served and typed_e.last_stats == lane_stats and len(served) > 0


@pytest.mark.parametrize("name", ["forbid-swaps", "mapped-eszett", "typed-ins-del",
                                  "typed-per-pattern"])
def test_lane_runs_long_hit_lists_in_ranges(monkeypatch, name):
    """Each DP lane runs a slice's hit list in ranges of at most
    ``pipeline_max_hits`` hits, each handed its preceding hit: ranges of 1,
    2 and 7 hits give the matches, hits and candidates of one range (and
    read the device more often: each range its own totals)."""
    _c, _p, hay, thrs, lane = CONFIGS[name]
    _jax_e, port_e = _pair(name)
    hay = hay[:400]
    whole = _tuples(port_e.search_raw(hay, thrs[0]))
    stats = dict(port_e.last_stats)
    assert stats["backend"] == BACKEND[lane] and stats["hits"] > 7 and len(whole) >= 4
    waits = stats.pop("host_waits")
    for range_hits in (1, 2, 7):
        monkeypatch.setattr(tvd, "pipeline_max_hits", lambda *a, r=range_hits, **k: r)
        assert _tuples(port_e.search_raw(hay, thrs[0])) == whole
        got = dict(port_e.last_stats)
        assert got.pop("host_waits") >= waits and got == stats


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lane_specs_of_routes_as_the_dispatchers(name):
    """``lane_specs_of`` sets the one spec of the lane that ``search_raw``
    reports for the engine, and none for a plain total-edits engine."""
    _jax_e, port_e = _pair(name)
    lane = CONFIGS[name][4]
    specs = tvd.lane_specs_of(port_e)
    assert [s is not None for s in specs] == [lane == "typed", lane == "mapped", lane == "forbid"]
    for got, want in zip(specs, _specs(tvd, port_e, lane)):
        assert got is want or got == want
    plain = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(2)).device("cpu")
             .build(["needle"]))
    assert tvd.lane_specs_of(plain) == (None, None, None)
