"""The fuzzy DP lane's modules, port against the JAX package on the CPU.

- the prefilter model and the packed fuzzy scan tables are byte-equal;
- ``expand_candidates`` equals the JAX ``_expand_candidates``, order included;
- ``banded_dp_torch`` equals the JAX ``_banded_dp`` bit for bit (f32 bit
  patterns of every emission channel and the packed edit counts), on the
  same candidates and tables.

Both sides get the same numpy inputs. The tolerance is exact: the port
replays the JAX package's f32 operations in the same order."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder as JaxBuilder
from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits
from fuzzy_aho_corasick_tpu import FuzzyPenalties as JaxPenalties
from fuzzy_aho_corasick_tpu import Similarity as JaxSimilarity
from fuzzy_aho_corasick_tpu.ops import packed_bitap as jpb
from fuzzy_aho_corasick_tpu.ops import verify_dp as jvd
from fuzzy_aho_corasick_tpu.utils.graphemes import view_of
from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits
from fuzzy_aho_corasick_tpu_torch import FuzzyPenalties, Similarity
from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
from fuzzy_aho_corasick_tpu_torch.ops import verify_dp as tvd

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)

HEADLINE = [
    "tincidunt", "phaetra", "sollicitudin", "venenatis", "fringilla",
    "ullamcorper", "pellentesque", "sagittis", "condimentum", "habitasse",
    "malesuada", "scelerisque", "imperdiet", "vulputate", "ridiculus",
    "parturient",
]
CYRILLIC = ["привет", "мир", "Москва", "ирина", "тест"]
FILLER = ["lorem", "ipsum", "dolor", "sit", "amet", "elit", "eros", "porta"]


def _edit(word: str, rng) -> str:
    i, op = int(rng.integers(1, len(word) - 1)), int(rng.integers(4))
    return [word[:i] + "x" + word[i + 1:], word[:i] + word[i + 1:],
            word[:i] + "q" + word[i:], word[:i] + word[i + 1] + word[i] + word[i + 2:]][op]


def _corpus(seed: int, words: int, needles, max_edits: int = 2) -> str:
    """Filler with needles at 1 in 5, each with up to ``max_edits`` edits;
    the first word is a needle so a match starts at position 0."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(words):
        if i == 0 or rng.integers(5) == 0:
            w = needles[int(rng.integers(len(needles)))]
            for _ in range(int(rng.integers(0, max_edits + 1))):
                w = _edit(w, rng) if len(w) > 3 else w
        else:
            w = FILLER[int(rng.integers(len(FILLER)))]
        out.append(w)
    return " ".join(out)


def _pair(configure, words):
    """The same configuration built by both packages."""
    jax_e = configure(JaxBuilder.new(), JaxLimits, JaxPenalties, JaxSimilarity).build(words)
    port_e = configure(FuzzyAhoCorasickBuilder.new(), FuzzyLimits, FuzzyPenalties,
                       Similarity).device("cpu").build(words)
    return jax_e, port_e


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), what


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "words,edits", [(HEADLINE, 1), (CYRILLIC, 2)], ids=["headline", "cyrillic"]
)
def test_fuzzy_tables_byte_equal(words, edits):
    jax_e, port_e = _pair(
        lambda b, L, P, S: b.fuzzy(L.new().edits(edits)).case_insensitive(True), words)
    jp, tp = jpb.packed_fuzzy_of(jax_e), tpb.packed_fuzzy_of(port_e)
    assert jp is not None and tp is not None
    jf, tf = jp.filt, tp.filt
    assert tf.symbol_ids == jf.symbol_ids
    _same(jf.ascii_id, tf.ascii_id, "ascii_id")
    assert (tf.edit_cost_mult, tf.edit_cost_mult_d) == (jf.edit_cost_mult, jf.edit_cost_mult_d)
    for jb, tb in zip(jf.patterns, tf.patterns):
        assert (tb.m, tb.weight, tb.k_limit, tb.k_limit_d) == (jb.m, jb.weight, jb.k_limit, jb.k_limit_d)
        _same(jb.mask, tb.mask, "pattern mask")
    assert (tp.W, tp.A, tp.m_max, tp.ms, tp.offsets) == (jp.W, jp.A, jp.m_max, jp.ms, jp.offsets)
    _same(jp.word_tbl, tp.word_tbl, "word_tbl")
    _same(jp.starts, tp.starts, "starts")
    _same(jp.notlast(), tp.notlast(), "notlast")
    for thr in (0.5, 0.7, 0.8, 0.9, 0.95):
        thr = np.float32(thr)
        for dam in (False, True):
            ks = [tf.k_for(bp, thr, damerau=dam) for bp in tf.patterns]
            assert ks == [jf.k_for(bp, thr, damerau=dam) for bp in jf.patterns]
            if None in ks:
                continue
            for a, b in zip(jp.fuzzy_masks(ks), tp.fuzzy_masks(ks)):
                assert a == b if isinstance(a, int) else a.tobytes() == b.tobytes()
    for hay in ("Tincidunt PHAETRA sollicitudin, ПРИВЕТ мир", "x" * 40):
        (a, a_offs), (b, b_offs) = jf.transcode(hay), tf.transcode(hay)
        _same(np.asarray(a), np.asarray(b), "transcode")
        assert (a_offs is None) == (b_offs is None)
    jv, tv = jvd.verify_fields_of(jax_e), tvd.verify_fields_of(port_e)
    assert (tv.num_fields, tv.max_depth, tv.nf_max) == (jv.num_fields, jv.max_depth, jv.nf_max)
    for attr in ("depth", "node", "path_cls", "path_node", "pat2field"):
        _same(getattr(jv, attr), getattr(tv, attr), attr)
    if words is HEADLINE:
        assert (tp.W, tp.A, tp.m_max) == (3, 21, 12)
        thr = np.float32(0.8)
        assert max(tf.k_for(bp, thr) for bp in tf.patterns) == 2
        assert max(tf.k_for(bp, thr, damerau=True) for bp in tf.patterns) == 1


@pytest.mark.parametrize(
    "words",
    [
        [chr(0x4E00 + i) + chr(0x5E00 + i) for i in range(70)],  # A > 128
        ["a" * 64, "bc"],  # a pattern longer than 63 graphemes
    ],
    ids=["alphabet-over-128", "pattern-over-63"],
)
def test_unpackable_fuzzy_engines_have_no_tables(words):
    jax_e, port_e = _pair(lambda b, L, P, S: b.fuzzy(L.new().edits(1)), words)
    assert jpb.packed_fuzzy_of(jax_e) is None
    assert tpb.packed_fuzzy_of(port_e) is None
    view = view_of("abc " * 10, False)
    assert tvd.dp_plan(port_e, 0.8, len(view)) is None
    assert jvd.fuzzy_search_dp(jax_e, "abc " * 10, 0.8, view, len(view)) is None


# ---------------------------------------------------------------------------
# Candidate expansion
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("E", "CAND", "BITS", "P2F", "DEPTHS"))
def _jax_expand(pos, words, start_lo, start_hi, pos_hi, E, CAND, BITS, P2F, DEPTHS):
    return jvd._expand_candidates(pos, words, start_lo, start_hi, pos_hi, E, CAND, BITS, P2F, DEPTHS)


def _hits(port_e, hay, thr):
    """The port's plan, hits (pos, words) and dense ids for ``hay``."""
    view = view_of(hay, True)
    n = len(view)
    plan = tvd.dp_plan(port_e, thr, n)
    run = tvd.dp_inputs(port_e, hay, plan, view, n)
    part = run.parts[0]
    count, pos, words = tpb.packed_hits(part.ids_pf, run.T_scan, run.halo)
    return plan, run, part, pos, words


@pytest.mark.parametrize("edits", [1, 2])
def test_expand_candidates_equal_to_jax(edits):
    jax_e, port_e = _pair(
        lambda b, L, P, S: b.fuzzy(L.new().edits(edits)).case_insensitive(True), HEADLINE)
    hay = _corpus(21 + edits, 900, HEADLINE)
    plan, run, part, pos, words = _hits(port_e, hay, 0.8)
    K = pos.numel()
    assert K > 100
    runs = int((pos[1:] == pos[:-1] + 1).sum())
    assert runs > 10  # consecutive hit ends: the dedup is exercised
    # Windows cut inside hit runs, and the whole slice.
    p = pos.tolist()
    windows = [(0, part.local_n, part.local_n),
               (p[K // 3] - 4, p[2 * K // 3] - 6, p[-3])]
    for lo, hi, pos_hi in windows:
        cf, cs = tvd.expand_candidates(pos, words, lo, hi, pos_hi, plan.E, *run.statics)
        CAND = 1 << 16
        count, jf, js = _jax_expand(
            jnp.asarray(pos.numpy().astype(np.int32)), jnp.asarray(words.numpy().astype(np.uint32)),
            np.int32(lo), np.int32(hi), np.int32(pos_hi),
            E=plan.E, CAND=CAND, BITS=run.statics[0], P2F=run.statics[1], DEPTHS=run.statics[2],
        )
        count = int(count)
        assert 0 < count < CAND
        assert cf.numel() == count
        assert np.array_equal(cf.numpy(), np.asarray(jf)[:count])
        assert np.array_equal(cs.numpy(), np.asarray(js)[:count])
        assert int(cs.min()) >= lo and int(cs.max()) < hi


# ---------------------------------------------------------------------------
# Banded DP
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("E", "Lmax", "C", "deadend"))
def _jax_dp(cand_field, cand_start, path_cls, path_node, depth, ids_pad, limit, sim, node_ceil,
            max_pen, p_sub, p_ins, p_del, p_swap, floor, sb_edge, out_count, E, Lmax, C, deadend):
    return jvd._banded_dp(
        cand_field, cand_start, path_cls, path_node, depth, ids_pad, limit, sim, node_ceil,
        max_pen, p_sub, p_ins, p_del, p_swap, floor, E, Lmax, C,
        deadend=deadend, sb_edge_flat=sb_edge, out_count_arr=out_count,
    )


DP_CASES = {
    "e1-default": (lambda b, L, P, S: b.fuzzy(L.new().edits(1)).case_insensitive(True),
                   HEADLINE, 0.8, None),
    "e2-penalties": (lambda b, L, P, S: b.fuzzy(L.new().edits(2)).case_insensitive(True).penalties(
        P.default().with_substitution(0.7).with_insertion(0.1)
        .with_deletion(0.3).with_swap(0.3)), HEADLINE[:6], 0.7, None),
    "e1-similarity-floor": (lambda b, L, P, S: b.fuzzy(L.new().edits(1)).similarity(
        S.from_map({("o", "0"): 0.9, ("i", "1"): 0.85, ("e", "3"): 0.3, ("a", "4"): 0.6}))
        .min_symbol_similarity(0.5), ["condimentum", "imperdiet", "vulputate", "ridiculus"],
        0.6, "0134"),
    "e2-deadend": (lambda b, L, P, S: b.fuzzy(L.new().edits(2)).case_insensitive(True),
                   CYRILLIC + ["café"], 0.6, None),
}


def _dp_corpus(name, words, digits):
    if name == "e2-deadend":
        rng = np.random.default_rng(5)
        fill = ["и", "мира", "тесты", "привет", "кафе", "cafe", "мосвка", "ирнна", "прuвет"]
        return " ".join(fill[int(rng.integers(len(fill)))] for _ in range(400)).upper()
    hay = _corpus(31, 500, words)
    if digits:  # leetspeak substitutions for the custom similarity
        rng = np.random.default_rng(6)
        hay = "".join(digits[int(rng.integers(4))] if c in "oiea" and rng.integers(6) == 0
                      else c for c in hay)
    return hay


@pytest.mark.parametrize("name", list(DP_CASES))
def test_banded_dp_torch_bit_equal_to_jax(name):
    configure, words, thr, digits = DP_CASES[name]
    jax_e, port_e = _pair(configure, words)
    hay = _dp_corpus(name, words, digits)
    plan, run, part, pos, words_ = _hits(port_e, hay, thr)
    n = part.local_n
    cf, cs = tvd.expand_candidates(pos, words_, 0, n, n, plan.E, *run.statics)
    # Candidates at position 0, at and near the limit, and dead slots.
    F = plan.vf.num_fields
    rng = np.random.default_rng(7)
    extra_f = np.concatenate([np.arange(F), np.arange(F), rng.integers(F, size=64), [-1, -1]])
    extra_s = np.concatenate([np.zeros(F), np.full(F, n), rng.integers(n - 20, n + 1, size=64),
                              [0, n]])
    cand_field = torch.cat([cf, torch.from_numpy(extra_f.astype(np.int32))])
    cand_start = torch.cat([cs, torch.from_numpy(extra_s.astype(np.int32))])
    assert cf.numel() > 50

    dense = port_e.dense
    npad = -(-(n + 128) // 32) * 32
    ids = np.zeros(npad, np.uint8)
    ids[:n] = part.ids_de.numpy()[:n]
    deadend = bool(dense.has_multibyte_edges)
    assert deadend == (name == "e2-deadend")
    vf, pens = plan.vf, port_e.penalties
    p = tvd.DpPenalties(plan.max_pen, pens.substitution, pens.insertion, pens.deletion,
                        pens.swap, port_e.min_symbol_similarity)
    got_pen, got_cnt = tvd.banded_dp_torch(cand_field, cand_start, torch.from_numpy(ids), n,
                                           run.T, p, plan.E, deadend)
    # A large unrolled body (rows x bands x channels) takes the JAX
    # function's row-loop form instead (path tables padded past its unroll
    # bound of 24 rows, dead past each field's depth), which compiles in a
    # fraction of the time; the others the unrolled form the pipeline uses.
    cells = vf.max_depth * (2 * plan.E + 1) * (plan.E + 1)
    Lj = 25 if cells > 100 else vf.max_depth
    pad = lambda a: np.pad(a, ((0, 0), (0, Lj - a.shape[1]))).reshape(-1)
    want_pen, want_cnt = _jax_dp(
        jnp.asarray(cand_field.numpy()), jnp.asarray(cand_start.numpy()),
        pad(vf.path_cls), pad(vf.path_node), vf.depth, jnp.asarray(ids),
        np.int32(n), dense.sim.reshape(-1), plan.ceil.astype(np.float32),
        *(np.float32(x) for x in p), dense.sb_edge.reshape(-1), dense.out_count,
        E=plan.E, Lmax=Lj, C=dense.num_classes, deadend=deadend,
    )
    want_pen, want_cnt = np.asarray(want_pen), np.asarray(want_cnt)
    assert got_pen.shape == want_pen.shape == ((2 * plan.E + 1) * (plan.E + 1), cand_field.numel())
    assert np.array_equal(got_pen.numpy().view(np.uint32), want_pen.view(np.uint32))
    assert np.array_equal(got_cnt.numpy(), want_cnt)
    live = np.isfinite(want_pen)
    assert live.sum() > 20  # real emissions, not only dead cells
    if plan.E == 2:
        assert live[np.arange(live.shape[0]) % 3 == 2].any()  # two-edit channels reached
    # The wrapper takes the plain version for CPU tensors and counts nothing.
    before = dict(tpb.LAUNCHES)
    pen2, cnt2 = tvd.banded_dp(cand_field, cand_start, torch.from_numpy(ids), n, run.T, p,
                               plan.E, deadend)
    assert tpb.LAUNCHES == before
    assert torch.equal(pen2.view(torch.int32), got_pen.view(torch.int32))
    assert torch.equal(cnt2, got_cnt)


def test_banded_dp_wrapper_refuses_bad_inputs():
    _jax_e, port_e = _pair(lambda b, L, P, S: b.fuzzy(L.new().edits(1)), HEADLINE[:3])
    hay = "tincidunt phaetra " * 4
    plan, run, part, pos, words = _hits(port_e, hay, 0.8)
    cf, cs = tvd.expand_candidates(pos, words, 0, part.local_n, part.local_n, 1, *run.statics)
    ids = part.ids_de
    with pytest.raises(ValueError, match="int32"):
        tvd.banded_dp(cf.long(), cs, ids, part.local_n, run.T, run.pens, 1)
    with pytest.raises(ValueError, match="uint8 or int32"):
        tvd.banded_dp(cf, cs, ids.float(), part.local_n, run.T, run.pens, 1)
    with pytest.raises(ValueError, match="edit budget"):
        tvd.banded_dp(cf, cs, ids, part.local_n, run.T, run.pens, 7)
    with pytest.raises(ValueError, match="ceilings"):
        tvd.banded_dp(cf, cs, ids, part.local_n, run.T.with_ceil(None), run.pens, 1)
    with pytest.raises(ValueError, match="tables on"):
        tvd.banded_dp(cf.to("meta"), cs.to("meta"), ids.to("meta"), part.local_n, run.T,
                      run.pens, 1)
