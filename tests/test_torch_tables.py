"""The port's host tables are byte-equal to the JAX package's: the dense
automaton, the packed exact tables and the fuzzy mask helpers."""

import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder as JaxBuilder
from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits
from fuzzy_aho_corasick_tpu.ops import packed_bitap as jpb
from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder
from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb

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
SUFFIXES = ["he", "she", "his", "hers"]
CYRILLIC = ["привет", "мир", "Москва", "ирина", "тест"]


def _wide_dictionary():
    rng = np.random.default_rng(7)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(rng.choice(letters, size=int(rng.integers(20, 40)))) for _ in range(12)]


def _engines(words, case_insensitive=True):
    jax_e = JaxBuilder.new().case_insensitive(case_insensitive).build(words)
    port_e = (FuzzyAhoCorasickBuilder.new().case_insensitive(case_insensitive)
              .device("cpu").build(words))
    return jax_e, port_e


DENSE_ATTRS = [
    "num_classes", "char_class", "ascii_class", "goto", "edge_target",
    "edge_class", "sb_edge", "out_start", "out_count", "out_patterns",
    "out_list", "pat_len", "pat_weight", "sim", "max_depth", "max_pattern_len",
]


@pytest.mark.parametrize(
    "words,ci",
    [(HEADLINE, True), (SUFFIXES, False), (_wide_dictionary(), True), (CYRILLIC, True)],
    ids=["headline", "suffix-outputs", "wide", "cyrillic"],
)
def test_tables_byte_equal(words, ci):
    jax_e, port_e = _engines(words, ci)
    for attr in DENSE_ATTRS:
        a, b = getattr(jax_e.dense, attr), getattr(port_e.dense, attr)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), attr
        else:
            assert a == b, attr
    jp, tp = jpb.packed_exact_of(jax_e), tpb.packed_exact_of(port_e)
    assert jp is not None and tp is not None
    assert (tp.W, tp.A, tp.m_max) == (jp.W, jp.A, jp.m_max)
    for attr in ("word_tbl", "starts", "ascii_tbl", "remap"):
        a, b = getattr(jp, attr), getattr(tp, attr)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), attr
    assert tp.match_mask().tobytes() == jp.match_mask().tobytes()
    assert tp.fields == jp.fields
    assert tpb._field_bits(tp) == jpb._field_bits(jp)
    if words is HEADLINE:
        assert (tp.W, tp.A, tp.m_max) == (3, 21, 12)
    if len(words) == 12:  # the wide dictionary spans several limbs
        assert tp.W > 2


@pytest.mark.parametrize(
    "words",
    [
        # more than 127 distinct edge classes: A > 128
        [chr(0x4E00 + i) + chr(0x5E00 + i) for i in range(70)],
        # a field longer than 64 graphemes
        ["a" * 65, "bc"],
    ],
    ids=["alphabet-over-128", "field-over-64"],
)
def test_unpackable_engines_have_no_tables(words):
    jax_e, port_e = _engines(words)
    assert jpb.packed_exact_of(jax_e) is None
    assert tpb.packed_exact_of(port_e) is None


@pytest.mark.parametrize("ks_of", [lambda i: 1, lambda i: 1 + i % 3], ids=["k1", "mixed"])
def test_fuzzy_mask_helpers_match_packed_fuzzy(ks_of):
    engine = JaxBuilder.new().fuzzy(JaxLimits.new().edits(2)).case_insensitive(True).build(HEADLINE)
    pf = jpb.packed_fuzzy_of(engine)
    ks = [ks_of(i) for i in range(len(pf.ms))]
    match, init, k = tpb.fuzzy_masks(pf.offsets, pf.ms, pf.W, ks)
    jm, ji, jk = pf.fuzzy_masks(ks)
    assert k == jk and match.tobytes() == jm.tobytes() and init.tobytes() == ji.tobytes()
    assert tpb.notlast_mask(pf.offsets, pf.ms, pf.W).tobytes() == pf.notlast().tobytes()


def test_tables_from_numpy_keeps_every_bit():
    jax_e, _ = _engines(HEADLINE)
    pk = jpb.packed_exact_of(jax_e)
    T = tpb.tables_from_numpy(pk.word_tbl, pk.starts, pk.match_mask(),
                              np.zeros((1, 2 * pk.W), np.uint32))
    assert (T.A, T.W, T.k, T.damerau) == (pk.A, pk.W, 0, False)
    lo, hi = tpb._halves(T.tbl)
    back = np.stack([lo.numpy(), hi.numpy()], axis=2).reshape(pk.A, 2 * pk.W)
    assert np.array_equal(back.astype(np.uint32), pk.word_tbl.view(np.uint32))
