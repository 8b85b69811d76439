"""The plain reference against hand-checked matches, against the port's
oracle as a second witness on small random texts, and its bfloat16
control against the float32 reference."""

import numpy as np
import pytest
import torch

from portbench import recipes, reference

f32 = np.float32
P_SUB, P_DEL, P_SWAP = reference.P_SUB, reference.P_DEL, reference.P_SWAP


def sim(L, pen):
    return f32(f32(f32(f32(L) - f32(pen)) / f32(L)) * f32(1.0))


def test_hand_checked_edits1():
    got = reference.match_set(reference.Problem(["hello"], 1, 0.8), "helo hlelo jello")
    want = {
        (0, 0, 4): (sim(5, P_DEL), {(0, 1, 0, 0)}),     # "helo": an l deleted
        (0, 5, 10): (sim(5, P_SWAP), {(0, 0, 0, 1)}),   # "hlelo": e, l swapped
        # "jello": h -> j, two consonants, similarity 0.4
        (0, 11, 16): (sim(5, f32(P_SUB * f32(f32(1) - f32(0.4)))), {(0, 0, 1, 0)}),
        (0, 12, 16): (sim(5, P_DEL), {(0, 1, 0, 0)}),   # "ello": the h deleted
    }
    assert {k: (v[0], set(v[1])) for k, v in got.items()} == want
    assert got[(0, 0, 4)][0].tobytes().hex() == "7368513f"  # 0.818


def test_hand_checked_mapping_edits2():
    # rn <-> m at score 1: no penalty, one edit, counted a substitution
    got = reference.match_set(reference.Problem(["modern"], 2, 0.8, [("rn", "m", 1.0)]),
                              "the rnodern modem")
    sub_mn = f32(P_SUB * f32(f32(1) - f32(0.4)))
    want = {
        (0, 4, 10): (sim(6, P_DEL), {(0, 1, 1, 0)}),    # "rnoder": m as rn, the last n deleted
        (0, 4, 11): (f32(1.0), {(0, 0, 1, 0)}),         # "rnodern": m as rn
        (0, 5, 11): (sim(6, sub_mn), {(0, 0, 1, 0)}),   # "nodern": m -> n
        (0, 6, 11): (sim(6, P_DEL), {(0, 1, 0, 0)}),    # "odern": the m deleted
        (0, 12, 17): (f32(1.0), {(0, 0, 1, 0)}),        # "modem": rn as m
        (0, 13, 17): (sim(6, P_DEL), {(0, 1, 1, 0)}),   # "odem": m deleted, rn as m
    }
    assert {k: (v[0], set(v[1])) for k, v in got.items()} == want


def test_suffix_outputs_and_ties():
    # "cdef" is an output of the node "abcdef" (a suffix): its matches over
    # spans that the longer word's path covers are the crate's too.
    got = reference.match_set(reference.Problem(["abcdef", "cdef"], 1, 0.6), "xx abcdef yy")
    assert (1, 3, 9) in got and got[(1, 3, 9)][0] == f32(1.0)
    assert (1, 5, 9) in got


FILLER = ["lorem", "ipsum", "dolor", "sit", "amet", "consectetur", "commodo", "porta"]


@pytest.mark.parametrize("seed, E, maps", [(1, 1, ()), (2, 2, ()), (3, 4, (("rn", "m"),))])
def test_equal_to_the_port_oracle(seed, E, maps):
    """A second witness that shares no code with the reference."""
    from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits, oracle

    if E == 4:
        words = ["venenatis condimentum", "ullamcorper malesuada", "modern mormon"]
        base = recipes.build_corpus(2500, seed, FILLER, ["tincidunt"])
        text = recipes.plant_phrases(base, seed, 20, words)[0]
        thr = 0.8
    else:
        words = recipes.many_words(40, seed, (5, 10))
        base = recipes.build_corpus(2500, seed, FILLER, ["tincidunt"])
        text = recipes.many_corpus(base, words, 30, 7)
        thr = 0.75
    b = FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(E)).case_insensitive(True)
    for a, c in maps:
        b = b.mapping(a, c)
    eng = b.device("cpu").build(words)
    want = {(m.pattern_index, m.start, m.end): (f32(m.similarity),
            (m.insertions, m.deletions, m.substitutions, m.swaps))
            for m in oracle.search_raw(eng, text, thr)}
    got = reference.match_set(reference.Problem(words, E, thr, [(a, c, 1.0) for a, c in maps]),
                              text)
    assert set(got) == set(want) and want
    for k, (s, bd) in want.items():
        assert got[k][0].tobytes() == s.tobytes() and bd in got[k][1]


def test_bfloat16_control_differs():
    prob = reference.Problem(["hello", "world"], 1, 0.8)
    text = "helo hlelo jello wrld world"
    ref = reference.match_set(prob, text)
    ctl = reference.match_set(prob, text, dtype=torch.bfloat16)
    diff = sum(k not in ctl or ctl[k][0].tobytes() != v[0].tobytes() for k, v in ref.items())
    assert diff >= 4
