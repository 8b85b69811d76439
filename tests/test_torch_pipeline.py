"""The two redesigned steps of the fuzzy DP lane, port against the JAX
package on the CPU, at their edges.

(a) ``packed_hits`` (scan bits -> block offsets -> hit positions and words;
    on the CPU each kernel's plain version) equals the JAX ``packed_hits``
    (Pallas in interpret mode): the same ascending positions and the same
    match words, for k = 0, k = 1 with Damerau rows and k = 2; with no hit,
    with a hit at every position, with hits at position 0, inside the first
    ``halo`` symbols and on the last symbol; for streams of 1, 15, 16, 17
    symbols and of a length that is no multiple of 256.
(b) ``dp_pipeline_torch`` (expansion -> banded DP -> emission) returns the
    rows the JAX ``_dp_pipeline_jit`` returns, in the same order and with the
    same f32 penalty bits, and the same hit and candidate counts.
(c) ``fuzzy_search_dp`` cut into small slices equals the unsliced search.

Both sides get the same numpy inputs, made from a seed. The tolerance is
exact equality everywhere: the scan is integer and bitwise, and the DP
replays the JAX package's f32 operations in the same order."""

import functools

import jax
import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder as JaxBuilder
from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits
from fuzzy_aho_corasick_tpu import FuzzyPenalties as JaxPenalties
from fuzzy_aho_corasick_tpu import Pattern as JaxPattern
from fuzzy_aho_corasick_tpu.ops import packed_bitap as jpb
from fuzzy_aho_corasick_tpu.ops import verify_dp as jvd
from fuzzy_aho_corasick_tpu.utils import device_corpus as jax_corpus
from fuzzy_aho_corasick_tpu.utils.graphemes import view_of
from fuzzy_aho_corasick_tpu_torch import (
    FuzzyAhoCorasickBuilder, FuzzyLimits, FuzzyPenalties, Pattern)
from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
from fuzzy_aho_corasick_tpu_torch.ops import verify_dp as tvd
from fuzzy_aho_corasick_tpu_torch.utils import device_corpus

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)

WORDS = ["tincidunt", "phaetra", "sagittis", "venenatis"]
HEADLINE = WORDS + [
    "sollicitudin", "fringilla", "ullamcorper", "pellentesque", "condimentum",
    "habitasse", "malesuada", "scelerisque", "imperdiet", "vulputate", "ridiculus",
    "parturient",
]
FILLER = ["lorem", "ipsum", "dolor", "sit", "amet", "elit", "eros", "porta"]
CYRILLIC = ["привет", "мир", "москва", "ирина", "тест"]


def _edit(word: str, rng) -> str:
    i, op = int(rng.integers(1, len(word) - 1)), int(rng.integers(4))
    return [word[:i] + "x" + word[i + 1:], word[:i] + word[i + 1:],
            word[:i] + "q" + word[i:], word[:i] + word[i + 1] + word[i] + word[i + 2:]][op]


def _corpus(seed: int, size: int, needles, filler=FILLER, rate: int = 5, max_edits: int = 2) -> str:
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


# ---------------------------------------------------------------------------
# (a) the hit-list scan
# ---------------------------------------------------------------------------

def _tables(words, k: int, damerau: bool):
    """(word_tbl, starts, match, init, notlast, byte -> symbol table, halo)
    for ``words`` with a uniform budget ``k``, from the numpy mask helpers."""
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
    lut = np.zeros(256, np.uint8)
    for c, s in sym.items():
        lut[ord(c)] = s
    return (tpb._word_table(limb, A, W), tpb._starts_mask(offs, W), match, init, notlast,
            lut, max(ms) + kk)


@functools.partial(
    jax.jit,
    static_argnames=("A", "W", "NL", "TB", "grid", "chunk", "halo", "k", "KH", "consts"),
)
def _jax_packed_hits(ids_pad, tbl, sb, mb, ib, A, W, NL, TB, grid, chunk, halo, k, KH, consts):
    return jpb.packed_hits(
        ids_pad, tbl, sb, mb, ib, A, W, NL, TB, grid, chunk, halo, k, KH, consts=consts
    )


def _jax_hits(ids, word_tbl, starts, match, init, notlast, halo, layout_n=None):
    """(pos, words) of the JAX ``packed_hits`` over ``ids``, positions < n.
    ``layout_n`` sizes the lanes (streams that share it share one compile)."""
    n = len(ids)
    k, W, A = match.shape[0] - 1, word_tbl.shape[1] // 2, word_tbl.shape[0]
    NL, TB, chunk, grid = jpb._derive_layout(layout_n or n, halo, W)
    ids_pad = np.zeros(NL * chunk, np.uint8)
    ids_pad[:n] = ids
    KH = max(1 << 13, 1 << int(np.ceil(np.log2(n + 1))))
    count, pos, words = _jax_packed_hits(
        jax.device_put(ids_pad), jax.device_put(word_tbl), jpb._bcast(starts, NL),
        jpb._bcast(match, NL), jpb._bcast(init, NL),
        A=A, W=W, NL=NL, TB=TB, grid=grid, chunk=chunk, halo=halo, k=k, KH=KH,
        consts=jpb.scan_consts(word_tbl, starts, match, init, notlast),
    )
    count = int(count)
    assert count <= KH
    pos = np.asarray(pos)[:count].astype(np.int64)
    words = np.asarray(words)[:count]
    keep = pos < n  # hits the JAX lanes report on their zero padding
    return pos[keep], words[keep]


def _check_hits(text: str, words, k, damerau, layout_n=None):
    word_tbl, starts, match, init, notlast, lut, halo = _tables(words, k, damerau)
    ids = lut[np.frombuffer(text.encode(), np.uint8)]
    want_pos, want_words = _jax_hits(ids, word_tbl, starts, match, init, notlast, halo, layout_n)
    T = tpb.tables_from_numpy(word_tbl, starts, match, init, notlast)
    before = dict(tpb.LAUNCHES)
    count, pos, got_words = tpb.packed_hits(torch.from_numpy(ids), T, halo)
    assert tpb.LAUNCHES == before  # CPU tensors run the plain versions
    assert count == len(want_pos) == pos.numel()
    assert pos.tolist() == want_pos.tolist()
    assert got_words.numpy().astype(np.uint32).tolist() == want_words.tolist()
    return pos.numpy(), halo


@pytest.mark.parametrize("k,damerau", [(0, False), (1, True), (2, False)],
                         ids=["k0", "k1-damerau", "k2"])
def test_packed_hits_equal_to_jax(k, damerau):
    text = _corpus(50 + k, 3001, WORDS, max_edits=k)  # 3001: no multiple of 256
    pos, _halo = _check_hits(text, WORDS, k, damerau)
    assert len(pos) > 20 and np.all(np.diff(pos) > 0)


@pytest.mark.parametrize("n", [1, 15, 16, 17])
def test_packed_hits_short_streams(n):
    text = ("phaetra tincidunt " * 2)[:n]
    pos, _halo = _check_hits(text, WORDS, 1, True, layout_n=64)
    if n >= 15:  # "phaetra", and with 15+ symbols a prefix of "tincidunt" less one
        assert len(pos) > 0


def test_packed_hits_zero_hits():
    pos, _halo = _check_hits("lorem ipsum dolor sit amet " * 40, WORDS, 0, False)
    assert len(pos) == 0
    T = tpb.tables_from_numpy(*_tables(WORDS, 0, False)[:5])
    empty = torch.zeros(0, dtype=torch.uint8)
    count, pos, words = tpb.packed_hits(empty, T, 9)
    assert count == 0 and pos.shape == (0,) and words.shape == (0, 2 * T.W)


def test_packed_hits_every_position_hits():
    n = 700
    pos, _halo = _check_hits("a" * n, ["a", "aa"], 1, False)
    assert pos.tolist() == list(range(n))


def test_packed_hits_at_the_edges():
    # A word that ends on position 0 only through deletions, one inside the
    # first halo symbols, one on the last symbol.
    text = "a phaetra " + _corpus(53, 900, WORDS, max_edits=1) + " sagittis"
    pos, halo = _check_hits(text, WORDS + ["ab"], 1, True)
    assert pos[0] == 0 and np.any((pos > 0) & (pos < halo)) and pos[-1] == len(text) - 1


def test_max_count_skips_the_hit_list():
    word_tbl, starts, match, init, notlast, lut, halo = _tables(WORDS, 0, False)
    ids = torch.from_numpy(lut[np.frombuffer(b"phaetra sagittis phaetra", np.uint8)])
    T = tpb.tables_from_numpy(word_tbl, starts, match, init, notlast)
    assert tpb.packed_hits(ids, T, halo, max_count=2) == (3, None, None)
    count, pos, _words = tpb.packed_hits(ids, T, halo, max_count=3)
    assert count == 3 and pos.tolist() == [6, 15, 23]


def test_scan_bits_chunk_argument():
    word_tbl, starts, match, init, notlast, lut, halo = _tables(WORDS, 0, False)
    ids = torch.from_numpy(lut[np.frombuffer(b"phaetra sagittis phaetra", np.uint8)])
    T = tpb.tables_from_numpy(word_tbl, starts, match, init, notlast)
    bits, counts = tpb.scan_bits(ids, T, halo)
    for chunk in tpb.SCAN_CHUNKS:  # the result does not depend on it
        again = tpb.scan_bits(ids, T, halo, chunk=chunk)
        assert torch.equal(again[0], bits) and torch.equal(again[1], counts)
    with pytest.raises(ValueError, match="chunk"):
        tpb.scan_bits(ids, T, halo, chunk=100)


# ---------------------------------------------------------------------------
# (b) expansion -> DP -> emission
# ---------------------------------------------------------------------------

def _fuzzy(edits):
    return lambda b, L: b.fuzzy(L.new().edits(edits)).case_insensitive(True)


def _pair(configure, patterns):
    jp = patterns(JaxPattern) if callable(patterns) else patterns
    tp = patterns(Pattern) if callable(patterns) else patterns
    jax_e = configure(JaxBuilder.new(), JaxLimits).build(jp)
    port_e = configure(FuzzyAhoCorasickBuilder.new(), FuzzyLimits).device("cpu").build(tp)
    jax_e.backend = port_e.backend = "device"
    return jax_e, port_e


def _jax_pipeline_rows(monkeypatch, jax_e, hay, thr):
    """What ``_dp_pipeline_jit`` returned for each slice of the JAX search:
    {(limit, start_lo, start_hi, the slice's symbols): (hits, candidates,
    rows [total, 5])}, the 12-byte rows unpacked to (start, penalty bits,
    span, pattern, counts)."""
    real = jvd._dp_pipeline_jit
    seen = {}

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        limit = int(args[15])
        key = (limit, int(args[16]), int(args[17]), np.asarray(args[0]).reshape(-1)[:limit].tobytes())
        seen[key] = np.asarray(out)  # a retry overwrites
        return out

    monkeypatch.setattr(jvd, "_dp_pipeline_jit", spy)
    jax_corpus.clear()
    matches = jax_e.search_raw(hay, thr)
    assert jax_e.last_stats["backend"] == "device-fuzzy-dp"
    monkeypatch.setattr(jvd, "_dp_pipeline_jit", real)
    out = {}
    for key, buf in seen.items():
        hits, cands, total = (int(x) for x in buf[0])
        body = buf[1:1 + total].astype(np.int64)
        col2 = body[:, 2]
        c12 = col2 & 0xFFF
        cnt = (c12 & 7) | (((c12 >> 3) & 7) << 8) | (((c12 >> 6) & 7) << 16) | (((c12 >> 9) & 7) << 24)
        rows = np.stack([body[:, 0], body[:, 1], (col2 >> 24) & 0xFF, (col2 >> 12) & 0xFFF, cnt], axis=1)
        out[key] = (hits, cands, rows)
    return out, matches


def _port_pipeline_rows(port_e, hay, thr):
    """The same from the port's plain pipeline, per slice."""
    view = view_of(hay, port_e.case_insensitive)
    n = len(view)
    plan = tvd.dp_plan(port_e, thr, n)
    device_corpus.clear()
    run = tvd.dp_inputs(port_e, hay, plan, view, n)
    out = {}
    for part in run.parts:
        count, pos, words = tpb.packed_hits(part.ids_pf, run.T_scan, run.halo)
        window = tvd.DpWindow(part.lo, part.hi, part.local_n)
        args = (pos, words, window, part.ids_de, part.local_n, run.T, run.pens,
                np.float32(thr), plan.E, run.deadend, run.statics)
        rows, n_cand = tvd.dp_pipeline_torch(*args)
        again, n_again = tvd.dp_pipeline(*args)  # the wrapper, on CPU tensors
        assert torch.equal(rows, again) and n_cand == n_again
        assert rows.dtype == torch.int32 and rows.shape[1] == 5
        key = (part.local_n, part.lo, part.hi, part.ids_pf.numpy()[:part.local_n].tobytes())
        out[key] = (count, n_cand, rows.numpy().astype(np.int64))
    return out, run


def _check_rows(monkeypatch, jax_e, port_e, hay, thr, min_rows=20):
    want, matches = _jax_pipeline_rows(monkeypatch, jax_e, hay, thr)
    got, run = _port_pipeline_rows(port_e, hay, thr)
    assert sorted(got) == sorted(want)
    total = 0
    for key in want:
        assert got[key][:2] == want[key][:2]  # hits, candidates
        assert got[key][2].tolist() == want[key][2].tolist()
        total += len(want[key][2])
    assert total >= min_rows
    return got, run, matches


@pytest.fixture(scope="module")
def headline():
    return _pair(_fuzzy(1), HEADLINE)


def test_pipeline_rows_headline_edits1(monkeypatch, headline):
    hay = _corpus(61, 6000, HEADLINE)
    got, run, _m = _check_rows(monkeypatch, *headline, hay, 0.8, min_rows=100)
    (_hits, cands, rows), = got.values()
    assert cands > len(rows) / 3 and len(run.parts) == 1
    kinds = {int(c) for c in rows[:, 4]}
    assert {0, 1, 0x100, 0x10000, 0x1000000} <= kinds  # exact and each edit type


def test_pipeline_rows_edits2(monkeypatch):
    words = ["condim", "imperd", "vulput", "ridic"]
    jax_e, port_e = _pair(_fuzzy(2), words)
    got, _run, _m = _check_rows(monkeypatch, jax_e, port_e, _corpus(62, 4000, words), 0.6)
    (_h, _c, rows), = got.values()
    edits = [sum((int(c) >> s) & 0xFF for s in (0, 8, 16, 24)) for c in rows[:, 4]]
    assert max(edits) == 2


def test_pipeline_rows_weights_and_floor(monkeypatch):
    jax_e, port_e = _pair(
        lambda b, L: b.fuzzy(L.new().edits(1)).min_symbol_similarity(0.5),
        lambda P: [P("tincidunt").with_weight(0.9), P("phaetra").with_weight(1.1),
                   P("tin").with_weight(0.7)])
    hay = _corpus(63, 5000, ["tincidunt", "phaetra", "tin"], rate=4)
    _check_rows(monkeypatch, jax_e, port_e, hay, 0.65)


def test_pipeline_rows_multibyte_edges(monkeypatch):
    jax_e, port_e = _pair(_fuzzy(1), CYRILLIC)
    assert port_e.dense.has_multibyte_edges  # the dead-end filter runs
    hay = _corpus(64, 4000, CYRILLIC + ["прuвет", "мирр"], ["и", "мы", "тесты", "кафе", "она"], rate=3)
    _got, run, _m = _check_rows(monkeypatch, jax_e, port_e, hay, 0.6)
    assert run.deadend


def test_pipeline_rows_cut_window(monkeypatch, headline):
    slice_syms = 1500
    hay = _corpus(65, 4 * slice_syms, HEADLINE, rate=3)
    monkeypatch.setenv("FAC_SLICE_SYMS", str(slice_syms))
    monkeypatch.setattr(tvd, "SLICE_SYMS", slice_syms)
    got, run, _m = _check_rows(monkeypatch, *headline, hay, 0.8, min_rows=100)
    assert len(run.parts) == 4 and len(got) == 4
    assert all(len(rows) > 0 for _h, _c, rows in got.values())


def test_pipeline_rows_threshold_tie(monkeypatch, headline):
    jax_e, port_e = headline
    hay = "lorem tincdunt ipsum TINCIDUNT dolor tincidxnt amet tnicidunt " * 30
    sims = {float(m.similarity) for m in port_e.search_raw(hay, 0.8)}
    ties = sorted(x for x in sims if x < 1.0)
    assert len(ties) >= 3
    kept = 0
    for thr in (ties[0], ties[-1]):  # a similarity a match reaches, as the threshold
        got, _run, matches = _check_rows(monkeypatch, jax_e, port_e, hay, thr)
        kept += any(np.float32(m.similarity) == np.float32(thr) for m in matches)
        if kept:
            break
    assert kept >= 1


def test_pipeline_no_hits_and_refusals(headline):
    _jax_e, port_e = headline
    got, run = _port_pipeline_rows(port_e, "lorem ipsum dolor sit amet " * 20, 0.8)
    (hits, cands, rows), = got.values()
    assert (hits, cands, rows.shape) == (0, 0, (0, 5))
    part = run.parts[0]
    _count, pos, words = tpb.packed_hits(part.ids_pf, run.T_scan, run.halo)
    args = (tvd.DpWindow(0, 1, 1), part.ids_de, 1, run.T, run.pens, 0.8, 1, False, run.statics)
    with pytest.raises(ValueError, match="int64"):
        tvd.dp_pipeline(pos.int(), words, *args)
    with pytest.raises(ValueError, match="uint8 or int32"):
        tvd.dp_pipeline(pos, words, args[0], part.ids_de.float(), *args[2:])
    with pytest.raises(ValueError, match="edit budget"):
        tvd.dp_pipeline(pos, words, *args[:6], 7, *args[7:])


def test_lane_declines_past_the_hit_budget(monkeypatch, headline):
    """The lane no longer declines on the hit budget: past
    ``pipeline_max_hits`` a slice's hit list runs in ranges of that many
    hits (``dp_pipeline_ranges``), each handed its preceding hit for the run
    dedup, and the matches, hits and candidates equal one range's, with hit
    runs cut between two ranges. ``pipeline_max_hits`` keeps the counts of
    one range inside int32 offsets."""
    _jax_e, port_e = headline
    hay = _corpus(69, 2000, HEADLINE, rate=3) + " tincidunt" + "t" * 4
    view = view_of(hay, True)
    device_corpus.clear()
    served = tvd.fuzzy_search_dp(port_e, hay, 0.8, view, len(view))
    stats = dict(port_e.last_stats)
    assert served and stats["hits"] > 10
    calls = []
    real = tvd.dp_pipeline
    monkeypatch.setattr(tvd, "dp_pipeline", lambda *a, **k: calls.append(k.get("h0", 0))
                        or real(*a, **k))
    for range_hits in (1, 2, 7):
        monkeypatch.setattr(tvd, "pipeline_max_hits", lambda *a, r=range_hits: r)
        calls.clear()
        got = tvd.fuzzy_search_dp(port_e, hay, 0.8, view, len(view))
        assert _tuples(got) == _tuples(served) and port_e.last_stats == stats
        assert len(calls) == -(-stats["hits"] // range_hits) and set(calls) == {0, 1}
    monkeypatch.undo()
    for n_c, MO, E in ((48, 1, 1), (48, 16, 1), (600, 40, 3), (1, 1, 1)):
        most = tvd.pipeline_max_hits(n_c, MO, E)
        assert most * n_c * ((2 * E + 1) * MO + 1) < 1 << 31
        assert (most + 1) * n_c * ((2 * E + 1) * MO + 1) >= 1 << 31
    assert tvd.pipeline_max_hits(10 ** 10, 1, 1) == 1


def _tie_pair():
    """``abzz`` and ``bbzz`` both output their suffix ``zz`` in slot 1 at
    depth 4; with substitutions and swaps both priced 0.6, ``bazz`` is one
    swap from the first and one substitution from the second, so ``zz`` at
    that span ties on similarity with different edit counts, and the
    earliest row wins: the first field's. The second field's row comes from
    an earlier hit (``bbzz`` fires one position sooner), so a range boundary
    between the hits puts it first unless the rows are put back in one
    range's order."""
    jax_e = (JaxBuilder.new().fuzzy(JaxLimits.new().edits(1))
             .penalties(JaxPenalties().with_substitution(0.6).with_swap(0.6))
             .build(["abzz", "bbzz", "zz"]))
    port_e = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1))
              .penalties(FuzzyPenalties().with_substitution(0.6).with_swap(0.6))
              .device("cpu").build(["abzz", "bbzz", "zz"]))
    jax_e.backend = port_e.backend = "device"
    return jax_e, port_e


def test_ranges_keep_the_tie_rule(monkeypatch):
    jax_e, port_e = _tie_pair()
    hay = "xx bazz yy abzz ww bazz q"
    view = view_of(hay, True)
    want = sorted(_tuples(jax_e.search_raw(hay, 0.5)))
    ties = [t for t in want if t[0] == 2 and (t[1], t[2]) in ((3, 7), (19, 23))]
    assert len(ties) == 2 and all(t[4:] == (0, 0, 0, 1) for t in ties)  # the swap wins
    jax_e.backend = "oracle"
    assert sorted(_tuples(jax_e.search_raw(hay, 0.5))) == want
    for range_hits in (1, 2, 7):
        monkeypatch.setattr(tvd, "pipeline_max_hits", lambda *a, r=range_hits: r)
        assert sorted(_tuples(tvd.fuzzy_search_dp(port_e, hay, 0.5, view, len(view)))) == want
    # Without the sort by tags, one-hit ranges keep the substitution.
    plan = tvd.dp_plan(port_e, 0.5, len(view))
    run = tvd.dp_inputs(port_e, hay, plan, view, len(view))
    part = run.parts[0]
    _count, pos, words = tpb.packed_hits(part.ids_pf, run.T_scan, run.halo)
    args = (tvd.DpWindow(part.lo, part.hi, part.local_n), part.ids_de, part.local_n, run.T,
            run.pens, np.float32(0.5), plan.E, run.deadend, run.statics)
    cut = torch.cat([tvd.dp_pipeline(pos[a - min(a, 1):a + 1], words[a - min(a, 1):a + 1], *args,
                                     h0=min(a, 1))[0] for a in range(pos.numel())])
    ranged, _n = tvd.dp_pipeline_ranges(pos, words, 1, *args)
    whole, _n = tvd.dp_pipeline(pos, words, *args)
    assert torch.equal(ranged, whole) and not torch.equal(cut, whole)
    assert sorted(map(tuple, cut.tolist())) == sorted(map(tuple, whole.tolist()))


def test_row_order_does_not_reach_the_matches(headline):
    """``decode_matches`` keeps, per (pattern, start, end), the highest
    similarity and on ties the earliest row: rows of one span with equal
    similarity differ in nothing but their edit counts, so the rows' order
    among different spans is free. Shuffling whole spans leaves the result
    unchanged."""
    from fuzzy_aho_corasick_tpu_torch.ops.emit import decode_matches

    _jax_e, port_e = headline
    hay = _corpus(66, 5000, HEADLINE)
    got, _run = _port_pipeline_rows(port_e, hay, 0.8)
    (_h, _c, rows), = got.values()
    view = view_of(hay, True)

    def decode(r):
        out = decode_matches(port_e, view, hay, len(view), r[:, 0], r[:, 2], r[:, 3],
                             np.ascontiguousarray(r[:, 1].astype(np.int32)).view(np.float32),
                             r[:, 4], np.float32(0.8))
        return sorted((m.pattern_index, m.start, m.end, float(m.similarity), m.edits) for m in out)

    rng = np.random.default_rng(67)
    keys = rows[:, 0] * 1000 + rows[:, 2] * 20 + rows[:, 3]
    order = np.argsort(rng.permutation(keys.max() + 1)[keys], kind="stable")
    assert not np.array_equal(order, np.arange(len(rows)))
    assert decode(rows[order]) == decode(rows) and len(decode(rows)) > 50


# ---------------------------------------------------------------------------
# (c) the lane, sliced against unsliced
# ---------------------------------------------------------------------------

def _tuples(matches):
    return [(m.pattern_index, m.start, m.end, np.float32(m.similarity).view(np.uint32).item(),
             m.insertions, m.deletions, m.substitutions, m.swaps) for m in matches]


@pytest.mark.parametrize("slice_syms", [700, 2048])
def test_sliced_search_equals_unsliced(monkeypatch, headline, slice_syms):
    _jax_e, port_e = headline
    hay = _corpus(68, 9000, HEADLINE, rate=3)
    view = view_of(hay, True)
    device_corpus.clear()
    whole = _tuples(tvd.fuzzy_search_dp(port_e, hay, 0.8, view, len(view)))
    assert port_e.last_stats["slices"] == 1
    monkeypatch.setattr(tvd, "SLICE_SYMS", slice_syms)
    device_corpus.clear()
    sliced = _tuples(tvd.fuzzy_search_dp(port_e, hay, 0.8, view, len(view)))
    assert port_e.last_stats["slices"] == -(-len(view) // slice_syms)
    assert sliced == whole and len(whole) > 100
