"""The large-dictionary lane (``ops/many``), port against the JAX package and
the oracle on the CPU.

(a) ``_fold_assign`` and the ``ManyPackSpec`` tables (word tables, expansion
    rows, masks) are byte-equal to the JAX package's, folded and plain.
(b) ``expand_candidates_sparse`` (the expansion of ``many_step_kernel``'s
    plain version) returns the JAX ``_expand_candidates_sparse``'s
    candidates element by element, with and without the containment
    pre-verify, on the lane's own hits and on synthetic hit lists with runs
    and hits at the corpus edges; ``many.many_step`` (CPU tensors: its plain
    version) returns the rows of the JAX ``_expand_candidates_sparse`` ->
    ``_banded_dp`` -> ``_emit_rows`` element by element, E = 1 and 2,
    containment on and off, on a range handed its preceding hit, without
    hits and without candidates, and on a dictionary with multi-byte edges
    (the dead-end filter).
(c) The scan at W = 31 limbs (on the CPU the plain versions of the wide
    kernels) equals the JAX ``packed_hits`` in its traced-table form
    (Pallas in interpret mode).
(d) ``fuzzy_search_many`` equals the oracle, tuple by tuple with the f32
    similarity bits and edit counts: multi-chunk plain, verify fields shared
    by two chunks, wide Damerau, folded, and past the folded hit ceiling;
    and equals the JAX ``fuzzy_search_many`` in tuples and ``last_stats``,
    and in the row it keeps where two fields of one span tie.
(e) Routing: ``backend = "device"`` reaches the lane for plain and beamed
    engines whose dictionary does not pack, past 4095 patterns too (where
    the JAX package takes its beam lanes), equal to the oracle.

Both sides get the same numpy inputs, made from a seed. The tolerance is
exact equality everywhere: the scan and the expansion are integer, and the
DP replays the JAX package's f32 operations in the same order."""

import ctypes
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder as JaxBuilder
from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits
from fuzzy_aho_corasick_tpu import FuzzyPenalties as JaxPenalties
from fuzzy_aho_corasick_tpu.ops import many as jmany
from fuzzy_aho_corasick_tpu.ops import packed_bitap as jpb
from fuzzy_aho_corasick_tpu.ops import verify_dp as jvd
from fuzzy_aho_corasick_tpu.ops.engine import DeviceEngine as JaxDeviceEngine
from fuzzy_aho_corasick_tpu.utils.graphemes import view_of as jax_view_of
from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits, FuzzyPenalties, oracle
from fuzzy_aho_corasick_tpu_torch.ops import _cuda_build, many
from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
from fuzzy_aho_corasick_tpu_torch.ops import verify_dp as tvd
from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)

LETTERS = "abcdefghijklmnopqrstuvwxyz"


def _dictionary(n_pat: int, seed: int = 7, letters: str = LETTERS):
    """``bench.py``'s many1k recipe: random words of 6-11 letters."""
    rng = np.random.default_rng(seed)
    return sorted({
        "".join(letters[i] for i in rng.integers(0, len(letters), size=int(m)))
        for m in rng.integers(6, 12, size=n_pat)
    })


def _corpus(dictionary, size: int, seed: int = 11, rate: int = 13) -> str:
    """Filler words with dictionary words at 1 in ``rate``, half of them with
    one substitution."""
    rng = np.random.default_rng(seed)
    words = ["lorem", "ipsum", "dolor", "sit", "amet"]
    parts, total = [], 0
    while total < size:
        w = words[int(rng.integers(len(words)))]
        if rng.integers(rate) == 0:
            w = dictionary[int(rng.integers(len(dictionary)))]
            if rng.integers(2) == 0:
                i = int(rng.integers(1, len(w) - 1))
                w = w[:i] + ("q" if w[i] != "q" else "z") + w[i + 1:]
        parts.append(w)
        total += len(w) + 1
    return " ".join(parts)


def _edited(dictionary, count: int, seed: int) -> str:
    """The first ``count`` words each with one substitution, swap, deletion
    or insertion, separated by a filler word."""
    rng = np.random.default_rng(seed)
    parts = []
    for w in dictionary[:count]:
        i, mode = int(rng.integers(1, len(w) - 2)), int(rng.integers(4))
        parts.append([w[:i] + ("q" if w[i] != "q" else "z") + w[i + 1:],
                      w[:i] + w[i + 1] + w[i] + w[i + 2:], w[:i] + w[i + 1:],
                      w[:i] + "x" + w[i:]][mode])
        parts.append("filler")
    return " ".join(parts)


def _port(words, edits: int = 1, beam: bool = False):
    b = FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(edits))
    b = b.case_insensitive(True).device("cpu")
    if beam:
        b = b.beam_width(64)
    eng = b.build(words)
    eng.backend = "device"
    return eng


def _jax(words, edits: int = 1):
    return JaxBuilder.new().fuzzy(JaxLimits.new().edits(edits)).case_insensitive(True).build(words)


def _key(m):
    return (m.pattern_index, m.start, m.end, np.float32(m.similarity).view(np.uint32).item(),
            m.insertions, m.deletions, m.substitutions, m.swaps)


def _oracle_keys(engine, hay: str, thr: float):
    return sorted(map(_key, oracle.search_raw(engine, hay, thr)))


# ---------------------------------------------------------------------------
# (a) host tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_words, limbs, fold", [(120, 8, False), (120, 8, True),
                                                  (400, 32, False), (400, 32, True)])
def test_pack_spec_equal_to_jax(monkeypatch, n_words, limbs, fold):
    monkeypatch.setattr(jmany, "MANY_LIMBS", limbs)
    monkeypatch.setattr(many, "MANY_LIMBS", limbs)
    words = _dictionary(n_words, seed=29)
    want = jmany.ManyPackSpec.build(_jax(words), fold=fold)
    eng = _port(words)
    got = many.ManyPackSpec.build(eng, fold=fold)
    assert want is not None and got is not None
    assert [(p, bp.m) for p, bp in enumerate(got.filt.patterns)] == [
        (p, bp.m) for p, bp in enumerate(want.filt.patterns)]
    assert jmany._fold_assign(want.filt.patterns, want.A, 1) == many._fold_assign(
        got.filt.patterns, got.A, 1)
    for name in ("W", "A", "R", "m_max", "n_pat", "folded", "rd_min", "rd_max"):
        assert getattr(got, name) == getattr(want, name), name
    assert len(got.chunks) == len(want.chunks) >= (2 if limbs == 8 and not fold else 1)
    for g, w in zip(got.chunks, want.chunks):
        assert np.array_equal(g[0], w[0]) and g[1] == w[1] and g[2] == w[2]
        for a, b in zip(g[3:], w[3:]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    ks, dam = many.many_budgets(eng, got, np.float32(0.82))
    assert dam and max(ks) == 1
    for g, w in zip(got.masks_for(ks, max(ks)), want.masks_for(ks, max(ks))):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# (b) sparse expansion
# ---------------------------------------------------------------------------

_EXPAND = {}


def _expand_setup():
    """The 400-word folded spec (rows of depth >= 4, so the containment test
    applies), its device tables and a text with dictionary words at both
    corpus edges and hit runs; built once."""
    if not _EXPAND:
        words = _dictionary(400, seed=29)
        eng = _port(words)
        spec = many.many_spec_of(eng, fold=True)
        text = words[0] + " " + _edited(words, 60, 31) + " " + words[1] + words[1][-1] \
            + " " + words[2]
        view = view_of(text, True)
        run = many.many_inputs(eng, spec, text, 0.8, view, len(view))
        chunk = run.chunks[0]
        count, pos, w = tpb.packed_hits(run.ids_pf, chunk.T_scan, run.halo)
        _EXPAND.update(spec=spec, run=run, chunk=chunk, pos=pos, words=w, n=len(view))
    return _EXPAND


def _synthetic_hits(X, n: int, seed: int):
    """Ascending hit positions with runs of adjacent hits, hits on the first
    and last symbols and past the live window, and match words with random
    bits in the columns that have rows (and in one that has none)."""
    rng = np.random.default_rng(seed)
    pos = set(rng.integers(0, n, size=120).tolist()) | {0, 1, 2, n - 2, n - 1}
    for p in rng.integers(0, n - 4, size=15).tolist():
        pos.update((p, p + 1, p + 2))
    pos = np.asarray(sorted(pos), np.int64)
    cols = np.flatnonzero((X.field >= 0).any(dim=1).numpy())
    words = np.zeros((pos.size, X.field.shape[0]), np.int64)
    for h in range(pos.size):
        for c in rng.choice(cols, size=int(rng.integers(1, 3)), replace=False):
            words[h, c] = int(rng.integers(1, 1 << 32))
    words[5, [c for c in range(words.shape[1]) if c not in cols][:1]] = 7
    # A run whose hits fire the same bits (the dedup drops their bands > 0).
    words[10:13] = words[10]
    pos[10:13] = pos[10] + np.arange(3)
    return pos, words


#: The JAX expansion compiled once per shape, as the JAX lane runs it (the
#: window's bounds traced).
_jax_expand = jax.jit(jmany._expand_candidates_sparse,
                      static_argnames=("E", "CAND", "KH2", "k", "rd_min", "rd_max"))


@pytest.mark.parametrize("source", ["lane hits", "synthetic"])
@pytest.mark.parametrize("contain", [True, False])
def test_expand_sparse_equal_to_jax(source, contain):
    s = _expand_setup()
    X, run, n = s["chunk"].X, s["run"], s["n"]
    if source == "lane hits":
        pos, words = s["pos"], s["words"]
        windows = [(0, n, n)]
    else:
        pos_np, words_np = _synthetic_hits(X, n, seed=5)
        pos, words = torch.from_numpy(pos_np), torch.from_numpy(words_np)
        windows = [(0, n, n), (7, n - 5, n - 3)]
    assert pos.numel() > 20
    ids = run.ids_de if contain else None
    for window in windows:
        pairs, cf, cs = many.expand_candidates_sparse(
            pos, words, tvd.DpWindow(*window), run.E, X, ids, run.k)
        before = dict(tpb.LAUNCHES)
        assert many.many_step(pos, words, tvd.DpWindow(*window), run.ids_de, n, run.T, run.pens,
                              np.float32(0.8), run.E, run.deadend, X, run.k,
                              contain=contain)[1:] == (pairs, cf.numel())
        assert tpb.LAUNCHES == before  # CPU tensors run the plain version
        K = pos.numel()
        jp, jc, jf, js = _jax_expand(
            jnp.asarray(pos.numpy().astype(np.int32)),
            jnp.asarray(words.numpy().astype(np.uint32)), *map(np.int32, window), run.E,
            4 * K * X.R * (2 * run.E + 1) + 64, K * words.shape[1], jnp.asarray(X.field.numpy()),
            jnp.asarray(X.shift.numpy()), jnp.asarray(X.depth.numpy()),
            ids_dense=None if ids is None else jnp.asarray(ids.numpy()),
            cr_pc=jnp.asarray(X.pc.numpy()), k=run.k, rd_min=X.rd_min, rd_max=X.rd_max)
        jc = int(jc)
        assert (int(jp), jc) == (pairs, cf.numel())
        assert np.asarray(jf)[:jc].tolist() == cf.tolist()
        assert np.asarray(js)[:jc].tolist() == cs.tolist()
    assert cf.numel() > 0


def test_containment_drops_candidates_without_changing_the_matches():
    s = _expand_setup()
    X, run, n = s["chunk"].X, s["run"], s["n"]
    window = tvd.DpWindow(0, n, n)
    _p, cf_on, cs_on = many.expand_candidates_sparse(s["pos"], s["words"], window, run.E, X,
                                                     run.ids_de, run.k)
    _p, cf_off, cs_off = many.expand_candidates_sparse(s["pos"], s["words"], window, run.E, X,
                                                       None, run.k)
    assert 0 < cf_on.numel() < cf_off.numel()
    rows = [many.dp_list_torch(cf, cs, run.ids_de, n, run.T, run.pens, np.float32(0.8), run.E,
                               run.deadend) for cf, cs in ((cf_on, cs_on), (cf_off, cs_off))]
    key = lambda r: sorted(map(tuple, r.tolist()))
    assert key(rows[0]) == key(rows[1]) and len(rows[0]) > 20


# ---------------------------------------------------------------------------
# (b') the chunk step: expansion, DP and emission
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("E", "Lmax", "C", "MO", "CAND", "KG", "deadend"))
def _jax_dp_emit(cf, cs, ids, limit, path_cls, path_node, depth, node, out_list, pat_len,
                 pat_weight, sim, node_ceil, sb_edge, out_count, pens, thr, E, Lmax, C, MO, CAND,
                 KG, deadend):
    """What ``_many_pipeline_jit`` runs behind its expansion: ``_banded_dp``
    and ``_emit_rows``."""
    pen, cnt = jvd._banded_dp(cf, cs, path_cls, path_node, depth, ids, limit, sim, node_ceil,
                              *pens, E, Lmax, C, deadend=deadend, sb_edge_flat=sb_edge,
                              out_count_arr=out_count)
    return jvd._emit_rows(pen, cnt, cf, cs, depth, node, out_list, pat_len, pat_weight, limit,
                          thr, E, MO, CAND, KG)


def _unpack_jax_rows(packed):
    """The JAX 12-byte rows (span, pattern and 3-bit counts packed in one
    word) as the port's five columns."""
    packed = packed.astype(np.int64)
    col2 = packed[:, 2]
    c12 = col2 & 0xFFF
    counts = (c12 & 7) | ((c12 >> 3) & 7) << 8 | ((c12 >> 6) & 7) << 16 | ((c12 >> 9) & 7) << 24
    return np.stack([packed[:, 0], packed[:, 1], col2 >> 24, (col2 >> 12) & 0xFFF, counts], axis=1)


#: Hits the JAX step is handed (padded with hits at -1, which it does not
#: expand), candidates and rows it has room for: one compile per engine and
#: option.
_STEP_HITS, _STEP_CAND, _STEP_ROWS = 256, 4096, 8192


def _jax_step_rows(run, X, pos, words, window, thr, contain):
    """(pairs, candidates, rows [total, 5]) of the JAX step over the hits."""
    K, W2 = words.shape
    assert K <= _STEP_HITS
    pos_p = np.full(_STEP_HITS, -1, np.int32)
    pos_p[:K] = pos.numpy()
    words_p = np.zeros((_STEP_HITS, W2), np.uint32)
    words_p[:K] = words.numpy().astype(np.uint32)
    T, E = run.T, run.E
    ids = jnp.asarray(run.ids_de.numpy())
    pairs, cands, cf, cs = _jax_expand(
        jnp.asarray(pos_p), jnp.asarray(words_p), *map(np.int32, window), E, _STEP_CAND,
        _STEP_HITS * W2, *(jnp.asarray(t.numpy()) for t in (X.field, X.shift, X.depth)),
        ids_dense=ids if contain else None, cr_pc=jnp.asarray(X.pc.numpy()), k=run.k,
        rd_min=X.rd_min, rd_max=X.rd_max)
    # A large unrolled body takes the JAX DP's row-loop form instead (path
    # tables padded past its unroll bound of 24 rows, dead past each field's
    # depth), which compiles in a fraction of the time.
    Lj = 25 if T.Lmax * (2 * E + 1) * (E + 1) > 100 else T.Lmax
    pad = lambda t: np.pad(t.numpy(), ((0, 0), (0, Lj - T.Lmax))).reshape(-1)
    total, rows = _jax_dp_emit(
        cf, cs, ids, np.int32(window[2]), pad(T.path_cls), pad(T.path_node),
        *(t.numpy() for t in (T.depth, T.node, T.out_list, T.pat_len, T.pat_weight)),
        T.sim.numpy().reshape(-1), T.node_ceil.numpy(), T.sb_edge.numpy().reshape(-1),
        T.out_count.numpy(), tuple(np.float32(x) for x in run.pens), np.float32(thr),
        E=E, Lmax=Lj, C=T.C, MO=T.out_list.shape[1], CAND=_STEP_CAND, KG=_STEP_ROWS,
        deadend=run.deadend)
    cands, total = int(cands), int(total)
    assert cands <= _STEP_CAND and total <= _STEP_ROWS
    return int(pairs), cands, _unpack_jax_rows(np.asarray(rows)[:total])


_STEP = {}


def _step_setup(name: str):
    """(run, chunk, text length, threshold, pos, words) of one engine's lane
    hits; built once per engine. "e1": the 400-word folded spec (rows of
    depth >= 4, so the containment test applies), "e2": 90 words with
    ``edits(2)``, "deadend": Cyrillic words with ``edits(1)`` (multi-byte
    edges: the dead-end filter)."""
    if name not in _STEP:
        if name == "e1":
            s = _expand_setup()
            _STEP[name] = (s["run"], s["chunk"], s["n"], 0.8, s["pos"], s["words"])
            return _STEP[name]
        if name == "e2":
            words = _dictionary(90, seed=43)
            eng, thr = _port(words, edits=2), 0.7
            text = _edited(words, 40, 47)
        else:
            words = ["привет", "мир", "москва", "ирина", "тест", "кафе", "café", "мосвка"]
            b = FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1))
            eng, thr = b.case_insensitive(True).device("cpu").build(words), 0.6
            rng = np.random.default_rng(5)
            fill = ["и", "мира", "тесты", "привет", "кафе", "cafe", "мосвка", "ирнна", "прuвет",
                    "caff", "кофе"]
            text = " ".join(fill[int(rng.integers(len(fill)))] for _ in range(40))
        view = view_of(text, True)
        run = many.many_inputs(eng, many.many_spec_of(eng), text, thr, view, len(view))
        assert run.E == (2 if name == "e2" else 1) and run.deadend == (name == "deadend")
        chunk = run.chunks[0]
        _count, pos, w = tpb.packed_hits(run.ids_pf, chunk.T_scan, run.halo)
        _STEP[name] = (run, chunk, len(view), thr, pos, w)
    return _STEP[name]


STEP_CASES = {
    # engine, containment, hits: "lane" (the lane's own), "range" (the
    # second half handed its preceding hit), "synthetic", "none", "cut"
    # (a window that no start lies in: hits and pairs, no candidate)
    "e1": ("e1", True, "lane"),
    "e1-no-containment": ("e1", False, "lane"),
    "e1-range": ("e1", True, "range"),
    "e1-range-no-containment": ("e1", False, "range"),
    "e1-synthetic-runs": ("e1", True, "synthetic"),
    "e1-no-hits": ("e1", True, "none"),
    "e1-no-candidates": ("e1", True, "cut"),
    "e2": ("e2", True, "lane"),
    "e2-no-containment": ("e2", False, "lane"),
    "e2-range": ("e2", True, "range"),
    "deadend": ("deadend", True, "lane"),
    "deadend-range-no-containment": ("deadend", False, "range"),
}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_many_step_equal_to_jax(name):
    """``many.many_step`` on CPU tensors (its plain version, no launch) equals
    ``dp_list_torch(expand_candidates_sparse(...))`` and the JAX step's rows,
    pairs and candidates element by element; a range handed its preceding
    hit equals the plain version element by element, and with the first
    range its rows are the JAX step's over the whole list, as a multiset."""
    engine, contain, hits = STEP_CASES[name]
    run, chunk, n, thr, pos, words = _step_setup(engine)
    X, thr = chunk.X, np.float32(thr)
    window = tvd.DpWindow(0, n, n)
    if hits == "synthetic":
        pos_np, words_np = _synthetic_hits(X, n, seed=9)
        keep = slice(0, _STEP_HITS)
        pos, words = torch.from_numpy(pos_np[keep].copy()), torch.from_numpy(words_np[keep].copy())
    elif hits == "none":
        pos, words = pos[:0], words[:0]
    elif hits == "cut":
        window = tvd.DpWindow(0, 0, n)
    assert (pos.numel() > 20) == (hits != "none")
    args = (run.ids_de, n, run.T, run.pens, thr, run.E, run.deadend, X, run.k)

    def both(p, w, h0=0):
        before = dict(tpb.LAUNCHES)
        got = many.many_step(p, w, window, *args, h0=h0, contain=contain)
        assert tpb.LAUNCHES == before  # CPU tensors run the plain version
        pairs, cf, cs = many.expand_candidates_sparse(p, w, window, run.E, X,
                                                      run.ids_de if contain else None, run.k, h0)
        rows = many.dp_list_torch(cf, cs, run.ids_de, n, run.T, run.pens, thr, run.E,
                                  run.deadend)
        assert torch.equal(got[0], rows) and got[1:] == (pairs, cf.numel())
        assert many.many_step_torch(p, w, window, *args, h0=h0, contain=contain)[1:] == got[1:]
        return got

    want_pairs, want_cands, want_rows = _jax_step_rows(run, X, pos, words, window, thr, contain)
    if hits == "range":
        a = pos.numel() // 2
        first = both(pos[:a], words[:a])
        second = both(pos[a - 1:], words[a - 1:], h0=1)
        rows = torch.cat((first[0], second[0])).numpy()
        assert sorted(map(tuple, rows.tolist())) == sorted(map(tuple, want_rows.tolist()))
        assert (first[1] + second[1], first[2] + second[2]) == (want_pairs, want_cands)
        assert second[2] > 0
        return
    rows, pairs, cands = both(pos, words)
    assert np.array_equal(rows.numpy(), want_rows) and (pairs, cands) == (want_pairs, want_cands)
    if hits == "none":
        assert rows.shape == (0, 5) and pairs == cands == 0
    elif hits == "cut":
        assert pairs > 0 and cands == 0 and rows.shape[0] == 0
    else:
        assert cands > 0 and rows.shape[0] > 0


def test_many_lane_tie_order_across_fields_equals_jax(monkeypatch):
    """The many lane keeps the JAX lane's row order where two fields of one
    span tie (ROADMAP queue C, open 2). ``abzz`` and ``bbzz`` both output
    ``zz`` at depth 4; with substitutions and swaps at 0.6, ``bazz`` is one
    swap from ``abzz`` and one substitution from ``bbzz``, so ``zz`` over
    ``bazz`` ties on similarity with different edit counts, and
    ``decode_matches`` keeps the earliest row. Both lanes keep the
    substitution: (2, 3, 7, sim bits 1060320051, insertions 0, deletions 0,
    substitutions 1, swaps 0), the same at (2, 19, 23). The oracle keeps the
    swap there: (2, 3, 7, 1060320051, 0, 0, 0, 1) and (2, 19, 23, ...,
    0, 0, 0, 1); the DP lane (``verify_dp``) keeps the swap too. The test
    holds the port to the reference, not to the oracle. Both lanes run the
    plain chunking at 2 limbs a chunk: the JAX scan in Pallas interpret mode
    is cheap at that width."""
    for mod in (jmany, many):
        monkeypatch.setattr(mod, "MANY_LIMBS", 2)
    monkeypatch.setenv("FAC_MANY_FOLD", "0")
    monkeypatch.setattr(many, "FOLD", False)
    extra = _dictionary(120, seed=7)
    words = ["abzz", "bbzz", "zz"] + extra
    jax_e = (JaxBuilder.new().fuzzy(JaxLimits.new().edits(1))
             .penalties(JaxPenalties().with_substitution(0.6).with_swap(0.6)).build(words))
    port_e = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1))
              .penalties(FuzzyPenalties().with_substitution(0.6).with_swap(0.6))
              .device("cpu").build(words))
    hay = "xx bazz yy abzz ww bazz q"
    jview, view = jax_view_of(hay, False), view_of(hay, False)
    want = sorted(map(_key, jmany.fuzzy_search_many(jax_e, hay, 0.5, jview, len(jview))))
    got = sorted(map(_key, many.fuzzy_search_many(port_e, hay, 0.5, view, len(view))))
    assert port_e.last_stats["backend"] == "device-fuzzy-many"
    assert got == want
    ties = [t for t in got if t[0] == 2 and (t[1], t[2]) in ((3, 7), (19, 23))]
    assert [t[4:] for t in ties] == [(0, 0, 1, 0)] * 2  # the substitution row


def test_many_lane_tie_order_across_ranges(monkeypatch):
    """The tie of ``test_many_lane_tie_order_across_fields_equals_jax`` with
    each hit a range of its own (``many_max_hits`` = 1). Two hits of one
    chunk (ends 5 and 6 of the first ``bazz``, 21 and 22 of the second)
    each emit rows of ``zz`` over its span, a substitution and a swap, so
    the tied rows lie in two ranges. The tuples, edit counts included, are
    the one-range run's, and the tie still keeps the substitution row."""
    monkeypatch.setattr(many, "MANY_LIMBS", 2)
    monkeypatch.setattr(many, "FOLD", False)
    words = ["abzz", "bbzz", "zz"] + _dictionary(120, seed=7)
    port_e = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1))
              .penalties(FuzzyPenalties().with_substitution(0.6).with_swap(0.6))
              .device("cpu").build(words))
    hay = "xx bazz yy abzz ww bazz q bbaz bazzz"
    view = view_of(hay, False)
    one = sorted(map(_key, many.fuzzy_search_many(port_e, hay, 0.5, view, len(view))))
    hits = port_e.last_stats["hits"]
    monkeypatch.setattr(many, "many_max_hits", lambda X, E, nch: 1)
    got = sorted(map(_key, many.fuzzy_search_many(port_e, hay, 0.5, view, len(view))))
    assert port_e.last_stats["backend"] == "device-fuzzy-many" and hits > 2
    assert got == one
    ties = [t for t in got if t[0] == 2 and (t[1], t[2]) in ((3, 7), (19, 23))]
    assert [t[4:] for t in ties] == [(0, 0, 1, 0)] * 2


# ---------------------------------------------------------------------------
# (c) the wide scan
# ---------------------------------------------------------------------------

def _wide_tables(words, k: int, damerau: bool):
    alphabet = sorted(set("".join(words)))
    sym = {c: i + 1 for i, c in enumerate(alphabet)}
    A, ms = len(alphabet) + 1, [len(w) for w in words]
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
    return (tpb._word_table(limb, A, W), tpb._starts_mask(offs, W), match, init, notlast, lut,
            max(ms) + kk)


def test_wide_scan_equal_to_jax_traced_tables():
    """W = 31 limbs (the many1k folded layout's), k = 1 with the Damerau rows
    (a two-letter alphabet keeps the interpreted Pallas body small); hits on
    the first symbols, on the last and in runs."""
    words = _dictionary(228, seed=5, letters="ab")
    word_tbl, starts, match, init, notlast, lut, halo = _wide_tables(words, 1, True)
    W, A = word_tbl.shape[1] // 2, word_tbl.shape[0]
    assert W == 31
    rng = np.random.default_rng(3)
    text = " ".join(words[int(i)] for i in rng.integers(len(words), size=300))[:2001]
    ids = lut[np.frombuffer(text.encode(), np.uint8)]
    n, nb = len(ids), 8192
    NL, TB, chunk, grid = jpb._derive_layout_resident(nb, halo, W, k=1, tables_in_vmem=True,
                                                      damerau=True)
    ids_pad = np.zeros(nb, np.uint8)
    ids_pad[:n] = ids
    count, pos, jw = jpb.packed_hits(
        jnp.asarray(ids_pad), jnp.asarray(word_tbl), jnp.asarray(starts.view(np.int32)),
        jnp.asarray(match.view(np.int32)), jnp.asarray(init.view(np.int32)), A, W, NL, TB, grid,
        chunk, halo, 1, 2048, consts=None, notlast=jnp.asarray(notlast.view(np.int32)))
    count = int(count)
    assert count <= 2048
    pos = np.asarray(pos)[:count].astype(np.int64)
    keep = pos < n
    T = tpb.tables_from_numpy(word_tbl, starts, match, init, notlast)
    before = dict(tpb.LAUNCHES)
    got_count, got_pos, got_words = tpb.packed_hits(torch.from_numpy(ids), T, halo)
    assert tpb.LAUNCHES == before  # CPU tensors run the plain versions
    assert got_pos.tolist() == pos[keep].tolist() and got_count == int(keep.sum()) > 100
    assert {0, 1, n - 1} & set(got_pos.tolist())  # hits at the edges
    assert np.array_equal(got_words.numpy(), np.asarray(jw)[:count][keep].astype(np.int64))


# ---------------------------------------------------------------------------
# (d) the lane against the oracle and the JAX package
# ---------------------------------------------------------------------------

def _lane(engine, hay: str, thr: float):
    view = view_of(hay, True)
    res = many.fuzzy_search_many(engine, hay, thr, view, len(view))
    assert res is not None
    return sorted(map(_key, res)), dict(engine.last_stats)


def test_multi_chunk_plain_lane_matches_oracle(monkeypatch):
    monkeypatch.setattr(many, "MANY_LIMBS", 8)
    monkeypatch.setattr(many, "FOLD", False)
    words = _dictionary(120)
    eng = _port(words)
    assert tpb.packed_fuzzy_of(eng) is None
    hay = _corpus(words, 12_000)
    got, stats = _lane(eng, hay, 0.82)
    assert stats["backend"] == "device-fuzzy-many" and not stats["folded"]
    assert stats["chunks"] == len(many.many_spec_of(eng).chunks) >= 2
    assert got == _oracle_keys(eng, hay, 0.82) and len(got) > 30


def test_fields_shared_across_chunks_collapse_in_the_decode(monkeypatch):
    """Suffix patterns share verify fields with the words they end, and land
    in other chunks: both chunks emit the same rows, which the merged decode
    collapses to the oracle's matches."""
    monkeypatch.setattr(many, "MANY_LIMBS", 8)
    monkeypatch.setattr(many, "FOLD", False)
    words = _dictionary(90, seed=3)
    words = sorted(set(words) | {w[2:] for w in words[:10] if len(w) > 7})
    eng = _port(words)
    spec = many.many_spec_of(eng)
    chunk_of = {int(p): ci for ci, ch in enumerate(spec.chunks) for p in ch[0]}
    shared = [(words.index(w[2:]), words.index(w)) for w in words
              if len(w) > 7 and w[2:] in words]
    assert any(chunk_of[a] != chunk_of[b] for a, b in shared)
    hay = _corpus(words, 8000, seed=5, rate=4)
    view = view_of(hay, True)
    got = many.fuzzy_search_many(eng, hay, 0.8, view, len(view))
    assert eng.last_stats["emissions"] > len(got) > 30
    assert sorted(map(_key, got)) == _oracle_keys(eng, hay, 0.8)


def test_wide_damerau_lane_matches_oracle():
    words = _dictionary(90, seed=13)
    eng = _port(words)
    rng = np.random.default_rng(17)
    parts = []
    for w in words[:40]:
        i = int(rng.integers(1, len(w) - 2))
        parts += [w[:i] + w[i + 1] + w[i] + w[i + 2:], "filler"]
    hay = " ".join(parts)
    got, stats = _lane(eng, hay, 0.8)
    assert stats["damerau"] and many.many_spec_of(eng).W > tpb.MAX_LIMBS
    assert got == _oracle_keys(eng, hay, 0.8) and len(got) > 20


def test_folded_lane_matches_oracle():
    words = _dictionary(400, seed=29)
    eng = _port(words)
    hay = _edited(words, 60, 31)
    got, stats = _lane(eng, hay, 0.8)
    assert stats["folded"] and stats["chunks"] == len(many.many_spec_of(eng, fold=True).chunks)
    assert got == _oracle_keys(eng, hay, 0.8) and len(got) > 30


def test_fold_overflow_reruns_plain_and_remembers(monkeypatch):
    monkeypatch.setattr(many, "FOLD_HIT_CEIL_MIN", 64)
    words = _dictionary(400, seed=37)
    eng = _port(words)
    assert many.many_spec_of(eng, fold=True) is not None
    rng = np.random.default_rng(41)
    hay = " ".join(words[int(rng.integers(len(words)))] for _ in range(150))
    got, stats = _lane(eng, hay, 0.82)
    assert not stats["folded"]
    assert len(eng._many_fold_overflow) == 1
    assert got == _oracle_keys(eng, hay, 0.82) and len(got) >= 150
    # The overflow is remembered for this corpus and threshold only: the
    # next search of it goes straight to the plain chunking, another
    # corpus tries the folded layout again.
    calls = []
    spec_search = many._many_search_spec
    monkeypatch.setattr(many, "_many_search_spec",
                        lambda e, sp, *a: calls.append(sp.folded) or spec_search(e, sp, *a))
    assert _lane(eng, hay, 0.82)[0] == got and calls == [False]
    _lane(eng, hay[:200], 0.82)
    assert calls[1] is True


def test_lane_equal_to_jax_in_tuples_and_stats(monkeypatch):
    """The whole JAX lane once, on 4 KB: three plain chunks (limb budget 2)."""
    monkeypatch.setattr(jmany, "MANY_LIMBS", 2)
    monkeypatch.setattr(many, "MANY_LIMBS", 2)
    monkeypatch.setenv("FAC_MANY_FOLD", "0")
    monkeypatch.setattr(many, "FOLD", False)
    words = _dictionary(40, seed=29)
    hay = _corpus(words, 4000, rate=5)
    jeng, eng = _jax(words), _port(words)
    jview = jax_view_of(hay, True)
    want = jmany.fuzzy_search_many(jeng, hay, 0.8, jview, len(jview))
    got, stats = _lane(eng, hay, 0.8)
    assert got == sorted(map(_key, want)) and len(got) > 50
    assert stats == jeng.last_stats and stats["chunks"] >= 3


@pytest.mark.parametrize("range_hits", [1, 3])
def test_lane_runs_long_hit_lists_in_ranges(monkeypatch, range_hits):
    """Past the int32 bound of the counts (``many_max_hits``) a chunk's hit
    list is expanded and verified in ranges, each handed its preceding hit:
    the same matches, candidates and emissions as in one range, hit runs cut
    between two ranges included (the dedup sees across the cut)."""
    words = _dictionary(120)
    hay = _corpus(words, 3000) + " " + words[3] + words[3][-1] * 3
    want, want_stats = _lane(_port(words), hay, 0.82)
    calls = []
    expand = many.expand_candidates_sparse
    monkeypatch.setattr(many, "many_max_hits", lambda X, E, nch: range_hits)
    monkeypatch.setattr(many, "expand_candidates_sparse",
                        lambda *a: calls.append(a[-1]) or expand(*a))
    got, stats = _lane(_port(words), hay, 0.82)
    assert got == want and stats == want_stats and len(got) > 5
    assert len(calls) >= want_stats["hits"] // range_hits > 5 and set(calls) == {0, 1}


# ---------------------------------------------------------------------------
# (e) routing, kernel entries
# ---------------------------------------------------------------------------

def test_device_backend_routes_to_the_lane():
    words = _dictionary(120)
    hay = _corpus(words, 3000)
    want = None
    for beam in (False, True):
        eng = _port(words, beam=beam)
        assert eng._device_engine().supports(hay)
        assert JaxDeviceEngine(_jax(words)).supports(hay)
        got = sorted(map(_key, eng.search_raw(hay, 0.82)))
        assert eng.last_stats["backend"] == "device-fuzzy-many"
        assert want is None or got == want
        want = got
    assert want == _oracle_keys(_port(words), hay, 0.82) and len(want) > 5


def test_past_the_pattern_gate_raises_the_beam_lanes_error():
    """The JAX package's 4095-pattern gate (its rows hold the pattern id in
    12 bits) is not the port's: a 4,200-word ``edits(1)`` engine runs on the
    large-dictionary lane and equals the oracle and the JAX package (whose
    host path serves a haystack under ``AUTO_DEVICE_MIN``)."""
    words = [f"{a}{b}{c}word" for a in LETTERS for b in LETTERS for c in LETTERS[:7]][:4200]
    eng = _port(words)
    assert len(words) == 4200 and many.many_spec_of(eng) is not None
    hay = "abcword and xyzwrod zzgword zgzword qqaword " * 3
    got = sorted(map(_key, eng.search_raw(hay, 0.8)))
    assert eng.last_stats["backend"] == "device-fuzzy-many"
    jax_e = JaxBuilder.new().fuzzy(JaxLimits.new().edits(1)).case_insensitive(True).build(words)
    jax_e.backend = "auto"
    assert got == sorted(map(_key, jax_e.search_raw(hay, 0.8)))
    assert got == _oracle_keys(eng, hay, 0.8) and len(got) > 10


def test_c_entries_match_their_ctypes_signatures():
    """Every ``fac_*`` entry of ``csrc/*.cu`` has the argument types its
    ``_SIGNATURES`` row gives ctypes (a wrong row would pass a pointer as a
    32-bit int, which only the card would show)."""
    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "long long": ctypes.c_longlong, "int": ctypes.c_int, "float": ctypes.c_float}
    found = {}
    for src in _cuda_build.SOURCES:
        text = src.read_text()
        for mo in re.finditer(r"^int (fac_\w+)\(([^)]*)\)", text[text.index('extern "C" {'):],
                              re.M):
            found[mo.group(1)] = [ctype[re.sub(r"\s*\w+$", "", p.strip())]
                                  for p in mo.group(2).split(",") if p.strip()]
    assert set(found) == set(_cuda_build._SIGNATURES)
    for name, argtypes in _cuda_build._SIGNATURES.items():
        assert argtypes == found[name], name
