"""The wide packed scan (W = 9..64 limbs, and every W past six error rows)
on the CPU, where ``packed_hits`` runs the plain versions of
``scan_bits_wide_kernel`` and ``hit_words_wide_kernel``.

(a) At every edge of the k = 0 instance table (chains of 8 lanes of
    ceil(W / 8) limbs) and at W = 43 (the exact-wide dictionary's width),
    the hit positions and match words equal an independent numpy brute
    force: each field's symbols compared at every end position, setting the
    field's last bit in its limb; hits on the first symbol, on the last and
    across a 16,384-symbol tile edge.
(b) At W = 43 and W = 9, traced tables, the plain versions equal the JAX
    ``packed_hits`` (``consts=None``, Pallas in interpret mode).
(c) ``wide_scan_instance``, the Python mirror of the kernels' instance
    table, covers W with at most 7 padded limbs at k = 0 and 31 at k >= 1.
(d) Past the one-thread kernels' six rows (the wide kernels' deep
    instances, every W): at k = 8 and 13, W = 1 and 9, with and without
    the Damerau rows, the plain scan and replay equal the JAX
    ``packed_hits``; ``wide_scan_instance`` covers W = 1..64 at k = 7..24.
(e) The deep replay's design (``replay_deep`` in ``csrc/scan_wide.cu``: a
    grid striding over the items (hit i // W, limb i % W) of the whole hit
    list, each replaying all rows of its template (the multiple of 4 >= k)
    with no match word read during the replay and ANDing the match rows up
    to k once after it, its two halves at words[2 i]), modelled in numpy,
    equals the plain replay at k = 7, 8, 12,
    13 and 24, W = 1, 6 and 33, with and without the Damerau rows.
(f) At W = 33 and k = 24 the plain scan and replay equal an edit-distance
    brute force: a field's last bit is set at an end position where its
    Levenshtein distance to some text span ending there is at most k.

Inputs are made with numpy from a seed; the tolerance is exact equality
(the scan is integer)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu.ops import packed_bitap as jpb
from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)

#: Edges of the k = 0 instance table (LPL = 2..8 limbs per lane) and W = 43.
K0_EDGES = (9, 16, 17, 24, 25, 32, 33, 40, 41, 43, 48, 49, 56, 57, 64)


def _tables(W: int, A: int, seed: int):
    """Exact (k = 0) tables of exactly ``W`` limbs over symbols 1..A-1: a
    one-symbol field of symbol A - 1 first, then random words of 6-14
    symbols of 1..A-2, packed until the next one would open limb W. Returns
    (ScanTables, numpy word table [A, 2W], starts, match, init, fields as
    (symbols, limb, bit offset), halo)."""
    rng = np.random.default_rng(seed)
    words = [[A - 1]]
    while True:
        w = rng.integers(1, A - 1, size=int(rng.integers(6, 15))).tolist()
        offs = tpb._pack_fields([len(x) for x in words + [w]])
        if max(lw for lw, _ in offs) + 1 > W:
            break
        words.append(w)
    ms = [len(w) for w in words]
    offs = tpb._pack_fields(ms)
    assert max(lw for lw, _ in offs) + 1 == W
    limb = np.zeros((A, W), np.uint64)
    for w, (lw, lo) in zip(words, offs):
        for i, c in enumerate(w):
            limb[c, lw] |= np.uint64(1) << np.uint64(lo + i)
    match, init, _k = tpb.fuzzy_masks(offs, ms, W, [0] * len(words))
    word_tbl, starts = tpb._word_table(limb, A, W), tpb._starts_mask(offs, W)
    T = tpb.tables_from_numpy(word_tbl, starts, match, init)
    fields = [(w, lw, lo) for w, (lw, lo) in zip(words, offs)]
    return T, word_tbl, starts, match, init, fields, max(ms)


def _brute_force(ids: np.ndarray, fields, W: int):
    """(end positions ascending, [count, W] u64 words): every end position
    of every field's symbols in ``ids``, with the field's last bit set in
    its limb."""
    words = np.zeros((len(ids), W), np.uint64)
    for syms, lw, lo in fields:
        m = len(syms)
        if m > len(ids):
            continue
        win = np.lib.stride_tricks.sliding_window_view(ids, m)
        ends = np.nonzero((win == np.asarray(syms, np.uint8)).all(axis=1))[0] + m - 1
        words[ends, lw] |= np.uint64(1) << np.uint64(lo + m - 1)
    pos = np.nonzero(words.any(axis=1))[0]
    return pos, words[pos]


def _limb_words(words: torch.Tensor) -> np.ndarray:
    """int64 [count, 2W] u32 halves -> u64 [count, W]."""
    a = words.numpy().astype(np.uint64)
    return a[:, 0::2] | (a[:, 1::2] << np.uint64(32))


@pytest.mark.parametrize("W", K0_EDGES)
def test_k0_hits_equal_brute_force(W):
    A = 8
    T, _tbl, _st, _m, _i, fields, halo = _tables(W, A, seed=100 + W)
    rng = np.random.default_rng(W)
    n = tpb.SCAN_BLOCK_SYMS + 1500
    ids = rng.integers(0, A - 1, size=n).astype(np.uint8)  # symbol A - 1 only where planted
    for at in rng.integers(0, n - 16, size=n // 60).tolist():
        syms = fields[int(rng.integers(1, len(fields)))][0]
        ids[at:at + len(syms)] = syms
    longest = max((f[0] for f in fields), key=len)
    L, edge = len(longest), tpb.SCAN_BLOCK_SYMS
    ids[edge - L // 2:edge - L // 2 + L] = longest  # across the tile edge
    ids[n - 1 - L:n - 1] = longest                 # ending one before the last symbol
    ids[0] = ids[n - 1] = A - 1                    # the one-symbol field, first and last
    want_pos, want_words = _brute_force(ids, fields, W)
    count, pos, words = tpb.packed_hits(torch.from_numpy(ids), T, halo)
    assert count == len(want_pos) > 100
    assert {0, edge - L // 2 + L - 1, n - 2, n - 1} <= set(pos.tolist())
    assert pos.tolist() == want_pos.tolist()
    assert np.array_equal(_limb_words(words), want_words)


@pytest.mark.parametrize("W", (43, 9))
def test_k0_plain_equal_to_jax_traced_tables(W):
    """The exact-wide width and the narrowest wide one, over a two-letter
    alphabet (symbols 1, 2; the one-symbol field takes 3), which keeps the
    interpreted Pallas body small; the dictionary's words planted at 1 in
    60 positions."""
    A = 4
    T, tbl, starts, match, init, fields, halo = _tables(W, A, seed=W)
    rng = np.random.default_rng(7 + W)
    n, nb = 3001, 4096
    ids = rng.integers(0, A - 1, size=n).astype(np.uint8)
    for at in rng.integers(0, n - 16, size=n // 60).tolist():
        syms = fields[int(rng.integers(1, len(fields)))][0]
        ids[at:at + len(syms)] = syms
    ids[0] = ids[n - 1] = A - 1
    NL, TB, chunk, grid = jpb._derive_layout_resident(nb, halo, W, k=0, tables_in_vmem=True)
    ids_pad = np.zeros(nb, np.uint8)
    ids_pad[:n] = ids
    count, pos, jw = jpb.packed_hits(
        jnp.asarray(ids_pad), jnp.asarray(tbl), jnp.asarray(starts.view(np.int32)),
        jnp.asarray(match.view(np.int32)), jnp.asarray(init.view(np.int32)), A, W, NL, TB, grid,
        chunk, halo, 0, 4096, consts=None)
    count = int(count)
    assert count <= 4096
    pos = np.asarray(pos)[:count].astype(np.int64)
    keep = pos < n
    before = dict(tpb.LAUNCHES)
    got_count, got_pos, got_words = tpb.packed_hits(torch.from_numpy(ids), T, halo)
    assert tpb.LAUNCHES == before  # CPU tensors run the plain versions
    assert got_pos.tolist() == pos[keep].tolist() and got_count == int(keep.sum()) > 100
    assert {0, n - 1} <= set(got_pos.tolist())
    assert np.array_equal(got_words.numpy(), np.asarray(jw)[:count][keep].astype(np.int64))


@pytest.mark.parametrize("k", range(tpb.MAX_K + 1))
def test_wide_scan_instance_covers_every_width(k):
    padded = []
    for W in range(tpb.MAX_LIMBS + 1, tpb.MAX_SCAN_LIMBS + 1):
        lpl, g = tpb.wide_scan_instance(W, k)
        assert lpl * g >= W
        padded.append(lpl * g - W)
        if k == 0:
            assert g == tpb.WIDE_K0_LANES and 2 <= lpl <= 8
        else:
            assert (lpl, g) in ((2, 8), (4, 8), (4, 16))
    assert max(padded) == (7 if k == 0 else 31)
    for W in (tpb.MAX_LIMBS, tpb.MAX_SCAN_LIMBS + 1):
        with pytest.raises(ValueError):
            tpb.wide_scan_instance(W, k)


# ---------------------------------------------------------------------------
# Past the one-thread kernels' six rows (k = 7..24): the wide kernels' deep
# instances, at every W
# ---------------------------------------------------------------------------

def _deep_tables(W: int, k: int, damerau: bool, A: int, seed: int, length=None):
    """Tables of exactly ``W`` limbs at ``k`` error rows: random words of
    ``length`` = (shortest, longest + 1) symbols of 1..A-1, by default k + 8
    to k + 23 (longer than k, so that a hit is not every position), packed
    until the next one would open limb W. Returns (ScanTables, numpy word
    table, starts, match, init, notlast or None, words, halo)."""
    rng = np.random.default_rng(seed)
    lo, hi = length or (k + 8, min(k + 24, 65))
    words = []
    while True:
        w = rng.integers(1, A, size=int(rng.integers(lo, hi))).tolist()
        offs = tpb._pack_fields([len(x) for x in words + [w]])
        if max(lw for lw, _ in offs) + 1 > W:
            break
        words.append(w)
    ms = [len(w) for w in words]
    offs = tpb._pack_fields(ms)
    assert max(lw for lw, _ in offs) + 1 == W
    limb = np.zeros((A, W), np.uint64)
    for w, (lw, lo) in zip(words, offs):
        for i, c in enumerate(w):
            limb[c, lw] |= np.uint64(1) << np.uint64(lo + i)
    match, init, kk = tpb.fuzzy_masks(offs, ms, W, [k] * len(words))
    assert kk == k
    notlast = tpb.notlast_mask(offs, ms, W) if damerau else None
    word_tbl, starts = tpb._word_table(limb, A, W), tpb._starts_mask(offs, W)
    T = tpb.tables_from_numpy(word_tbl, starts, match, init, notlast)
    return T, word_tbl, starts, match, init, notlast, words, max(ms) + k


@pytest.mark.parametrize("damerau", (False, True))
@pytest.mark.parametrize("k", (8, 13))
@pytest.mark.parametrize("W", (1, 9))
def test_deep_plain_equal_to_jax_traced_tables(W, k, damerau):
    """k = 8 (the K = 12 row template) and 13 (K = 24), one limb and the
    narrowest wide table, with and without the Damerau rows: the plain scan
    and replay, which the deep instances are held to on the card, equal
    the JAX ``packed_hits`` (traced tables, Pallas in interpret mode) over
    3,001 symbols of an 8-symbol alphabet with the words planted at 1 in 50
    positions, each with up to k substitutions."""
    A = 8
    T, tbl, starts, match, init, notlast, words, halo = _deep_tables(W, k, damerau, A,
                                                                     seed=10 * W + k)
    assert T.k == k > tpb.MAX_K and T.damerau == damerau
    rng = np.random.default_rng(3 * W + k)
    n, nb = 3001, 8192  # 128 JAX lanes of 64 >= halo symbols
    ids = rng.integers(0, A, size=n).astype(np.uint8)
    for at in rng.integers(0, n - 64, size=n // 50).tolist():
        w = list(words[int(rng.integers(len(words)))])
        for _ in range(int(rng.integers(0, k + 1))):
            w[int(rng.integers(len(w)))] = int(rng.integers(1, A))
        ids[at:at + len(w)] = w
    NL, TB, chunk, grid = jpb._derive_layout_resident(nb, halo, W, k=k, tables_in_vmem=True,
                                                      damerau=damerau)
    ids_pad = np.zeros(nb, np.uint8)
    ids_pad[:n] = ids
    i32 = lambda a: jnp.asarray(np.ascontiguousarray(a).view(np.int32))
    count, pos, jw = jpb.packed_hits(
        jnp.asarray(ids_pad), jnp.asarray(tbl), i32(starts), i32(match), i32(init), A, W, NL, TB,
        grid, chunk, halo, k, 4096, consts=None,
        notlast=None if notlast is None else i32(notlast))
    count = int(count)
    assert count <= 4096
    pos = np.asarray(pos)[:count].astype(np.int64)
    keep = pos < n
    before = dict(tpb.LAUNCHES)
    got_count, got_pos, got_words = tpb.packed_hits(torch.from_numpy(ids), T, halo)
    assert tpb.LAUNCHES == before  # CPU tensors run the plain versions
    assert got_pos.tolist() == pos[keep].tolist() and got_count == int(keep.sum())
    assert 100 < got_count < n  # not every position
    assert np.array_equal(got_words.numpy(), np.asarray(jw)[:count][keep].astype(np.int64))


@pytest.mark.parametrize("k", range(tpb.MAX_K + 1, tpb.MAX_SCAN_K + 1))
def test_wide_scan_instance_past_six_rows_covers_every_width(k):
    """At k = 7..24 the wide kernels take every W = 1..64: one limb a lane
    and the least power-of-two lane count >= W up to 32 limbs, two limbs on
    32 lanes past it."""
    for W in range(1, tpb.MAX_SCAN_LIMBS + 1):
        lpl, g = tpb.wide_scan_instance(W, k)
        assert lpl * g >= W and g & (g - 1) == 0 and g <= 32
        if W <= 32:
            assert lpl == 1 and g // 2 < W
        else:
            assert (lpl, g) == (2, 32)
    for W in (0, tpb.MAX_SCAN_LIMBS + 1):
        with pytest.raises(ValueError):
            tpb.wide_scan_instance(W, k)
    with pytest.raises(ValueError):
        tpb.wide_scan_instance(1, tpb.MAX_SCAN_K + 1)
    with pytest.raises(ValueError):
        tpb.wide_scan_instance(tpb.MAX_LIMBS, tpb.MAX_K)


def _deep_replay_model(ids: np.ndarray, pos: np.ndarray, T, halo: int,
                       threads: int) -> np.ndarray:
    """What the deep replay's second launch computes, item by item: ``threads``
    threads striding over the items i = (hit i // W, limb i % W) of the hit
    list, each advancing all K + 1 rows of its instance (K the multiple of 4
    >= k, at least 8: ``replay_rows``; the rows past k from zero, and K
    Damerau rows) over the halo symbols ending at its hit from the init
    words, with no match word read during the replay, then ORing (row d &
    match row d) once over d <= k; item i's two u32 halves land at
    words[2 i], words[2 i + 1] of the [hits, 2W] output. Returns u64 [hits,
    W]; every item is written exactly once."""
    u64 = lambda t: t.numpy().view(np.uint64).reshape(-1, T.W)
    W, k, A, n = T.W, T.k, T.A, ids.size
    tbl, starts, match, init = u64(T.tbl), u64(T.starts)[0], u64(T.match), u64(T.init)
    nl = u64(T.notlast)[0] if T.notlast is not None else None
    one = np.uint64(1)
    K = max(8, -(-k // 4) * 4)  # csrc/scan_wide.cu's replay_rows
    flat = np.zeros(2 * pos.size * W, np.uint64)
    written = np.zeros(pos.size * W, np.int64)
    items = pos.size * W
    for t0 in range(threads):  # the grid's threads; each strides by ``threads``
        i = np.arange(t0, items, threads)
        if i.size == 0:
            continue
        h, w = i // W, i % W
        r = [init[d, w].copy() if d <= k else np.zeros(i.size, np.uint64) for d in range(K + 1)]
        dam = [np.zeros(i.size, np.uint64) for _ in range(K + 1)]
        st = starts[w]
        q0 = pos[h] - halo + 1
        for j in range(halo):
            q = q0 + j
            sym = np.where((q >= 0) & (q < n), ids[np.clip(q, 0, n - 1)], 0)
            bc = np.where(sym < A, tbl[np.minimum(sym, A - 1), w], np.uint64(0))
            old = [x.copy() for x in r]
            r[0] = ((old[0] << one) | st) & bc
            for d in range(1, K + 1):
                carry = old[d - 1] | r[d - 1]
                if nl is not None:
                    carry = carry | (dam[d] & bc)
                    dam[d] = ((old[d - 1] << one) | st) & ((bc >> one) & nl[w])
                r[d] = ((old[d] << one) & bc) | (carry << one) | old[d - 1] | st
        out = np.zeros(i.size, np.uint64)
        for d in range(k + 1):
            out |= r[d] & match[d, w]
        flat[2 * i] = out & np.uint64(0xFFFFFFFF)
        flat[2 * i + 1] = out >> np.uint64(32)
        written[i] += 1
    assert (written == 1).all()
    pairs = flat.reshape(pos.size, W, 2)
    return pairs[..., 0] | (pairs[..., 1] << np.uint64(32))


@pytest.mark.parametrize("k", (7, 8, 12, 13, 24))
@pytest.mark.parametrize("W", (1, 6, 33))
def test_deep_replay_model_equals_plain_replay(W, k):
    """(e): 1,500 symbols of an alphabet of 64 with the words planted at 1
    in 40 positions, each with up to k + 4 substitutions; the Damerau rows
    where W + k is odd; a grid of 7 threads (items left over on some)."""
    A, damerau = 64, (W + k) % 2 == 1
    T, _t, _s, _m, _i, _n, words, halo = _deep_tables(W, k, damerau, A, seed=7 * W + k)
    assert T.damerau == damerau
    rng = np.random.default_rng(W * 31 + k)
    n = 1500
    ids = rng.integers(0, A, size=n).astype(np.uint8)
    for at in rng.integers(0, n - 64, size=n // 40).tolist():
        w = list(words[int(rng.integers(len(words)))])
        for _ in range(int(rng.integers(0, k + 5))):
            w[int(rng.integers(len(w)))] = int(rng.integers(1, A))
        ids[at:at + len(w)] = w
    count, pos, words_t = tpb.packed_hits(torch.from_numpy(ids), T, halo)
    assert 10 < count < n
    got = _deep_replay_model(ids, pos.numpy(), T, halo, threads=7)
    assert np.array_equal(got, _limb_words(words_t))


def _sellers(pat, ids: np.ndarray) -> np.ndarray:
    """Per end position of ``ids``, the least Levenshtein distance between
    ``pat`` and a span of ``ids`` ending there (any start)."""
    m = len(pat)
    p = np.asarray(pat)
    idx = np.arange(m + 1)
    col = idx.copy()
    out = np.empty(ids.size, np.int64)
    for t, c in enumerate(ids.tolist()):
        a = np.empty(m + 1, np.int64)
        a[0] = 0
        a[1:] = np.minimum(col[1:] + 1, col[:-1] + (p != c))
        col = np.minimum.accumulate(a - idx) + idx  # the insertions' chain
        out[t] = col[m]
    return out


def test_deep_replay_w33_k24_equals_brute_force():
    """(f): 900 symbols of an alphabet of 64 with the words planted every
    45 symbols, each with up to k + 8 substitutions (some beyond reach)."""
    W, k, A = 33, 24, 64
    T, _t, _s, _m, _i, _n, words, halo = _deep_tables(W, k, False, A, seed=5)
    offs = tpb._pack_fields([len(w) for w in words])
    rng = np.random.default_rng(1)
    n = 900
    ids = rng.integers(1, A, size=n).astype(np.uint8)
    for at in range(10, n - 60, 45):
        w = list(words[int(rng.integers(len(words)))])
        for _ in range(int(rng.integers(0, k + 8))):
            w[int(rng.integers(len(w)))] = int(rng.integers(1, A))
        ids[at:at + len(w)] = w
    want = np.zeros((n, W), np.uint64)
    for w, (lw, lo) in zip(words, offs):
        near = _sellers(w, ids) <= k
        want[near, lw] |= np.uint64(1) << np.uint64(lo + len(w) - 1)
    want_pos = np.nonzero(want.any(axis=1))[0]
    count, pos, words_t = tpb.packed_hits(torch.from_numpy(ids), T, halo)
    assert 50 < count == want_pos.size < n - 100
    assert pos.tolist() == want_pos.tolist()
    assert np.array_equal(_limb_words(words_t), want[want_pos])
