"""The port's plain shift-AND scan + compaction + replay is bit-equal to the
JAX package's ``packed_hits`` (Pallas in interpret mode on the CPU), for
exact tables and for ``k >= 1`` tables with and without the Damerau rows.

Both sides get the same tables (``tables_from_numpy`` carries the JAX
package's numpy arrays across) and the same symbol stream. The tolerance is
exact: the work is integer and bitwise."""

import functools

import jax
import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder as JaxBuilder
from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits
from fuzzy_aho_corasick_tpu.ops import packed_bitap as jpb
from fuzzy_aho_corasick_tpu.utils.graphemes import view_of
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
N = 6000


def _edit(word: str, op: int, rng) -> str:
    i = int(rng.integers(1, len(word) - 2))
    if op == 1:  # substitution
        return word[:i] + "x" + word[i + 1 :]
    if op == 2:  # deletion
        return word[:i] + word[i + 1 :]
    if op == 3:  # insertion
        return word[:i] + "q" + word[i:]
    if op == 4:  # adjacent transposition
        return word[:i] + word[i + 1] + word[i] + word[i + 2 :]
    return word


def _corpus(seed: int, max_edits: int) -> str:
    """Seeded filler with dictionary words planted at position 0, around
    the plain scan's 256-symbol chunk edges, and at random places; each
    plant carries up to ``max_edits`` edits."""
    rng = np.random.default_rng(seed)
    buf = list(rng.choice(list("aeioulnrstcdmp  "), size=N))
    ends = [None, 255, 256, 257, 511, 512, 1023, N - 1]
    ends += sorted(int(x) for x in rng.integers(40, N - 40, size=40))
    for end in ends:
        w = HEADLINE[int(rng.integers(len(HEADLINE)))]
        for _ in range(int(rng.integers(0, max_edits + 1))):
            w = _edit(w, int(rng.integers(1, 5)), rng)
        start = 0 if end is None else end - len(w) + 1
        buf[start : start + len(w)] = list(w)
    return "".join(buf)[:N]


@functools.partial(
    jax.jit,
    static_argnames=("A", "W", "NL", "TB", "grid", "chunk", "halo", "k", "KH", "consts"),
)
def _jax_packed_hits(ids_pad, tbl, sb, mb, ib, A, W, NL, TB, grid, chunk, halo, k, KH, consts):
    return jpb.packed_hits(
        ids_pad, tbl, sb, mb, ib, A, W, NL, TB, grid, chunk, halo, k, KH, consts=consts
    )


def _case(name):
    """(ids u8 [n], word_tbl, starts, match, init, notlast, halo)."""
    if name == "k0-exact":
        engine = JaxBuilder.new().case_insensitive(True).build(HEADLINE)
        pk = jpb.packed_exact_of(engine)
        hay = _corpus(1, 0)
        ids = pk.transcode(hay, view_of(hay, True), engine.dense)
        init = np.zeros((1, 2 * pk.W), np.uint32)
        return ids, pk.word_tbl, pk.starts, pk.match_mask(), init, None, pk.m_max
    engine = (JaxBuilder.new().fuzzy(JaxLimits.new().edits(2))
              .case_insensitive(True).build(HEADLINE))
    pf = jpb.packed_fuzzy_of(engine)
    if name == "k1-damerau":
        ks, notlast, hay = [1] * len(pf.ms), pf.notlast(), _corpus(2, 1)
    else:  # k2: mixed per-field budgets, no Damerau rows
        ks, notlast, hay = [1 + i % 2 for i in range(len(pf.ms))], None, _corpus(3, 2)
    match, init, k = pf.fuzzy_masks(ks)
    ids = np.ascontiguousarray(pf.filt.transcode(hay)[0], dtype=np.uint8)
    return ids, pf.word_tbl, pf.starts, match, init, notlast, pf.m_max + k


@pytest.mark.parametrize("name", ["k0-exact", "k1-damerau", "k2"])
def test_plain_kernels_bit_equal_to_jax_packed_hits(name):
    ids, word_tbl, starts, match, init, notlast, halo = _case(name)
    k = match.shape[0] - 1
    W = word_tbl.shape[1] // 2
    A = word_tbl.shape[0]

    NL, TB, chunk, grid = jpb._derive_layout(len(ids), halo, W)
    ids_pad = np.zeros(NL * chunk, np.uint8)
    ids_pad[: len(ids)] = ids
    KH = 1 << 13
    consts = jpb.scan_consts(word_tbl, starts, match, init, notlast)
    count, pos, words = _jax_packed_hits(
        jax.device_put(ids_pad), jax.device_put(word_tbl), jpb._bcast(starts, NL),
        jpb._bcast(match, NL), jpb._bcast(init, NL),
        A=A, W=W, NL=NL, TB=TB, grid=grid, chunk=chunk, halo=halo, k=k, KH=KH,
        consts=consts,
    )
    count = int(count)
    assert 0 < count < KH
    want_pos = np.asarray(pos)[:count].astype(np.int64)
    want_words = np.asarray(words)[:count]

    T = tpb.tables_from_numpy(word_tbl, starts, match, init, notlast)
    assert T.damerau == (notlast is not None)
    got_count, got_pos, got_words = tpb.packed_hits(torch.from_numpy(ids_pad), T, halo)
    assert got_count == count
    assert np.array_equal(got_pos.numpy(), want_pos)
    assert np.array_equal(got_words.numpy().astype(np.uint32), want_words)
    # Planted occurrences at the plain scan's chunk edges and at the start.
    assert np.all(np.diff(want_pos) > 0)
    assert want_pos[0] < 16


def test_wrappers_refuse_unknown_devices_and_shapes():
    ids, word_tbl, starts, match, init, _notlast, halo = _case("k0-exact")
    T = tpb.tables_from_numpy(word_tbl, starts, match, init)
    t = torch.from_numpy(ids)
    with pytest.raises(ValueError, match="halo"):
        tpb.scan_bits(t, T, tpb.HALO_MAX + 1)
    with pytest.raises(ValueError, match="uint8"):
        tpb.scan_bits(t.to(torch.int32), T, halo)
    with pytest.raises(ValueError, match="tables on"):
        tpb.scan_bits(t.to("meta"), T, halo)
    before = dict(tpb.LAUNCHES)
    tpb.packed_hits(t, T, halo)
    assert tpb.LAUNCHES == before  # CPU tensors run the plain versions


@pytest.mark.parametrize("n", [1, 2, 31, 1023, 1024, 1025, tpb.OFFSETS_TILE - 1, tpb.OFFSETS_TILE,
                               tpb.OFFSETS_TILE + 1])
def test_block_offsets_equal_to_an_exclusive_scan(n):
    """``block_offsets`` (its plain version, on CPU tensors) is the int32
    exclusive scan of the counts with the total last, at lengths around the
    kernel's warp, block and tile edges."""
    counts = np.random.default_rng(n).integers(0, 60, size=n).astype(np.int32)
    before = dict(tpb.LAUNCHES)
    got = tpb.block_offsets(torch.from_numpy(counts))
    assert tpb.LAUNCHES == before  # no launch counted for the plain version
    assert got.dtype == torch.int32 and got.shape == (n + 1,)
    assert got.tolist() == [0] + np.cumsum(counts, dtype=np.int64).tolist()


def test_block_offsets_checks_its_counts():
    """One count, all zeros, a total just under 2^31; an empty array, other
    dtypes, shapes and devices raise."""
    assert tpb.block_offsets(torch.tensor([7], dtype=torch.int32)).tolist() == [0, 7]
    assert not tpb.block_offsets(torch.zeros(40000, dtype=torch.int32)).any()
    big = torch.full((3,), (1 << 31) // 3 - 1, dtype=torch.int32)
    assert tpb.block_offsets(big)[-1] == 3 * ((1 << 31) // 3 - 1) < 1 << 31
    with pytest.raises(ValueError, match="empty"):
        tpb.block_offsets(torch.zeros(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        tpb.block_offsets(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="int32"):
        tpb.block_offsets(torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        tpb.block_offsets(torch.zeros(8, dtype=torch.int32)[::2])
    with pytest.raises(ValueError, match="no scan kernel"):
        tpb.block_offsets(torch.zeros(4, dtype=torch.int32, device="meta"))
