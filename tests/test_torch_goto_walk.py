"""The goto walk's plain version (``ops/exact.goto_walk_torch``, what
``exact.goto_walk`` runs on CPU tensors) against a numpy brute-force trie
walk: the arrivals (start, span, node) in the kernels' order (start, then
span) and the walks alive after each span, at the walk's edges: a start on
the last symbol, length-1 patterns, a match ending exactly at ``n_read``,
fewer starts than symbols read (a shard), a pattern of depth ``L``, a node
the prune ceiling cuts, u8 and int32 symbol ids, no survivor at all and an
empty corpus. The goto tables are the engines' own (``exact.walk_tables``,
the prune mask folded in, and the unmasked table the seed filter walks).
At each of them the folded table the kernels read (``exact.fold_table``:
``2 t + emits[t]`` per edge and the pair table's rows) is walked as the
kernels walk it, in numpy, and must give the same arrivals and alive
counts. ``exact.keep_edge_text`` is the input whose first tile holds
exactly the kept rows a tile has room for and whose second holds one more.
The JAX package's walk is held against the port's in
``tests/test_torch_exact.py`` (``walk-*``), ``tests/test_torch_parallel.py``
and ``tests/test_torch_beam.py``. Inputs are seeded; tolerance: exact."""

import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder
from fuzzy_aho_corasick_tpu_torch.ops import exact
from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)


def _brute(ids, n_starts, n_read, goto, emits, L):
    """Every start walked one symbol at a time in Python."""
    found, alive = [], [0] * L
    for s in range(n_starts):
        node, span = int(goto[0, ids[s]]), 1
        while node >= 0:
            alive[span - 1] += 1
            if emits[node]:
                found.append((s, span, node))
            if span == L or s + span >= n_read:
                break
            node, span = int(goto[node, ids[s + span]]), span + 1
    while alive and alive[-1] == 0:
        alive.pop()
    return found, alive


def _brute_folded(ids, n_starts, n_read, folded, N, C, L):
    """The walk as the kernels make it, from the folded table alone: span 1
    from row 0, span 2 from the pair table's row ``ids[s]`` where it is
    there, later spans from the row of ``entry >> 1``; an entry's low bit
    is the emits flag."""
    pair = C <= exact.WALK_PAIR_MAX
    assert folded.shape == (N + (C if pair else 0), C)
    found, alive = [], [0] * L
    for s in range(n_starts):
        e, span = int(folded[0, ids[s]]), 1
        while e >= 0:
            alive[span - 1] += 1
            if e & 1:
                found.append((s, span, e >> 1))
            if span == L or s + span >= n_read:
                break
            row = N + ids[s] if span == 1 and pair else e >> 1
            e, span = int(folded[row, ids[s + span]]), span + 1
    while alive and alive[-1] == 0:
        alive.pop()
    return found, alive


def _engine(patterns, ci=True):
    return FuzzyAhoCorasickBuilder.new().case_insensitive(ci).device("cpu").build(patterns)


def _ids(engine, hay: str) -> np.ndarray:
    dense = engine.dense
    return np.ascontiguousarray(dense.transcode(hay, view_of(hay, engine.case_insensitive)),
                                dtype=np.uint8 if dense.num_classes <= 256 else np.int32)


def _tables(engine, thr=0.5, masked=True):
    if masked:
        return exact.walk_tables(engine, thr, torch.device("cpu"))
    dense = engine.dense
    goto = torch.from_numpy(np.ascontiguousarray(dense.goto, dtype=np.int32))
    emits = torch.from_numpy(np.asarray(dense.out_count > 0))
    return goto, emits, exact.fold_table(goto, emits)


def _check(engine, ids: np.ndarray, n_starts: int, n_read: int, thr=0.5, masked=True):
    goto, emits, folded = _tables(engine, thr, masked)
    L = max(engine.dense.max_depth, 1)
    before = dict(tpb.LAUNCHES)
    found, alive = exact.goto_walk(torch.from_numpy(ids), n_starts, n_read, goto, emits, L,
                                   folded=folded)
    assert tpb.LAUNCHES == before  # CPU tensors run the plain version
    assert found.dtype == torch.int64 and found.shape[0] == 3
    want, want_alive = _brute(ids, n_starts, n_read, goto.numpy(), emits.numpy(), L)
    assert [tuple(r) for r in found.t().tolist()] == want
    assert alive == want_alive
    assert folded.dtype == torch.int32
    assert _brute_folded(ids, n_starts, n_read, folded.numpy(), *goto.shape, L) == (
        want, want_alive)
    return want, alive


_RNG_LETTERS = "abcz "


def _random_hay(seed: int, n: int, letters=_RNG_LETTERS) -> str:
    rng = np.random.default_rng(seed)
    return "".join(letters[i] for i in rng.integers(len(letters), size=n))


#: Length-1 patterns, prefixes of each other, and one of depth L (4).
_ABC = ["a", "ab", "abc", "bca", "c", "zzzz"]


@pytest.mark.parametrize("cut", ["whole", "shard", "shard-halo-short", "one-start"])
def test_walk_equal_to_brute_force_ascii(cut):
    """u8 ids; the whole stream, and a shard: fewer starts than symbols read,
    with the halo whole or cut short so walks end at ``n_read``."""
    engine = _engine(_ABC)
    hay = _random_hay(1, 3000) + " zzzz abc"
    ids = _ids(engine, hay)
    assert ids.dtype == np.uint8
    n = len(ids)
    n_starts, n_read = {"whole": (n, n), "shard": (1500, 1503),
                        "shard-halo-short": (1500, 1501), "one-start": (1, n)}[cut]
    found, alive = _check(engine, ids, n_starts, n_read)
    assert len(found) > (0 if cut == "one-start" else 100)
    if cut == "whole":
        assert len(alive) == 4  # the depth-L pattern: walks alive at span L
        assert (n - 8, 4) in {(s, span) for s, span, _ in found}


def test_walk_ends_at_the_last_symbol_and_at_n_read():
    """A length-1 match on the last symbol (the last start), a match ending
    exactly at ``n_read``, and one cut by it."""
    engine = _engine(_ABC)
    ids = _ids(engine, "zz bca zzab abca")
    n = len(ids)
    found, _alive = _check(engine, ids, n, n)
    spans = {(s, span) for s, span, _ in found}
    assert (n - 1, 1) in spans  # "a", the last start
    assert (n - 3, 3) in spans  # "bca" ends on the last symbol
    # n_read = n - 1: the last "bca" no longer fits, "abc" (ending on symbol
    # n - 2) does.
    found, _alive = _check(engine, ids, n - 2, n - 1)
    spans = {(s, span) for s, span, _ in found}
    assert (n - 3, 3) not in spans and (n - 4, 3) in spans


def test_walk_with_a_pruned_node():
    """The weights of ``walk-prune-tie``: at threshold 0.578 the prune
    ceiling cuts the 5-grapheme pattern's path (its table entries -1) and
    keeps the 6-grapheme one."""
    thr = np.float32(0.578)
    engine = _engine([("prune", 0.578), ("kepted", 0.578), "tincidunt"])
    hay = " ".join(["prune", "kepted", "tincidunt", "lorem"] * 40)
    ids = _ids(engine, hay)
    goto, _emits, _folded = _tables(engine, thr)
    assert (goto.numpy() < 0).sum() > (engine.dense.goto < 0).sum()  # the mask cut edges
    found, _alive = _check(engine, ids, len(ids), len(ids), thr=thr)
    pats = {int(engine.dense.out_list[node][0]) for _s, _span, node in found}
    assert pats == {1, 2}
    unmasked, _alive = _check(engine, ids, len(ids), len(ids), thr=thr, masked=False)
    assert {int(engine.dense.out_list[node][0]) for _s, _span, node in unmasked} == {0, 1, 2}


def test_walk_int32_ids_past_256_classes():
    cjk = [chr(0x4E00 + 3 * i) for i in range(300)]
    words = ["".join(cjk[i:i + 5]) for i in range(0, 300, 5)] + ["привет", cjk[7]]
    engine = _engine(words)
    assert engine.dense.num_classes > 256
    rng = np.random.default_rng(2)
    parts = [words[i] if i < len(words) else "xyz" for i in rng.integers(len(words) + 20,
                                                                         size=300)]
    ids = _ids(engine, " ".join(parts))
    assert ids.dtype == np.int32
    found, _alive = _check(engine, ids, len(ids), len(ids), masked=False)
    assert len(found) > 200
    _check(engine, ids, len(ids) // 2, len(ids) // 2 + 2)


def test_walk_without_survivors_and_on_an_empty_corpus():
    engine = _engine(_ABC)
    ids = _ids(engine, "xyxy qqq " * 50)
    assert _check(engine, ids, len(ids), len(ids)) == ([], [])
    assert _check(engine, ids[:0], 0, 0) == ([], [])
    assert _check(engine, ids, 0, len(ids)) == ([], [])


def test_walk_tiles_at_the_kept_rows_edge():
    """``keep_edge_text``: tile 0 holds exactly ``WALK_KEEP`` arrivals (its
    rows are copied from the count pass's slots), tile 1 one more (walked
    again), tile 2 none; an "ab" straddles tiles 0 and 1, and a start with
    arrivals at spans 1 and 2 fixes the order within a start."""
    patterns, hay = exact.keep_edge_text()
    engine = _engine(patterns)
    ids = _ids(engine, hay)
    assert len(ids) == 3 * exact.WALK_TILE
    found, _alive = _check(engine, ids, len(ids), len(ids))
    per_tile = np.bincount([s // exact.WALK_TILE for s, _span, _node in found], minlength=3)
    assert per_tile.tolist() == [exact.WALK_KEEP, exact.WALK_KEEP + 1, 0]
    t = exact.WALK_TILE
    assert [(s, span) for s, span, _ in found if t - 2 <= s <= t] == [(t - 1, 1), (t - 1, 2),
                                                                       (t, 1)]
    # The same tiles walked as a shard: fewer starts than symbols read.
    _check(engine, ids, 2 * t - 5, 2 * t)


def test_fold_table():
    """Each edge ``t`` becomes ``2 t + emits[t]``; the pair table's row
    ``c0`` is the folded row of the root's child by ``c0`` (all -1 where
    the root has none); none past ``WALK_PAIR_MAX`` classes."""
    engine = _engine(_ABC)
    goto, emits, folded = _tables(engine)
    N, C = goto.shape
    g, f = goto.numpy(), folded.numpy()
    assert f.shape == (N + C, C) and (g[0] < 0).any()
    want = np.where(g >= 0, 2 * g + emits.numpy()[np.maximum(g, 0)], -1)
    assert (f[:N] == want).all()
    for c0 in range(C):
        assert (f[N + c0] == (want[g[0, c0]] if g[0, c0] >= 0 else -1)).all()
    wide = torch.zeros((5, exact.WALK_PAIR_MAX + 1), dtype=torch.int32)
    assert exact.fold_table(wide, torch.ones(5, dtype=torch.bool)).shape == wide.shape


def test_wrapper_raises_off_the_cpu_and_the_card():
    engine = _engine(_ABC)
    goto, emits, _folded = _tables(engine)
    ids = torch.from_numpy(_ids(engine, "abc abc"))
    with pytest.raises(ValueError, match="meta"):
        exact.goto_walk(ids.to("meta"), 7, 7, goto.to("meta"), emits.to("meta"), 4)
    with pytest.raises(ValueError, match="n_read"):
        exact.goto_walk(ids, 7, 8, goto, emits, 4)
