"""Frozen copies of the seeded corpus and dictionary recipes.

Copied from ``chip_smoke.py`` (the port's correctness run) so that later
changes there cannot move the benchmark's inputs:

* ``build_corpus``: ``chip_smoke.py:392-406`` (the headline lorem recipe),
  with its word lists and needle rate as arguments;
* ``edit``: ``chip_smoke.py:409-413``;
* ``many_words``: ``chip_smoke.py:1064-1073`` (``bench.py:187-193``);
* ``many_corpus``: ``chip_smoke.py:1076-1090`` (``bench.py:194-208``),
  with the words' order drawn from a seed where one is given;
* ``plant_phrases``: ``chip_smoke.py:4341-4358``, with the copies drawn
  from a seed of their own where one is given.

Each takes its generator's seed, which may be an int or a sequence of ints
(``numpy.random.default_rng`` accepts both).
"""

from __future__ import annotations

import numpy as np


def build_corpus(size: int, seed, filler, needles, needle_one_in: int = 997) -> str:
    """Filler words with one of ``needles`` at 1 in ``needle_one_in``,
    space-joined, ``size`` characters, drawn vectorised from ``seed``."""
    rng = np.random.default_rng(seed)
    vocab = list(filler) + list(needles)
    mean = sum(len(w) + 1 for w in filler) / len(filler)
    count = int(size / mean * 1.02) + 1024
    idx = rng.integers(len(filler), size=count)
    needle = rng.integers(needle_one_in, size=count) == 0
    idx[needle] = len(filler) + rng.integers(len(needles), size=int(needle.sum()))
    lens = np.array([len(w) + 1 for w in vocab])[idx]
    keep = int(np.searchsorted(np.cumsum(lens), size)) + 2
    return " ".join([vocab[i] for i in idx[:keep].tolist()])[:size]


def edit(w: str, rng) -> str:
    """One substitution, deletion, insertion or adjacent swap inside ``w``."""
    i, op = int(rng.integers(1, len(w) - 2)), int(rng.integers(4))
    return [w[:i] + "x" + w[i + 1:], w[:i] + w[i + 1:], w[:i] + "q" + w[i:],
            w[:i] + w[i + 1] + w[i] + w[i + 2:]][op]


def many_words(count: int, seed, length=(6, 12), letters="abcdefghijklmnopqrstuvwxyz"):
    """``count`` random words with lengths in ``length`` (a half-open range),
    sorted, duplicates dropped."""
    rng = np.random.default_rng(seed)
    return sorted({
        "".join(letters[i] for i in rng.integers(0, len(letters), size=int(m)))
        for m in rng.integers(*length, size=count)
    })


def many_corpus(corpus: str, words, typos: int, min_length: int = 9, order_seed=None) -> str:
    """``corpus`` with ``typos`` one-substitution typos (third letter) of the
    words of ``min_length`` or more letters, each between spaces, at a fixed
    step; with ``order_seed`` the words are cycled in an order drawn from it
    (the same typos, in another order)."""
    long_pats = [p for p in words if len(p) >= min_length]
    if order_seed is not None:
        long_pats = [long_pats[i] for i in np.random.default_rng(order_seed).permutation(
            len(long_pats))]
    buf = bytearray(corpus.encode())
    step = max(1, len(buf) // typos)
    for j in range(typos):
        p = long_pats[j % len(long_pats)]
        w = (" " + p[:2] + ("x" if p[2] != "x" else "y") + p[3:] + " ").encode()
        at = 100 + j * step
        if at + len(w) >= len(buf):
            break
        buf[at:at + len(w)] = w
    return buf.decode()


def plant_phrases(text: str, seed, count: int, phrases, edits=(1, 4), rewrite=("m", "rn"),
                  rewrite_every: int = 2, set_seed=None):
    """``text`` (ASCII) with ``count`` of ``phrases`` written over it at
    seeded positions, in every ``rewrite_every``-th copy each ``rewrite[0]``
    written ``rewrite[1]`` first, then ``edits[0]``-``edits[1]`` ``edit()``s.
    With ``set_seed`` the copies (phrase, rewrite, edits) are drawn from it
    and only their order and positions from ``seed``: every seed plants the
    same copies. Returns (text, [(start, end)] of the copies)."""
    rng = np.random.default_rng(seed)
    buf = bytearray(text.encode())
    spans = []
    draw = rng if set_seed is None else np.random.default_rng(set_seed)
    places = rng.integers(0, len(buf) - 64, size=count).tolist()
    copies = []
    for j in range(count):
        w = phrases[int(draw.integers(len(phrases)))]
        if rewrite_every and j % rewrite_every == rewrite_every - 1:
            w = w.replace(rewrite[0], rewrite[1])
        for _ in range(int(draw.integers(edits[0], edits[1] + 1))):
            w = edit(w, draw)
        copies.append(w)
    if set_seed is not None:
        copies = [copies[i] for i in rng.permutation(count)]
    for at, w in zip(places, copies):
        buf[at:at + len(w)] = w.encode()
        spans.append((at, at + len(w)))
    return buf.decode(), spans
