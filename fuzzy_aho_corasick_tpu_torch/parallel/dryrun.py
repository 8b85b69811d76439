"""Multi-device dry run: the sharded searches on small inputs, each held
against the oracle (the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``). Run it on every card of the host
with::

    python -c "from fuzzy_aho_corasick_tpu_torch.parallel.dryrun import dryrun_multichip; \\
    import torch; dryrun_multichip(torch.cuda.device_count())"
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

DEMO_WORDS = [
    "needle", "pattern", "automaton", "fuzzy", "match", "grapheme",
    "similarity", "threshold", "corpus", "stream", "window", "shard",
]


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, mesh: Optional[Sequence] = None) -> dict:
    """The exact, fuzzy, typed and mapped sharded searches over an
    ``n_devices``-shard mesh (``mesh``, else ``default_mesh(n_devices)``),
    each equal to the oracle on the same text, with needles across shard
    boundaries; raises on the first disagreement. Returns the match counts
    and the exact lane's summed emissions."""
    from .. import FuzzyAhoCorasickBuilder, FuzzyLimits
    from .shard_search import default_mesh, sharded_exact_search, sharded_fuzzy_search

    mesh = default_mesh(n_devices) if mesh is None else list(mesh)
    _require(len(mesh) == n_devices, f"expected {n_devices} devices, got {len(mesh)}")
    key = lambda m: (m.start, m.end, m.pattern_index,
                     np.float32(m.similarity).view(np.uint32).item(),
                     m.insertions, m.deletions, m.substitutions, m.swaps)

    def check(engine, text, thr, search, what, floor):
        got = search(engine, text, thr, mesh)
        _require(got is not None, f"{what}: the sharded lane declined")
        stats = dict(engine.last_stats)
        engine.backend = "oracle"
        truth = sorted(map(key, engine.search_raw(text, thr)))
        _require(sorted(map(key, got)) == truth,
                 f"{what}: {len(got)} sharded matches, {len(truth)} from the oracle")
        _require(len(truth) >= floor, f"{what}: {len(truth)} matches, fewer than {floor}")
        return len(truth), stats

    counts = {}
    exact = FuzzyAhoCorasickBuilder.new().case_insensitive(True).build(DEMO_WORDS)
    text = ("the needle in the fuzzy corpus stream " * 64)[: n_devices * 256]
    counts["exact"], stats = check(exact, text, 0.5, sharded_exact_search, "exact", 1)
    _require(stats["emissions"] == counts["exact"], "summed emissions != matches")

    def fuzzy(limits, words, mappings=()):
        b = FuzzyAhoCorasickBuilder.new().fuzzy(limits).case_insensitive(True)
        for a, c in mappings:
            b = b.mapping(a, c)
        return b.build(words)

    for what, engine, text, thr, floor in (
        ("fuzzy", fuzzy(FuzzyLimits.new().edits(1), ["needle", "pattern"]),
         ("pad words " * 13 + "nedle ") * (4 * n_devices), 0.72, 4 * n_devices),
        ("typed", fuzzy(FuzzyLimits.new().edits(2).swaps(0), ["needle", "pattern"]),
         ("pad words " * 13 + "nedle ") * (3 * n_devices), 0.6, 3 * n_devices),
        ("mapped", fuzzy(FuzzyLimits.new().edits(1), ["modern", "pattern"], [("rn", "m")]),
         ("pad words " * 11 + "modem morn ") * (3 * n_devices), 0.6, 3 * n_devices),
    ):
        counts[what], stats = check(engine, text, thr, sharded_fuzzy_search, what, floor)
        _require(stats["backend"] == "device-fuzzy-sharded" and stats["shards"] == n_devices,
                 f"{what}: last_stats {stats}")
    return counts
