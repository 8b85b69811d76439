"""The sharded lanes (``parallel/shard_search``), port against the JAX
package's ``parallel/shard_search``, the oracle and the port's own
``search_raw``, on CPU meshes of 1, 2 and 3 shards.

(a) ``sharded_exact_search`` on ``tests/test_sharding.py``'s texts equals
    the JAX ``sharded_exact_search`` over ``default_mesh(n)`` of the
    virtual CPU devices, the oracle and ``search_raw``; the summed count
    (the JAX ``psum``) equals the matches.
(b) ``sharded_fuzzy_search`` for ``edits(1)``, the Damerau swaps case,
    ``edits(2)``, forbid (``edits(2).swaps(0)``), typed limits and mapped
    engines (one at ``edits(4)``, a scan budget of 8 rows, where the lane
    returned None before it took budgets past six rows), the needles
    planted across every shard boundary and the
    Unicode text: equal to the oracle and ``search_raw`` at 1, 2 and 3
    shards, and to the JAX package at 3 shards (one JAX compile per
    engine): pattern, start, end, f32 similarity bits and the four edit
    counts, and ``last_stats`` key for key.
(c) ``None`` and ``[]`` where the JAX package returns them.
(d) The mesh: ``default_mesh`` raises without CUDA; the tables are built on
    the mesh's devices, never by moving the engine.
(e) ``dryrun_multichip`` on CPU meshes.

Both sides get the same inputs. The tolerance is exact equality: the lanes
replay the JAX package's f32 operations in the same order."""

import numpy as np
import pytest
import torch

import fuzzy_aho_corasick_tpu as jax_pkg
import fuzzy_aho_corasick_tpu_torch as port_pkg
from fuzzy_aho_corasick_tpu.parallel import shard_search as jss
from fuzzy_aho_corasick_tpu_torch.ops.packed_bitap import packed_fuzzy_of
from fuzzy_aho_corasick_tpu_torch.parallel import shard_search as pss
from fuzzy_aho_corasick_tpu_torch.parallel.dryrun import dryrun_multichip

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)

SHARDS = (1, 2, 3)


def key(m):
    return (m.start, m.end, m.pattern_index, np.float32(m.similarity).view(np.uint32).item(),
            m.insertions, m.deletions, m.substitutions, m.swaps)


def build(pkg, limits, words, mappings=(), case_insensitive=True):
    """An engine of ``pkg`` (the port's on the CPU): ``limits`` maps a
    ``FuzzyLimits.new()`` to the configuration, None for exact."""
    b = pkg.FuzzyAhoCorasickBuilder.new().case_insensitive(case_insensitive)
    if limits is not None:
        b = b.fuzzy(limits(pkg.FuzzyLimits.new()))
    for a, c in mappings:
        b = b.mapping(a, c)
    if pkg is port_pkg:
        b = b.device("cpu")
    return b.build(words)


def cpu_mesh(n):
    return ["cpu"] * n


def port_truths(engine, text, thr):
    """(the oracle's keys, the port's search_raw keys) for ``text``."""
    engine.backend = "oracle"
    truth = sorted(map(key, engine.search_raw(text, thr)))
    engine.backend = "device"
    single = sorted(map(key, engine.search_raw(text, thr)))
    return truth, single


# ---------------------------------------------------------------------------
# (a) exact
# ---------------------------------------------------------------------------

def _exact_text():
    filler = "xyzzy plugh " * 40
    hay = ""
    for i in range(200):
        hay += filler[: 7 + (i * 13) % 90] + ("needle" if i % 3 else "boundary")
    return hay


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_exact_equal_to_jax_oracle_and_search_raw(shards):
    words = ["needle", "haystack", "boundary"]
    hay = _exact_text()
    port_e = build(port_pkg, None, words)
    got = sorted(map(key, pss.sharded_exact_search(port_e, hay, 0.5, cpu_mesh(shards))))
    stats = port_e.last_stats
    want = sorted(map(key, jss.sharded_exact_search(build(jax_pkg, None, words), hay, 0.5,
                                                    jss.default_mesh(shards))))
    truth, single = port_truths(port_e, hay, 0.5)
    assert got == want == truth == single and len(got) > 100
    assert stats == {"backend": "device-exact-sharded", "shards": shards,
                     "positions": len(hay), "emissions": len(got)}


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_collective_count(shards):
    """The summed per-shard count (the JAX ``psum``) equals the host-side
    emission count."""
    hay = "ab " * 500
    port_e = build(port_pkg, None, ["ab"], case_insensitive=False)
    got = pss.sharded_exact_search(port_e, hay, 0.0, cpu_mesh(shards))
    jax_got = jss.sharded_exact_search(build(jax_pkg, None, ["ab"], case_insensitive=False),
                                       hay, 0.0, jss.default_mesh(shards))
    assert len(got) == len(jax_got) == port_e.last_stats["emissions"] == 500
    assert sorted(map(key, got)) == sorted(map(key, jax_got))


# ---------------------------------------------------------------------------
# (b) fuzzy
# ---------------------------------------------------------------------------

def _variants_text(filler, variants, reps, step, lead=""):
    hay = lead
    for i in range(reps):
        hay += filler[: 5 + (i * step) % 110] + variants[i % len(variants)]
    return hay


#: Length of the three texts of the ``edits(1)`` dictionary below: one
#: length, so the JAX package compiles its sharded step once for the three.
EDITS1_LEN = 3072


def _straddle_text():
    """``nedle`` (one deletion) across every boundary of 2- and 3-shard
    meshes (shard lengths 1,536 and 1,024), and every 256 symbols between."""
    hay = list("." * EDITS1_LEN)
    for b in range(256, EDITS1_LEN, 256):
        hay[b - 2: b + 3] = "nedle"
    return "".join(hay)


def _unicode_text():
    filler = "àbçdé fgh íjk " * 11
    hay = ""
    for i in range(80):
        hay += filler[: 4 + (i * 13) % 100] + ("héllo" if i % 2 else "wörlt")
    return hay


#: name -> (limits, words, mappings, text, threshold, lane of search_raw, floor).
FUZZY = {
    # test_sharding.py's texts; edits1 opens with a deletion and a swap at
    # position 0 (the first shard's zero left halo).
    "edits1": (lambda L: L.edits(1), ["needle", "haystack", "boundary"], (),
               _variants_text("xyzzy plugh qwertz " * 9,
                              ["needle", "nedle", "neXdle", "neddle", "boundray", "boundary"],
                              150, 17, lead="eedle enedle ")[:EDITS1_LEN],
               0.72, "device-fuzzy-dp", 40),
    "damerau-swaps": (lambda L: L.edits(1), ["needle", "haystack", "boundary"], (),
                      "".join("xyzzy plugh qwertz "[: 4 + (i * 13) % 15]
                              + ("needel" if i % 2 else "boundray")
                              for i in range(300))[:EDITS1_LEN],
                      0.72, "device-fuzzy-dp", 100),
    "edits2": (lambda L: L.edits(2), ["needle", "haystack", "boundary"], (),
               ("pad " * 101 + "nele ") * 12, 0.55, "device-fuzzy-dp", 12),
    "forbid": (lambda L: L.edits(2).swaps(0), ["needle", "pattern"], (),
               ("pad words " * 13 + "nedle ") * 32 + ("x " * 5 + "pattrn ") * 8, 0.6,
               "device-fuzzy-dp-forbid", 32),
    "typed": (lambda L: L.substitutions(1), ["needle", "pattern"], (),
              _variants_text("lorem ipsum dolor " * 7,
                             ["needle", "needlz", "nedle", "pattern", "pXttern"], 90, 13),
              0.7, "device-fuzzy-dp-typed", 50),
    "mapped": (lambda L: L.edits(1), ["strasse"], [("ß", "ss")],
               ("wort satz " * 11 + "straße ") * 24 + "strasse am ende", 0.6,
               "device-fuzzy-dp-mapped", 24),
    # A scan budget of 2E = 8 rows, past the one-thread scan's six; the
    # words are longer than 8, so that a hit is not every position (the
    # hit count then does not depend on the buffers' padding).
    "mapped-edits4": (lambda L: L.edits(4), ["weissbier", "grossbaum"], [("ß", "ss")],
                      ("wort satz " * 2 + "weißbier großbaum grosbaum ") * 12, 0.6,
                      "device-fuzzy-dp-mapped", 24),
    "straddle": (lambda L: L.edits(1), ["needle", "haystack", "boundary"], (),
                 _straddle_text(), 0.72, "device-fuzzy-dp", 11),
    "unicode": (lambda L: L.edits(1), ["héllo", "wörld"], (), _unicode_text(), 0.7,
                "device-fuzzy-dp", 50),
}

#: Configurations that share edits1's engine: the JAX package then reuses
#: its compiled step for their texts of one length and threshold.
SAME_ENGINE = {"damerau-swaps": "edits1", "straddle": "edits1"}
#: The JAX package's engines and results at 3 shards.
_JAX_ENGINES, _JAX = {}, {}


def _jax_sharded(name, port_stats):
    """The JAX package's sharded search of case ``name`` at 3 shards (keys,
    stats), once per process. Its step starts at capacities no shard of
    this text passes, the port's totals over the shards (``port_stats``):
    the results do not depend on them, and its interpret-mode step then
    does a few thousand items' work where its default capacities for a
    short text made tens of thousands."""
    if name not in _JAX:
        limits, words, maps, text, thr, _lane, _floor = FUZZY[name]
        cfg = SAME_ENGINE.get(name, name)
        if cfg not in _JAX_ENGINES:
            _JAX_ENGINES[cfg] = build(jax_pkg, limits, words, maps)
        eng = _JAX_ENGINES[cfg]
        # The lane's capacity key: (devices, shard length), the shard length
        # as the lane sizes it for the text's graphemes.
        n, n_dev = port_stats["positions"], 3
        shard_len = max(128, -(-(-(-n // n_dev)) // 128) * 128)
        caps = getattr(eng, "_shard_fuzzy_caps", None)
        if caps is None:
            caps = eng._shard_fuzzy_caps = {}
        for cap, stat in (("KH", "hits"), ("CAND", "candidates"), ("KG", "emissions")):
            caps.setdefault((cap, n_dev, shard_len), max(port_stats[stat], 1))
        got = jss.sharded_fuzzy_search(eng, text, thr, jss.default_mesh(3))
        _JAX[name] = (sorted(map(key, got)), dict(eng.last_stats))
    return _JAX[name]


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("name", list(FUZZY))
def test_sharded_fuzzy_equal_to_jax_oracle_and_search_raw(name, shards):
    limits, words, maps, text, thr, lane, floor = FUZZY[name]
    port_e = build(port_pkg, limits, words, maps)
    got = pss.sharded_fuzzy_search(port_e, text, thr, cpu_mesh(shards))
    assert got is not None
    stats = dict(port_e.last_stats)
    truth, single = port_truths(port_e, text, thr)
    assert port_e.last_stats["backend"] == lane
    assert sorted(map(key, got)) == truth == single and len(truth) >= floor
    assert stats["backend"] == "device-fuzzy-sharded" and stats["shards"] == shards
    assert stats["positions"] == len(text) and stats["matches"] == len(got)
    assert stats["emissions"] >= len(got) and stats["candidates"] >= stats["hits"] > 0
    hb = text.encode("utf-8")
    assert all(hb[m.start:m.end].decode("utf-8") == m.text for m in got)
    if shards == 3:
        want, want_stats = _jax_sharded(name, stats)
        assert sorted(map(key, got)) == want
        assert stats == want_stats


def test_sharded_fuzzy_damerau_budgets_are_smaller():
    """The swaps case scans with the Damerau budgets (a swap = 1 bitap
    error), which the single-device lane picks for swap-permitting
    configurations, and they are smaller than the plain ones."""
    limits, words, _maps, _text, thr, _lane, _floor = FUZZY["damerau-swaps"]
    port_e = build(port_pkg, limits, words)
    pk = packed_fuzzy_of(port_e)
    thr = np.float32(thr)
    kd = max(pk.filt.k_for(bp, thr, damerau=True) for bp in pk.filt.patterns)
    kp = max(pk.filt.k_for(bp, thr) for bp in pk.filt.patterns)
    from fuzzy_aho_corasick_tpu_torch.ops import verify_dp

    plan = verify_dp.dp_plan(port_e, thr, 1024)
    assert kd < kp and plan.dam and plan.k == kd


# ---------------------------------------------------------------------------
# (c) None and [] where the JAX package returns them
# ---------------------------------------------------------------------------

_CJK = ["".join(chr(0x4E00 + (i * 7 + j * 13) % 300) for j in range(4)) for i in range(60)]

#: name -> (limits, words, mappings, text, threshold, JAX result).
DECLINES = {
    "exact engine": (None, ["needle"], (), "a needle", 0.5, None),
    "mapped, combining mark": (lambda L: L.edits(1), ["strasse"], [("ß", "ss")],
                               "straße é strasse", 0.6, None),
    "mapped with type limits": (lambda L: L.edits(2).swaps(0), ["strasse"], [("ß", "ss")],
                                "straße strasse", 0.6, None),
    "pattern past 63 graphemes": (lambda L: L.edits(1), ["a" * 70, "hello"], (),
                                  "hello " * 20, 0.8, None),
    "CJK past 127 symbols": (lambda L: L.edits(1), _CJK, (), "".join(_CJK[:5]), 0.8, None),
    "threshold above 1": (lambda L: L.edits(1), ["needle"], (), "needle nedle", 1.5, []),
    "empty haystack": (lambda L: L.edits(1), ["needle"], (), "", 0.8, []),
}


@pytest.mark.parametrize("name", list(DECLINES))
def test_sharded_fuzzy_declines_where_jax_does(name):
    limits, words, maps, text, thr, want = DECLINES[name]
    jax_got = jss.sharded_fuzzy_search(build(jax_pkg, limits, words, maps), text, thr,
                                       jss.default_mesh(3))
    got = pss.sharded_fuzzy_search(build(port_pkg, limits, words, maps), text, thr,
                                   cpu_mesh(3))
    assert jax_got == got == want


def test_sharded_fuzzy_without_matches_has_the_jax_stats():
    """No emission in any shard: ``[]`` and the JAX package's three keys (on
    edits1's engine and text length, so the JAX package reuses its step)."""
    limits, words, _maps, _text, thr, _lane, _floor = FUZZY["edits1"]
    text = ("lorem ipsum " * 300)[:EDITS1_LEN]
    port_e = build(port_pkg, limits, words)
    pss.sharded_fuzzy_search(port_e, FUZZY["edits1"][3], thr, cpu_mesh(3))
    _jax_sharded("edits1", port_e.last_stats)
    jax_e = _JAX_ENGINES["edits1"]
    assert jss.sharded_fuzzy_search(jax_e, text, thr, jss.default_mesh(3)) == []
    assert pss.sharded_fuzzy_search(port_e, text, thr, cpu_mesh(3)) == []
    assert port_e.last_stats == jax_e.last_stats == {
        "backend": "device-fuzzy-sharded", "shards": 3, "matches": 0}


# ---------------------------------------------------------------------------
# (d) the mesh
# ---------------------------------------------------------------------------

def test_default_mesh_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        pss.default_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        pss.default_mesh(2)
    engine = build(port_pkg, lambda L: L.edits(1), ["needle"])
    with pytest.raises(RuntimeError, match="CUDA"):
        pss.sharded_fuzzy_search(engine, "a needle", 0.8)
    with pytest.raises(RuntimeError, match="cuda"):
        pss.sharded_exact_search(engine, "a needle", 0.8, ["cuda:0", "cuda:0"])


def test_mesh_tables_live_on_the_mesh_devices():
    """A CPU mesh serves an engine whose own device is CUDA (the default of
    ``FuzzyAhoCorasickBuilder``) without moving it: each shard's tables are
    built on its device."""
    words = ["needle", "haystack", "boundary"]
    engine = (port_pkg.FuzzyAhoCorasickBuilder.new().fuzzy(port_pkg.FuzzyLimits.new().edits(1))
              .case_insensitive(True).build(words))
    assert engine.device.type == "cuda"
    limits, _words, _maps, text, thr, _lane, _floor = FUZZY["edits1"]
    got = pss.sharded_fuzzy_search(engine, text, thr, [torch.device("cpu")] * 2)
    assert engine.device.type == "cuda"
    assert sorted(map(key, got)) == port_truths(build(port_pkg, limits, words), text, thr)[0]
    assert {k[-1] for k in engine._dp_dev_consts} == {"cpu"}
    with pytest.raises(ValueError, match="at least one device"):
        pss.sharded_fuzzy_search(engine, text, thr, [])


# ---------------------------------------------------------------------------
# (e) the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", SHARDS)
def test_dryrun_multichip_on_cpu_meshes(shards):
    counts = dryrun_multichip(shards, cpu_mesh(shards))
    assert counts["exact"] > 0 and counts["fuzzy"] >= 4 * shards
    assert counts["typed"] >= 3 * shards and counts["mapped"] >= 3 * shards
