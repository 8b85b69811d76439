"""The beam-frontier lanes (``ops/fuzzy.beam_search``) and what they stand
on, port against the JAX package and the oracle on the CPU.

Every search case holds the port (engine on ``"cpu"``, ``backend =
"device"``) against the JAX package's ``backend = "device"`` result (its
beam kernels are XLA code; its scans run Pallas in interpret mode) as
lists of (pattern, start, end, f32 similarity bits, edit counts), in the
JAX package's order, with its ``last_stats`` backend, anchor count,
overflow rescues and match count, and against the JAX oracle as sets. The
tolerance is exact.

The cases reach every lane the JAX package's ``fuzzy_search_device`` runs
past its DP and many lanes, and every source of candidate starts:

* CJK, E = 1: 60 words of 4 characters from 300 (more than 127 prefilter
  symbols, so no packed scan): the seed filter, over 17 K characters; the
  same engine on 4 K characters at the threshold that one deletion's
  similarity ties, and one ulp under it;
* a 70-character pattern (past the prefilter's 63) and ``hello``, E = 1,
  under ``FILTER_MIN_N`` characters: every position a start;
* E = 2 with a node of 41 children behind a two-character prefix, so the
  starts where the text spells the prefix pass the beam's 80 slots: the
  sorted beam, with oracle rescues;
* CJK, E = 1, with a two-character pattern (no seed partition) and at most
  64 patterns: the per-pattern bitap filter;
* an ASCII dictionary that packs, searched with ``MAX_USEFUL_K`` lowered to
  0 in both packages (a FAST engine caps each budget at 2 E, so only a
  lowered bound reaches the case): the DP lane declines, the seed filter
  over ASCII pieces (the packed exact scan);
* the same kind of dictionary with ``RESIDENT_MAX`` and ``STREAM_CHUNK``
  lowered in both packages: the DP lane declines, and the packed anchors
  stream in segments with a halo.

The modules under them are held against their JAX counterparts on the
same inputs: ``compact.dilate_any``, ``packed_bitap.fuzzy_anchors_packed``
(resident branch, and the budgets past the one-thread scan's six rows),
``exact.exact_scan_hits`` (packed and goto-walk seed engines) and the
candidate starts of every case; and the frontier takes its starts
unpadded, in runs whose size does not change its output.

JAX compiles each beam shape once: the engines and both packages' results
are module-scoped."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fuzzy_aho_corasick_tpu.ops.fuzzy as jfuzzy
import fuzzy_aho_corasick_tpu.ops.packed_bitap as jpb
import fuzzy_aho_corasick_tpu.prefilter as jprefilter
from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder as JaxBuilder
from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits
from fuzzy_aho_corasick_tpu.ops.compact import dilate_any as jax_dilate_any
from fuzzy_aho_corasick_tpu.ops.exact import exact_scan_hits as jax_exact_scan_hits
from fuzzy_aho_corasick_tpu.utils.graphemes import view_of as jax_view_of
from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits
from fuzzy_aho_corasick_tpu_torch import prefilter as tprefilter
from fuzzy_aho_corasick_tpu_torch.ops import compact as tcompact
from fuzzy_aho_corasick_tpu_torch.ops import exact as texact
from fuzzy_aho_corasick_tpu_torch.ops import fuzzy as tfuzzy
from fuzzy_aho_corasick_tpu_torch.ops import packed_bitap as tpb
from fuzzy_aho_corasick_tpu_torch.utils.graphemes import view_of

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)

CJK = [chr(0x4E00 + i) for i in range(600)]
ASCII_WORDS = ["tincidunt", "phaetra", "sollicitudin", "venenatis", "fringilla",
               "malesuada", "vulputate", "ridiculus"]
FILLER = ["lorem", "ipsum", "dolor", "sit", "amet", "elit", "eros", "porta"]


def _tuples(matches):
    return [(m.pattern_index, m.start, m.end, np.float32(m.similarity).view(np.uint32).item(),
             m.insertions, m.deletions, m.substitutions, m.swaps) for m in matches]


def _plant(rng, words, filler, count, edit_chars, rate=2):
    """``count`` words of ``words``, every ``rate``-th with one edit drawn
    from ``edit_chars`` (a substitution, deletion or insertion), each after
    a filler run of 2-7 characters drawn from ``filler``."""
    parts = []
    for i in range(count):
        parts.append("".join(filler[k] for k in rng.integers(0, len(filler),
                                                            int(rng.integers(2, 8)))))
        w = list(words[int(rng.integers(len(words)))])
        if i % rate:
            at, op = int(rng.integers(len(w))), int(rng.integers(3))
            ch = edit_chars[int(rng.integers(len(edit_chars)))]
            if op == 0:
                w[at] = ch
            elif op == 1 and len(w) > 2:
                del w[at]
            else:
                w.insert(at, ch)
        parts.append("".join(w))
    return "".join(parts)


def _ascii_corpus(seed: int, size: int) -> str:
    rng = np.random.default_rng(seed)
    out, n = [], 0
    while n < size:
        w = ASCII_WORDS[int(rng.integers(len(ASCII_WORDS)))] if rng.integers(4) == 0 \
            else FILLER[int(rng.integers(len(FILLER)))]
        if len(w) > 4 and rng.integers(2):
            at = int(rng.integers(1, len(w) - 1))
            w = w[:at] + "xq"[int(rng.integers(2))] + w[at + 1:]
        out.append(w)
        n += len(w) + 1
    return " ".join(out)[:size]


def _cjk1():
    rng = np.random.default_rng(1)
    words = sorted({"".join(CJK[i] for i in rng.integers(0, 300, 4)) for _ in range(60)})
    return words, _plant(rng, words, CJK[:300], 2050, CJK[:300])


def _long():
    hay = ("x hello y hxllo z helo " * 60 + "a" * 70 + " " + "a" * 69 + "b" + "a" * 72 + " "
           + "ab" * 40 + " " + "a" * 71)
    return ["a" * 70, "hello"], hay


def _overflow():
    rng = np.random.default_rng(5)
    words = [CJK[0] + CJK[1] + CJK[10 + i] + CJK[100 + i] for i in range(41)]
    words += [CJK[200 + i] + "".join(CJK[j] for j in rng.integers(300, 500, 3)) for i in range(30)]
    return words, _plant(rng, words, CJK[500:], 24, CJK[500:])


def _bitap():
    rng = np.random.default_rng(2)
    words = sorted({"".join(CJK[i] for i in rng.integers(0, 300, 5)) for _ in range(40)})
    words.append(CJK[400] + CJK[401])
    return words, _plant(rng, words, CJK[:300], 1950, CJK[:300])


#: name -> (dictionary and text, edit budget, threshold, the source of the
#: candidate starts, ``(module attribute, value)`` pairs to set in both
#: packages, or in the port alone where the JAX package has no such knob).
#: The cases with 2-4 chunks of the JAX package's size (``NCHUNK``) hold the
#: emission and rescue order across chunks; ``GROUP_CANDIDATES`` at 1 makes
#: the port's frontier take them one at a time.
CASES = {
    "cjk-e1-seeds": (_cjk1, 1, 0.8, "seeds", (("GROUP_CANDIDATES", 1),)),
    "long-pattern-every-position": (_long, 1, 0.8, "every", ()),
    "e2-overflow-every-position": (_overflow, 2, 0.6, "every", (("NCHUNK", 64),)),
    "cjk-e1-bitap": (_bitap, 1, 0.8, "bitap", ()),
    "k-past-useful-seeds": (lambda: (ASCII_WORDS, _ascii_corpus(3, 17000)), 1, 0.8, "seeds",
                            (("MAX_USEFUL_K", 0),)),
    "streamed-packed-anchors": (lambda: (ASCII_WORDS, _ascii_corpus(4, 17000)), 1, 0.8,
                                "packed", (("RESIDENT_MAX", 4096), ("STREAM_CHUNK", 4096))),
}

_PATCHED = {"NCHUNK": (jfuzzy, tfuzzy), "GROUP_CANDIDATES": (tfuzzy,),
            "MAX_USEFUL_K": (jprefilter, tprefilter),
            "RESIDENT_MAX": (jpb, tpb), "STREAM_CHUNK": (jpb, tpb)}


#: The settings the cases change, as the modules held them when this module
#: was imported.
_OWN = {(mod, name): getattr(mod, name) for name, mods in _PATCHED.items() for mod in mods}


@pytest.fixture(autouse=True)
def _own_settings(request, monkeypatch):
    """A test that takes no ``case`` runs at the modules' own settings, the
    port's chunk at the JAX package's, even where its worker still holds a
    ``case`` around it: the fixture is module-scoped, so the last case a
    worker set up keeps its settings until the module's last test there."""
    if "case" in request.fixturenames:
        return
    for (mod, name), value in _OWN.items():
        monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(tfuzzy, "NCHUNK", jfuzzy.NCHUNK)


def _patch(mp, patches):
    for name, value in patches:
        for mod in _PATCHED[name]:
            mp.setattr(mod, name, value)


def _source(port_e, n: int) -> str:
    """Which source ``_candidate_starts`` took for ``port_e``."""
    if n < tfuzzy.FILTER_MIN_N:
        return "every"
    if tpb.packed_fuzzy_of(port_e) is not None and getattr(port_e, "_seed_filter_cache",
                                                           None) is None:
        return "packed"
    if getattr(port_e, "_seed_filter_cache", None):
        return "seeds"
    return "bitap" if getattr(port_e, "_bitap_filter_cache", None) else "every"


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """Both packages' engines and results for one case, with the case's
    module settings in place while they run."""
    make, E, thr, source, patches = CASES[request.param]
    words, hay = make()
    mp = pytest.MonkeyPatch()
    try:
        # The port keeps the JAX package's chunk as the unit of its emission
        # order: hold it at the JAX package's value (other test modules set
        # the JAX one when imported), unless the case sets both.
        mp.setattr(tfuzzy, "NCHUNK", jfuzzy.NCHUNK)
        _patch(mp, patches)
        jax_e = JaxBuilder.new().fuzzy(JaxLimits.new().edits(E)).build(words)
        port_e = FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(E)).device(
            "cpu").build(words)
        jax_e.backend = port_e.backend = "device"
        got = _tuples(port_e.search_raw(hay, thr))
        got_stats = dict(port_e.last_stats)
        want = _tuples(jax_e.search_raw(hay, thr))
        want_stats = dict(jax_e.last_stats)
        n = len(view_of(hay, False))
        cand = tfuzzy._candidate_starts(port_e, hay, view_of(hay, False), n, np.float32(thr))
        jcand = jfuzzy._candidate_starts(jax_e, hay, jax_view_of(hay, False), n, np.float32(thr))
        yield dict(name=request.param, words=words, hay=hay, thr=thr, E=E, source=source,
                   jax_e=jax_e, port_e=port_e, got=got, got_stats=got_stats, want=want,
                   want_stats=want_stats, n=n, cand=cand.cpu().numpy(),
                   jcand=np.asarray(jcand), patches=patches)
    finally:
        mp.undo()


def test_beam_lane_equal_to_jax(case):
    """The port's list is the JAX package's, in its order, with its stats."""
    got_stats, want_stats = case["got_stats"], case["want_stats"]
    assert got_stats["backend"] == want_stats["backend"] == "device-fuzzy"
    for key in ("anchors", "positions", "overflow_rescues", "matches"):
        assert got_stats[key] == want_stats[key], key
    assert case["got"] == case["want"]
    assert len(case["got"]) > 20
    if case["name"].startswith("e2-overflow"):
        assert got_stats["overflow_rescues"] > 0


def test_beam_lane_equal_to_the_oracle(case):
    """The port's matches are the oracle's (as sets; the tuples are unique)."""
    jax_e = JaxBuilder.new().fuzzy(JaxLimits.new().edits(case["E"])).build(case["words"])
    jax_e.backend = "oracle"
    want = _tuples(jax_e.search_raw(case["hay"], case["thr"]))
    assert sorted(case["got"]) == sorted(want)
    assert len(set(case["got"])) == len(case["got"])


def test_candidate_starts_equal_to_jax(case):
    """``_candidate_starts`` takes the case's source, and its positions are
    the JAX package's: ascending, in the prefilter's grapheme indexing."""
    assert _source(case["port_e"], case["n"]) == case["source"]
    cand, jcand = case["cand"], case["jcand"]
    assert cand.tolist() == jcand.astype(np.int64).tolist()
    assert len(cand) == case["got_stats"]["anchors"]
    if case["source"] != "every":
        assert 0 < len(cand) < case["n"]
    starts = {s for _p, s, *_rest in case["got"]}
    hay_bytes = case["hay"].encode()
    offs = np.cumsum([0] + [len(c.encode()) for c in case["hay"]])
    byte_starts = set(offs[cand].tolist()) if not case["hay"].isascii() else set(cand.tolist())
    assert starts <= byte_starts and len(hay_bytes) == offs[-1]


def test_threshold_tie_equal_to_jax_and_the_oracle(monkeypatch):
    """At the f32 similarity of one deletion in a 4-character word,
    ``(4 - deletion penalty) / 4``, and one ulp under it: the port keeps and
    drops what the JAX package and the oracle do. Under the tie the
    deletions pass; at the tie the node's prune ceiling (in f32, 0.9099998
    against a penalty of 0.91) drops them, in all three."""
    monkeypatch.setattr(tfuzzy, "NCHUNK", jfuzzy.NCHUNK)
    words, hay = _cjk1()
    hay = hay[:4000]
    jax_e = JaxBuilder.new().fuzzy(JaxLimits.new().edits(1)).build(words)
    port_e = FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1)).device(
        "cpu").build(words)
    four = np.float32(4.0)
    tie = np.float32(np.float32(four - port_e.penalties.deletion) / four)
    tied = []
    for thr in (np.nextafter(tie, np.float32(0.0)), tie):
        jax_e.backend = port_e.backend = "device"
        got = _tuples(port_e.search_raw(hay, float(thr)))
        assert port_e.last_stats["backend"] == "device-fuzzy"
        assert got == _tuples(jax_e.search_raw(hay, float(thr)))
        jax_e.backend = "oracle"
        assert sorted(got) == sorted(_tuples(jax_e.search_raw(hay, float(thr))))
        tied.append(sum(t[3] == tie.view(np.uint32).item() for t in got))
    assert tied[0] > 10 and tied[1] == 0


def test_frontier_takes_the_starts_unpadded(monkeypatch):
    """No TPU shapes: the frontier takes exactly the candidate starts, in
    runs of whole chunks of the JAX package's size with a short last one
    and no padding, and its emissions do not depend on how many chunks a
    run holds (``GROUP_CANDIDATES`` is a memory cap only)."""
    words, hay = _cjk1()
    engine = FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1)).device(
        "cpu").build(words)
    thr = np.float32(0.8)
    view = view_of(hay, False)
    n = len(view)
    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr)
    cand = tfuzzy._candidate_starts(engine, hay, view, n, thr)
    seen = []
    pool = tfuzzy._pool_chunk
    monkeypatch.setattr(tfuzzy, "_pool_chunk",
                        lambda starts, *a: seen.append(starts.numel()) or pool(starts, *a))
    monkeypatch.setattr(tfuzzy, "NCHUNK", 4096)
    whole, _ = tfuzzy.beam_emissions(engine, hay, view, n, cand, thr, ceil)
    assert seen == [cand.numel()] and cand.numel() > 3 * 4096
    seen.clear()
    monkeypatch.setattr(tfuzzy, "GROUP_CANDIDATES", 1)
    per_chunk, _ = tfuzzy.beam_emissions(engine, hay, view, n, cand, thr, ceil)
    assert seen[:-1] == [4096] * (len(seen) - 1) and 0 < seen[-1] <= 4096
    assert sum(seen) == cand.numel()
    assert whole[0].numel() > 100
    for a, b in zip(whole, per_chunk):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("span", [1, 2, 3, 5, 8, 13, 64, 300])
def test_dilate_any_equal_to_jax(span):
    rng = np.random.default_rng(span)
    flags = (rng.random(257) < 0.05).astype(np.int32)
    want = np.asarray(jax_dilate_any(jnp.asarray(flags), span))
    got = tcompact.dilate_any(torch.from_numpy(flags), span).numpy()
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("thr", [0.95, 0.8, 0.7])
def test_fuzzy_anchors_packed_equal_to_jax(thr):
    """The resident branch (what the port's search never reaches below
    ``RESIDENT_MAX``: the DP lane serves there) at budgets k = 0, 1 and 2."""
    hay = _ascii_corpus(9, 5000)
    jax_e = JaxBuilder.new().fuzzy(JaxLimits.new().edits(1)).build(ASCII_WORDS)
    port_e = FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1)).device(
        "cpu").build(ASCII_WORDS)
    got = tpb.fuzzy_anchors_packed(port_e, hay, np.float32(thr))
    want = jpb.fuzzy_anchors_packed(jax_e, hay, np.float32(thr))
    assert got.dtype == torch.int64 and got.tolist() == np.asarray(want).tolist()
    assert 0 < got.numel() < len(hay)


def test_fuzzy_anchors_past_six_rows_equal_to_jax():
    """With ``edits(4)`` at 0.5 the JAX package's plain budgets reach 8, past
    the one-thread scan's six rows: the port scans the same budgets (on the
    card the wide kernels' deep instances), so its anchors, the count
    included, are the JAX package's, and they keep every match start."""
    words = ["sollicitudin", "ullamcorper", "pellentesque"]
    hay = _ascii_corpus(11, 3000)
    jax_e = JaxBuilder.new().fuzzy(JaxLimits.new().edits(4)).build(words)
    port_e = FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(4)).device(
        "cpu").build(words)
    pk = tpb.packed_fuzzy_of(port_e)
    thr = np.float32(0.5)
    assert max(pk.filt.k_for(bp, thr) for bp in pk.filt.patterns) == 8 > tpb.MAX_K
    got = tpb.fuzzy_anchors_packed(port_e, hay, thr)
    want = np.asarray(jpb.fuzzy_anchors_packed(jax_e, hay, thr))
    assert got.numel() == want.size and got.tolist() == want.tolist()
    port_e.backend = "oracle"
    starts = {m.start for m in port_e.search_raw(hay, float(thr))}
    assert starts and starts <= set(got.tolist()) and len(got) < len(hay)


@pytest.mark.parametrize("which", ["cjk-goto-walk", "ascii-packed"])
def test_exact_scan_hits_equal_to_jax(which):
    """The seed filters' exact pass, on their own seed engines: the
    multiset of (start, pattern) pairs is the JAX package's."""
    if which == "cjk-goto-walk":
        words, hay = _cjk1()
    else:
        words, hay = ASCII_WORDS, _ascii_corpus(3, 17000)
    from fuzzy_aho_corasick_tpu.ops.seeds import SeedFilter as JaxSeedFilter
    from fuzzy_aho_corasick_tpu_torch.ops.seeds import SeedFilter

    jax_sf = JaxSeedFilter.build(JaxBuilder.new().fuzzy(JaxLimits.new().edits(1)).build(words))
    port_sf = SeedFilter.build(FuzzyAhoCorasickBuilder.new().fuzzy(
        FuzzyLimits.new().edits(1)).device("cpu").build(words))
    assert port_sf.seed_engine.device == torch.device("cpu")
    assert (tpb.packed_exact_of(port_sf.seed_engine) is None) == (which == "cjk-goto-walk")
    got = sorted(zip(*(a.tolist() for a in texact.exact_scan_hits(port_sf.seed_engine, hay))))
    want = sorted(zip(*(np.asarray(a).tolist()
                        for a in jax_exact_scan_hits(jax_sf.seed_engine, hay))))
    assert got == want and len(got) > 100
    assert port_sf.piece_offsets == jax_sf.piece_offsets
    n = len(hay)
    assert port_sf.candidate_starts(hay, n).tolist() == jax_sf.candidate_starts(hay, n).tolist()
