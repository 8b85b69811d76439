"""``FAC_TIME=1`` in the port's device lanes: every lane records its spans
(``utils/trace``) into ``last_stats``, and the DP and many lanes add the
JAX package's stage keys (``dispatch_ms``, ``readback_ms``, ``decode_ms``,
``result_buf_kib``), read from those spans. Without the switch there are
no spans and no stage key, nothing is printed, and the switch changes no
match. On the CPU (the kernels' plain versions)."""

import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)

STAGE_KEYS = {"dispatch_ms", "readback_ms", "decode_ms", "result_buf_kib"}
TRACE_KEYS = {"spans", "search_id", "prepare_us", "host_wait_us"}
WORDS = ["tincidunt", "phaetra", "sollicitudin", "venenatis", "fringilla", "malesuada"]
LETTERS = "abcdefghijklmnopqrstuvwxyz"


def _many_words():
    rng = np.random.default_rng(7)
    return sorted({"".join(LETTERS[i] for i in rng.integers(0, 26, int(m)))
                   for m in rng.integers(6, 12, 120)})


def _text(words, seed: int) -> str:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2500):
        w = words[int(rng.integers(len(words)))] if rng.integers(5) == 0 else "lorem"
        if len(w) > 5 and rng.integers(2):
            at = int(rng.integers(1, len(w) - 1))
            w = w[:at] + "x" + w[at + 1:]
        out.append(w)
    return " ".join(out)


#: lane -> (dictionary, edit budget, threshold, backend, spans it records)
LANES = {
    "exact": (WORDS, 0, 0.5, "device-exact-packed",
              {"search", "prepare", "residency", "hit_list", "step", "host_wait", "finish"}),
    "dp": (WORDS, 1, 0.8, "device-fuzzy-dp",
           {"search", "prepare", "residency", "hit_list", "step", "host_wait", "finish",
            "timing_sync", "decode", "decode:filter", "decode:sort", "decode:offsets",
            "decode:build"}),
    "many": (None, 1, 0.82, "device-fuzzy-many",
             {"search", "prepare", "residency", "hit_list", "step", "host_wait", "finish",
              "timing_sync", "decode", "decode:filter", "decode:sort", "decode:offsets",
              "decode:build"}),
}


@pytest.mark.parametrize("lane", list(LANES))
def test_fac_time_stage_stats(lane, monkeypatch, capsys):
    words, E, thr, backend, names = LANES[lane]
    words = words or _many_words()
    b = FuzzyAhoCorasickBuilder.new().device("cpu")
    if E:
        b = b.fuzzy(FuzzyLimits.new().edits(E))
    engine = b.build(words)
    engine.backend = "device"
    text = _text(words, 3)
    key = lambda m: (m.pattern_index, m.start, m.end, np.float32(m.similarity).item(),
                     m.insertions, m.deletions, m.substitutions, m.swaps)
    monkeypatch.delenv("FAC_TIME", raising=False)
    plain = [key(m) for m in engine.search_raw(text, thr)]
    stats = dict(engine.last_stats)
    assert stats["backend"] == backend and len(plain) > 50
    assert not (STAGE_KEYS | TRACE_KEYS) & set(stats)

    monkeypatch.setenv("FAC_TIME", "1")
    timed = [key(m) for m in engine.search_raw(text, thr)]
    out = capsys.readouterr()
    assert timed == plain
    assert out.out + out.err == ""
    stats_t = engine.last_stats
    spans = stats_t["spans"]
    assert {s[0] for s in spans} == names and spans[0][0] == "search"
    assert spans[0][4]["lane"] == backend
    if lane == "exact":
        assert not STAGE_KEYS & set(stats_t)
    else:
        assert STAGE_KEYS <= set(stats_t)
        assert all(stats_t[k] >= 0 for k in STAGE_KEYS) and stats_t["result_buf_kib"] >= 1
        (decode,) = [s for s in spans if s[0] == "decode"]
        assert stats_t["decode_ms"] == round((decode[3] - decode[2]) / 1e6, 1)
    assert {k: v for k, v in stats_t.items() if k not in STAGE_KEYS | TRACE_KEYS} == stats
