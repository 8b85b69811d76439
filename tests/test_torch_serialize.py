"""Checkpoints across the two packages: the port writes the JAX package's
``.npz`` format (the same arrays and configuration), an engine saved by
either package loads in the other, and every loaded engine searches equal
to the engine it was saved from — match tuples with f32 similarity bits and
edit counts, on the oracle, the native BFS and the port's device path (the
kernels' plain torch versions on the CPU). Tolerance: exact."""

import json

import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasick as JaxEngine
from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder as JaxBuilder
from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits
from fuzzy_aho_corasick_tpu import Pattern as JaxPattern
from fuzzy_aho_corasick_tpu_torch import (
    FuzzyAhoCorasick,
    FuzzyAhoCorasickBuilder,
    FuzzyLimits,
    Pattern,
    SearchOptions,
)

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)


def key(m):
    return (m.start, m.end, m.pattern_index, np.float32(m.similarity).view(np.uint32).item(),
            m.edits, m.insertions, m.deletions, m.substitutions, m.swaps)


def _mixed(builder, limits, pattern):
    return (builder.new().fuzzy(limits.new().edits(2)).case_insensitive(True)
            .mapping("ß", "ss").min_symbol_similarity(0.1)
            .build(["strasse", ("weighted", 1.5),
                    pattern.of("custom").fuzzy(limits.new().edits(1)).with_custom_unique_id(9)]))


def test_save_load_roundtrip(tmp_path):
    engine = _mixed(FuzzyAhoCorasickBuilder, FuzzyLimits, Pattern)
    path = str(tmp_path / "engine.npz")
    engine.save(path)
    loaded = FuzzyAhoCorasick.load(path, device="cpu")
    assert loaded.device.type == "cpu"
    for hay in ["die STRAßE und strasse", "weigted custom cstom", "no match"]:
        for thr in [0.5, 0.8]:
            assert sorted(map(key, engine.search_raw(hay, thr))) == \
                sorted(map(key, loaded.search_raw(hay, thr))), (hay, thr)
    opts = SearchOptions.new().with_threshold(0.8).sorted().non_overlapping()
    assert engine.search("strase here", opts).matched_strings() == \
        loaded.search("strase here", opts).matched_strings()
    assert loaded.patterns()[2].custom_unique_id == 9


def test_save_load_mapped_engine_device_lane(tmp_path):
    """A mapped engine round-trips with its mapping transitions intact and
    the loaded engine runs the port's mapped device lane, equal to the JAX
    package's oracle on the engine it loads from the same file."""
    from fuzzy_aho_corasick_tpu_torch.ops.verify_dp import mapped_spec_of

    eng = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1))
           .mapping("ß", "ss").device("cpu").build(["strasse"]))
    path = tmp_path / "mapped.npz"
    eng.save(path)
    loaded = FuzzyAhoCorasick.load(path, device="cpu")
    new_spec = mapped_spec_of(loaded)
    assert new_spec is not None and new_spec.maps == mapped_spec_of(eng).maps
    hay = ("wort " * 60) + "straße und strasse"
    loaded.backend = "device"
    got = sorted(map(key, loaded.search_raw(hay, 0.6)))
    assert loaded.last_stats["backend"] == "device-fuzzy-dp-mapped"
    jax_loaded = JaxEngine.load(str(path))
    jax_loaded.backend = "oracle"
    assert got == sorted(map(key, jax_loaded.search_raw(hay, 0.6)))
    assert len(got) >= 2


def _arrays(path):
    z = np.load(path)
    out = {k: z[k] for k in z.files}
    out["config"] = json.loads(bytes(out["config"]).decode())
    return out


def test_format_is_the_jax_packages(tmp_path):
    """Both packages write the same arrays and configuration for the same
    engine."""
    jax_e = _mixed(JaxBuilder, JaxLimits, JaxPattern)
    port_e = _mixed(FuzzyAhoCorasickBuilder, FuzzyLimits, Pattern)
    jax_e.save(str(tmp_path / "jax.npz"))
    port_e.save(str(tmp_path / "port.npz"))
    a, b = _arrays(tmp_path / "jax.npz"), _arrays(tmp_path / "port.npz")
    assert sorted(a) == sorted(b)
    assert a.pop("config") == b.pop("config")
    for name in a:
        assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), name


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_engine_saved_by_one_package_loads_in_the_other(tmp_path, saved_by):
    words = ["tincidunt", "phaetra", "sollicitudin", "venenatis"]
    jax_e = JaxBuilder.new().fuzzy(JaxLimits.new().edits(1)).case_insensitive(True).build(words)
    port_e = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1))
              .case_insensitive(True).device("cpu").build(words))
    path = str(tmp_path / "engine.npz")
    (jax_e if saved_by == "jax" else port_e).save(path)
    jax_l = JaxEngine.load(path)
    port_l = FuzzyAhoCorasick.load(path, device="cpu")
    rng = np.random.default_rng(12)
    filler = ["lorem", "ipsum", "dolor", "tincidnt", "phaetar", "sollicitudin", "venentis"]
    hay = " ".join(filler[i] for i in rng.integers(0, len(filler), 1500))
    assert len(hay) < jax_l.AUTO_DEVICE_MIN  # the JAX side runs its host path
    port_l.backend = "device"
    got = [key(m) for m in port_l.search_raw(hay, 0.8)]
    assert port_l.last_stats["backend"] == "device-fuzzy-dp"
    assert sorted(got) == sorted(map(key, jax_l.search_raw(hay, 0.8)))
    assert got == [key(m) for m in port_e.to("cpu").search_raw(hay, 0.8)]
    assert len(got) > 300
    port_l.backend = "auto"
    small = hay[:300]
    got = sorted(map(key, port_l.search_raw(small, 0.8)))
    assert port_l.last_stats["backend"] == "native-bfs"
    jax_l.backend = "oracle"
    assert got == sorted(map(key, jax_l.search_raw(small, 0.8)))
    assert len(got) > 10
