"""The torch port stands alone: no JAX, no JAX package, and no ``regex`` on
the ASCII path; CUDA is never replaced by the CPU behind the caller's back."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder as JaxBuilder
from fuzzy_aho_corasick_tpu.utils import graphemes as jax_graphemes
from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder
from fuzzy_aho_corasick_tpu_torch.utils import graphemes as port_graphemes

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "fuzzy_aho_corasick_tpu_torch"

_CHILD = r"""
import sys
sys.modules["regex"] = None  # any import of regex now raises ImportError
sys.path.insert(0, sys.argv[1])
from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits
builder = FuzzyAhoCorasickBuilder.new().case_insensitive(True).device("cpu")
if len(sys.argv) > 4:
    builder = builder.fuzzy(FuzzyLimits.new().edits(int(sys.argv[4])))
engine = builder.build(sys.argv[3].split(","))
engine.backend = "device"
got = engine.search_raw(sys.argv[2], 0.5 if len(sys.argv) == 4 else 0.8)
print(sorted((m.pattern_index, m.start, m.end) for m in got))
print(engine.last_stats["backend"], "jax" in sys.modules,
      "fuzzy_aho_corasick_tpu" in sys.modules)
"""
_WORDS = ["he", "she", "his", "hers", "tincidunt"]
_HAY = "Ushers and his TINCIDUNT\r\nshe"


def test_ascii_exact_search_runs_without_jax_or_regex():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, str(ROOT), _HAY, ",".join(_WORDS)],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    matches_line, state_line = out.stdout.strip().splitlines()[-2:]
    ref = JaxBuilder.new().case_insensitive(True).build(_WORDS)
    ref.backend = "oracle"
    want = sorted((m.pattern_index, m.start, m.end) for m in ref.search_raw(_HAY, 0.5))
    assert len(want) == 9
    assert matches_line == repr(want)
    assert state_line == "device-exact-packed False False"


def test_ascii_fuzzy_search_runs_without_jax_or_regex():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    hay = "Ushers and his TINCIDNT, tincidunt\r\nshe tnicidunt " * 3
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, str(ROOT), hay, "tincidunt,phaetra", "1"],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    matches_line, state_line = out.stdout.strip().splitlines()[-2:]
    from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits

    ref = JaxBuilder.new().fuzzy(JaxLimits.new().edits(1)).case_insensitive(True).build(
        ["tincidunt", "phaetra"])
    ref.backend = "oracle"
    want = sorted((m.pattern_index, m.start, m.end) for m in ref.search_raw(hay, 0.8))
    assert len(want) >= 9
    assert matches_line == repr(want)
    assert state_line == "device-fuzzy-dp False False"


def test_large_dictionary_search_runs_without_jax_or_regex():
    """The large-dictionary lane (``ops/many``: the wide scan, the sparse
    expansion and the DP over a candidate list) in a child without JAX."""
    import numpy as np

    rng = np.random.default_rng(7)
    words = sorted({"".join("abcdefghijklmnopqrstuvwxyz"[i] for i in rng.integers(0, 26, size=9))
                    for _ in range(120)})
    hay = " ".join(w[:3] + "q" + w[4:] if i % 2 else w for i, w in enumerate(words[:30]))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, str(ROOT), hay, ",".join(words), "1"],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    matches_line, state_line = out.stdout.strip().splitlines()[-2:]
    from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits

    ref = JaxBuilder.new().fuzzy(JaxLimits.new().edits(1)).case_insensitive(True).build(words)
    ref.backend = "oracle"
    want = sorted((m.pattern_index, m.start, m.end) for m in ref.search_raw(hay, 0.8))
    assert len(want) >= 30
    assert matches_line == repr(want)
    assert state_line == "device-fuzzy-many False False"


def test_beam_lane_runs_without_jax_or_regex():
    """The beam frontier (``ops/fuzzy.beam_search``: a pattern past the
    prefilter's 63 graphemes) in a child without JAX."""
    hay = "x hello y hxllo " * 30 + "a" * 70 + " " + "a" * 69 + "b" + "a" * 71
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, str(ROOT), hay, "a" * 70 + ",hello", "1"],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    matches_line, state_line = out.stdout.strip().splitlines()[-2:]
    from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits

    ref = JaxBuilder.new().fuzzy(JaxLimits.new().edits(1)).case_insensitive(True).build(
        ["a" * 70, "hello"])
    ref.backend = "oracle"
    want = sorted((m.pattern_index, m.start, m.end) for m in ref.search_raw(hay, 0.8))
    assert len(want) >= 60
    assert matches_line == repr(want)
    assert state_line == "device-fuzzy False False"


def test_port_sources_import_no_jax():
    bad = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|fuzzy_aho_corasick_tpu)(\.|\s|$)", re.M
    )
    sources = {str(p.relative_to(PORT)): p for p in PORT.rglob("*.py")}
    # The modules above search_raw are scanned too.
    assert {"stream.py", "serialize.py", "replacer.py", "prefilter.py", "ops/native_bfs.py",
            "ops/bitap.py", "utils/native.py", "ops/seeds.py", "ops/fuzzy.py",
            "parallel/shard_search.py", "parallel/multihost.py", "parallel/dryrun.py"
            } <= set(sources)
    offenders = [name for name, p in sources.items() if bad.search(p.read_text())]
    assert offenders == []
    assert not bad.search((ROOT / "chip_smoke.py").read_text())


_CHILD_PARALLEL = r"""
import sys
sys.modules["jax"] = None
sys.path.insert(0, sys.argv[1])
from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits
from fuzzy_aho_corasick_tpu_torch.parallel import multihost
from fuzzy_aho_corasick_tpu_torch.parallel.shard_search import sharded_fuzzy_search
engine = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1))
          .case_insensitive(True).device("cpu").build(["tincidunt", "phaetra"]))
got = sharded_fuzzy_search(engine, sys.argv[2], 0.8, ["cpu", "cpu"])
print(sorted((m.pattern_index, m.start, m.end) for m in got))
print(engine.last_stats["backend"], engine.last_stats["shards"], multihost.initialize(),
      sys.modules["jax"] is not None, "fuzzy_aho_corasick_tpu" in sys.modules)
"""


def test_sharded_search_runs_without_jax():
    """``parallel.shard_search`` and ``parallel.multihost`` import with
    ``jax`` blocked, and a 2-shard CPU search runs there, returning the
    oracle's matches."""
    hay = ("Ushers and his TINCIDNT, tincidunt\r\nshe tnicidunt phaetra " * 40)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _CHILD_PARALLEL, str(ROOT), hay],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    matches_line, state_line = out.stdout.strip().splitlines()[-2:]
    from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits

    ref = JaxBuilder.new().fuzzy(JaxLimits.new().edits(1)).case_insensitive(True).build(
        ["tincidunt", "phaetra"])
    ref.backend = "oracle"
    want = sorted((m.pattern_index, m.start, m.end) for m in ref.search_raw(hay, 0.8))
    assert len(want) >= 120
    assert matches_line == repr(want)
    assert state_line == "device-fuzzy-sharded 2 0 False False"


#: The entry points above search_raw on one engine; the same code runs in
#: the child (the port) and here (the JAX package).
_ENTRY_POINTS = r"""
def run(pkg, engine):
    import hashlib, io, tempfile
    data = b"why hello there, wrold of helpful words " * 300
    out = io.BytesIO()
    engine.replace_stream_parallel(data, out, 4, 0.8, ["HI", "EARTH"])
    hits = []
    engine.search_stream(data, 0.8, lambda m: hits.append((m.start, m.end)))
    with tempfile.TemporaryDirectory() as d:
        engine.save(d + "/e.npz")
        loaded = pkg.FuzzyAhoCorasick.load(d + "/e.npz")
    found = engine.with_prefilter().search("hello wrold", pkg.SearchOptions.new().with_threshold(0.8))
    return (hashlib.sha256(out.getvalue()).hexdigest()[:16], len(hits),
            hashlib.sha256(repr(hits).encode()).hexdigest()[:16],
            len(loaded.search_raw("hello wrold", 0.8)), len(found))
"""

_CHILD_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["regex"] = None
sys.path.insert(0, sys.argv[1])
import fuzzy_aho_corasick_tpu_torch as port
for info in pkgutil.walk_packages(port.__path__, "fuzzy_aho_corasick_tpu_torch."):
    importlib.import_module(info.name)
engine = (port.FuzzyAhoCorasickBuilder.new().fuzzy(port.FuzzyLimits.new().edits(1))
          .case_insensitive(True).device("cpu").build(["hello", "world"]))
""" + _ENTRY_POINTS + r"""
print(*run(port, engine), engine.last_stats["backend"],
      sys.modules["jax"] is not None, "fuzzy_aho_corasick_tpu" in sys.modules)
"""


def test_every_port_module_imports_without_jax_or_regex():
    """Every module of the port imports with ``jax`` and ``regex`` blocked,
    and the entry points above ``search_raw`` (streaming search and replace,
    save / load, the prefilter, the native host BFS) run on ASCII text
    without them, returning what the JAX package returns."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _CHILD_ALL, str(ROOT)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    import fuzzy_aho_corasick_tpu as jax_pkg

    scope = {}
    exec(_ENTRY_POINTS, scope)
    ref = (JaxBuilder.new().fuzzy(jax_pkg.FuzzyLimits.new().edits(1)).case_insensitive(True)
           .build(["hello", "world"]))
    want = [str(x) for x in scope["run"](jax_pkg, ref)]
    assert int(want[1]) >= 600
    assert out.stdout.split() == want + ["native-bfs", "False", "False"]


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    engine = FuzzyAhoCorasickBuilder.new().build(["abc"])
    with pytest.raises(RuntimeError, match="cuda"):
        engine.to("cuda")
    # The builder's default device is cuda: the device path refuses to run
    # rather than carrying on on the CPU.
    engine.backend = "device"
    with pytest.raises(RuntimeError, match="cuda"):
        engine.search_raw("xxabcxx", 0.5)


@pytest.mark.parametrize(
    "text", ["", "abc", "a\r\nb", "\r\r\n\n", "\n\r", "x\r", "\r\nA\r\n"]
)
def test_ascii_segmentation_matches_reference(text):
    assert port_graphemes.graphemes(text) == jax_graphemes.graphemes(text)
    assert port_graphemes.grapheme_len(text) == jax_graphemes.grapheme_len(text)
    for ci in (False, True):
        assert port_graphemes.fold_graphemes(text, ci) == jax_graphemes.fold_graphemes(text, ci)


def test_unicode_segmentation_without_regex_names_it(monkeypatch):
    monkeypatch.setattr(port_graphemes, "_GRAPHEME_RE", None)
    monkeypatch.setitem(sys.modules, "regex", None)
    with pytest.raises(ImportError, match="regex"):
        port_graphemes.graphemes("été")
