"""A whole run of the harness on the CPU at a small size (the port's plain
versions), with the timed path broken underneath: ``correct`` comes out
false for an answer altered where it is produced, for half of the answers
left out, and for the bfloat16 control in the program's place; a sound run
comes out true. Also the check that no module of a run is JAX or the JAX
package, by whole top-level names."""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import control, manifest, run

ROOT = Path(__file__).resolve().parents[2]
SCALE = {"dict1k-e1.typos96": 1 / 1024, "ocr-names-e4.copies96": 1 / 512}


def _run(cell, seed=2**31 + 11):
    return run.run_cell(manifest.Manifest(ROOT), cell, seed, 0.5, False, device="cpu",
                        scale=SCALE[cell], t0=time.perf_counter())


@pytest.mark.parametrize("cell", sorted(SCALE))
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"search_MBps", "search_ms_p95", "setup_s"}


def _patch_decode(monkeypatch, fault):
    from fuzzy_aho_corasick_tpu_torch.ops import emit

    orig = emit.decode_matches

    def broken(*a, **k):
        return fault(list(orig(*a, **k)))

    monkeypatch.setattr(emit, "decode_matches", broken)


def _altered(out):
    if out:
        out[0] = dataclasses.replace(out[0], end=out[0].end + 1)
    return out


@pytest.mark.parametrize("cell", sorted(SCALE))
@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out"])
def test_broken_path_is_not_correct(monkeypatch, cell, fault):
    _patch_decode(monkeypatch, _altered if fault == "answer_altered"
                  else lambda out: out[: len(out) // 2])
    r = _run(cell)
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.parametrize("cell", sorted(SCALE))
def test_bfloat16_control_is_not_correct(cell):
    got = control.control_checks(manifest.Manifest(ROOT), cell, 2**31 + 5, "cpu", SCALE[cell])
    assert got["matches"] > 0
    assert any(got[k] > lim for k, lim in run.compare.LIMITS.items() if k in got)


def test_forbidden_names_compare_whole():
    fine = ["jax_tools", "jaxx.core", "fuzzy_aho_corasick_tpu_torch",
            "fuzzy_aho_corasick_tpu_torch.ops.many", "fuzzy_aho_corasick_tpux", "flaxen"]
    assert run.forbidden_modules(fine) == []
    assert run.forbidden_modules(fine + ["fuzzy_aho_corasick_tpu.ops", "jax.numpy", "jaxlib",
                                         "flax.linen"]) == [
        "flax", "fuzzy_aho_corasick_tpu", "jax", "jaxlib"]


def test_a_run_loads_no_jax():
    """A run's process, through the window and the reference, holds no
    module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
    ``fuzzy_aho_corasick_tpu``."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from portbench import run, manifest\n"
        "r = run.run_cell(manifest.Manifest(), 'dict1k-e1.typos96', 7, 0.2, False, device='cpu',"
        " scale=1/2048, t0=time.perf_counter())\n"
        "import json; print(json.dumps({'correct': r['correct'], 'bad': run.forbidden_modules(),"
        " 'tops': sorted({m.split('.')[0] for m in sys.modules})}))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["bad"] == []
    assert "fuzzy_aho_corasick_tpu_torch" in got["tops"] and "jax" not in got["tops"]


@pytest.mark.card
def test_card_run_is_correct(card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "dict1k-e1.typos96",
                          "--seed", "77", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
