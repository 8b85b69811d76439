"""Multi-host search and replace (``parallel/multihost``): every case of
``tests/test_multihost.py`` on the port, on the CPU.

The host-sharded plan and the per-host search must equal the whole-input
search: with 1, 2 and 3 logical hosts in one process, each host's slice
sharded over a mesh of 2 CPU devices (the sharded lanes) or searched whole
(one device: ``search_raw``), and in a real launch of 2 processes joined by
``initialize`` (a ``gloo`` process group on localhost), where both ranks
return the identical gathered list and their replace segments concatenate
to ``replace_stream``'s bytes. The whole-input references are the JAX
package's oracle and the port's ``search_raw``; the tolerance is exact
equality of (start, end, pattern, f32 similarity bits, edit counts)."""

import base64
import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder as JaxBuilder
from fuzzy_aho_corasick_tpu import FuzzyLimits as JaxLimits
from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits, SearchOptions
from fuzzy_aho_corasick_tpu_torch.parallel.multihost import (
    HostShardPlan,
    align_utf8,
    initialize,
    replace_multihost,
    search_multihost,
)

# Tier-1 runs the suite in several worker processes on a few cores: one
# intra-op thread each, so that torch's idle threads do not spin on the
# others' cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MESH2 = ["cpu", "cpu"]


def key(m):
    return (m.start, m.end, m.pattern_index, np.float32(m.similarity).view(np.uint32).item(),
            m.insertions, m.deletions, m.substitutions, m.swaps)


def engines(words, edits=1):
    """(the port's engine on the CPU, the JAX package's oracle engine)."""
    port_e = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(edits))
              .case_insensitive(True).device("cpu").build(words))
    jax_e = JaxBuilder.new().fuzzy(JaxLimits.new().edits(edits)).case_insensitive(True).build(words)
    jax_e.backend = "oracle"
    return port_e, jax_e


def test_initialize_single_process_noop():
    assert initialize() == 0
    assert initialize(num_processes=1) == 0


def test_host_shard_plan_covers_exactly():
    plan = HostShardPlan(1000, 4, overlap_bytes=50)
    shards = plan.shards()
    assert [s.own_start for s in shards] == [0, 250, 500, 750]
    assert [s.own_end for s in shards] == [250, 500, 750, 1000]
    assert all(s.read_end == min(s.own_end + 50, 1000) for s in shards)


def test_align_utf8():
    data = "héllo".encode("utf-8")
    # position 2 is the continuation byte of 'é'
    assert align_utf8(data, 2) == 3
    assert align_utf8(data, 0) == 0


def _search_corpus() -> str:
    filler = "assorted filler words "
    hay = ""
    for i in range(300):
        hay += filler[: 5 + (i * 7) % 20] + ("nedle" if i % 2 else "boundary")
    return hay


@pytest.mark.parametrize("mesh", [MESH2, ["cpu"]], ids=["mesh2", "mesh1"])
@pytest.mark.parametrize("n_hosts", [1, 2, 3])
def test_multihost_fuzzy_equals_whole_input(n_hosts, mesh):
    hay = _search_corpus()
    port_e, jax_e = engines(["needle", "boundary"])
    truth = sorted(map(key, jax_e.search_raw(hay, 0.72)))
    port_e.backend = "device"
    assert sorted(map(key, port_e.search_raw(hay, 0.72))) == truth and len(truth) > 200
    got = search_multihost(port_e, hay.encode("utf-8"), 0.72, n_hosts, mesh)
    assert sorted(map(key, got)) == truth
    assert [key(m) for m in got] == sorted(map(key, got), key=lambda k: (k[0], k[1], k[2]))
    assert port_e.last_stats["backend"] == ("device-fuzzy-sharded" if len(mesh) > 1
                                            else "device-fuzzy-dp")


def test_multihost_unicode_boundary_alignment():
    """A host boundary landing inside a multi-byte code point must not break
    decode or ownership."""
    port_e, jax_e = engines(["héllo"])
    hay = ("àé " * 40 + "héllo ") * 40
    truth = sorted(map(key, jax_e.search_raw(hay, 0.8)))
    got = search_multihost(port_e, hay.encode("utf-8"), 0.8, 3, MESH2)
    assert sorted(map(key, got)) == truth and len(truth) >= 40
    hb = hay.encode("utf-8")
    assert all(hb[m.start:m.end].decode("utf-8") == m.text for m in got)


def _replace_corpus(n: int = 240) -> bytes:
    filler = "assorted filler words "
    hay = ""
    for i in range(n):
        hay += filler[: 5 + (i * 7) % 20] + ("nedle" if i % 2 else "boundary")
    return hay.encode("utf-8")


@pytest.mark.parametrize("n_hosts", [1, 2, 3])
def test_multihost_replace_equals_single_host_stream(n_hosts):
    """``replace_multihost`` is byte-identical to the single-host streaming
    replace (BASELINE config 5; reference src/stream.rs:533-638's seq-tagged
    reassembly at host granularity)."""
    port_e, _jax_e = engines(["needle", "boundary"])
    corpus = _replace_corpus()
    table = ["<N>", "<B>"]
    w = io.BytesIO()
    port_e.replace_stream(io.BytesIO(corpus), w, 0.72,
                          lambda m: table[m.pattern_index] if m.pattern_index < 2 else None)
    single = w.getvalue()
    assert single.count(b"<N>") > 50 and single.count(b"<B>") > 50
    out = io.BytesIO()
    got = replace_multihost(port_e, corpus, 0.72, table, n_hosts, MESH2, writer=out)
    assert got == single == out.getvalue()


def test_multihost_replace_boundary_overrun():
    """A match straddling a host boundary is emitted exactly once (by the
    owner of its START), and the next host resumes after its end."""
    port_e, _jax_e = engines(["boundarymarker"])
    base = bytearray(b"." * 300)
    for b in (100, 200):
        w = b"boundarymarker"
        base[b - len(w) // 2: b - len(w) // 2 + len(w)] = w
    corpus = bytes(base)
    full = port_e.replace(corpus.decode(), SearchOptions.new().with_threshold(0.8),
                          lambda m: "<X>").encode()
    got = replace_multihost(port_e, corpus, 0.8, lambda m: "<X>", 3, MESH2)
    assert got == full and got.count(b"<X>") == 2


def test_replace_multihost_single_device_mesh():
    """A host with one local device searches its slice with ``search_raw``;
    the output is byte-identical to the sharded lanes' over 3 devices."""
    port_e, _jax_e = engines(["needle", "pattern"])
    port_e.backend = "device"
    corpus = ("find the needle in this patern haystack " * 400).encode()
    table = ["<N>", "<P>"]
    got1 = replace_multihost(port_e, corpus, 0.72, table, 3, ["cpu"])
    assert port_e.last_stats["backend"] == "device-fuzzy-dp"
    got3 = replace_multihost(port_e, corpus, 0.72, table, 3, ["cpu"] * 3)
    assert port_e.last_stats["backend"] == "device-fuzzy-sharded"
    assert got1 == got3 and b"<N>" in got1 and b"<P>" in got1


# ---------------------------------------------------------------------------
# A real 2-process run: torch.distributed (gloo) on the CPU
# ---------------------------------------------------------------------------

_WORKER = r"""
import base64, json, sys
sys.modules["jax"] = None
sys.path.insert(0, sys.argv[4])
import torch.distributed as dist
from fuzzy_aho_corasick_tpu_torch import FuzzyAhoCorasickBuilder, FuzzyLimits
from fuzzy_aho_corasick_tpu_torch.parallel import multihost

port, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
got_pid = multihost.initialize(f"127.0.0.1:{port}", nproc, pid, timeout_s=60)
assert got_pid == pid == dist.get_rank() and dist.get_world_size() == nproc
engine = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1))
          .case_insensitive(True).device("cpu").build(["needle", "pattern"]))
corpus = (("filler " * 97) + "needle " + ("words " * 83) + "pattren ").encode() * 40
ms = multihost.search_multihost(engine, corpus, 0.8, mesh=["cpu", "cpu"])
rows = [(m.start, m.end, m.pattern_index, float(m.similarity), m.edits, m.text) for m in ms]
print("RESULT " + json.dumps(rows))
seg = multihost.replace_multihost(engine, corpus, 0.8, ["<N>", "<P>"])
print("SEGMENT " + base64.b64encode(seg).decode())
dist.destroy_process_group()
"""

_CORPUS_2P = (("filler " * 97) + "needle " + ("words " * 83) + "pattren ").encode() * 40


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(script: Path, argv_of, n: int, timeout: float):
    """Run ``n`` workers of ``script``; returns their (returncode, stdout,
    stderr). A worker past ``timeout`` seconds, and every worker once one
    fails, is killed: a dead peer cannot hang the test."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, str(script), *argv_of(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err += f"\n[killed after {timeout} s]"
            outs.append((p.returncode, out, err))
            if p.returncode != 0:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_two_process_distributed_allgather(tmp_path):
    """Two processes under ``initialize``: each searches only its host
    shard; the gather hands both the identical, complete match list, equal
    to the whole-corpus search, and their replace segments concatenate (rank
    order) to ``replace_stream``'s bytes."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = _free_port()
    outs = _launch(script, lambda r: [str(port), "2", str(r), str(ROOT)], 2, 240)
    assert [rc for rc, _o, _e in outs] == [0, 0], "\n".join(e[-3000:] for _r, _o, e in outs)
    results, segs = [], []
    for _rc, out, _err in outs:
        lines = out.splitlines()
        results.append(json.loads(next(l for l in lines if l.startswith("RESULT "))[7:]))
        segs.append(base64.b64decode(next(l for l in lines if l.startswith("SEGMENT "))[8:]))
    assert results[0] == results[1]

    port_e, jax_e = engines(["needle", "pattern"])
    text = _CORPUS_2P.decode()
    expect = sorted((m.start, m.end, m.pattern_index, float(m.similarity), m.edits, m.text)
                    for m in jax_e.search_raw(text, 0.8))
    assert sorted(tuple(r) for r in results[0]) == expect and len(expect) >= 80

    w = io.BytesIO()
    port_e.replace_stream(io.BytesIO(_CORPUS_2P), w, 0.8,
                          lambda m: ["<N>", "<P>"][m.pattern_index] if m.pattern_index < 2 else None)
    assert segs[0] + segs[1] == w.getvalue()
    assert w.getvalue().count(b"<N>") == 40 and w.getvalue().count(b"<P>") == 40


_LONELY = r"""
import sys, time
sys.path.insert(0, sys.argv[3])
from fuzzy_aho_corasick_tpu_torch.parallel import multihost
t0 = time.monotonic()
try:
    multihost.initialize(f"127.0.0.1:{sys.argv[1]}", 2, int(sys.argv[2]), timeout_s=3)
except Exception as e:
    print(f"RAISED {type(e).__name__} after {time.monotonic() - t0:.1f} s")
    sys.exit(3)
print("JOINED")
"""


def test_initialize_raises_when_a_peer_never_joins(tmp_path):
    """Rank 0 of 2 whose peer never starts raises after its timeout instead
    of waiting for ever, and the failure reaches the caller."""
    script = tmp_path / "lonely.py"
    script.write_text(_LONELY)
    port = _free_port()
    (rc, out, err), = _launch(script, lambda r: [str(port), "0", str(ROOT)], 1, 120)
    assert rc == 3 and "RAISED" in out, out + err
