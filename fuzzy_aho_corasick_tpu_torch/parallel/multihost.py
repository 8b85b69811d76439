"""Multi-process execution: host-sharded corpus IO and a result gather over
``torch.distributed``.

The torch counterpart of the JAX package's ``parallel/multihost.py``. The
reference's concurrency ceiling is one process (a thread pool over mpsc
channels, src/stream.rs:378-429); the scale-out keeps the JAX package's
two levels:

* **Devices of one process**: the corpus shards over a mesh of the
  process's devices with halo copies and summed counts
  (:mod:`.shard_search`), one controller driving every shard.
* **Across processes**: each process owns a byte range of the input
  (:class:`HostShardPlan`, the stream window's ownership rule lifted to
  host granularity), searches it on its own devices, and the match rows
  all-gather; the ``start < commit`` rule makes each process's emission
  exactly-once, so the gather is the only traffic between processes.

The gathered rows are host arrays (int64 CPU tensors), in both packages: no
device tensor crosses processes. So the process group is ``gloo``, which
serves hosts with and without cards alike, and the rule of NCCL that a
card takes at most one rank never arises (two processes may share a card).

Call :func:`initialize` first in every process (it is a no-op for one
process). With one process, :func:`search_multihost` and
:func:`replace_multihost` run the logical host shards one after another —
the code path each process of a real launch takes for its own shard.
"""

from __future__ import annotations

import dataclasses
import datetime
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

#: Seconds a process waits for its peers, at ``initialize`` and in each
#: collective, before the process group raises.
TIMEOUT_S = 300


def _world() -> int:
    """Processes in the initialised process group (1 when there is none)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = TIMEOUT_S,
) -> int:
    """Join the process group of ``num_processes`` processes whose rank 0
    listens on ``coordinator_address`` (``"host:port"``); returns this
    process's rank. A no-op returning 0 for one process, as the JAX
    package's ``jax.distributed`` wrapper. The group is ``gloo`` (see the
    module docstring), and waits at most ``timeout_s`` seconds for a peer."""
    import torch.distributed as dist

    if num_processes is None or num_processes <= 1:
        return 0
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize needs coordinator_address and process_id for "
                         f"{num_processes} processes")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank()


@dataclass
class HostShard:
    """One host's byte assignment: it reads [read_start, read_end) and owns
    matches whose start byte is in [own_start, own_end)."""

    host: int
    read_start: int
    read_end: int
    own_start: int
    own_end: int


class HostShardPlan:
    """Partition ``total_bytes`` across ``n_hosts`` with a right halo.

    The halo is ``overlap_bytes`` (callers pass ``(engine.stream_overlap() +
    1) * 4``: 4 bytes per grapheme bound it; UTF-8 boundaries are then
    re-aligned against the data by :func:`align_utf8`). Host ``h`` owns the
    starts in its own range (reference src/stream.rs:262-297), so no match
    is emitted twice and none is missed: a match starting in ``h`` lies
    inside ``h``'s read range because the halo exceeds the longest match."""

    def __init__(self, total_bytes: int, n_hosts: int, overlap_bytes: int):
        self.total = total_bytes
        self.n = max(1, n_hosts)
        self.overlap = overlap_bytes
        self.span = -(-total_bytes // self.n)

    def shard(self, h: int) -> HostShard:
        own_start = min(h * self.span, self.total)
        own_end = min(own_start + self.span, self.total)
        read_end = min(own_end + self.overlap, self.total)
        return HostShard(h, own_start, read_end, own_start, own_end)

    def shards(self) -> List[HostShard]:
        return [self.shard(h) for h in range(self.n)]


def align_utf8(data: bytes, pos: int) -> int:
    """Smallest offset >= pos that starts a UTF-8 code point."""
    n = len(data)
    while pos < n and (data[pos] & 0xC0) == 0x80:
        pos += 1
    return pos


def _local_devices(engine, mesh) -> int:
    """Devices this process searches on: the mesh's, else every card for a
    CUDA engine and one for a CPU engine."""
    if mesh is not None:
        return len(mesh)
    return torch.cuda.device_count() if engine.device.type == "cuda" else 1


def search_host_shard(engine, data: bytes, shard: HostShard, threshold: float, mesh=None):
    """One host's work: the search over its byte slice ``data`` (the read
    range ``bytes[read_start:read_end]``), its owned matches rebased to
    absolute byte offsets. With more than one local device the slice shards
    over them (:func:`.shard_search.sharded_fuzzy_search`, or the exact one
    for an exact engine; ``mesh=None`` takes :func:`.shard_search.default_mesh`);
    with one, or where the sharded lane declines, ``engine.search_raw``."""
    from .shard_search import sharded_exact_search, sharded_fuzzy_search

    lo = align_utf8(data, 0)
    body = data[lo:]
    try:
        text = body.decode("utf-8")
    except UnicodeDecodeError as e:
        # The halo's tail may cut a code point; a match the host owns never
        # needs it.
        text = body[: e.start].decode("utf-8")
    base = shard.read_start + lo

    matches = None
    if _local_devices(engine, mesh) > 1:
        if engine.max_edits_fast >= 1:
            matches = sharded_fuzzy_search(engine, text, threshold, mesh)
        if matches is None and engine.max_edits_fast == 0:
            matches = sharded_exact_search(engine, text, threshold, mesh)
    if matches is None:
        matches = engine.search_raw(text, threshold)

    return [dataclasses.replace(m, start=base + m.start, end=base + m.end)
            for m in matches if shard.own_start <= base + m.start < shard.own_end]


#: Gathered match row layout: [start, end, pattern_index, sim_bits, counts].
_ROW_COLS = 5


def _encode_matches(matches) -> np.ndarray:
    rows = np.zeros((len(matches), _ROW_COLS), dtype=np.int64)
    for i, m in enumerate(matches):
        counts = (
            (m.insertions & 0xFF)
            | ((m.deletions & 0xFF) << 8)
            | ((m.substitutions & 0xFF) << 16)
            | ((m.swaps & 0xFF) << 24)
        )
        rows[i] = (
            m.start,
            m.end,
            m.pattern_index,
            int(np.float32(m.similarity).view(np.int32)),
            counts,
        )
    return rows


def _decode_matches(engine, corpus: Optional[bytes], rows: np.ndarray):
    from ..structs import FuzzyMatch

    out = []
    for start, end, p, sim_bits, counts in rows:
        start, end, p = int(start), int(end), int(p)
        text = ""
        if corpus is not None and 0 <= start <= end <= len(corpus):
            text = corpus[start:end].decode("utf-8", errors="replace")
        ins = int(counts) & 0xFF
        dels = (int(counts) >> 8) & 0xFF
        subs = (int(counts) >> 16) & 0xFF
        swaps = (int(counts) >> 24) & 0xFF
        out.append(
            FuzzyMatch(
                insertions=ins, deletions=dels, substitutions=subs,
                swaps=swaps, edits=ins + dels + subs + swaps,
                pattern_index=p, pattern=engine._patterns[p],
                start=start, end=end,
                similarity=np.int32(int(sim_bits)).view(np.float32),
                text=text,
            )
        )
    return out


def _allgather_rows(rows: np.ndarray) -> np.ndarray:
    """All-gather variable-length match rows across the process group:
    counts first, then the rows padded to the largest count, as int64 CPU
    tensors (the ordered fan-in of the reference's seq-tagged reassembly,
    src/stream.rs:603-630). Returns every process's rows in rank order."""
    import torch.distributed as dist

    world = dist.get_world_size()
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(counts, torch.tensor([rows.shape[0]], dtype=torch.int64))
    counts = [int(c) for c in counts]
    cap = max(1, max(counts))
    padded = torch.zeros((cap, _ROW_COLS), dtype=torch.int64)
    padded[: rows.shape[0]] = torch.from_numpy(rows)
    gathered = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(gathered, padded)
    return np.concatenate([g[:c].numpy() for g, c in zip(gathered, counts)], axis=0)


def _own_shard_matches(engine, corpus: bytes, threshold: float, mesh):
    """Under a process group: this process's host shard searched, and every
    process's matches gathered (the complete match set, unsorted)."""
    import torch.distributed as dist

    overlap = (engine.stream_overlap() + 1) * 4
    plan = HostShardPlan(len(corpus), dist.get_world_size(), overlap)
    shard = plan.shard(dist.get_rank())
    local: List = []
    if shard.own_start < shard.own_end:
        data = corpus[shard.read_start: shard.read_end]
        local = search_host_shard(engine, data, shard, threshold, mesh)
    rows = _allgather_rows(_encode_matches(local))
    return shard, _decode_matches(engine, corpus, rows)


def _logical_shard_matches(engine, corpus: bytes, threshold: float, n_hosts, mesh):
    """One process: the plan's host shards searched one after another."""
    overlap = (engine.stream_overlap() + 1) * 4
    plan = HostShardPlan(len(corpus), n_hosts if n_hosts else 1, overlap)
    out: List = []
    for shard in plan.shards():
        if shard.own_start >= shard.own_end:
            continue
        data = corpus[shard.read_start: shard.read_end]
        out.extend(search_host_shard(engine, data, shard, threshold, mesh))
    return plan, out


def search_multihost(engine, corpus: bytes, threshold: float, n_hosts: Optional[int] = None,
                     mesh=None):
    """Multi-host search.

    Under an initialised process group of more than one process
    (:func:`initialize`) each process searches only its own host shard
    (on ``mesh``, or its own devices) and the match rows all-gather:
    every process returns the identical, complete, sorted match list. With
    one process it runs the ``n_hosts`` logical host shards in turn.

    ``corpus``: this process's view of the input; a gathered span outside
    it decodes with ``text = ""``."""
    if _world() > 1:
        _shard, out = _own_shard_matches(engine, corpus, threshold, mesh)
    else:
        _plan, out = _logical_shard_matches(engine, corpus, threshold, n_hosts, mesh)
    out.sort(key=lambda m: (m.start, m.end, m.pattern_index))
    return out


# ---------------------------------------------------------------------------
# Multi-host streaming replace (reference src/stream.rs:533-638: parallel
# search + in-stream-order reassembly, lifted to host granularity)
# ---------------------------------------------------------------------------


def _selected_replace_matches(engine, corpus: bytes, matches):
    """Global deterministic replacement selection: the ``segmented`` upgrade
    (Default rank + greedy non-overlap — reference src/query.rs:46-64,
    src/matches.rs:24-38, 86-112) applied to the gathered match set, then
    position order. Every host computes the identical list, so boundary
    decisions need no extra communication round."""
    from ..matches import FuzzyMatches
    from ..options import Order, Overlap

    fm = FuzzyMatches(corpus.decode("utf-8"), list(matches))
    fm.apply(Order.Default, Overlap.NonOverlapping)
    return sorted(fm, key=lambda m: (m.start, m.end, m.pattern_index))


def _emit_host_segment(engine, corpus: bytes, sel, own_start: int, own_end: int,
                       callback) -> bytes:
    """Bytes host ``h`` contributes to the replaced stream: its owned range
    with selected matches spliced, honouring the cross-host cursor rule — a
    match STARTING in an earlier host's range but overrunning into this one
    was emitted there, so emission here starts at its end (the host-level
    form of the reference's ReplaceCursor hand-off, src/stream.rs:644-705).
    Concatenating every host's segment in host order reproduces the
    single-host replace byte-for-byte."""
    cur = own_start
    for m in sel:
        if m.start < own_start and m.end > own_start:
            cur = max(cur, m.end)  # previous host emitted this replacement
    parts = []
    for m in sel:
        if not (own_start <= m.start < own_end):
            continue
        if m.start < cur:
            continue  # overlapped by the boundary overrun
        if cur < m.start:
            parts.append(corpus[cur: m.start])
        rep = callback(m)
        parts.append(corpus[m.start: m.end] if rep is None
                     else rep.encode("utf-8") if isinstance(rep, str) else rep)
        cur = m.end
    if cur < own_end:
        parts.append(corpus[cur:own_end])
    return b"".join(parts)


def _as_callback(callback):
    """Accept the FuzzyReplacer-style table (list of replacements indexed by
    pattern) or a callable, like stream.replace_stream*."""
    if callable(callback):
        return callback
    table = list(callback)
    return lambda m: (
        table[m.pattern_index] if m.pattern_index < len(table) else None
    )


def replace_multihost(engine, corpus: bytes, threshold: float, callback,
                      n_hosts: Optional[int] = None, mesh=None, writer=None):
    """Multi-host find-and-replace over a host-sharded corpus (BASELINE
    config 5; reference src/stream.rs:533-638's ordered reassembly at host
    granularity).

    Each host searches only its owned byte range (:func:`search_host_shard`,
    halo'd reads), the match rows all-gather, every host applies the
    identical global selection, and host ``h`` emits the replaced bytes of
    exactly its owned range. Under a process group of more than one process
    the local segment is returned (and written to ``writer`` when given):
    the segments concatenated in rank order are the whole replaced stream,
    byte-identical to ``stream.replace_stream`` on unambiguous corpora. With
    one process it runs the logical host shards in turn and returns the
    whole output.

    ``callback``: a ``match -> Optional[str|bytes]`` callable or a
    pattern-indexed replacement table (the FuzzyReplacer form)."""
    cb = _as_callback(callback)
    if _world() > 1:
        shard, found = _own_shard_matches(engine, corpus, threshold, mesh)
        sel = _selected_replace_matches(engine, corpus, found)
        out = _emit_host_segment(engine, corpus, sel, shard.own_start, shard.own_end, cb)
    else:
        plan, found = _logical_shard_matches(engine, corpus, threshold, n_hosts, mesh)
        sel = _selected_replace_matches(engine, corpus, found)
        out = b"".join(
            _emit_host_segment(engine, corpus, sel, s.own_start, s.own_end, cb)
            for s in plan.shards() if s.own_start < s.own_end)
    if writer is not None:
        writer.write(out)
    return out
