"""Data-parallel corpus sharding over a mesh of devices, with halo overlap.

The torch counterpart of the JAX package's ``parallel/shard_search.py``
(reference window/thread parallelism, src/stream.rs:378-429). A mesh is an
ordered list of torch devices; shard ``d`` of the transcoded corpus lives on
``mesh[d]``. One process drives every shard, as the JAX package's single
controller drives its ``shard_map``:

* the ``ppermute`` of a boundary strip becomes a copy of the neighbour's
  strip onto the shard's device (a peer copy between cards, a plain slice
  on one card); positions before the corpus and past the last shard read
  the dead symbol 0;
* the ``psum`` of the per-shard counts becomes their sum on the host.

A device may repeat in a mesh: ``[cuda:0] * 3`` is three logical shards on
one card, run one after another (the counterpart of the JAX tests' virtual
CPU devices). A mesh of ``"cpu"`` devices runs the kernels' plain torch
versions.

Every shard owns exactly the matches that start in its own range (the
reference's ``start < commit`` rule, src/stream.rs:262-297), so emission is
exactly once with no dedup step. The automaton's tables are replicated:
each device's copy is built once per engine (``verify_dp._dev_cache`` keys
by device), and the engine's own ``device`` is never changed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

#: Shard lengths are multiples of this many symbols, and at least this long
#: (the JAX package's layout rule, kept so both cut the corpus alike).
SHARD_ALIGN = 128


def default_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The first ``n_devices`` CUDA devices (all of them by default). Raises
    on a host without CUDA: a mesh of ``"cpu"`` devices is asked for
    explicitly, never handed out in place of the cards."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "default_mesh needs CUDA devices but torch.cuda.is_available() is False; "
            "pass an explicit mesh such as ['cpu'] * n to run the plain torch versions")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"default_mesh({n_devices}): this host has {count} CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


def mesh_devices(mesh: Optional[Sequence] = None) -> List[torch.device]:
    """``mesh`` as a list of torch devices (``None``: :func:`default_mesh`),
    each checked as ``engine.to`` checks one."""
    from ..automaton import checked_device

    if mesh is None:
        return default_mesh()
    devs = [checked_device(d) for d in mesh]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


def shard_length(n: int, n_dev: int) -> int:
    """Symbols per shard: ``ceil(n / n_dev)`` rounded up to
    ``SHARD_ALIGN``, at least ``SHARD_ALIGN``."""
    per = -(-n // n_dev)
    return max(SHARD_ALIGN, -(-per // SHARD_ALIGN) * SHARD_ALIGN)


def put_shards(ids: np.ndarray, shard_len: int, devs: List[torch.device]) -> List[torch.Tensor]:
    """``ids`` zero-padded to ``len(devs) * shard_len`` and cut into one
    tensor per shard, shard ``d`` on ``devs[d]``."""
    padded = np.zeros(len(devs) * shard_len, dtype=ids.dtype)
    padded[: len(ids)] = ids
    return [torch.from_numpy(padded[d * shard_len:(d + 1) * shard_len]).to(dev)
            for d, dev in enumerate(devs)]


def _strip(shards: List[torch.Tensor], lo: int, hi: int, device) -> List[torch.Tensor]:
    """Symbols ``[lo, hi)`` of the sharded stream as pieces on ``device``:
    each piece a copy from the shard that holds it, zeros before the stream
    and past the last shard."""
    shard_len = shards[0].numel()
    parts, pos = [], lo
    while pos < hi:
        d = pos // shard_len
        if pos < 0 or d >= len(shards):
            end = min(hi, 0) if pos < 0 else hi
            parts.append(torch.zeros(end - pos, dtype=shards[0].dtype, device=device))
        else:
            end = min(hi, (d + 1) * shard_len)
            parts.append(shards[d][pos - d * shard_len:end - d * shard_len].to(device))
        pos = end
    return parts


def extended(shards: List[torch.Tensor], d: int, left: int, right: int, device,
             tail: int = 0) -> torch.Tensor:
    """Shard ``d`` with ``left`` symbols of halo before it and ``right``
    after it, fetched from the shards that hold them (zeros at the stream's
    ends), and ``tail`` zeros past that, as one tensor on ``device``."""
    base = d * shards[0].numel()
    end = base + shards[d].numel()
    parts = _strip(shards, base - left, base, device) + [shards[d].to(device)]
    parts += _strip(shards, end, end + right, device)
    if tail:
        parts.append(torch.zeros(tail, dtype=shards[d].dtype, device=device))
    return torch.cat(parts)


def sharded_exact_search(engine, haystack: str, threshold: float, mesh=None):
    """Multi-device exact search: the single-device path's matches.

    The dense class stream is sharded over the mesh; each shard runs the
    goto walk (``ops/exact.goto_walk``) on its own device over its own
    symbols and a right halo of the longest pattern's length from its
    neighbour, walking only the starts it owns, and the arrivals decode
    once on the host with byte offsets from the whole haystack.
    ``last_stats`` holds the shards, positions and the summed emissions
    (the JAX package's ``psum``)."""
    from ..ops.exact import _emit, goto_walk, walk_tables
    from ..utils.graphemes import view_of

    devs = mesh_devices(mesh)
    thr = np.float32(threshold)
    dense = engine.dense
    view = view_of(haystack, engine.case_insensitive)
    ids = dense.transcode(haystack, view)
    n = len(ids)
    if n == 0 or walk_tables(engine, thr, devs[0]) is None:
        return []
    L = max(dense.max_depth, 1)
    shard_len = shard_length(n, len(devs))
    shards = put_shards(np.ascontiguousarray(ids), shard_len, devs)
    found = []
    for d, dev in enumerate(devs):
        base = d * shard_len
        own = min(shard_len, n - base)
        if own <= 0:
            continue
        goto, emits, folded = walk_tables(engine, thr, dev)
        ids_ext = extended(shards, d, 0, L, dev)
        arrivals, _alive = goto_walk(ids_ext, own, min(shard_len + L, n - base), goto, emits,
                                     L, folded=folded)
        found.append((base, arrivals))
    start, span, node = np.concatenate(
        [arrivals.cpu().numpy() + [[base], [0], [0]] for base, arrivals in found], axis=1)
    engine.last_stats = {
        "backend": "device-exact-sharded",
        "shards": len(devs),
        "positions": int(n),
        "emissions": int(start.size),
    }
    return _emit(engine, view, start, start + span, node, thr)


def _lane_specs(engine, haystack: str, view):
    """(typed, maps, forbid) of the sharded fuzzy lane, or None where it
    declines: the JAX package's decisions (``shard_search.py:428-451``)."""
    from ..ops import verify_dp as vdp

    if 1 <= engine.max_edits_fast <= vdp.MAX_E:
        if not engine.mappings:
            return None, None, None
        maps = vdp.mapped_spec_of(engine)
        # Every grapheme one code point, so class identity is char identity
        # (as the single-device mapped lane gates).
        if maps is None or (not haystack.isascii() and len(view) != len(haystack)):
            return None
        return None, maps, None
    if engine.mappings:
        return None
    forbid = vdp.forbid_spec_of(engine)
    if forbid is not None:
        return None, None, forbid
    typed = vdp.typed_spec_of(engine)
    return None if typed is None else (typed, None, None)


def sharded_fuzzy_search(engine, haystack: str, threshold: float, mesh=None):
    """Multi-device fuzzy search (the DP lane sharded over the mesh with halo
    overlap): the single-device path's and the oracle's matches. Returns
    None where the lane declines (no packed prefilter or DP fields, a
    mapped engine on a haystack with multi-code-point graphemes, a
    configuration without a forbid or typed spec, a threshold budget past
    ``MAX_USEFUL_K``) — the caller falls back (reference parallel fuzzy
    windows, src/stream.rs:378-429). A mapped engine's scan budget
    E x its longest side may pass the one-thread scan's six rows (up to
    24): its shards then scan on the wide kernels' deep instances.

    Per shard ``d`` on ``mesh[d]``: the prefilter and dense class streams
    extended to ``[left halo | local | right margin | zeros]`` (left halo =
    longest pattern + scan budget, the scan's warm-up; right margin =
    ``max(halo, Lmax + 2E + 2)``, every owned match's span), the hit-list
    scan (``packed_hits``), then the expansion, DP and emission
    (``dp_pipeline_ranges``) over the starts the shard owns, with the
    lane's budgets from ``dp_plan`` and its ``DpVariant``. The rows come to
    the host once per shard, rebased to whole-corpus positions, and decode
    once, in shard order."""
    from ..ops import verify_dp as vdp
    from ..ops.emit import decode_matches
    from ..ops.packed_bitap import packed_fuzzy_of, packed_hits
    from ..utils.device_corpus import TAIL_MARGIN
    from ..utils.graphemes import view_of

    devs = mesh_devices(mesh)
    n_dev = len(devs)
    thr = np.float32(threshold)
    pk = packed_fuzzy_of(engine)
    vf = vdp.verify_fields_of(engine)
    if pk is None or vf is None:
        return None
    view = view_of(haystack, engine.case_insensitive)
    specs = _lane_specs(engine, haystack, view)
    if specs is None:
        return None
    n = len(view)
    shard_len = shard_length(n, n_dev)
    plan = vdp.dp_plan(engine, thr, shard_len, *specs)
    if plan is None:
        return None
    if np.float32(0.0) > plan.max_pen or n == 0:
        return []

    E = plan.E
    halo = pk.m_max + plan.k
    margin = max(halo, vf.max_depth + 2 * E + 2)
    ext_len = halo + shard_len + margin + TAIL_MARGIN
    dense = engine.dense
    hay_bytes = view.hay_bytes() if view.ascii else None
    ids_pf = np.ascontiguousarray(pk.filt.transcode(haystack, hay_bytes=hay_bytes)[0],
                                  dtype=np.uint8)
    ids_dn = np.ascontiguousarray(dense.transcode(haystack, view),
                                  dtype=np.uint8 if dense.num_classes <= 256 else np.int32)
    pf_shards = put_shards(ids_pf, shard_len, devs)
    dn_shards = put_shards(ids_dn, shard_len, devs)
    statics = vdp._statics(engine, pk, vf)
    dev_rows, hits, cands = [], [], []
    for d, dev in enumerate(devs):
        lt = vdp.lane_tables(engine, plan, dev, *specs)
        base = d * shard_len
        # Ext position p is corpus position base - halo + p; the text ends
        # at ``limit``.
        limit = min(max(n - base + halo, 0), ext_len)
        count, pos, words = packed_hits(
            extended(pf_shards, d, halo, margin, dev, TAIL_MARGIN), lt.T_scan, halo)
        rows, n_cand = vdp.dp_pipeline_ranges(
            pos, words, vdp.step_max_hits(plan.n_combo, lt.T.out_list.shape[1], E, lt.variant),
            vdp.DpWindow(halo, min(halo + shard_len, limit), limit),
            extended(dn_shards, d, halo, margin, dev, TAIL_MARGIN), limit, lt.T, lt.pens,
            thr, E, lt.deadend, statics, lt.variant)
        dev_rows.append(rows)
        hits.append(count)
        cands.append(n_cand)
    row_parts = []
    for d, rows in enumerate(dev_rows):
        rows = rows.cpu().numpy()
        rows[:, 0] += d * shard_len - halo
        row_parts.append(rows)
    rows = np.concatenate(row_parts)
    if len(rows) == 0:
        engine.last_stats = {"backend": "device-fuzzy-sharded", "shards": n_dev, "matches": 0}
        return []
    results = decode_matches(
        engine, view, haystack, n,
        rows[:, 0], rows[:, 2], rows[:, 3],
        np.ascontiguousarray(rows[:, 1]).view(np.float32), rows[:, 4], thr,
    )
    engine.last_stats = {
        "backend": "device-fuzzy-sharded",
        "shards": n_dev,
        "hits": int(sum(hits)),
        "candidates": int(sum(cands)),
        "positions": int(n),
        "emissions": int(len(rows)),
        "matches": len(results),
    }
    return results
