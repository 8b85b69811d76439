"""Device-resident corpus cache.

The deployment model keeps the corpus in device memory and runs many searches
against it (different engines, thresholds, options) — the analog of the
reference keeping the haystack in RAM across calls. A repeated search then
ships nothing to the device; only the compacted hits come back.

``resident`` maps (haystack, symbol-space, device) -> a torch uint8 tensor of
transcoded symbol ids on that device, padded with zeros (the dead symbol) to
a bucketed length. Keyed by the haystack's *content* (sampled for multi-MB
strings — see ``_content_key``); a full string equality check guards against
key collisions. LRU-evicted by total device bytes.

``resident_sliced`` holds overlapping slices of a corpus as separate
zero-padded buffers of one common length, for the sliced fuzzy DP lane.

The JAX package also keeps a packed u32 word view of each corpus
(``resident_words``) for its aligned window fetch; the CUDA kernels read the
u8 stream directly, so the port does not carry it.

Searches run off the main thread (the parallel streaming replace's search
workers), so every read and write of the LRU, its byte count and the
verified-pair cache happens under one lock. The transcode and the upload of
a miss run outside it; two threads that miss on one key both upload, and the
second insert replaces the first, its bytes counted once.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from . import trace

#: Device bytes the cache may hold before LRU eviction.
CAPACITY_BYTES = 8 << 30
#: Smallest bucketed length.
MIN_BUCKET = 1 << 16
#: Guaranteed dead-symbol tail past ``n`` in every resident buffer, so
#: kernels may read fixed-width windows starting anywhere < n without
#: clamping.
TAIL_MARGIN = 128

_lru: "OrderedDict[tuple, tuple]" = OrderedDict()  # key -> (hay, dev, n)
_held_bytes = 0
#: Guards ``_lru``, ``_held_bytes`` and ``_VERIFIED``.
_LOCK = threading.Lock()

#: Above this length the cache key samples the content instead of hashing
#: all of it. Hits are still verified by full string equality, so a sample
#: collision costs one memcmp, never correctness.
_SAMPLED_HASH_MIN = 1 << 20

#: Last (query str, entry str) PAIR verified (by full equality) per content
#: key, so a repeated search with the same str object skips the memcmp. The
#: pair matters: vouching for the content KEY alone would trust any replaced
#: entry under a colliding sampled hash. Both strs are immutable, so identity
#: of BOTH endpoints implies the memcmp'd equality.
_VERIFIED: "OrderedDict[tuple, tuple]" = OrderedDict()
_VERIFIED_MAX = 32


def _hit_fresh(hkey: tuple, stored, haystack: str) -> bool:
    """Whether ``stored`` (the LRU entry's haystack) matches ``haystack`` —
    by identity, by this exact pair's prior verification, or by one memcmp."""
    if stored is haystack:
        return True
    v = _VERIFIED.get(hkey)
    if v is not None and v[0] is haystack and v[1] is stored:
        return True
    if stored == haystack:
        _VERIFIED[hkey] = (haystack, stored)
        _VERIFIED.move_to_end(hkey)
        while len(_VERIFIED) > _VERIFIED_MAX:
            _VERIFIED.popitem(last=False)
        return True
    return False


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _lookup(hkey: tuple, key: tuple, haystack: str):
    """The entry under ``key`` if it holds ``haystack``, marked most recent
    (caller holds ``_LOCK``)."""
    hit = _lru.get(key)
    if hit is None or not _hit_fresh(hkey, hit[0], haystack):
        return None
    if hit[0] is not haystack:  # skip the memcmp for the sibling lookups
        hit = (haystack,) + hit[1:]
        _lru[key] = hit
    _lru.move_to_end(key)
    return hit


def _insert(key: tuple, entry: tuple) -> None:
    """Store ``entry`` = (hay, tensor, n) under ``key``, replacing (and
    uncounting) an entry another thread stored meanwhile (caller holds
    ``_LOCK``)."""
    global _held_bytes
    old = _lru.pop(key, None)
    if old is not None:
        _held_bytes -= _nbytes(old[1])
    _lru[key] = entry
    _held_bytes += _nbytes(entry[1])


def _evict_to_capacity() -> None:
    """Drop the least recent entries past ``CAPACITY_BYTES`` (caller holds
    ``_LOCK``)."""
    global _held_bytes
    while _held_bytes > CAPACITY_BYTES and len(_lru) > 1:
        _, (_, old_dev, _old_n) = _lru.popitem(last=False)
        _held_bytes -= _nbytes(old_dev)


def held_bytes() -> tuple:
    """(the byte count the cache keeps, the bytes its entries hold): equal
    whenever no call is inside the cache."""
    with _LOCK:
        return _held_bytes, sum(_nbytes(e[1]) for e in _lru.values())


def _content_key(haystack: str) -> tuple:
    n = len(haystack)
    if n < _SAMPLED_HASH_MIN:
        return (hash(haystack), n)
    mid = n >> 1
    return (
        hash((haystack[:2048], haystack[mid : mid + 2048], haystack[-2048:])),
        n,
    )


def bucket_len(n: int) -> int:
    """Smallest length >= n of the form (8..15)/8 * 2^k (<= 12.5%
    overshoot; the scan kernels do work proportional to the bucket, so
    overshoot is wasted throughput; every bucket is a multiple of
    2^(k-3) >= 8192)."""
    b = MIN_BUCKET
    while b < n:
        p = 1 << (b.bit_length() - 1)  # containing power of two
        b += p // 8 if b != p else b // 8
    return b


def resident(
    haystack: str,
    space: tuple,
    transcode: Callable[[str], np.ndarray],
    device: torch.device,
) -> Tuple[torch.Tensor, int]:
    """Tensor on ``device`` of ``transcode(haystack)`` padded with zeros to
    ``bucket_len(n + TAIL_MARGIN)``; ships at most once per (haystack
    content, space, device).

    ``space`` must identify the symbol mapping (e.g. an engine's packed
    alphabet id); zero must be a dead symbol in that space (the pad tail).
    Returns (tensor, n).
    """
    with trace.span("residency") as sp:
        hkey = _content_key(haystack)
        key = hkey + (space, str(device))
        with _LOCK:
            hit = _lookup(hkey, key, haystack)
        if hit is not None:
            if sp:
                sp.set(hit=True)
            return hit[1], hit[2]

        ids = transcode(haystack)
        n = len(ids)
        nb = bucket_len(max(n, 1) + TAIL_MARGIN)
        pad = np.zeros(nb, dtype=ids.dtype)
        pad[:n] = ids
        dev = torch.from_numpy(pad).to(device)
        if sp:
            sp.set(hit=False, upload=pad.nbytes)

        with _LOCK:
            _insert(key, (haystack, dev, n))
            _evict_to_capacity()
    return dev, n


def resident_sliced(
    haystack: str,
    space: tuple,
    transcode: Callable[[str], np.ndarray],
    bounds: Tuple[Tuple[int, int], ...],
    pad_len: int,
    device: torch.device,
) -> List[torch.Tensor]:
    """Overlapping corpus slices as tensors on ``device`` (uint8 spaces
    only), one per ``(base, local_n)`` in ``bounds``: ``ids[base : base +
    local_n]`` zero-padded to the common length ``pad_len``.

    Each slice is a buffer of its own, not a view into the whole resident
    corpus, so every symbol past a slice's ``local_n`` is the dead symbol 0.
    Transcodes the whole haystack at most once per miss and ships each slice
    at most once per (content, space, device)."""
    with trace.span("residency") as sp:
        hkey = _content_key(haystack)
        keys = [hkey + (space, "sl", base, ln, pad_len, str(device)) for base, ln in bounds]
        res: List[Optional[torch.Tensor]] = [None] * len(bounds)
        missing = []
        with _LOCK:
            for i, key in enumerate(keys):
                hit = _lookup(hkey, key, haystack)
                if hit is not None:
                    res[i] = hit[1]
                else:
                    missing.append(i)
        if sp:
            sp.set(hit=not missing, upload=len(missing) * pad_len)
        if not missing:
            return res

        ids_full = transcode(haystack)
        if ids_full.dtype != np.uint8:
            raise ValueError("sliced residency is for uint8 symbol spaces only")
        for i in missing:
            base, ln = bounds[i]
            pad = np.zeros(pad_len, dtype=np.uint8)
            pad[:ln] = ids_full[base : base + ln]
            res[i] = torch.from_numpy(pad).to(device)
        with _LOCK:
            for i in missing:
                _insert(keys[i], (haystack, res[i], bounds[i][1]))
            _evict_to_capacity()
    return res


def clear() -> None:
    """Drop every cached device buffer (tests / memory pressure)."""
    global _held_bytes
    with _LOCK:
        _lru.clear()
        _VERIFIED.clear()
        _held_bytes = 0
