"""Bitap (Wu-Manber shift-AND) scans on the host (a copy of the JAX
package's ``ops/bitap``), for the prefilter's window re-search.

The reference's scalar recurrence (src/prefilter.rs:410-435) runs one u64
state per error level sequentially over the symbol stream. A state bit
depends on at most ``m + k`` trailing symbols, so the stream can be cut into
independent chunks with an ``m + k`` warm-up halo, each running the
recurrence on its own — identical results (differential-tested against the
scalar form). The same decomposition is the device scan's
(``csrc/packed_bitap.cu``, one chunk per thread).

Implementations, fastest applicable wins (:func:`bitap_windows_auto`):

* the native C scan (``utils/native.bitap_scan_hits``);
* :func:`bitap_windows_chunked` — NumPy-vectorized chunked form;
* :func:`bitap_windows` — scalar loop, bit-exact port of the recurrence
  (tiny inputs, and the differential oracle).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

U64 = np.uint64
_U64_MASK = (1 << 64) - 1


def bitap_windows(
    mask: np.ndarray, m: int, k: int, ids: np.ndarray, out: List[Tuple[int, int]],
    damerau: bool = False,
) -> None:
    """Scalar shift-AND NFA over ``k + 1`` error rows
    (bit-exact port of reference src/prefilter.rs:410-435).

    For every end position where ``levenshtein(pattern, window) <= k`` for
    some start, pushes the candidate window ``[end - m - k, end]`` (grapheme
    indices) onto ``out``.

    ``damerau=True`` adds k pending-transposition rows so an adjacent swap
    costs ONE error (the scalar form of the packed device kernel's Damerau
    recurrence, csrc/packed_bitap.cu): ``s[d]`` holds "read
    p[j+1] last step from a d-1 prefix through j-1"; reading p[j] now
    completes the swap onto bit j+1 of row d.
    """
    match_bit = 1 << (m - 1)
    mask_int = [int(x) for x in mask]
    r = [((1 << d) - 1) for d in range(k + 1)]
    nr = [0] * (k + 1)
    s = [0] * (k + 1)
    ns = [0] * (k + 1)
    span = m + k
    for i, c in enumerate(ids):
        bc = mask_int[c]
        nr[0] = ((r[0] << 1) | 1) & bc
        for d in range(1, k + 1):
            nr[d] = (
                ((r[d] << 1) & bc)
                | ((r[d - 1] | nr[d - 1]) << 1)
                | r[d - 1]
                | 1
            ) & _U64_MASK
            if damerau:
                nr[d] |= (s[d] << 1) & ((bc << 1) & _U64_MASK)
                ns[d] = ((r[d - 1] << 1) | 1) & (bc >> 1)
        if nr[k] & match_bit:
            end = i + 1
            out.append((max(end - span, 0), end))
        r, nr = nr, r
        if damerau:
            s, ns = ns, s


def bitap_windows_auto(
    mask: np.ndarray, m: int, k: int, ids: np.ndarray, out: List[Tuple[int, int]],
    damerau: bool = False,
) -> None:
    """Pick the fastest applicable implementation (same output set)."""
    from ..utils import native

    hits = native.bitap_scan_hits(mask, m, k, ids, damerau=damerau)
    if hits is not None:
        span = m + k
        for e in np.nonzero(hits)[0]:
            end = int(e) + 1
            out.append((max(end - span, 0), end))
        return
    if len(ids) > 8192:
        bitap_windows_chunked(mask, m, k, ids, out, damerau=damerau)
    else:
        bitap_windows(mask, m, k, ids, out, damerau=damerau)


def bitap_windows_chunked(
    mask: np.ndarray,
    m: int,
    k: int,
    ids: np.ndarray,
    out: List[Tuple[int, int]],
    chunk: int = 4096,
    damerau: bool = False,
) -> None:
    """Chunk-parallel shift-AND: identical output to :func:`bitap_windows`.

    Cuts ``ids`` into ``chunk``-sized pieces, each prefixed by an ``m + k``
    halo; all chunks advance the recurrence in lockstep (one vectorized step
    per in-chunk position). This is the same decomposition the device scan
    uses across threads.
    """
    n = len(ids)
    if n == 0:
        return
    span = m + k
    halo = span  # warm-up length guaranteeing exact state at chunk start
    if n <= chunk + halo:
        bitap_windows(mask, m, k, ids, out, damerau=damerau)
        return

    num_chunks = -(-n // chunk)
    width = chunk + halo
    # Rows: [num_chunks, width] of symbol ids, left-padded with 0 ("other",
    # which matches no pattern position) for the first chunk's missing halo.
    rows = np.zeros((num_chunks, width), dtype=np.int64)
    valid = np.zeros((num_chunks, width), dtype=bool)
    for ci in range(num_chunks):
        s = ci * chunk - halo
        e = min(ci * chunk + chunk, n)
        src_lo = max(s, 0)
        dst_lo = src_lo - s
        rows[ci, dst_lo : dst_lo + (e - src_lo)] = ids[src_lo:e]
        # Output positions: only the non-halo region, and within bounds.
        valid[ci, halo : halo + (e - ci * chunk)] = True

    mask_u = mask.astype(np.uint64)
    match_bit = U64(1) << U64(m - 1)
    one = U64(1)

    r = np.zeros((k + 1, num_chunks), dtype=np.uint64)
    for d in range(k + 1):
        r[d, :] = U64((1 << d) - 1)
    s = np.zeros((k + 1, num_chunks), dtype=np.uint64)

    hits_chunk: list[np.ndarray] = []
    hits_pos: list[np.ndarray] = []
    for t in range(width):
        bc = mask_u[rows[:, t]]
        nr0 = ((r[0] << one) | one) & bc
        prev = nr0
        nr = np.empty_like(r)
        nr[0] = nr0
        if damerau:
            ns = np.zeros_like(s)
            sbc = bc << one
            bcn = bc >> one
        for d in range(1, k + 1):
            cur = ((r[d] << one) & bc) | ((r[d - 1] | prev) << one) | r[d - 1] | one
            if damerau:
                cur = cur | ((s[d] << one) & sbc)
                ns[d] = ((r[d - 1] << one) | one) & bcn
            nr[d] = cur
            prev = cur
        hit = ((nr[k] & match_bit) != 0) & valid[:, t]
        if hit.any():
            idx = np.nonzero(hit)[0]
            hits_chunk.append(idx)
            hits_pos.append(np.full(len(idx), t, dtype=np.int64))
        r = nr
        if damerau:
            s = ns

    for cs, ts in zip(hits_chunk, hits_pos):
        for ci, t in zip(cs, ts):
            end = int(ci) * chunk + (int(t) - halo) + 1
            out.append((max(end - span, 0), end))
