"""Packed multi-pattern shift-AND NFA: tables, kernels and the exact glue.

One device pass scans the whole corpus against the *entire* dictionary:
bit-vector fields (reference src/prefilter.rs:186-236) are packed into a
shared set of u64 limbs (a field never straddles a u64), and the Wu-Manber
``k+1``-row recurrence (reference src/prefilter.rs:410-435) runs over all
limbs at once.

Packing soundness: a left shift leaks each field's last bit into the next
field's bit 0 — but every row's recurrence ORs the start mask (bit 0 of every
field) before any use, so the leak is absorbed; u64 limbs never carry into
each other, and no field straddles a limb, so no other cross-talk exists.

:class:`PackedExact` (``k = 0``) packs the **output-bearing trie nodes**
(path string, length = depth) — not raw patterns — because merged AC outputs
emit suffix patterns with the full walked span (reference builder
output-union src/builder.rs:239-276). A hit *is* an exact state-arrival at
that node.

Device work, per search (:func:`packed_hits`), three kernels and one
scalar read back:

1. :func:`scan_bits` — ``scan_bits_kernel`` writes one hit *bit* per stream
   position (packed u32 words) and the number of hits of every
   ``SCAN_BLOCK_SYMS``-symbol block;
2. :func:`block_offsets` — ``block_offsets_kernel`` (``csrc/scan_offsets.cu``),
   the exclusive scan of the block counts; its last entry, the hit count, is
   the one value the host reads (to size the outputs);
3. :func:`hit_words` — ``hit_words_kernel`` turns each block's set bits into
   ascending hit positions behind its offset and replays the NFA from the
   fresh state over each hit's trailing ``halo`` symbols for its match words.

Tables of up to ``MAX_LIMBS`` limbs at up to ``MAX_K`` error rows run those
kernels; wider ones, up to ``MAX_SCAN_LIMBS`` (exact dictionaries past 8
limbs, and the large-dictionary lane, ``ops/many``), and every table at
``MAX_K`` < k <= ``MAX_SCAN_K`` (the mapped lane where E x its longest side
passes 6, the beam anchors at a low threshold) run ``scan_bits_wide_kernel``
and ``hit_words_wide_kernel`` of ``csrc/scan_wide.cu``, whose outputs are the
same, so the plain versions and ``block_offsets`` serve both.

Each wrapper runs its plain torch version (``scan_bits_torch``,
``block_offsets_torch``, ``hit_words_torch``; built from
``scan_flags_torch``, ``torch.nonzero`` and ``replay_words_torch``) for
tensors on the CPU, and launches its kernel for CUDA tensors — there is no
fallback from one to the other.

Tables are u64 limb words held as int64 bit patterns (``tables_from_numpy``
converts the JAX package's u32-pair numpy tables). The plain versions split
them into u32 halves in int64 tensors, because ``<<`` on a negative int64 is
not a u64 shift.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils import trace
from . import _cuda_build
from .compact import compact_indices

#: Max packed alphabet (the kernels hold the [A, W] word table in shared
#: memory and mask symbols to 7 bits).
MAX_ALPHABET_PACKED = 128
#: Max u64 limbs of the packed DP lanes' tables (the narrow kernels are
#: instantiated for W = 1..8).
MAX_LIMBS = 8
#: Max u64 limbs the scan takes (the wide kernels serve W = 9..64), and the
#: exact lane's limb bound.
MAX_SCAN_LIMBS = 64
#: Max error rows of the one-thread kernels (``scan_bits_kernel``,
#: ``hit_words_kernel``); past it the wide kernels serve every W.
MAX_K = 6
#: Max error rows the scan takes (``MAX_KW`` in ``csrc/packed_bitap.cuh``):
#: the prefilter's ``MAX_USEFUL_K``, the most any budget reaches.
MAX_SCAN_K = 24
#: Largest warm-up halo the scan kernels take (m_max + k <= 64 + 24).
HALO_MAX = 128
#: Outer corpus slice per dispatch on the streaming branch.
STREAM_CHUNK = 1 << 26
#: Largest corpus the resident path serves; larger inputs stream in slices.
RESIDENT_MAX = 1 << 27
#: Stream positions per chunk in the plain scan (one row of its batch).
PLAIN_CHUNK = 256

#: Stream positions per block of ``scan_bits_kernel`` (BLOCK_SYMS in
#: ``csrc/packed_bitap.cu``; the wrapper checks it against the built library).
SCAN_BLOCK_SYMS = 16384
#: Chunk lengths ``scan_bits_kernel`` takes (symbols per thread), longest first.
SCAN_CHUNKS = (512, 256, 128)
#: Counts one block of ``block_offsets_kernel`` scans alone (1024 threads x
#: 16 counts), and past that the counts of each block of the look-back
#: chain (OFFSETS_TILE, CHAIN_TILE in ``csrc/scan_offsets.cu``, checked
#: against the built library).
OFFSETS_TILE = 16384
OFFSETS_CHAIN_TILE = 4096
#: Symbols one chain of ``scan_bits_wide_kernel`` scans (WIDE_CHUNK in
#: ``csrc/scan_wide.cu``; the wrapper checks it against the built library).
SCAN_WIDE_CHUNK = 512
#: Lanes of one chain of ``scan_bits_wide_kernel`` at k = 0 (G0 in
#: ``csrc/scan_wide.cu``).
WIDE_K0_LANES = 8
#: Threads per multiprocessor a chunk length must leave the scan (see
#: :func:`scan_chunk`): 20 warps, five per scheduler. On an H100 80GB HBM3
#: (700 W) this picked a length within 8 % of the best of the three on
#: streams of 16 M to 109 M symbols; ``chip_smoke.py`` prints that sweep.
SCAN_FILL_THREADS = 640

#: Kernel launches per wrapper (CUDA launches only; the plain versions on CPU
#: tensors do not count). ``dp`` counts ``verify_dp.banded_dp``,
#: ``dp_pipeline`` both passes of ``verify_dp.dp_pipeline``'s count-channel
#: step; ``typed_expand`` the one launch of ``verify_dp.typed_expand``,
#: ``typed_dp`` and ``typed_emit`` the typed step's DP and emission;
#: ``block_offsets`` the launches of :func:`block_offsets`; ``scan_bits`` and ``hit_words`` count the narrow kernels, the
#: ``_wide`` keys the wide ones; ``many_step`` both passes of
#: ``many.many_step``; ``goto_walk`` both passes of ``exact.goto_walk``;
#: ``count_dp`` and ``count_emit`` the count-channel list step's DP and
#: emission (its expansion counts under ``typed_expand``); ``beam_pool`` (the
#: thread path) and ``beam_pool_warp`` (the warp path) the count and write
#: launches of ``fuzzy.pool_frontier``, ``beam_sorted`` those of
#: ``fuzzy.sorted_frontier``, ``beam_order`` those of ``fuzzy.order_emissions``.
LAUNCHES = {"scan_bits": 0, "block_offsets": 0, "hit_words": 0, "dp": 0, "dp_pipeline": 0,
            "dp_typed": 0, "typed_expand": 0, "typed_dp": 0, "typed_emit": 0,
            "count_dp": 0, "count_emit": 0,
            "scan_bits_wide": 0, "hit_words_wide": 0, "many_step": 0, "goto_walk": 0,
            "beam_pool": 0, "beam_pool_warp": 0, "beam_sorted": 0, "beam_order": 0}

_M32 = 0xFFFFFFFF


def _pack_fields(lengths: List[int]) -> Optional[List[Tuple[int, int]]]:
    """First-fit (limb, bit offset) per field; None if some field > 64 bits."""
    out: List[Tuple[int, int]] = []
    w, off = 0, 0
    for m in lengths:
        if m < 1 or m > 64:
            return None
        if off + m > 64:
            w, off = w + 1, 0
        out.append((w, off))
        off += m
    return out


def _word_table(limb: np.ndarray, A: int, W: int) -> np.ndarray:
    """[A, W] u64 per-symbol limb words -> [A, 2W] i32 (u32 bit patterns,
    low half first; symbol 0 is the dead/pad class and stays all-zero)."""
    tbl = np.zeros((A, 2 * W), dtype=np.uint32)
    for lw in range(W):
        tbl[:, 2 * lw] = (limb[:, lw] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        tbl[:, 2 * lw + 1] = (limb[:, lw] >> np.uint64(32)).astype(np.uint32)
    return tbl.view(np.int32)


def _starts_mask(offsets: List[Tuple[int, int]], W: int) -> np.ndarray:
    starts = np.zeros(2 * W, dtype=np.uint32)
    for lw, lo in offsets:
        starts[2 * lw + (lo >> 5)] |= np.uint32(1) << np.uint32(lo & 31)
    return starts


def _last_bit_mask(offsets, lengths, rows, row_of, W) -> np.ndarray:
    """[rows, 2W] u32 with each field's last bit set on its designated row."""
    mask = np.zeros((rows, 2 * W), dtype=np.uint32)
    for i, ((lw, lo), m) in enumerate(zip(offsets, lengths)):
        bit = lo + m - 1
        mask[row_of(i), 2 * lw + (bit >> 5)] |= np.uint32(1) << np.uint32(bit & 31)
    return mask


def fuzzy_masks(offsets, lengths, W: int, ks: List[int]) -> Tuple[np.ndarray, np.ndarray, int]:
    """(match [k+1, 2W], init [k+1, 2W], k) for per-field budgets ``ks``; the
    init rows reproduce the reference's fresh-start state ``(1 << d) - 1``
    per field (reference src/prefilter.rs:414-418). The numpy form of the JAX
    package's ``PackedFuzzy.fuzzy_masks``, so ``k >= 1`` tables can be built
    without the prefilter."""
    k = max(ks)
    match = _last_bit_mask(offsets, lengths, k + 1, lambda i: ks[i], W)
    init = np.zeros((k + 1, 2 * W), dtype=np.uint32)
    for (lw, lo), m in zip(offsets, lengths):
        for d in range(1, k + 1):
            word = np.uint64((1 << min(d, m)) - 1) << np.uint64(lo)
            init[d, 2 * lw] |= np.uint32(word & np.uint64(0xFFFFFFFF))
            init[d, 2 * lw + 1] |= np.uint32(word >> np.uint64(32))
    return match, init, k


def notlast_mask(offsets, lengths, W: int) -> np.ndarray:
    """[2W] u32 mask with every field's LAST bit cleared — the Damerau
    recurrence's bc_next guard (a shr1 of a char mask must not leak a
    neighbouring field's first char into this field's last position)."""
    last = _last_bit_mask(offsets, lengths, 1, lambda i: 0, W)[0]
    return np.uint32(0xFFFFFFFF) ^ last


class PackedExact:
    """Output-node packing for exact (k = 0) search.

    Symbols are a compact remap of the dense char classes to just the classes
    appearing on trie edges (everything else -> 0, which matches nothing)."""

    __slots__ = ("W", "A", "fields", "word_tbl", "starts", "m_max", "ascii_tbl", "remap")

    def __init__(self, W, A, fields, word_tbl, starts, m_max, ascii_tbl, remap):
        self.W = W
        self.A = A
        #: per field: (node_id, depth, limb, bit, path node ids)
        self.fields = fields
        self.word_tbl = word_tbl
        self.starts = starts
        self.m_max = m_max
        self.ascii_tbl = ascii_tbl  # byte -> packed symbol (u8[256])
        self.remap = remap  # dense class -> packed symbol (u8[num_classes])

    @staticmethod
    def build(engine) -> Optional["PackedExact"]:
        dense = engine.dense
        nodes = engine.nodes
        if nodes[0].output:
            return None  # empty patterns: oracle semantics (NaN), no kernel

        # Trie walk collecting output-bearing nodes with their class paths.
        out_nodes: List[Tuple[int, List[int], List[int]]] = []
        used: dict[int, int] = {}
        stack = [(0, [], [0])]
        while stack:
            ni, cls_path, node_path = stack.pop()
            node = nodes[ni]
            if node.output and ni != 0:
                out_nodes.append((ni, cls_path, node_path))
            for fc, nxt, _single in node.edges:
                cid = dense.char_class.get(fc, 0)
                if cid not in used:
                    used[cid] = len(used) + 1  # packed symbols start at 1
                stack.append((nxt, cls_path + [used[cid]], node_path + [nxt]))
        if not out_nodes:
            return None
        A = len(used) + 1
        if A > MAX_ALPHABET_PACKED:
            return None

        lengths = [len(p) for _, p, _ in out_nodes]
        offsets = _pack_fields(lengths)
        if offsets is None:
            return None
        W = max(w for w, _ in offsets) + 1
        if W > MAX_SCAN_LIMBS:
            return None

        limb = np.zeros((A, W), dtype=np.uint64)
        for (ni, cls_path, _np_), (lw, lo) in zip(out_nodes, offsets):
            for i, sym in enumerate(cls_path):
                limb[sym, lw] |= np.uint64(1) << np.uint64(lo + i)
        fields = [
            (ni, len(cls), lw, lo, node_path)
            for (ni, cls, node_path), (lw, lo) in zip(out_nodes, offsets)
        ]

        remap = np.zeros(dense.num_classes, dtype=np.uint8)
        for cid, sym in used.items():
            remap[cid] = sym
        ascii_tbl = remap[np.minimum(dense.ascii_class, dense.num_classes - 1)].astype(np.uint8)
        return PackedExact(
            W, A, fields, _word_table(limb, A, W), _starts_mask(offsets, W),
            max(lengths), ascii_tbl, remap,
        )

    def transcode(self, haystack: str, view, dense) -> np.ndarray:
        """Haystack -> packed u8 symbol stream (native byte-table path for
        ASCII)."""
        from ..utils import native

        if view.ascii:
            return native.transcode_bytes_u8(view.hay_bytes(), self.ascii_tbl)
        ids = dense.transcode(haystack, view)
        return self.remap[np.minimum(ids, len(self.remap) - 1)]

    def match_mask(self) -> np.ndarray:
        offs = [(lw, lo) for _, _, lw, lo, _ in self.fields]
        lens = [d for _, d, _, _, _ in self.fields]
        return _last_bit_mask(offs, lens, 1, lambda i: 0, self.W)


def packed_exact_of(engine) -> Optional[PackedExact]:
    pk = getattr(engine, "_packed_exact_cache", None)
    if pk is None:
        pk = PackedExact.build(engine)
        engine._packed_exact_cache = pk if pk is not None else False
    return pk if pk is not False else None


class PackedFuzzy:
    """Pattern packing with per-pattern row budgets (prefilter model): one
    field per pattern, the fuzzy DP lane's scan tables."""

    __slots__ = ("filt", "W", "A", "offsets", "ms", "word_tbl", "starts", "m_max")

    def __init__(self, filt, W, A, offsets, ms, word_tbl, starts, m_max):
        self.filt = filt
        self.W = W
        self.A = A
        self.offsets = offsets
        self.ms = ms
        self.word_tbl = word_tbl
        self.starts = starts
        self.m_max = m_max

    @staticmethod
    def build(engine) -> Optional["PackedFuzzy"]:
        from ..prefilter import BitapFilter

        filt = getattr(engine, "_bitap_filter_cache", None)
        if filt is None:
            # allow_mappings: mapped engines use the packed scan with an
            # edit-count-based budget (ops/verify_dp.MappedSpec), never the
            # threshold-based k_for. Engines without mappings are unaffected.
            filt = BitapFilter.build(engine, allow_mappings=True)
            engine._bitap_filter_cache = filt if filt is not None else False
        if filt is False or filt is None:
            return None
        A = len(filt.symbol_ids) + 1
        if A > MAX_ALPHABET_PACKED:
            return None
        ms = [bp.m for bp in filt.patterns]
        offsets = _pack_fields(ms)
        if offsets is None:
            return None
        W = max(w for w, _ in offsets) + 1
        if W > MAX_LIMBS:
            return None
        limb = np.zeros((A, W), dtype=np.uint64)
        for bp, (lw, lo) in zip(filt.patterns, offsets):
            limb[: len(bp.mask), lw] |= bp.mask << np.uint64(lo)
        return PackedFuzzy(
            filt, W, A, offsets, ms, _word_table(limb, A, W),
            _starts_mask(offsets, W), max(ms),
        )

    def notlast(self) -> np.ndarray:
        """[2W] u32: every field's last bit cleared (see :func:`notlast_mask`)."""
        return notlast_mask(self.offsets, self.ms, self.W)

    def fuzzy_masks(self, ks: List[int]) -> Tuple[np.ndarray, np.ndarray, int]:
        """(match [k+1, 2W], init [k+1, 2W], k) for per-pattern budgets (see
        :func:`fuzzy_masks`)."""
        return fuzzy_masks(self.offsets, self.ms, self.W, ks)


def packed_fuzzy_of(engine) -> Optional[PackedFuzzy]:
    pk = getattr(engine, "_packed_fuzzy_cache", None)
    if pk is None:
        pk = PackedFuzzy.build(engine)
        engine._packed_fuzzy_cache = pk if pk is not None else False
    return pk if pk is not False else None


def _field_bits(pk) -> tuple:
    """(u32 column, shift) of each field's last bit in the match words."""
    out = []
    for _ni, depth, lw, fo, _path in pk.fields:
        bit = fo + depth - 1
        out.append((2 * lw + (bit >> 5), bit & 31))
    return tuple(out)


# ---------------------------------------------------------------------------
# Tables on the device
# ---------------------------------------------------------------------------

class ScanTables:
    """The scan's tables on one device: u64 limb words as int64 bit patterns.

    ``tbl`` [A, W], ``starts`` [W], ``match`` and ``init`` [k + 1, W],
    ``notlast`` [W] or None (None: plain recurrence; set with ``k >= 1``:
    Damerau recurrence, swap = one error)."""

    __slots__ = ("A", "W", "k", "tbl", "starts", "match", "init", "notlast")

    def __init__(self, tbl, starts, match, init, notlast):
        self.A, self.W = tbl.shape
        self.k = match.shape[0] - 1
        self.tbl = tbl
        self.starts = starts
        self.match = match
        self.init = init
        self.notlast = notlast

    @property
    def device(self) -> torch.device:
        return self.tbl.device

    @property
    def damerau(self) -> bool:
        return self.notlast is not None and self.k >= 1


def _u64_limbs(a) -> np.ndarray:
    """[..., 2W] u32 bit patterns (any 32-bit dtype) -> [..., W] int64
    holding each limb's u64 bit pattern."""
    a = np.ascontiguousarray(a)
    a = a.view(np.uint32) if a.dtype.itemsize == 4 else a.astype(np.uint32)
    lo = a[..., 0::2].astype(np.uint64)
    hi = a[..., 1::2].astype(np.uint64)
    return np.ascontiguousarray(lo | (hi << np.uint64(32))).view(np.int64)


def tables_from_numpy(word_tbl, starts, match, init, notlast=None, device="cpu") -> ScanTables:
    """The port's tables from the JAX package's numpy arrays: ``word_tbl``
    [A, 2W] int32 (u32 bit patterns), ``starts`` [2W], ``match`` and ``init``
    [k + 1, 2W], ``notlast`` [2W] (all u32)."""
    conv = lambda a: torch.from_numpy(_u64_limbs(a)).to(device)
    return ScanTables(
        conv(word_tbl), conv(starts), conv(np.atleast_2d(match)),
        conv(np.atleast_2d(init)), None if notlast is None else conv(notlast),
    )


# ---------------------------------------------------------------------------
# Plain torch versions of the kernels
# ---------------------------------------------------------------------------

def _halves(t: torch.Tensor):
    return t & _M32, (t >> 32) & _M32


def _shl1(lo, hi):
    return (lo << 1) & _M32, ((hi << 1) & _M32) | (lo >> 31)


class _PlainNfa:
    """The recurrence of ``csrc/packed_bitap.cu`` over a batch of B
    independent streams, in u32 halves (see the kernel source for the
    equations). Rows 0..k are the error rows, k+1..2k the pending
    transpositions under Damerau."""

    def __init__(self, T: ScanTables, B: int):
        self.k, self.dam = T.k, T.damerau
        self.tbl = _halves(T.tbl)
        self.st = _halves(T.starts)
        self.match = [_halves(T.match[d]) for d in range(self.k + 1)]
        if self.dam:
            self.nl = _halves(T.notlast)
        shape = (B, T.W)
        self.rows = [
            tuple(h.expand(shape).clone() for h in _halves(T.init[d]))
            for d in range(self.k + 1)
        ] + [
            (torch.zeros(shape, dtype=torch.int64, device=T.device),) * 2
            for _ in range(self.k if self.dam else 0)
        ]

    def step(self, sym: torch.Tensor):
        """Advance every stream by one symbol; returns the (lo, hi) match
        words [B, W]."""
        k = self.k
        bc_lo, bc_hi = self.tbl[0][sym], self.tbl[1][sym]
        st_lo, st_hi = self.st
        prev = self.rows
        new = [None] * len(prev)
        s_lo, s_hi = _shl1(*prev[0])
        new[0] = ((s_lo | st_lo) & bc_lo, (s_hi | st_hi) & bc_hi)
        if self.dam:
            nl_lo, nl_hi = self.nl
            bcn_lo = ((bc_lo >> 1) | ((bc_hi << 31) & _M32)) & nl_lo
            bcn_hi = (bc_hi >> 1) & nl_hi
            sbc_lo, sbc_hi = _shl1(bc_lo, bc_hi)
        for d in range(1, k + 1):
            a_lo, a_hi = _shl1(*prev[d])
            u_lo = prev[d - 1][0] | new[d - 1][0]
            u_hi = prev[d - 1][1] | new[d - 1][1]
            b_lo, b_hi = _shl1(u_lo, u_hi)
            n_lo = (a_lo & bc_lo) | b_lo | prev[d - 1][0] | st_lo
            n_hi = (a_hi & bc_hi) | b_hi | prev[d - 1][1] | st_hi
            if self.dam:
                t_lo, t_hi = _shl1(*prev[k + d])
                n_lo = n_lo | (t_lo & sbc_lo)
                n_hi = n_hi | (t_hi & sbc_hi)
                p_lo, p_hi = _shl1(*prev[d - 1])
                new[k + d] = ((p_lo | st_lo) & bcn_lo, (p_hi | st_hi) & bcn_hi)
            new[d] = (n_lo, n_hi)
        self.rows = new
        w_lo = new[0][0] & self.match[0][0]
        w_hi = new[0][1] & self.match[0][1]
        for d in range(1, k + 1):
            w_lo = w_lo | (new[d][0] & self.match[d][0])
            w_hi = w_hi | (new[d][1] & self.match[d][1])
        return w_lo, w_hi


def scan_flags_torch(ids: torch.Tensor, T: ScanTables, halo: int) -> torch.Tensor:
    """u8 [n] flags (the scan's hit bits, one byte each), 1 where some
    field's match bit is set at that stream position. Vectorised over
    ``PLAIN_CHUNK``-symbol slices of the stream, each warmed up from the fresh
    state over the ``halo`` symbols before it (positions < 0 read as the
    dead symbol 0); a Python loop walks the positions."""
    n = ids.numel()
    if n == 0:
        return torch.zeros(0, dtype=torch.uint8, device=ids.device)
    chunk = PLAIN_CHUNK
    nch = -(-n // chunk)
    padded = torch.zeros(halo + nch * chunk, dtype=torch.int64, device=ids.device)
    padded[halo : halo + n] = ids.to(torch.int64)
    rows = padded.unfold(0, halo + chunk, chunk)  # [nch, halo + chunk]
    nfa = _PlainNfa(T, nch)
    flags = torch.zeros((nch, chunk), dtype=torch.uint8, device=ids.device)
    for t in range(halo + chunk):
        w_lo, w_hi = nfa.step(rows[:, t])
        if t >= halo:
            flags[:, t - halo] = ((w_lo | w_hi) != 0).any(dim=1).to(torch.uint8)
    return flags.reshape(-1)[:n]


def replay_words_torch(ids: torch.Tensor, pos: torch.Tensor, T: ScanTables,
                       halo: int) -> torch.Tensor:
    """The replay of ``hit_words_kernel``: for each stream position in
    ``pos``, replay ``ids[pos - halo + 1 .. pos]`` from the fresh state
    (reads outside the stream are symbol 0) and return the match words as
    int64 [len(pos), 2W] u32 halves, low half first per limb."""
    kh = pos.numel()
    if kh == 0:
        return torch.zeros((0, 2 * T.W), dtype=torch.int64, device=ids.device)
    n = ids.numel()
    idx = pos.reshape(-1, 1) + torch.arange(-halo + 1, 1, device=ids.device)
    ok = (idx >= 0) & (idx < n)
    win = torch.where(ok, ids[idx.clamp(0, n - 1)].to(torch.int64), 0)
    nfa = _PlainNfa(T, kh)
    for t in range(halo):
        w_lo, w_hi = nfa.step(win[:, t])
    return torch.stack([w_lo, w_hi], dim=2).reshape(kh, 2 * T.W)


def scan_bits_torch(ids: torch.Tensor, T: ScanTables, halo: int):
    """Plain version of ``scan_bits_kernel``: (bits int32 [nblocks *
    SCAN_BLOCK_SYMS / 32], counts int32 [nblocks]). Bit ``i`` of word ``j``
    is the hit flag of stream position ``32 j + i`` (positions >= n carry
    none); ``counts[b]`` is the number of hits of block ``b``."""
    n = ids.numel()
    nblocks = -(-n // SCAN_BLOCK_SYMS)
    flags = torch.zeros(nblocks * SCAN_BLOCK_SYMS, dtype=torch.int64, device=ids.device)
    flags[:n] = scan_flags_torch(ids, T, halo)
    weights = torch.ones(32, dtype=torch.int64, device=ids.device) << torch.arange(
        32, device=ids.device)
    words = (flags.reshape(-1, 32) * weights).sum(dim=1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    counts = flags.reshape(nblocks, SCAN_BLOCK_SYMS).sum(dim=1).to(torch.int32)
    return words, counts


def block_offsets_torch(counts: torch.Tensor) -> torch.Tensor:
    """Plain version of ``block_offsets_kernel``: int32 [len + 1] exclusive
    scan of ``counts``, the total last."""
    out = torch.zeros(counts.numel() + 1, dtype=torch.int32, device=counts.device)
    out[1:] = torch.cumsum(counts, dim=0)
    return out


def hit_words_torch(ids: torch.Tensor, bits: torch.Tensor, offsets: torch.Tensor,
                    count: int, T: ScanTables, halo: int):
    """Plain version of ``hit_words_kernel``: (pos int64 [count] ascending,
    words int64 [count, 2W]) from the scan's bit words."""
    lanes = torch.arange(32, device=bits.device)
    flags = (bits.to(torch.int64).reshape(-1, 1) >> lanes) & 1
    pos = torch.nonzero(flags.reshape(-1)).reshape(-1)
    if pos.numel() != count or int(offsets[-1]) != count:
        raise ValueError(f"{pos.numel()} bits set, offsets end at {int(offsets[-1])}, count {count}")
    return pos, replay_words_torch(ids, pos, T, halo)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(ids: torch.Tensor, T: ScanTables, halo: int) -> None:
    if ids.dtype != torch.uint8 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous 1-D uint8 tensor")
    if T.device != ids.device:
        raise ValueError(f"tables on {T.device}, ids on {ids.device}")
    if ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no scan kernel for device {ids.device}")
    if not (1 <= halo <= HALO_MAX):
        raise ValueError(f"halo {halo} outside 1..{HALO_MAX}")
    if T.A > MAX_ALPHABET_PACKED or T.W > MAX_SCAN_LIMBS or T.k > MAX_SCAN_K:
        raise ValueError(f"tables A={T.A} W={T.W} k={T.k} beyond the kernel limits")
    if not 1 <= ids.numel() < 1 << 31:
        raise ValueError(f"stream of {ids.numel()} symbols outside 1..2^31 - 1")


def on_device(dev: torch.device):
    """A context in which a C entry launches on ``dev``: none where ``dev``
    is the current device (the common case, and free), else
    ``torch.cuda.device(dev)``."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(dev: torch.device) -> int:
    """The handle of ``dev``'s current CUDA stream, which the kernels launch
    on (without building a ``torch.cuda.Stream`` where torch offers the raw
    handle: a wrapper's host time is most of a small launch's cost)."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(torch.cuda.current_device() if dev.index is None else dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _check_int32(name: str, t: torch.Tensor, numel: int, device) -> None:
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() \
            or t.numel() != numel or t.device != device:
        raise ValueError(f"{name} must be a contiguous int32 [{numel}] tensor on {device}")


def _tables_args(T: ScanTables):
    return (_ptr(T.tbl), _ptr(T.starts), _ptr(T.match), _ptr(T.init),
            _ptr(T.notlast), T.A, T.W, T.k)


_CHECKED: Optional[_cuda_build.Kernels] = None


def _kernels():
    """The built library, checked once against this module's block sizes."""
    global _CHECKED
    kern = _cuda_build.load()
    if kern is _CHECKED:
        return kern
    if kern.lib.fac_scan_block_syms() != SCAN_BLOCK_SYMS:
        raise RuntimeError(
            f"library scans {kern.lib.fac_scan_block_syms()} symbols per block, "
            f"SCAN_BLOCK_SYMS is {SCAN_BLOCK_SYMS}")
    if kern.lib.fac_scan_wide_chunk() != SCAN_WIDE_CHUNK:
        raise RuntimeError(
            f"library's wide scan takes {kern.lib.fac_scan_wide_chunk()} symbols per chain, "
            f"SCAN_WIDE_CHUNK is {SCAN_WIDE_CHUNK}")
    if (kern.lib.fac_offsets_tile(), kern.lib.fac_offsets_chain_tile()) != (
            OFFSETS_TILE, OFFSETS_CHAIN_TILE):
        raise RuntimeError("csrc/scan_offsets.cu and packed_bitap disagree on OFFSETS_TILE / "
                           "OFFSETS_CHAIN_TILE")
    _CHECKED = kern
    return kern


def _wide(T: ScanTables) -> bool:
    """Whether the wide kernels scan ``T`` (past ``MAX_LIMBS`` limbs or past
    ``MAX_K`` error rows)."""
    return T.W > MAX_LIMBS or T.k > MAX_K


def wide_scan_instance(W: int, k: int) -> Tuple[int, int]:
    """(limbs per lane LPL, lanes per chain G) of the ``scan_bits_wide_kernel``
    instance that scans ``W`` limbs at ``k`` error rows (``MAX_LIMBS`` < W <=
    ``MAX_SCAN_LIMBS`` at k <= ``MAX_K``, 1 <= W <= ``MAX_SCAN_LIMBS`` at
    ``MAX_K`` < k <= ``MAX_SCAN_K``): the table of ``dispatch_wide`` in
    ``csrc/scan_wide.cu``, mirrored. A chain computes LPL x G >= W limbs, the
    ones past W zero: at k = 0 ``WIDE_K0_LANES`` lanes of ceil(W / 8) limbs
    (at most 7 past W); at k = 1..6 (2, 8) up to 16 limbs, (4, 8) up to 32,
    else (4, 16) (at most 31 past W); at k = 7..24 one limb a lane, G the
    power of two >= W, up to 32 limbs, else (2, 32)."""
    if not 0 <= k <= MAX_SCAN_K:
        raise ValueError(f"k = {k} outside the scan's 0..{MAX_SCAN_K}")
    lo = 1 if k > MAX_K else MAX_LIMBS + 1
    if not lo <= W <= MAX_SCAN_LIMBS:
        raise ValueError(f"W = {W} outside the wide scan's {lo}..{MAX_SCAN_LIMBS} at k = {k}")
    if k == 0:
        return -(-W // WIDE_K0_LANES), WIDE_K0_LANES
    if k > MAX_K:
        return (1, 1 << (W - 1).bit_length()) if W <= 32 else (2, 32)
    return (2, 8) if W <= 16 else (4, 8) if W <= 32 else (4, 16)


def scan_chunk(n: int, device: torch.device) -> int:
    """Symbols one thread of ``scan_bits_kernel`` scans on a stream of ``n``
    symbols: the longest of ``SCAN_CHUNKS`` (less warm-up per reported
    symbol) that still leaves ``SCAN_FILL_THREADS`` threads for each of the
    card's multiprocessors, else the shortest."""
    fill = torch.cuda.get_device_properties(device).multi_processor_count * SCAN_FILL_THREADS
    for chunk in SCAN_CHUNKS:
        if n >= chunk * fill:
            return chunk
    return SCAN_CHUNKS[-1]


def scan_bits(ids: torch.Tensor, T: ScanTables, halo: int, chunk: Optional[int] = None):
    """(bits int32 [nblocks * SCAN_BLOCK_SYMS / 32], counts int32 [nblocks]):
    one hit bit per stream position and the hits per block (see
    :func:`scan_bits_torch`). CPU tensors run the plain version; CUDA tensors
    launch ``scan_bits_kernel``, each thread scanning ``chunk`` symbols
    (:func:`scan_chunk` of the stream where None; the result does not depend
    on it), or for tables wider than ``MAX_LIMBS`` or deeper than ``MAX_K``
    rows ``scan_bits_wide_kernel``, whose chunk is ``SCAN_WIDE_CHUNK``."""
    _check(ids, T, halo)
    wide = _wide(T)
    chunks = (SCAN_WIDE_CHUNK,) if wide else SCAN_CHUNKS
    if chunk is not None and chunk not in chunks:
        raise ValueError(f"chunk {chunk} is none of {chunks}")
    dev = ids.device
    if dev.type == "cpu":
        return scan_bits_torch(ids, T, halo)
    n = ids.numel()
    if chunk is None:
        chunk = SCAN_WIDE_CHUNK if wide else scan_chunk(n, dev)
    nblocks = -(-n // SCAN_BLOCK_SYMS)
    bits = torch.empty(nblocks * (SCAN_BLOCK_SYMS // 32), dtype=torch.int32, device=dev)
    counts = torch.empty(nblocks, dtype=torch.int32, device=dev)
    kern = _CHECKED if _CHECKED is not None else _kernels()
    entry = kern.lib.fac_scan_bits_wide if wide else kern.lib.fac_scan_bits
    with on_device(dev):
        rc = entry(ids.data_ptr(), n, *_tables_args(T), halo, chunk, nblocks, bits.data_ptr(),
                   counts.data_ptr(), stream_of(dev))
    name = "scan_bits_wide" if wide else "scan_bits"
    kern.check(rc, name)
    LAUNCHES[name] += 1
    return bits, counts


#: The status arrays of ``csrc/lookback.cuh``, per (device index, stream
#: handle): [int64 tensor, ticket base]. Word 0 of a tensor is the blocks'
#: ticket counter, then one word per tile; zeroed when made, never reset.
_LOOKBACK: dict = {}
#: Epochs of the chained launches, unique per call.
_LOOKBACK_EPOCHS = itertools.count(1)
#: Held from a call's ticket base to its launch, so the calls on one stream
#: are enqueued in the order of their bases.
_LOOKBACK_LOCK = threading.Lock()


def lookback_launch(dev: torch.device, stream: int, tiles: int, launch) -> int:
    """Enqueue on ``stream`` a kernel whose ``tiles`` blocks chain by
    ``csrc/lookback.cuh``'s look-back (the multi-tile ``block_offsets``
    and ``verify_dp.typed_expand``): ``launch(status, epoch, base)`` gets
    the stream's status array (a data pointer, grown to ``tiles`` tiles),
    an epoch no earlier call used, and the ticket counter's value after the
    earlier calls' blocks took theirs, and returns the launch's
    cudaError_t, which this returns. Calls on one stream run in order, so
    one array serves them all and nothing is reset between them."""
    with _LOOKBACK_LOCK:
        epoch = next(_LOOKBACK_EPOCHS) & 0xFFFFFFFF
        if epoch == 0:  # 2^32 calls on: every word could be mistaken, so zero them
            for slot in _LOOKBACK.values():
                slot[0].zero_()
                slot[1] = 0
            epoch = next(_LOOKBACK_EPOCHS) & 0xFFFFFFFF
        key = (dev.index, stream)
        slot = _LOOKBACK.get(key)
        if slot is None or slot[0].numel() < tiles + 1:
            n = max(tiles + 1, 64, 0 if slot is None else 2 * slot[0].numel())
            slot = _LOOKBACK[key] = [torch.zeros(n, dtype=torch.int64, device=dev), 0]
        rc = launch(slot[0].data_ptr(), epoch, slot[1])
        if rc == 0:
            slot[1] += tiles
    return rc


def block_offsets(counts: torch.Tensor) -> torch.Tensor:
    """int32 [len + 1]: exclusive scan of the int32 ``counts``, the total
    last. CPU tensors run :func:`block_offsets_torch`; CUDA tensors launch
    ``block_offsets_kernel`` once: one block up to ``OFFSETS_TILE`` counts,
    past it blocks of ``OFFSETS_CHAIN_TILE`` chained by look-back
    (:func:`lookback_launch`). The checks are kept lean:
    at the callers' sizes the call's host time is most of its cost."""
    n = counts.numel()
    dev = counts.device
    if counts.dtype != torch.int32 or counts.dim() != 1 or not counts.is_contiguous():
        raise ValueError(f"counts must be a contiguous int32 [{n}] tensor on {dev}")
    if n == 0:
        raise ValueError("counts is empty")
    if dev.type != "cuda":
        if dev.type == "cpu":
            return block_offsets_torch(counts)
        raise ValueError(f"no scan kernel for device {dev}")
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    kern = _CHECKED if _CHECKED is not None else _kernels()
    with on_device(dev):
        stream = stream_of(dev)
        if n <= OFFSETS_TILE:
            rc = kern.lib.fac_block_offsets(counts.data_ptr(), n, offsets.data_ptr(), None, 0, 0,
                                            stream)
        else:
            rc = lookback_launch(dev, stream, -(-n // OFFSETS_CHAIN_TILE),
                                 lambda status, epoch, base: kern.lib.fac_block_offsets(
                                     counts.data_ptr(), n, offsets.data_ptr(), status, epoch,
                                     base, stream))
    kern.check(rc, "block_offsets")
    LAUNCHES["block_offsets"] += 1
    return offsets


def hit_words(ids: torch.Tensor, bits: torch.Tensor, offsets: torch.Tensor,
              count: int, T: ScanTables, halo: int):
    """(pos int64 [count] ascending, words int64 [count, 2W] u32 halves) from
    the bit words and block offsets of :func:`scan_bits` and
    :func:`block_offsets`; ``count`` is ``offsets[-1]``, read by the caller.
    CPU tensors run :func:`hit_words_torch`; CUDA tensors launch
    ``hit_words_kernel``, or ``hit_words_wide_kernel`` for tables wider than
    ``MAX_LIMBS`` or deeper than ``MAX_K`` rows."""
    _check(ids, T, halo)
    dev = ids.device
    nblocks = -(-ids.numel() // SCAN_BLOCK_SYMS)
    _check_int32("bits", bits, nblocks * (SCAN_BLOCK_SYMS // 32), dev)
    _check_int32("offsets", offsets, nblocks + 1, dev)
    if count == 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros((0, 2 * T.W), dtype=torch.int64, device=dev))
    if dev.type == "cpu":
        return hit_words_torch(ids, bits, offsets, count, T, halo)
    pos = torch.empty(count, dtype=torch.int64, device=dev)
    words = torch.empty((count, 2 * T.W), dtype=torch.int64, device=dev)
    kern = _CHECKED if _CHECKED is not None else _kernels()
    wide = _wide(T)
    entry = kern.lib.fac_hit_words_wide if wide else kern.lib.fac_hit_words
    with on_device(dev):
        rc = entry(ids.data_ptr(), ids.numel(), bits.data_ptr(), offsets.data_ptr(),
                   *_tables_args(T), halo, nblocks, pos.data_ptr(), words.data_ptr(),
                   stream_of(dev))
    name = "hit_words_wide" if wide else "hit_words"
    kern.check(rc, name)
    LAUNCHES[name] += 1
    return pos, words


def packed_hits(ids: torch.Tensor, T: ScanTables, halo: int, max_count: Optional[int] = None):
    """Shift-AND pass emitting per-hit (end positions, match words).

    Returns ``(count, pos [count] int64, words [count, 2W])``: ``pos`` is the
    stream index of each hit's last symbol, ascending; ``words`` the OR over
    error rows of the per-field match bits at that position (u32 halves).
    The hit count is the one value read back from the device between the
    kernels. With ``count > max_count`` the positions and words are not
    produced: ``(count, None, None)``."""
    if ids.numel() == 0:
        return (0, torch.zeros(0, dtype=torch.int64, device=ids.device),
                torch.zeros((0, 2 * T.W), dtype=torch.int64, device=ids.device))
    trace.launch()
    with trace.span("hit_list") as sp:
        with trace.timed(ids.device):
            bits, counts = scan_bits(ids, T, halo)
            offsets = block_offsets(counts)
        with trace.wait("hit_count"):
            count = int(offsets[-1])
        if sp:
            sp.set(hits=count)
        if max_count is not None and count > max_count:
            return count, None, None
        pos, words = hit_words(ids, bits, offsets, count, T, halo)
    return count, pos, words


# ---------------------------------------------------------------------------
# Exact lane
# ---------------------------------------------------------------------------

_SPACE_COUNTER = itertools.count(1)


def _space_token(engine) -> int:
    """Stable per-engine id for device-corpus cache keys (id() could be
    reused after GC; this token never is)."""
    tok = getattr(engine, "_dev_space_token", None)
    if tok is None:
        tok = next(_SPACE_COUNTER)
        engine._dev_space_token = tok
    return tok


def _exact_consts(engine, pk: PackedExact, device: torch.device):
    """(tables, field columns, field shifts) of the exact lane on ``device``,
    cached on the engine (``engine.to`` drops the cache)."""
    cache = getattr(engine, "_packed_dev_consts", None)
    if cache is None or cache[0] != device:
        fb = _field_bits(pk)
        cache = (device, (
            tables_from_numpy(
                pk.word_tbl, pk.starts, pk.match_mask(),
                np.zeros((1, 2 * pk.W), np.uint32), device=device,
            ),
            torch.tensor([c for c, _ in fb], dtype=torch.int64, device=device),
            torch.tensor([s for _, s in fb], dtype=torch.int64, device=device),
        ))
        engine._packed_dev_consts = cache
    return cache[1]


def _run_exact_kernel(ids: torch.Tensor, T: ScanTables, halo: int, cols, shs):
    """Field emissions of one exact pass: (positions, field indices) as numpy
    int64, field-major with positions ascending within each field. Field
    bits are expanded on the device, so one (pos, field) pair per emission
    crosses to the host, in one copy."""
    count, pos, w = packed_hits(ids, T, halo)
    if count == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    with trace.span("step") as sp:
        bits = (w[:, cols] >> shs) & 1                      # [K, F]
        with trace.wait("emission_count"):
            eidx = compact_indices(bits.T.reshape(-1))      # field-major
        out = torch.stack([pos[eidx % count], eidx // count])
        if sp:
            sp.set(rows=out.shape[1])
    with trace.wait("rows", out.nbytes):
        out = out.cpu().numpy()
    return out[0], out[1]


def exact_hits_packed(engine, haystack: str, view):
    """All exact state-arrivals at output nodes: (ends [h], node field [h])
    as numpy arrays; ends are end-exclusive grapheme indices. None when the
    engine isn't packable."""
    from ..utils import device_corpus

    pk = packed_exact_of(engine)
    if pk is None:
        return None
    halo = pk.m_max

    n_graphemes = len(view)
    if n_graphemes == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    device = engine.device
    T, cols, shs = _exact_consts(engine, pk, device)
    transcode = lambda h: np.ascontiguousarray(pk.transcode(h, view, engine.dense), dtype=np.uint8)

    if n_graphemes <= RESIDENT_MAX:
        # Resident path: the transcoded corpus stays on the device across
        # searches; a repeated search ships nothing but the hits back.
        ids_dev, n = device_corpus.resident(
            haystack, ("pk-exact", _space_token(engine)), transcode, device
        )
        pos, fld = _run_exact_kernel(ids_dev, T, halo, cols, shs)
        keep = pos < n
        return pos[keep] + 1, fld[keep]

    # Streaming path for corpora past the resident budget: slices overlap by
    # m_max - 1 symbols so every match ends inside exactly one slice's
    # owned range.
    ids = transcode(haystack)
    n = len(ids)
    ends_all: List[np.ndarray] = []
    fields_all: List[np.ndarray] = []
    for c0 in range(0, n, STREAM_CHUNK):
        c1 = min(n, c0 + STREAM_CHUNK)
        lo = max(0, c0 - (pk.m_max - 1))
        ids_dev = torch.from_numpy(ids[lo:c1]).to(device)
        pos, fld = _run_exact_kernel(ids_dev, T, halo, cols, shs)
        keep = (pos >= (c0 - lo)) & (pos < (c1 - lo))
        ends_all.append(pos[keep] + lo + 1)
        fields_all.append(fld[keep])
    return np.concatenate(ends_all), np.concatenate(fields_all)


# ---------------------------------------------------------------------------
# Fuzzy anchors (the beam lanes' candidate starts)
# ---------------------------------------------------------------------------

def hit_flags(bits: torch.Tensor, n: int) -> torch.Tensor:
    """u8 [n]: the hit flag of each stream position, unpacked from the bit
    words of :func:`scan_bits` (bit ``i`` of word ``j`` is position
    ``32 j + i``)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return ((bits.view(torch.uint8).reshape(-1, 1) >> shifts) & 1).reshape(-1)[:n]


def anchor_covered_flags(ids: torch.Tensor, T: ScanTables, halo: int, span: int,
                         n_live: int) -> torch.Tensor:
    """u8 [len(ids)]: 1 where a position may start a fuzzy match — some hit
    of the scan ends at it or within the ``span - 1`` positions after it —
    and the position is below ``n_live``. The scan's hit bits, dilated
    backwards over the window span (``compact.dilate_any``)."""
    from .compact import dilate_any

    bits, _counts = scan_bits(ids, T, halo)
    covered = dilate_any(hit_flags(bits, ids.numel()), span)
    covered[n_live:] = 0
    return covered


def fuzzy_anchors_packed(engine, haystack: str, threshold) -> Optional[torch.Tensor]:
    """Candidate anchor positions (a superset of all match starts) for a
    fuzzy search at ``threshold``, ascending int64 on the engine's device;
    None when the engine does not pack or some pattern's budget is past
    ``MAX_USEFUL_K``. Positions are in the prefilter's grapheme indexing
    (the engine's for ASCII and for the first-char class stream).

    The scan runs the JAX package's per-pattern budgets (a swap costs two
    errors) without the Damerau rows, up to ``MAX_SCAN_K`` rows, so the
    anchors are the JAX package's.

    Haystacks of up to ``RESIDENT_MAX`` characters scan the resident
    prefilter stream once; longer ones stream ``STREAM_CHUNK`` segments,
    each with ``halo`` symbols of context on both sides, and keep the
    anchors of the segment's own range."""
    from ..utils import device_corpus
    from .verify_dp import _dev_cache

    pk = packed_fuzzy_of(engine)
    if pk is None:
        return None
    thr = np.float32(threshold)
    ks = [pk.filt.k_for(bp, thr) for bp in pk.filt.patterns]
    if None in ks:
        return None
    match, init, k = pk.fuzzy_masks(ks)
    halo = pk.m_max + k
    span = halo  # the longest window m + k over the patterns
    device = engine.device
    T = _dev_cache(engine, ("anchors", tuple(ks), str(device)), lambda: tables_from_numpy(
        pk.word_tbl, pk.starts, match, init, device=device))
    transcode = lambda h: np.ascontiguousarray(pk.filt.transcode(h)[0], dtype=np.uint8)

    if len(haystack) == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    # len(haystack) bounds the grapheme count from above.
    if len(haystack) <= RESIDENT_MAX:
        ids, n = device_corpus.resident(
            haystack, ("pk-fuzzy", _space_token(engine)), transcode, device)
        return compact_indices(anchor_covered_flags(ids[:n], T, halo, span, n))

    ids = transcode(haystack)
    n = len(ids)
    parts: List[torch.Tensor] = []
    for c0 in range(0, n, STREAM_CHUNK):
        c1 = min(n, c0 + STREAM_CHUNK)
        lo, hi = max(0, c0 - halo), min(n, c1 + halo)
        seg = torch.from_numpy(ids[lo:hi]).to(device)
        a = compact_indices(anchor_covered_flags(seg, T, halo, span, hi - lo)) + lo
        parts.append(a[(a >= c0) & (a < c1)])
    return torch.cat(parts)
