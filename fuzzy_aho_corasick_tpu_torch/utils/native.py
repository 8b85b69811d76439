"""ctypes loader for the native host fast paths (``native/fastpath.c``, a
copy of the JAX package's source).

The shared object is compiled at first use with ``gcc -O3 -march=native
-ffp-contract=off`` into ``build/native/<hash>/fastpath.so`` at the
repository root, keyed by a hash of the source, the flags and the CPU that
``-march=native`` resolves to, so an edited source or another host's CPU
rebuilds and an unchanged one loads at once. Concurrent builders (threads of
one process, or test workers collecting together) take a process-wide lock
and an ``fcntl`` lock on the build directory, compile to a per-process
temporary name and ``os.replace`` it into place, so every loader sees one
whole library. Every entry point has a NumPy fallback, so the package works
without a compiler: ``lib()`` is then None (``build_error()`` says why). See
``native/fastpath.c`` for what each routine replaces.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "fastpath.c"
BUILD_ROOT = _PKG.parent / "build" / "native"
#: -ffp-contract=off: the BFS penalty arithmetic must round every f32 op like
#: the oracle's numpy scalars — an FMA contraction would change similarities
#: by 1 ULP.
CFLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_ERROR: Optional[str] = None


def _target(gcc: str) -> str:
    """The ``-march`` that ``-march=native`` resolves to on this host (part
    of the build's hash: a library built for one CPU may not run on
    another)."""
    out = subprocess.run([gcc, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, timeout=60).stdout
    return " ".join(line.split()[-1] for line in out.splitlines()
                    if line.strip().startswith("-march="))


def library_path() -> Optional[Path]:
    """Where the library for this source, these flags and this CPU lives
    (None without ``gcc``)."""
    gcc = shutil.which("gcc")
    if gcc is None:
        return None
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CFLAGS).encode())
    h.update(_target(gcc).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "fastpath.so"


def _compile(so: Path) -> None:
    """Build ``so`` once across threads and processes: an ``fcntl`` lock on
    the build directory, a per-process temporary, then ``os.replace``."""
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return
        tmp = so.with_name(f"fastpath.{os.getpid()}.so.tmp")
        try:
            subprocess.run([shutil.which("gcc") or "gcc", *CFLAGS, str(SOURCE), "-o", str(tmp)],
                           check=True, capture_output=True, text=True, timeout=120)
            os.replace(tmp, so)
        finally:
            tmp.unlink(missing_ok=True)


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _ERROR
    try:
        so = library_path()
        if so is None:
            _ERROR = "gcc not found"
            return None
        if not so.exists():
            _compile(so)
        lib = ctypes.CDLL(str(so))
    except subprocess.CalledProcessError as e:
        _ERROR = f"gcc failed: {e.stderr[-2000:]}"
        return None
    except Exception as e:
        _ERROR = repr(e)
        return None
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    f32c = ctypes.c_float
    p8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.transcode_u8.argtypes = [p8, i64, p8, p8]
    lib.transcode_i32.argtypes = [p8, i64, p32, p32]
    lib.bitap_scan.argtypes = [p64, i32, i32, p8, i64, p64, p64, p8]
    if hasattr(lib, "bitap_scan_damerau"):
        lib.bitap_scan_damerau.argtypes = [
            p64, i32, i32, p8, i64, p64, p64, p64, p64, p8
        ]
    if hasattr(lib, "bfs_search"):
        # Raw void pointers on purpose: the BFS lane is a per-call latency
        # path and ndpointer's from_param validates every array argument
        # on every call; ops/native_bfs caches the .ctypes.data addresses once
        # per engine (holding the arrays alive alongside them).
        vp = ctypes.c_void_p
        lib.bfs_search.argtypes = [
            vp, vp, vp, i32,               # goto, edge_target, edge_class, max_deg
            vp, vp, i32,                   # out_count, out_list, max_out
            vp, vp, i32,                   # sb_edge, sim, C
            vp, vp, vp,                    # node_ceil, pat_len, pat_weight
            i32, f32c,                     # mef, threshold
            f32c, f32c, f32c, f32c, f32c, f32c,  # max_pen, penalties, min_sym
            i32, vp, vp,                   # window-skip flag + masks
            ctypes.c_char_p, vp, i64,      # hay bytes, byte->class table, len
            vp, i64,                       # out_rows, out_cap
        ]
        lib.bfs_search.restype = i64
    if hasattr(lib, "bfs_engine_new"):
        vp = ctypes.c_void_p
        # Same layout as bfs_search minus the per-call (hay, len, rows, cap).
        lib.bfs_engine_new.argtypes = [
            vp, vp, vp, i32,               # goto, edge_target, edge_class, deg
            vp, vp, i32,                   # out_count, out_list, max_out
            vp, vp, i32,                   # sb_edge, sim, C
            vp, vp, vp,                    # node_ceil, pat_len, pat_weight
            i32, f32c,                     # mef, threshold
            f32c, f32c, f32c, f32c, f32c, f32c,
            i32, vp, vp,                   # window-skip flag + masks
            vp,                            # byte->class table
        ]
        lib.bfs_engine_new.restype = vp
        lib.bfs_engine_free.argtypes = [vp]
        lib.bfs_search_h.argtypes = [vp, ctypes.c_char_p, i64, vp, i64]
        lib.bfs_search_h.restype = i64
    pi64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    if hasattr(lib, "greedy_nonoverlap"):
        lib.greedy_nonoverlap.argtypes = [pi64, pi64, i64, p8, p8]
    if hasattr(lib, "replace_emit_table"):
        lib.replace_emit_table.argtypes = [
            ctypes.c_char_p, i64,          # data, commit
            pi64, pi64, p32, i64,          # s, e, pat, n
            p8, pi64, i32, p8,             # tbl, tbl_off, ntbl, keep_orig
            pi64, p8,                      # state, out
        ]
        lib.replace_emit_table.restype = i64
    if hasattr(lib, "replace_emit_batch"):
        lib.replace_emit_batch.argtypes = [
            ctypes.c_char_p,               # superwindow bytes
            pi64, pi64, pi64, i32,         # doff, base, commit, nwin
            pi64, pi64, p32, p32, i64,     # s, e, pat, wid, n
            p8, pi64, i32, p8,             # tbl, tbl_off, ntbl, keep_orig
            pi64, p8,                      # state, out
        ]
        lib.replace_emit_batch.restype = i64
    return lib


def lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        with _LOCK:
            if not _TRIED:
                _LIB = _build_and_load()
                _TRIED = True
    return _LIB


def build_error() -> Optional[str]:
    """Why ``lib()`` is None (None while it loads or before the first try)."""
    return _ERROR


def transcode_bytes_u8(data: bytes, table: np.ndarray) -> np.ndarray:
    """Byte stream -> uint8 symbol ids via a 256-entry uint8 table."""
    raw = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(len(raw), dtype=np.uint8)
    L = lib()
    if L is not None:
        L.transcode_u8(raw, len(raw), np.ascontiguousarray(table), out)
    else:
        out[:] = table[raw]
    return out


def transcode_bytes_i32(data: bytes, table: np.ndarray) -> np.ndarray:
    """Byte stream -> int32 symbol ids via a 256-entry int32 table."""
    raw = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(len(raw), dtype=np.int32)
    L = lib()
    if L is not None:
        L.transcode_i32(raw, len(raw), np.ascontiguousarray(table, dtype=np.int32), out)
    else:
        out[:] = table[raw]
    return out


def bitap_scan_hits(mask: np.ndarray, m: int, k: int, ids: np.ndarray,
                    damerau: bool = False) -> Optional[np.ndarray]:
    """Native shift-AND scan -> uint8 hit flags per position, or None when the
    native library is unavailable. ``damerau=True`` runs the recurrence with
    pending-transposition rows (swap = 1 error)."""
    L = lib()
    if L is None:
        return None
    if damerau and not hasattr(L, "bitap_scan_damerau"):
        return None
    ids8 = np.ascontiguousarray(ids, dtype=np.uint8)
    r = np.array([(1 << d) - 1 for d in range(k + 1)], dtype=np.uint64)
    nr = np.zeros(k + 1, dtype=np.uint64)
    hit = np.empty(len(ids8), dtype=np.uint8)
    mask_c = np.ascontiguousarray(mask, dtype=np.uint64)
    if damerau:
        s = np.zeros(k + 1, dtype=np.uint64)
        ns = np.zeros(k + 1, dtype=np.uint64)
        L.bitap_scan_damerau(mask_c, m, k, ids8, len(ids8), r, nr, s, ns, hit)
    else:
        L.bitap_scan(mask_c, m, k, ids8, len(ids8), r, nr, hit)
    return hit


def greedy_nonoverlap(s: np.ndarray, e: np.ndarray, span: int) -> Optional[np.ndarray]:
    """Keep flags for greedy interval scheduling over rows already in rank
    order (superwindow-global, disjoint-window coordinates); None when the
    native library is unavailable (the caller runs the bisect loop)."""
    L = lib()
    if L is None or not hasattr(L, "greedy_nonoverlap"):
        return None
    s64 = np.ascontiguousarray(s, dtype=np.int64)
    e64 = np.ascontiguousarray(e, dtype=np.int64)
    if len(s64) and int((e64 - s64).min()) <= 0:
        # Zero-length intervals: the C occupancy pass keeps them but occupies
        # nothing, while the bisect fallback inserts the point and rejects a
        # later interval containing it. Decline so both pipelines run the
        # same (fallback) semantics — such rows are vanishingly rare.
        return None
    occ = np.zeros(max(span, 1), dtype=np.uint8)
    keep = np.empty(len(s64), dtype=np.uint8)
    L.greedy_nonoverlap(s64, e64, len(s64), occ, keep)
    return keep.view(bool)


class ReplacementTable:
    """Flattened replacement table for the native emit: concatenated bytes +
    offsets + keep-original flags (None entries)."""

    __slots__ = ("tbl", "off", "keep", "n", "max_len")

    def __init__(self, table):
        parts = []
        off = [0]
        keep = []
        for r in table:
            if r is None:
                keep.append(1)
                parts.append(b"")
            else:
                keep.append(0)
                parts.append(r)
            off.append(off[-1] + len(parts[-1]))
        self.tbl = np.frombuffer(b"".join(parts) or b"\0", dtype=np.uint8)
        self.off = np.asarray(off, dtype=np.int64)
        self.keep = np.asarray(keep, dtype=np.uint8)
        self.n = len(table)
        self.max_len = int(max((len(p) for p in parts), default=0))


class _BatchEmitBuf:
    """Reusable output buffer for the batch emit (a fresh batch-sized np.empty
    per batch costs page-fault time on the critical emit path)."""

    __slots__ = ("buf",)

    def __init__(self):
        self.buf = np.empty(0, dtype=np.uint8)

    def get(self, cap: int) -> np.ndarray:
        if self.buf.size < cap:
            self.buf = np.empty(cap + (cap >> 2), dtype=np.uint8)
        return self.buf


def replace_emit_batch(data: bytes, emitted: int, doff, base, commit,
                       s, e, pat, wid, rt: "ReplacementTable",
                       buf: Optional[_BatchEmitBuf] = None) -> Optional[tuple]:
    """One superwindow BATCH's table-replacement emit in C: returns
    (out_memoryview, new_emitted) or None when the native library is
    unavailable. ``doff``/``base``/``commit`` are per-window (byte offset in
    ``data``, absolute stream base, commit length); ``s``/``e``/``pat``/
    ``wid`` the window-local match rows in stream order; ``emitted`` the
    absolute cursor carried across batches."""
    L = lib()
    if L is None or not hasattr(L, "replace_emit_batch"):
        return None
    doff64 = np.ascontiguousarray(doff, dtype=np.int64)
    base64 = np.ascontiguousarray(base, dtype=np.int64)
    cm64 = np.ascontiguousarray(commit, dtype=np.int64)
    s64 = np.ascontiguousarray(s, dtype=np.int64)
    e64 = np.ascontiguousarray(e, dtype=np.int64)
    p32 = np.ascontiguousarray(pat, dtype=np.int32)
    w32 = np.ascontiguousarray(wid, dtype=np.int32)
    n = len(s64)
    nwin = len(base64)
    # Output may extend past the last commit (keep-original overhang; see
    # replace_emit_table) — size for the furthest absolute span end.
    end_abs = int(base64[-1] + cm64[-1]) if nwin else 0
    if n:
        end_abs = max(end_abs, int((base64[w32] + e64).max()))
    cap = (end_abs - min(emitted, end_abs)) + n * rt.max_len + 1
    out = np.empty(cap, dtype=np.uint8) if buf is None else buf.get(cap)
    state = np.array([emitted], dtype=np.int64)
    written = L.replace_emit_batch(
        data, doff64, base64, cm64, nwin, s64, e64, p32, w32, n,
        rt.tbl, rt.off, rt.n, rt.keep, state, out,
    )
    return memoryview(out)[:written], int(state[0])


def replace_emit_table(data: bytes, cur: int, commit: int, s, e, pat,
                       rt: "ReplacementTable") -> Optional[tuple]:
    """One window's table-replacement emit in C: returns (out_bytes, new_cur)
    or None when the native library is unavailable."""
    L = lib()
    if L is None or not hasattr(L, "replace_emit_table"):
        return None
    s64 = np.ascontiguousarray(s, dtype=np.int64)
    e64 = np.ascontiguousarray(e, dtype=np.int64)
    p32 = np.ascontiguousarray(pat, dtype=np.int32)
    n = len(s64)
    # Output may extend past ``commit``: a keep-original match (None table
    # entry / pattern index >= table length) copies its full span, and
    # ownership only requires start < commit — the span's END can overhang
    # the window by arbitrarily many bytes. Size for the furthest span end.
    hi = max(commit, int(np.max(e64, initial=0)))
    cap = (hi - min(cur, commit)) + n * rt.max_len + 1
    out = np.empty(cap, dtype=np.uint8)
    state = np.array([cur], dtype=np.int64)
    written = L.replace_emit_table(
        data, commit, s64, e64, p32, n, rt.tbl, rt.off, rt.n, rt.keep,
        state, out,
    )
    return out[:written], int(state[0])
