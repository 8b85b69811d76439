"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use by ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, which is loaded with ``ctypes``:
tensors pass as ``data_ptr()`` and the stream as
``torch.cuda.current_stream().cuda_stream``, all ``c_void_p``. The library
lands in ``build/kernels/<hash>/`` at the repository root, keyed by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads at once. ``ptxas -v``'s register and spill report is kept beside it in
``build.log``.

Nothing here runs at import time: a host without ``nvcc`` or a card imports
the package and runs the plain torch versions of the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(
    _PKG / "csrc" / name
    for name in ("packed_bitap.cu", "scan_wide.cu", "scan_offsets.cu", "many_step.cu",
                 "banded_dp.cu", "dp_pipeline.cu", "dp_typed.cu", "goto_walk.cu", "dp_list.cu",
                 "beam.cu")
)
#: Headers the sources include (part of the build's hash).
HEADERS = tuple(_PKG / "csrc" / name
                for name in ("packed_bitap.cuh", "banded_dp.cuh", "lookback.cuh"))
BUILD_ROOT = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # The DP keeps the oracle's f32 operation order: nothing may be
    # contracted into a fused multiply-add.
    "-fmad=false",
)

_c_void_p, _c_ll, _c_int, _c_f = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
)
_SIGNATURES = {
    # ids, n, tbl, starts, match, init, notlast, A, W, k, halo, chunk, nblocks,
    # bits, counts, stream
    "fac_scan_bits": [_c_void_p, _c_ll] + [_c_void_p] * 5 + [_c_int] * 5
    + [_c_ll] + [_c_void_p] * 3,
    # the same for W = 9..64 (csrc/scan_wide.cu)
    "fac_scan_bits_wide": [_c_void_p, _c_ll] + [_c_void_p] * 5 + [_c_int] * 5
    + [_c_ll] + [_c_void_p] * 3,
    # counts, len, offsets, status, epoch, base, stream
    "fac_block_offsets": [_c_void_p, _c_ll, _c_void_p, _c_void_p, _c_ll, _c_ll, _c_void_p],
    # ids, n, bits, offsets, tbl, starts, match, init, notlast, A, W, k, halo,
    # nblocks, pos, words, stream
    "fac_hit_words": [_c_void_p, _c_ll] + [_c_void_p] * 7 + [_c_int] * 4
    + [_c_ll] + [_c_void_p] * 3,
    # the same for W = 9..64 (csrc/scan_wide.cu)
    "fac_hit_words_wide": [_c_void_p, _c_ll] + [_c_void_p] * 7 + [_c_int] * 4
    + [_c_ll] + [_c_void_p] * 3,
    # pos, words, K, h0, W2, field, shift, rdepth, pc, R, k, rd_min, rd_max,
    # contain, start_lo, start_hi, pos_hi, ids, npad, limit, path_cls,
    # path_node, depth, node, Lmax, F, sim, C, node_ceil, sb_edge, out_count,
    # N, out_list, MO, pat_len, pat_weight, max_pen, p_sub, p_ins, p_del,
    # p_swap, floor, bound, E, deadend, write, counts, offsets, rows, stream
    "fac_many_step": [_c_void_p, _c_void_p, _c_ll, _c_ll, _c_int] + [_c_void_p] * 4
    + [_c_int] * 5 + [_c_ll] * 3 + [_c_void_p, _c_ll, _c_ll] + [_c_void_p] * 4
    + [_c_int] * 2 + [_c_void_p, _c_int] + [_c_void_p] * 3 + [_c_int]
    + [_c_void_p, _c_int] + [_c_void_p] * 2 + [_c_f] * 7 + [_c_int] * 3
    + [_c_void_p] * 4,
    # cand_field, cand_start, M, ids, ids_u8, npad, limit, path_cls,
    # path_node, depth, Lmax, F, sim, C, node_ceil, sb_edge, out_count, N,
    # max_pen, p_sub, p_ins, p_del, p_swap, floor, E, deadend, forbid,
    # map_tab, map_rowptr, map_fields, map_fw, pen, cnt, stream
    "fac_banded_dp": [_c_void_p, _c_void_p, _c_ll, _c_void_p, _c_int, _c_ll, _c_ll]
    + [_c_void_p] * 3 + [_c_int] * 2 + [_c_void_p, _c_int] + [_c_void_p] * 3
    + [_c_int] + [_c_f] * 6 + [_c_int] * 3 + [_c_void_p] * 3 + [_c_int]
    + [_c_void_p] * 3,
    # pos, words, K, h0, W2, combos, n_combo, start_lo, start_hi, pos_hi,
    # ids, ids_u8, npad, limit, path_cls, path_node, depth, node, Lmax, F,
    # sim, C, node_ceil, sb_edge, out_count, N, out_list, MO, pat_len,
    # pat_weight, max_pen, p_sub, p_ins, p_del, p_swap, floor, bound, E,
    # deadend, write, nblk, counts, offsets, rows, tags, stream
    "fac_dp_pipeline": [_c_void_p, _c_void_p, _c_ll, _c_ll, _c_int, _c_void_p, _c_int]
    + [_c_ll] * 3 + [_c_void_p, _c_int, _c_ll, _c_ll] + [_c_void_p] * 4
    + [_c_int] * 2 + [_c_void_p, _c_int] + [_c_void_p] * 3 + [_c_int]
    + [_c_void_p, _c_int] + [_c_void_p] * 2 + [_c_f] * 7 + [_c_int] * 3
    + [_c_ll] + [_c_void_p] * 5,
    # cand_field, cand_start, M, ids, ids_u8, npad, limit, path_cls,
    # path_node, depth, Lmax, F, sim, C, node_ceil, N, max_pen, p_sub, p_ins,
    # p_del, p_swap, floor, E, graph, nch, node_caps, root_caps, pen, stream
    "fac_banded_dp_typed": [_c_void_p, _c_void_p, _c_ll, _c_void_p, _c_int, _c_ll, _c_ll]
    + [_c_void_p] * 3 + [_c_int] * 2 + [_c_void_p, _c_int, _c_void_p, _c_int]
    + [_c_f] * 6 + [_c_int, _c_void_p, _c_int] + [_c_void_p] * 4,
    # pos, words, K, h0, W2, combos, n_combo, start_lo, start_hi, pos_hi,
    # nblk, status, epoch, base, cand_field, cand_start, cand_combo, total, stream
    "fac_typed_expand": [_c_void_p, _c_void_p, _c_ll, _c_ll, _c_int, _c_void_p, _c_int]
    + [_c_ll] * 4 + [_c_void_p, _c_ll, _c_ll] + [_c_void_p] * 5,
    # cand_field, cand_start, n_cand, items, ids, ids_u8, npad, limit,
    # path_cls, path_node, depth, node, Lmax, F, sim, C, node_ceil, N,
    # out_list, MO, pat_len, pat_weight, max_pen, p_sub, p_ins, p_del,
    # p_swap, floor, bound, E, graph, nch, node_caps, root_caps, limcls, adm,
    # nlc, dec, row_counts, ntile, stream
    "fac_typed_dp": [_c_void_p] * 3 + [_c_ll, _c_void_p, _c_int, _c_ll, _c_ll]
    + [_c_void_p] * 4 + [_c_int] * 2 + [_c_void_p, _c_int, _c_void_p, _c_int]
    + [_c_void_p, _c_int] + [_c_void_p] * 2 + [_c_f] * 7 + [_c_int, _c_void_p, _c_int]
    + [_c_void_p] * 4 + [_c_int] + [_c_void_p] * 2 + [_c_ll, _c_void_p],
    # cand_field, cand_start, n_cand, items, ids, ids_u8, npad, limit,
    # path_cls, path_node, depth, node, Lmax, F, sim, C, node_ceil, sb_edge,
    # out_count, N, out_list, MO, pat_len, pat_weight, max_pen, p_sub, p_ins,
    # p_del, p_swap, floor, bound, E, deadend, forbid, map_tab, map_rowptr,
    # map_fields, map_fw, dec, row_counts, ntile, stream
    "fac_count_dp": [_c_void_p] * 3 + [_c_ll, _c_void_p, _c_int, _c_ll, _c_ll]
    + [_c_void_p] * 4 + [_c_int] * 2 + [_c_void_p, _c_int] + [_c_void_p] * 3
    + [_c_int, _c_void_p, _c_int] + [_c_void_p] * 2 + [_c_f] * 7 + [_c_int] * 3
    + [_c_void_p] * 3 + [_c_int] + [_c_void_p] * 2 + [_c_ll, _c_void_p],
    # cand_field, cand_start, cand_combo, n_cand, items, live, depth, node,
    # out_list, MO, E, n_combo, counts, counts_stride, dec, row_counts,
    # ntile, rows, tags, stream
    "fac_count_emit": [_c_void_p] * 4 + [_c_ll] * 2 + [_c_void_p] * 3 + [_c_int] * 3
    + [_c_void_p, _c_int] + [_c_void_p] * 2 + [_c_ll] + [_c_void_p] * 3,
    # ids, sym_bytes, n_starts, n_read, folded, N, C, L, write, counts, keep,
    # overflow, tally, offsets, total, n_over, found, stream
    "fac_goto_walk": [_c_void_p, _c_int, _c_ll, _c_ll, _c_void_p] + [_c_int] * 4
    + [_c_void_p] * 5 + [_c_ll, _c_int] + [_c_void_p] * 2,
    # ids, sym_bytes, limit, go, sb, N, C, et_full, ec_full, Df, et_deep,
    # ec_deep, Dd, sim, out_count, out_list, MO, pat_len, pat_weight, npat,
    # ceil, max_pen, p_sub, p_ins, p_del, p_swap, floor, slack, E, T, starts,
    # n, write, counts, offsets, staged, total, flags, handed, stats,
    # scratch, scratch_bytes, stream
    "fac_beam_frontier": [_c_void_p, _c_int, _c_ll, _c_void_p, _c_void_p, _c_int, _c_int]
    + [_c_void_p] * 2 + [_c_int] + [_c_void_p] * 2 + [_c_int] + [_c_void_p] * 3 + [_c_int]
    + [_c_void_p] * 2 + [_c_int, _c_void_p] + [_c_f] * 7 + [_c_int] * 2
    + [_c_void_p, _c_ll, _c_int] + [_c_void_p] * 3 + [_c_ll] + [_c_void_p] * 4
    + [_c_ll, _c_void_p],
    # E, Df, Dd, T, N, C, MO, npat, sym_bytes, out
    "fac_beam_layout": [_c_int] * 9 + [_c_void_p],
    # staged, offsets, n, nchunk, T, out, out_pen, total, hist, stream
    "fac_beam_order": [_c_void_p] * 2 + [_c_ll] + [_c_int] * 2 + [_c_void_p] * 2 + [_c_ll]
    + [_c_void_p] * 2,
    # i
    "fac_beam_const": [_c_int],
    "fac_scan_block_syms": [],
    "fac_scan_wide_chunk": [],
    # W, k
    "fac_scan_wide_instance": [_c_int, _c_int],
    "fac_dp_pipeline_threads": [],
    "fac_offsets_tile": [],
    "fac_offsets_chain_tile": [],
    "fac_typed_tile": [],
    "fac_typed_expand_items": [],
    "fac_typed_rows_waves": [],
    "fac_count_tile": [],
    "fac_goto_walk_tile": [],
    "fac_goto_walk_keep": [],
    "fac_goto_walk_pair_max": [],
}


class Kernels:
    """The loaded library plus how it was built."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float, log: str):
        self.lib = lib
        self.path = path
        #: Seconds ``nvcc`` took in this process (0.0 when loaded from cache).
        self.build_seconds = build_seconds
        #: nvcc / ptxas output of the build that made the library.
        self.log = log

    def check(self, rc: int, what: str) -> None:
        """Raise if a C entry returned a CUDA error."""
        if rc != 0:
            msg = self.lib.fac_error_string(rc).decode()
            raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


_LOCK = threading.Lock()
_LOADED: Optional[Kernels] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            "csrc/ at first use"
        )
    return found


def _extra_flags(nvcc: str) -> tuple:
    """``--split-compile=0`` (optimise a source's kernels on all cores) where
    this nvcc has it; the many template instantiations build in about half
    the time with it."""
    out = subprocess.run([nvcc, "--help"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True).stdout
    return ("--split-compile=0",) if "--split-compile" in out else ()


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(out_dir: Path, so: Path) -> str:
    """Compile every source to an object, one ``nvcc`` each in parallel,
    then link the shared library; returns the build log."""
    nvcc = _nvcc()
    extra = _extra_flags(nvcc)
    jobs = []
    for src in SOURCES:
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    log, failed, errors = "", False, ""
    t0 = time.perf_counter()
    for cmd, _obj, proc in jobs:
        out, _ = proc.communicate()
        # Jobs run together, so this is the time until this one had ended.
        log += " ".join(cmd) + f"\n[done {time.perf_counter() - t0:.1f} s after start]\n" + out
        if proc.returncode != 0:
            failed = True
            errors += cmd[-1] + ":\n" + "\n".join(
                line for line in out.splitlines() if "error" in line.lower()) + "\n"
    if not failed:
        tmp = out_dir / f"libfac_kernels.{os.getpid()}.so.tmp"
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _c, obj, _p in jobs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log += " ".join(cmd) + "\n" + proc.stdout
        failed = proc.returncode != 0
        if not failed:
            os.replace(tmp, so)
    for _c, obj, _p in jobs:
        obj.unlink(missing_ok=True)
    (out_dir / "build.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{errors[-6000:] or log[-6000:]}")
    return log


def load() -> Kernels:
    """Build (once per source hash) and load the kernel library."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    with _LOCK:
        if _LOADED is not None:
            return _LOADED
        out_dir = BUILD_ROOT / _digest()
        so = out_dir / "libfac_kernels.so"
        log_path = out_dir / "build.log"
        seconds = 0.0
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            _build(out_dir, so)
            seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.fac_error_string.argtypes = [ctypes.c_int]
        lib.fac_error_string.restype = ctypes.c_char_p
        log = log_path.read_text() if log_path.exists() else ""
        _LOADED = Kernels(lib, so, seconds, log)
        return _LOADED
