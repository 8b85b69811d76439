"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use by ``nvcc`` for ``sm_90a`` into a
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
SOURCES = (_PKG / "csrc" / "packed_bitap.cu",)
BUILD_ROOT = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c_void_p, _c_ll, _c_int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    # ids, n, tbl, starts, match, init, notlast, A, W, k, halo, flags, stream
    "fac_scan_flags": [_c_void_p, _c_ll] + [_c_void_p] * 5 + [_c_int] * 4
    + [_c_void_p, _c_void_p],
    # ids, n, pos, nhits, tbl, starts, match, init, notlast, A, W, k, halo,
    # words, stream
    "fac_replay_words": [_c_void_p, _c_ll, _c_void_p, _c_ll] + [_c_void_p] * 5
    + [_c_int] * 4 + [_c_void_p, _c_void_p],
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


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load() -> Kernels:
    """Build (once per source hash) and load the kernel library."""
    global _LOADED
    with _LOCK:
        if _LOADED is not None:
            return _LOADED
        out_dir = BUILD_ROOT / _digest()
        so = out_dir / "libfac_kernels.so"
        log_path = out_dir / "build.log"
        seconds = 0.0
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"libfac_kernels.{os.getpid()}.so.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
            log_path.write_text(log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log[-4000:]}")
            os.replace(tmp, so)
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
