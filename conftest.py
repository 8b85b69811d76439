"""Session set-up that has to run before any test module is imported.

The JAX package's native library (``fuzzy_aho_corasick_tpu/utils/native.py``)
compiles on first use into one ``fastpath.so.tmp`` beside its source, so
test processes that start together (``pytest -n``) race on that file, and a
process that loses has no native lane for the rest of the run: its native
cases skip, and its host searches take the oracle, whose match order
differs. Here each process builds or loads the library under a file lock,
so the first builds and the others load what it built. The loader is read
by its file path, so that nothing imports ``jax`` before
``tests/conftest.py`` has chosen its platform.
"""

import fcntl
import importlib.util
import os

ROOT = os.path.dirname(os.path.abspath(__file__))


def _build_jax_native() -> None:
    path = os.path.join(ROOT, "fuzzy_aho_corasick_tpu", "utils", "native.py")
    spec = importlib.util.spec_from_file_location("_fac_native_build", path)
    native = importlib.util.module_from_spec(spec)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", ".jax-native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        spec.loader.exec_module(native)
        native.lib()


_build_jax_native()
