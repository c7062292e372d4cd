"""ctypes bindings for the native C++ minibatcher (``native/batcher.cc``).

Counterpart of ``zigp_tpu/io/native.py``. ``NativeDataSet`` stands in for
``training.data.DataSet``: epochs are shuffled as an index permutation (the
rows never move), each batch is one gather with epoch wraparound, and
``next_block`` stages K minibatches for a block of scanned steps in one
native call. For the same seed it draws the same batches as the JAX
package's ``NativeDataSet`` (the same source, the same ``std::mt19937_64``).

The library is compiled from the repository's ``native/batcher.cc`` with
``g++ -O3 -shared -fPIC`` at first use, into ``_build/`` beside this module
(listed in ``.gitignore``), never into ``native/`` (the JAX package's
``make`` target). The file name carries a hash of the source and the flags,
so an edited source rebuilds. The build holds an ``fcntl`` lock on
``_build/.lock`` and renames the finished library into place, so processes
that build at once (pytest-xdist workers) wait for one compiler run and all
load the same complete file. Nothing is built at import.

``make_dataset`` returns a ``NativeDataSet`` when the library builds and
loads, the numpy ``DataSet`` otherwise (no compiler on the machine), as the
JAX package's does; ``available()`` says which, and ``build_error()`` why.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "batcher.cc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> Path:
    """``_build/libzigp_native-<hash>.so``: the hash covers the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libzigp_native-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile the source into ``path`` under the directory's lock, through
    a temporary file renamed into place; a no-op when another process has
    built it meanwhile."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cxx = os.environ.get("CXX", "g++")
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True,
                             timeout=300)
        if out.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{out.stdout}{out.stderr}")
        os.replace(tmp, path)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_dbl_p = ctypes.POINTER(ctypes.c_double)
    lib.zigp_batcher_create.restype = ctypes.c_void_p
    lib.zigp_batcher_create.argtypes = [c_dbl_p, c_dbl_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_uint64]
    lib.zigp_batcher_next.restype = None
    lib.zigp_batcher_next.argtypes = [ctypes.c_void_p, ctypes.c_int64, c_dbl_p, c_dbl_p]
    lib.zigp_batcher_next_block.restype = None
    lib.zigp_batcher_next_block.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, c_dbl_p, c_dbl_p]
    lib.zigp_batcher_skip.restype = None
    lib.zigp_batcher_skip.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.zigp_batcher_epochs.restype = ctypes.c_int64
    lib.zigp_batcher_epochs.argtypes = [ctypes.c_void_p]
    lib.zigp_batcher_destroy.restype = None
    lib.zigp_batcher_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built if needed; None (once and for all in this
    process) when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            _lib = _bind(ctypes.CDLL(str(path)))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available (None when it is, or before the first try)."""
    return _error


def _as_c(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeDataSet:
    """Epoch-shuffled minibatcher backed by the C++ batcher; its batches are
    float64."""

    def __init__(self, x: np.ndarray, y: np.ndarray, *, seed: int = 121):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native batcher unavailable ({_error})")
        self._lib = lib
        # contiguous float64 copies, owned for the lifetime of the handle
        self._x = np.ascontiguousarray(x, dtype=np.float64)
        self._y = np.ascontiguousarray(np.asarray(y).reshape(self._x.shape[0], -1), dtype=np.float64)
        self._n, self._dx = self._x.shape
        self._dy = self._y.shape[1]
        self._h = lib.zigp_batcher_create(_as_c(self._x), _as_c(self._y), self._n, self._dx, self._dy, seed)

    @property
    def num_examples(self) -> int:
        return self._n

    @property
    def arrays(self):
        """(X, Y) backing arrays, for device-resident sampling."""
        return self._x, self._y

    @property
    def epochs_completed(self) -> int:
        return int(self._lib.zigp_batcher_epochs(self._h))

    def next_batch(self, batch_size: int, shuffle: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        bx = np.empty((batch_size, self._dx), dtype=np.float64)
        by = np.empty((batch_size, self._dy), dtype=np.float64)
        self._lib.zigp_batcher_next(self._h, batch_size, _as_c(bx), _as_c(by))
        return bx, by

    def next_block(self, batch_size: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """k minibatches in one call: ((k, B, dx), (k, B, dy)), the same rows
        as k calls of ``next_batch``."""
        bx = np.empty((k, batch_size, self._dx), dtype=np.float64)
        by = np.empty((k, batch_size, self._dy), dtype=np.float64)
        self._lib.zigp_batcher_next_block(self._h, batch_size, k, _as_c(bx), _as_c(by))
        return bx, by

    def skip(self, batch_size: int, k: int) -> None:
        """Move past k batches without copying rows (resume)."""
        self._lib.zigp_batcher_skip(self._h, batch_size, k)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.zigp_batcher_destroy(h)
            self._h = None


def make_dataset(x: np.ndarray, y: np.ndarray, *, seed: int = 121):
    """``NativeDataSet`` when the library is available, numpy ``DataSet`` otherwise."""
    if available():
        return NativeDataSet(x, y, seed=seed)
    from ..training.data import DataSet

    return DataSet(x, y, seed=seed)
