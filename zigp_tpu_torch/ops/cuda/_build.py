"""Build the CUDA sources under ``csrc/`` into shared libraries, at first use.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, where the hash
covers the source files and the compiler flags, so an edited source rebuilds
and an unchanged one is loaded from the cache. The sources have a plain C
interface and no PyTorch headers: ``nvcc`` takes seconds, and the library is
loaded with ``ctypes`` (pointers and the stream are passed as ``c_void_p``).

``build_all()`` starts one ``nvcc`` per source, all at once, and waits for
them; ``load(name)`` builds one source if it is not cached and returns its
``ctypes.CDLL``. Nothing here runs at import: the CPU tests import every
module, and this machine-independent part needs no compiler until a kernel
is launched on a CUDA tensor.

No ``--use_fast_math``: the kernels rely on IEEE ``sqrtf`` and division.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of zigp_tpu_torch are compiled on first use"
        )
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):  # .cu and any shared .cuh headers
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _start(src: Path, nvcc: str):
    """Start nvcc for ``src`` into a temporary file; None if already built."""
    out = _target(src)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return src, out, tmp, cmd, proc


def _finish(job) -> None:
    src, out, tmp, cmd, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name} ({' '.join(cmd)}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all() -> dict[str, Path]:
    """Compile every source that is not cached, one nvcc each, in parallel.
    Returns {name: library path}."""
    srcs = sources()
    with _lock:
        missing = [s for s in srcs if not _target(s).exists()]
        nvcc = nvcc_path() if missing else ""
        pending = [j for j in (_start(s, nvcc) for s in missing) if j is not None]
        errors = []
        for job in pending:
            try:
                _finish(job)
            except RuntimeError as e:  # wait for every nvcc before raising
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return {s.stem: _target(s) for s in srcs}


def build_log(name: str) -> str:
    """nvcc's output (with ``-Xptxas -v``: registers, shared memory, spills)
    from the build of ``csrc/<name>.cu``, or "" if it was loaded from cache
    without a log."""
    log = _target(CSRC / f"{name}.cu").with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        src = CSRC / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(src)
        path = _target(src)
        if not path.exists():
            with _lock:
                job = _start(src, nvcc_path())
                if job is not None:
                    _finish(job)
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
