"""Where ``bf16x3_mm.cu``'s tile instance spends its time, and the routes
and tile widths its plan chose, at the solve-precision path's shapes.

    python -m zigp_tpu_torch.experiments.bf16x3_phases [--shapes bulk long-k ...]

For each shape (the 105 × 250 grid at B = 8192, the champion at B = 4000,
the flagship at B = 1000; ``SHAPES``), on seeded operands in the path's
layout, one JSON line with: the plan (instance, copy routes, k ranges, tile
width); device µs a call (50 calls captured once in a CUDA graph, one replay
timed) of the kernel as planned, with both operands forced onto cp.async
(``copy_width`` patched to its cp.async width: the route TMA replaced), and,
where k is cut, with the 128-column tile forced (``NARROW_TILES`` 0);
exact-float32 ``torch.matmul``'s device µs; the bound (bytes over 3.35
TB/s against the three passes on the bf16 tensor cores); and cycles a
chunk by phase in the grid's first CTA, each warpgroup's median over its
chunks (``bf16x3_phases.cu``: the kernel built with its phase marks;
``wait`` its stage landed, ``split``, ``products done`` the wait for the
products two chunks back, ``barrier``, ``mma`` starting the three
products of each k16 step, ``fill`` the next copies, ``chunk`` start to
start). The marks' stores are inside the marked build's cycles, not
inside the timed library build. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..ops.cuda import _build
from ..ops.cuda import bf16x3 as bx

SOURCE = Path(__file__).resolve().parent / "bf16x3_phases.cu"
PEAK_BYTES_PER_S, PEAK_BF16 = 3.35e12, 989e12  # H100 SXM data sheet
REPS = 50
PHASES = ("wait", "split", "products done", "barrier", "mma", "fill")  # between marks 0-1, ..., 5-6


def _t(x):
    return x.transpose(-1, -2)


# name: (a, b) factories on (generator, device), in the layout the path gives the product
SHAPES = {
    "bulk": lambda r: (r(2, 250, 250), r(2, 250, 8192)),  # V = L⁻¹ K_mn, the grid
    "bulk L-T": lambda r: (_t(r(2, 250, 250)), r(2, 250, 8192)),  # L⁻ᵀ V
    "long-k": lambda r: (r(2, 250, 8192), _t(r(2, 250, 8192))),  # the backward's (n, B)(B, n)
    "long-k 105": lambda r: (r(2, 105, 8192), _t(r(2, 105, 8192))),
    "long-k 105x250": lambda r: (r(2, 105, 8192), _t(r(2, 250, 8192))),
    "champion bulk": lambda r: (r(2, 200, 200), r(2, 200, 4000)),
    "champion long-k": lambda r: (r(2, 200, 4000), _t(r(2, 200, 4000))),
    "flagship long-k": lambda r: (r(2, 100, 1000), _t(r(2, 100, 1000))),
}


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "libbf16x3_phases.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(SOURCE)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.zigp_bf16x3_mm_f32.argtypes = [ctypes.c_void_p] * 5
    lib.zigp_bf16x3_mm_f32.restype = ctypes.c_int
    lib.zigp_bf16x3_marks.argtypes = [ctypes.c_void_p]
    lib.zigp_bf16x3_marks.restype = ctypes.c_int
    return lib


def card() -> str:
    q = "--query-gpu=name,power.limit"
    return subprocess.run(["nvidia-smi", q, "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def device_us(fn) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / REPS * 1e3


def with_patch(fn, **patches):
    """``fn()`` with module attributes of ``bf16x3`` replaced, the call cache
    emptied before and after (a plan is cached by signature)."""
    saved = {k: getattr(bx, k) for k in patches}
    bx._CALLS.clear()
    for k, v in patches.items():
        setattr(bx, k, v)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            setattr(bx, k, v)
        bx._CALLS.clear()


def cp_async_only(ptr, rows, K, s_row, s_k, batch):
    """``copy_width`` with TMA taken away: the cp.async width it would give."""
    w = bx_copy_width(ptr, rows, K, s_row, s_k, batch)
    if w:
        return w
    strides = [4 * (s_k if (s_k != 1 and s_row == 1) else s_row)] + [4 * s for n, s in batch if n > 1]
    return next((v for v in (4, 2) if ptr % (4 * v) == 0 and all(s % (4 * v) == 0 for s in strides)), 1)


bx_copy_width = bx.copy_width


def phases(lib, a, b) -> dict:
    """Median cycles a chunk by phase in the first CTA, a warpgroup each."""
    lib_fn = lib.zigp_bf16x3_mm_f32
    c = with_patch(lambda: bx.bf16x3_mm_cuda(a, b), _fn=lib_fn)
    torch.cuda.synchronize()
    del c
    marks = np.zeros((2, 64, 8), np.int64)
    err = lib.zigp_bf16x3_marks(marks.ctypes.data)
    if err:
        raise RuntimeError(f"reading the marks: cudaError {err}")
    p = bx.plan_of(a, b)
    n = min(64, -(-min(a.shape[-1], p.ks) // bx.CHUNK))
    out = {}
    for wg in range(2):
        m = marks[wg, :n].astype(np.float64)
        if n < 2 or not m[:, :7].all():
            continue
        d = np.diff(m[:, :7], axis=1)
        inner = slice(1, n - 1) if n > 3 else slice(0, n)
        out[f"wg{wg}"] = {**{k: float(np.median(d[inner, i])) for i, k in enumerate(PHASES)},
                          "chunk": float(np.median(np.diff(m[:, 0])))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES), choices=list(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bf16x3_phases: needs a CUDA device")
    lib = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    info = card()
    for name in args.shapes:
        a, b = SHAPES[name](r)
        p = bx.plan_of(a, b)
        G, M, K, N = int(np.prod(a.shape[:-2])), a.shape[-2], a.shape[-1], b.shape[-1]
        row = {"shape": name, "G": G, "M": M, "N": N, "K": K, "plan": p.label, "splits": p.splits, "tile_n": p.tile_n}
        row["device_us"] = device_us(lambda: bx.bf16x3_mm_cuda(a, b))
        row["cp_async_us"] = with_patch(lambda: device_us(lambda: bx.bf16x3_mm_cuda(a, b)), copy_width=cp_async_only)
        if p.splits > 1:
            row["wide_tiles_us"] = with_patch(lambda: device_us(lambda: bx.bf16x3_mm_cuda(a, b)), NARROW_TILES=0)
        row["matmul_us"] = device_us(lambda: torch.matmul(a, b))
        t_bytes = 4 * G * (M * K + K * N + M * N) / PEAK_BYTES_PER_S
        row["bound_us"] = max(t_bytes, 6 * G * M * N * K / PEAK_BF16) * 1e6
        row["cycles_a_chunk"] = phases(lib, a, b)
        row["card"] = info
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
