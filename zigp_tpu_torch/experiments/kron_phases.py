"""Where ``kron_mv.cu``'s cluster instance spends its time, phase by phase,
and the tile sweep that chose the library's 16 × 16 tile.

    python -m zigp_tpu_torch.experiments.kron_phases [--shapes 2,105,250 2,10,100] \\
        [--tiles 16x16 16x32 16x64 32x32]

Builds ``kron_phases.cu`` (the kernel at every tile of the sweep, with a
``clock64()`` mark in thread 0 of every CTA after each phase) with nvcc,
launches it at each shape (G; Ma, Mb) and tile on seeded factors, both
orientations, and prints one JSON line each: per phase the median, least
and largest cycles over the CTAs (``p1`` T's rows, ``sync`` the first
cluster barrier, ``exchange`` the peers' rows through distributed shared
memory, ``p3`` Y's rows, ``end`` the store and the last cluster barrier),
the CTAs' spread of start times and the span from the first start to the
last end (global timer, ns), how many SMs the CTAs ran on, the card's SM
clock, the output's largest difference from ``kron_mv_2_plain``, and the
launch's ms per call with the host (CUDA events around 200 calls) and
device ms (the 200 calls captured once in a CUDA graph, one replay timed).
The marks' stores are inside those times; each shape's line ``library``
gives the library's own 16 × 16 build, without marks, timed the same way.
Needs a CUDA device and nvcc.
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
from ..ops.cuda import kron_matvec as km

SOURCE = Path(__file__).resolve().parent / "kron_phases.cu"
MAX_CTAS, MARKS = 4096, 10
PHASES = ("p1", "sync", "exchange", "p3", "end")  # between marks 1-2, 2-3, 3-4, 4-5, 5-6
REPS = 200


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "libkron_phases.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(SOURCE)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.zigp_kron_phases_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.zigp_kron_phases_f32.restype = ctypes.c_int
    lib.zigp_kron_marks.argtypes = [ctypes.c_void_p]
    lib.zigp_kron_marks.restype = ctypes.c_int
    return lib


def card() -> str:
    q = "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm"
    return subprocess.run(["nvidia-smi", q, "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def times(fn) -> tuple[float, float]:
    """(ms per call with the host, device ms per call) of ``fn`` over REPS
    calls: CUDA events around the calls, then the calls captured once in a
    CUDA graph and one replay timed."""
    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop) / REPS
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(REPS):
            fn()
    graph.replay()
    start.record()
    graph.replay()
    stop.record()
    stop.synchronize()
    return round(ms, 5), round(start.elapsed_time(stop) / REPS, 5)


def phases(lib, G: int, Ma: int, Mb: int, tm: int, tn: int, transpose: bool) -> dict:
    grid = (-(-Ma // tm), -(-Mb // tn), G)
    if grid[0] > km.MAX_CLUSTER:
        raise ValueError(f"kron_phases marks the cluster instance; ({G}; {Ma}, {Mb}) at {tm}x{tn} is past its reach")
    rng = np.random.RandomState(Ma * Mb)
    A, B, x = (torch.as_tensor(rng.randn(*s).astype(np.float32), device="cuda")
               for s in ((G, Ma, Ma), (G, Mb, Mb), (G, Ma * Mb)))
    y = torch.empty_like(x)

    def launch():
        err = lib.zigp_kron_phases_f32(A.data_ptr(), B.data_ptr(), x.data_ptr(), y.data_ptr(), Ma, Mb, G,
                                       int(transpose), tm, tn, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"kron_phases launch failed: cudaError {err}")

    ms, device_ms = times(launch)
    launch()  # the marks read are this launch's
    torch.cuda.synchronize()
    marks = np.zeros((MAX_CTAS, MARKS), np.uint64)
    if lib.zigp_kron_marks(marks.ctypes.data) != 0:
        raise RuntimeError("kron_phases: reading the marks failed")
    M = marks[: grid[0] * grid[1] * grid[2]].astype(np.int64)
    cycles = np.diff(M[:, 1:7], axis=1)
    stat = lambda v: [int(np.median(v)), int(v.min()), int(v.max())]
    return {"shape": [G, Ma, Mb], "tile": f"{tm}x{tn}", "transposed": transpose, "grid": list(grid),
            "ms": ms, "device_ms": device_ms,
            "cycles median/min/max": {name: stat(cycles[:, k]) for k, name in enumerate(PHASES)}
            | {"cta": stat(M[:, 6] - M[:, 1])},
            "start_spread_ns": int(M[:, 0].max() - M[:, 0].min()), "span_ns": int(M[:, 7].max() - M[:, 0].min()),
            "sms": len(set(M[:, 8].tolist())), "ctas": len(M),
            "max_abs_vs_plain": float((y - km.kron_mv_2_plain(A, B, x, transpose=transpose)).abs().max())}


def library(G: int, Ma: int, Mb: int) -> dict:
    """The library's kron_mv_2_cuda (16 × 16, no marks), both orientations:
    (ms, device ms)."""
    rng = np.random.RandomState(Ma * Mb)
    A, B, x = (torch.as_tensor(rng.randn(*s).astype(np.float32), device="cuda")
               for s in ((G, Ma, Ma), (G, Mb, Mb), (G, Ma * Mb)))
    return {f"{km.plan(G, Ma, Mb).name}{' T' if t else ''}": times(lambda: km.kron_mv_2_cuda(A, B, x, t))
            for t in (False, True)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=["2,105,250", "2,10,100"])
    ap.add_argument("--tiles", nargs="+", default=["16x16", "16x32", "16x64", "32x32"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kron_phases needs a CUDA device")
    lib = build()
    clock = card()
    for shape in args.shapes:
        G, Ma, Mb = (int(v) for v in shape.split(","))
        sweep = {}
        for tile in args.tiles:
            tm, tn = (int(v) for v in tile.split("x"))
            for transpose in (False, True):
                row = phases(lib, G, Ma, Mb, tm, tn, transpose)
                sweep[f"{tile}{' T' if transpose else ''}"] = (row["ms"], row["device_ms"])
                print(json.dumps({**row, "card": clock}), flush=True)
        print(json.dumps({"sweep": [G, Ma, Mb], "(ms, device ms), marks on": sweep, "library": library(G, Ma, Mb),
                          "card": clock}), flush=True)


if __name__ == "__main__":
    main()
