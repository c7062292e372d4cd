"""Where the tiled Cholesky kernels spend their cycles, phase by phase.

    python -m zigp_tpu_torch.experiments.chol_phases [--n 100 200] [--nb 4 8 16]
    python -m zigp_tpu_torch.experiments.chol_phases --cluster [--n 250 512]

Builds ``chol_phases.cu`` (``chol_tile.cuh``'s ``chol_blocked`` with a
``clock64()`` mark after each phase of each block step) with nvcc, runs it on
one seeded SPD matrix at each n and panel width, L only (``chol.cu``'s work)
and L with L⁻¹ (``chol_inv.cu``'s), and prints one JSON line each: the
cycles of the load, then, summed over the steps, of the panels with L_jj's
broadcast from shared memory (``P``), warp 0's lookahead (``D``: the next
diagonal block's tiles and factor) and the rest of each step's trailing
update after it (``U_rest``: the other warps' update beyond D), and the
store; the steps; the card's SM clock; and the relative error of L against
float64. Thread 0 reads the clock, so a step's time is P + D + U_rest.

With ``--cluster`` it runs the thread-block-cluster kernel
(``chol_inv_cluster.cu``) on the pair (G = 2) at every cluster size that
fits each n, and prints per size: the kernel's device ms with the marks on,
and per rank of the first cluster the cycles, summed over the steps, of
warp 0 (``w0``) and warp 1 (``w1``): the wait for L_jj (``wait_L``), the
panel (``P``), the chain on the owner of the next diagonal block (``D``,
warp 0 only: its three tiles, its factor and the push), the wait for the
staged panel (``wait_P``), the update with the step's closing barrier
(``U``), the load with the first factor, and the store. Needs a CUDA device
and nvcc.
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

SOURCE = Path(__file__).resolve().parent / "chol_phases.cu"


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "libchol_phases.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(SOURCE)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.zigp_chol_phases.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.zigp_chol_phases.restype = ctypes.c_int
    lib.zigp_chol_cluster_phases.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.zigp_chol_cluster_phases.restype = ctypes.c_int
    return lib


def card() -> str:
    q = "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm"
    return subprocess.run(["nvidia-smi", q, "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def phases(lib, n: int, nb: int, inv: bool, reps: int = 5) -> dict:
    A = np.random.RandomState(n).randn(n, n)
    K64 = A @ A.T + n * np.eye(n)
    K = torch.tensor(K64, dtype=torch.float32, device="cuda")
    L, Linv = torch.empty_like(K), torch.empty_like(K)
    cycles = torch.zeros(7, dtype=torch.int64, device="cuda")
    for _ in range(reps):  # the last run's marks are kept
        err = lib.zigp_chol_phases(K.data_ptr(), L.data_ptr(), Linv.data_ptr(), n, nb, int(inv), cycles.data_ptr())
        if err != 0:
            raise RuntimeError(f"chol_phases launch failed: cudaError {err} (n={n}, nb={nb})")
    torch.cuda.synchronize()
    _, P, U_rest, D, _, load, store = (int(c) for c in cycles.cpu())
    L_ref = np.linalg.cholesky(K64)
    rel = float(np.linalg.norm(L.cpu().double().numpy() - L_ref) / np.linalg.norm(L_ref))
    return {"n": n, "nb": nb, "what": "L, L^-1 (chol_inv.cu)" if inv else "L (chol.cu)", "steps": -(-n // nb),
            "cycles": {"load": load, "P": P, "D": D, "U_rest": U_rest, "store": store,
                       "total": load + P + D + U_rest + store},
            "rel_err_L": rel}


def cluster_phases(lib, n: int, C: int, reps: int = 20) -> dict:
    from ..ops.cuda import chol_inv as ci

    rng = np.random.RandomState(n)
    A = rng.randn(2, n, n)
    K64 = A @ A.transpose(0, 2, 1) + n * np.eye(n)
    K = torch.tensor(K64, dtype=torch.float32, device="cuda")
    L, Linv = torch.empty_like(K), torch.empty_like(K)
    cycles = torch.zeros(2 * C * 16, dtype=torch.int64, device="cuda")
    run = lambda: lib.zigp_chol_cluster_phases(K.data_ptr(), L.data_ptr(), Linv.data_ptr(), n, 2, C,
                                               cycles.data_ptr())
    for _ in range(3):
        if run() != 0:
            raise RuntimeError(f"chol_cluster_phases launch failed (n={n}, C={C})")
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    stop.record()
    stop.synchronize()
    c = cycles.cpu().reshape(2 * C, 2, 8).tolist()  # the last run's marks
    names = {1: "wait_L", 2: "P", 5: "D", 3: "wait_P", 4: "U", 6: "load", 7: "store"}
    ranks = {r: {w: {names[k]: c[r][i][k] for k in names if not (w == "w1" and k == 5)}
                 for i, w in enumerate(("w0", "w1"))} for r in range(C)}
    L_ref = np.linalg.cholesky(K64)
    rel = float(np.linalg.norm(L.cpu().double().numpy() - L_ref) / np.linalg.norm(L_ref))
    return {"n": n, "C": C, "plan_C": ci.plan(n).C, "steps": -(-n // 8), "ms_marks_on": start.elapsed_time(stop) / reps,
            "cycles_by_rank_of_cluster_0": ranks, "rel_err_L": rel}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[100, 200])
    ap.add_argument("--nb", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--cluster", action="store_true", help="the cluster kernel's phases (default n: 250 512)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chol_phases needs a CUDA device")
    lib = build()
    clock = card()
    if args.cluster:
        from ..ops.cuda import chol_inv as ci

        for n in args.n if args.n != [100, 200] else [250, 512]:
            for C in ci.CLUSTER_SIZES:
                if ci._cluster_bytes(n, C)[1] <= ci.SMEM_BYTES:
                    print(json.dumps({**cluster_phases(lib, n, C), "card": clock}), flush=True)
        return
    for n in args.n:
        for inv in (False, True):
            for nb in args.nb:
                print(json.dumps({**phases(lib, n, nb, inv), "card": clock}), flush=True)


if __name__ == "__main__":
    main()
