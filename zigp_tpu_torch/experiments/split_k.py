"""``ops.split_k.split_k_mm`` at the exact policy's batch-reducing products,
in the layouts the path gives them, against exact-float32 ``torch.matmul``
given each product whole.

    python -m zigp_tpu_torch.experiments.split_k [--cases NAME ...]

The cases: the grid's six backward products at B = 8192 as the training
step lays them out (dw = K_mn,s·dt, the (2, 105, B) factor by dt, a
contiguous (2, B, 250); dL_p⁻¹ = dV·K_mn,pᵀ at 250 and at 105, dV
contiguous for the projection's and m-contiguous for the mean's), the
champion's at B = 4000 (n = 200 and 32), the flagship's at B = 1000 (n = 100
and 10), the dense classifier's (1, 200, 200) at 1000, and those shapes at
K = 2048 (the threshold ``LONG_K``). For each, one JSON line: whether
``batch_reducing`` takes the shape; device µs a call (``REPS`` calls
captured in one CUDA graph, one replay timed) of ``torch.matmul`` and of
``split_k_mm`` with 4, 8 and 16 ranges; at ``SPLITS`` ranges the largest
error against float64 over the bound (K // S + S)·2⁻²⁴·Σ|a||b| and whether
two calls give the same bits; the FFMA bound 2·G·M·N·K over 67 TFLOP/s; the
card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from ..ops import split_k as sk

F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
REPS = 50


def cases(r) -> dict:
    """{name: (a, b)} in the path's layouts."""
    B = 8192
    return {
        "grid dw (2,105,250)": lambda: (r(2, 105, B), r(2, B, 250)),
        "grid dLinv (2,250,250) dV contiguous": lambda: (r(2, 250, B), r(2, 250, B).mT),
        "grid dLinv (2,250,250) dV m-contiguous": lambda: (r(2, B, 250).mT, r(2, 250, B).mT),
        "grid dLinv (2,105,105) dV contiguous": lambda: (r(2, 105, B), r(2, 105, B).mT),
        "grid dLinv (2,105,105) dV m-contiguous": lambda: (r(2, B, 105).mT, r(2, 105, B).mT),
        "champion dw (2,32,200)": lambda: (r(2, 32, 4000), r(2, 4000, 200)),
        "champion dLinv (2,200,200)": lambda: (r(2, 200, 4000), r(2, 200, 4000).mT),
        "champion dLinv (2,32,32)": lambda: (r(2, 32, 4000), r(2, 32, 4000).mT),
        "flagship dw (2,10,100)": lambda: (r(2, 10, 1000), r(2, 1000, 100)),
        "flagship dLinv (2,100,100)": lambda: (r(2, 100, 1000), r(2, 100, 1000).mT),
        "classifier dLq (1,200,200)": lambda: (r(1, 200, 1000), r(1, 200, 1000).mT),
        "K 2048 (2,250,250)": lambda: (r(2, 250, 2048), r(2, 250, 2048).mT),
        "K 2048 (2,100,100)": lambda: (r(2, 100, 2048), r(2, 100, 2048).mT),
        "K 2048 (1,200,200)": lambda: (r(1, 200, 2048), r(1, 200, 2048).mT),
        "K 2048 (2,32,200)": lambda: (r(2, 32, 2048), r(2, 2048, 200)),
    }


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


def with_splits(S: int, fn):
    """``fn()`` with ``split_k.SPLITS`` set to S."""
    saved, sk.SPLITS = sk.SPLITS, S
    try:
        return fn()
    finally:
        sk.SPLITS = saved


def error_share(a, b, c) -> float:
    """max |c − a·b| in float64 over (K // S + S)·2⁻²⁴·Σ|a||b|."""
    exact = a.double() @ b.double()
    bound = (a.shape[-1] // sk.SPLITS + sk.SPLITS) * 2.0**-24 * (a.double().abs() @ b.double().abs())
    return float(((c.double() - exact).abs() / bound.clamp_min(1e-300)).max())


def card() -> str:
    q = "--query-gpu=name,power.limit"
    return subprocess.run(["nvidia-smi", q, "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", nargs="*", help="names of the cases to run (a prefix each), all by default")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("split_k: needs a CUDA device")
    info = card()
    gen = torch.Generator(device="cuda").manual_seed(23)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    for name, make in cases(r).items():
        if args.cases and not any(name.startswith(c) for c in args.cases):
            continue
        a, b = make()
        G, M, N, K = math.prod(a.shape[:-2]), a.shape[-2], b.shape[-1], a.shape[-1]
        c = sk.split_k_mm(a, b)
        torch.cuda.synchronize()
        row = {"case": name, "G": G, "M": M, "N": N, "K": K, "batch_reducing": sk.batch_reducing(M, N, K),
               "err_share": error_share(a, b, c), "same_bits": bool(torch.equal(c, sk.split_k_mm(a, b))),
               "matmul_us": device_us(lambda: a @ b), "ffma_bound_us": 2.0 * G * M * N * K / F32_FLOPS * 1e6}
        for S in (4, 8, 16):
            row[f"split{S}_us"] = with_splits(S, lambda: device_us(lambda: sk.split_k_mm(a, b)))
        row["card"] = info
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
