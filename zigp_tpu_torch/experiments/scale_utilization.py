"""Batch scaling of the 105 × 250 grid, with FLOP accounting at each point.

Counterpart of ``zigp_tpu/experiments/scale_utilization.py``. For B in
{4096, 8192, 16384, 32768} at the 105 spatial × 250 temporal inducing grid
(26,250 inducing points a GP; the temporal factor goes to the cluster
kernel), it times the production step (the device sampler, each block one
replay of its CUDA graph; ``experiments.measure``'s convention, the median
of three passes of ``num_blocks`` blocks) and reports steps/s, FLOPs a step,
the FLOP rate and its share of the card's peak under two counts:

- ``*_counted``: ``torch.utils.flop_counter.FlopCounterMode`` over one
  eager step, forward and backward (the products torch dispatches: mm,
  bmm, addmm and what einsum lowers to; the port's hand-written kernels
  and the triangular solves are not counted), in place of the JAX
  package's XLA ``cost_analysis``;
- ``*_analytic``: ``measure.analytic_matmul_flops``, the logical product
  count of the factored conditional (forward and the backward's 2 ×).

The peak is the card's float32 rate outside the tensor cores (TF32 is
barred on these contractions, ``core.config``), from ``PEAK_F32`` by the
name ``torch.cuda.get_device_name`` gives; for a card not in the table (and
on the CPU) the shares are null.

``--solve-precision highest|high|mixed`` sets the policy before the first
model is built (``measure.solve_precision``) and goes into every row; the
3-pass products are the ``bf16x3_mm`` kernel's, which ``*_counted`` does
not see, as it does not see the port's other kernels.

    python -m zigp_tpu_torch.experiments.scale_utilization (--data PATH | --synthetic)
        [--batches 4096,8192,16384,32768] [--inner 100] [--blocks 3] [--solve-precision P] [--out PATH]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import torch

from . import measure

# float32 FLOP/s outside the tensor cores, by torch.cuda.get_device_name (NVIDIA's data sheet)
PEAK_F32 = {"NVIDIA H100 80GB HBM3": 67e12}


def counted_step_flops(model, X, Y) -> float:
    """FLOPs ``FlopCounterMode`` counts in one eager step's loss and its
    backward on (X, Y), on a copy of the model."""
    from torch.utils.flop_counter import FlopCounterMode

    m = copy.deepcopy(model)
    with FlopCounterMode(display=False) as fc:
        m.loss(X, Y).backward()
    return float(fc.get_total_flops())


def probe(batches=(4096, 8192, 16384, 32768), num_inner: int = 100, num_blocks: int = 3, solve_precision=None,
          log_fn=print, *, build_kw=None, split=None, grid=(105, 250), repeats: int = 3):
    with measure.solve_precision(solve_precision) as policy:
        return _probe(batches, num_inner, num_blocks, policy, log_fn, build_kw or {}, split, grid, repeats)


def _probe(batches, num_inner, num_blocks, policy, log_fn, build_kw, split, grid, repeats):
    from ..core.config import resolve_device
    from ..training.scan import StagedBlocks
    from ..training import DataSet
    from .builders import build_onoff_pptr
    from .configs import KronGridConfig, OnOffPptrConfig

    device = resolve_device(build_kw.get("device"))
    dtype = build_kw.get("dtype", torch.float32)
    if split is None:
        split = measure.load_split(build_kw.get("data"), build_kw.get("synthetic", False))
    name = measure.device_name(device)
    peak = PEAK_F32.get(name)
    rows = []
    for B in batches:
        cfg = OnOffPptrConfig(grid=KronGridConfig(num_spatial=grid[0], num_temporal=grid[1]))
        model = build_onoff_pptr(cfg, split, device=device, dtype=dtype, use_kernel=device.type == "cuda")
        one = StagedBlocks(DataSet(split.Xtrain, split.Ytrain), "device", B, 1, device=device, dtype=dtype)
        one.fill(0)
        fps_counted = counted_step_flops(model, one.Xs[0], one.Ys[0])
        del one
        step, trained, opt = measure.prepare_step(model, (split.Xtrain, split.Ytrain), B, cfg, num_inner=num_inner)
        b = measure.warm_up(step)
        rates = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(num_blocks):
                losses = step(measure.block_key(b))
                b += 1
            last = measure.sync(losses)
            rates.append(num_blocks * num_inner / (time.perf_counter() - t0))
        rate = sorted(rates)[len(rates) // 2]
        fps_an = measure.analytic_matmul_flops(B, grid[0], grid[1])
        share = lambda fps: fps * rate / peak if peak else None
        row = {
            "batch": B,
            "grid": f"{grid[0]}x{grid[1]}",
            "sampler": "device",
            "solve_precision": policy,
            "device": name,
            "peak_f32_flops": peak,
            "steps_per_sec": rate,
            "flops_per_step_counted": fps_counted,
            "achieved_tflops_counted": fps_counted * rate / 1e12,
            "mfu_f32_counted": share(fps_counted),
            "flops_per_step_analytic": fps_an,
            "achieved_tflops_analytic": fps_an * rate / 1e12,
            "mfu_f32_analytic": share(fps_an),
            "counted_vs_analytic": fps_counted / fps_an,
            "samples_per_sec": rate * B,
            "final_block_loss": last,
        }
        rows.append(row)
        log_fn(json.dumps(row))
        del step, trained, opt, model
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=str, default="4096,8192,16384,32768")
    ap.add_argument("--inner", type=int, default=100)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--solve-precision", type=str, default=None, choices=("highest", "high", "mixed"))
    measure.add_data_args(ap)
    args = ap.parse_args(argv)
    kw = measure.build_kw_of(args)
    rows = probe(tuple(int(b) for b in args.batches.split(",")), args.inner, args.blocks, args.solve_precision,
                 build_kw=kw)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"task": "scale_utilization", "grid": "105x250", "sampler": "device",
                       "data": measure.data_source(kw["data"], kw["synthetic"]), "rows": rows}, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
