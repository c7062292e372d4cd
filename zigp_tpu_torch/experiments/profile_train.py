"""Where the training step's time goes on the card: one profiled flagship
block of scanned steps, eager and as one CUDA-graph replay.

    python -m zigp_tpu_torch.experiments.profile_train [--steps 50]

Counterpart of ``zigp_tpu/experiments/profile_step.py``. Builds the flagship
(10 × 100 grid, B = 1000) on the CUDA device from the seeded pptr-shaped set,
with the ``rbf_gram`` kernel on and off, and for each runs one warm-up block
of device-sampled steps on a side stream (the capture's warm-up), then, by
each path (``eager``: the Python loop of steps; ``graphed``: the block
captured once by ``training.make_graphed_scan_step`` and replayed), one timed
block without the profiler and the same block (the same sampler seed, so the
same shapes and kernels) under ``torch.profiler``. Prints one JSON line per
run with ``profile_predict``'s fields (the wall time of the profiled block,
the summed device time of its kernels, the device's idle share and the
kernels with the most device time; ``rows`` is the rows the block trained
on), the profiled block's steps and steps/s, the unprofiled block's wall
time and steps/s, the idle share of the unprofiled block (1 − the profiled
block's device time / the unprofiled block's wall time: the profiler slows
the host, not the kernels), the device time and calls of the port's own
kernels, and for the graphed path the capture and instantiate times and the
graph pool's size. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..io.datasets import synthetic_pptr
from ..ops.cuda.graphs import on_side_stream
from ..training import DataSet, make_graphed_scan_step, make_optimizer, make_scan_train_step
from ..training.scan import StagedBlocks
from .builders import build_onoff_pptr
from .configs import OnOffPptrConfig
from .profile_predict import summarize


def profile_train(steps: int = 50, *, use_kernel: bool = True, graphed: bool = True) -> dict:
    cfg = OnOffPptrConfig()
    split = synthetic_pptr(105, 1080, seed=0)
    model = build_onoff_pptr(cfg, split, use_kernel=use_kernel)
    opt = make_optimizer(model, default_lr=cfg.indp_lr)
    blocks = StagedBlocks(DataSet(split.Xtrain, split.Ytrain), "device", cfg.batch_size, steps, device="cuda",
                          dtype=torch.float32)
    eager = make_scan_train_step(opt)
    blocks.fill(0)
    on_side_stream(lambda: eager(model, blocks.Xs, blocks.Ys))  # warm-up
    extra = {}
    if graphed:
        run = make_graphed_scan_step(opt, model, blocks.Xs, blocks.Ys)
        g = run.graph
        extra = {"capture_ms": g.capture_ms, "instantiate_ms": g.instantiate_ms, "graph_pool_mib": g.pool_bytes / 2**20}
    else:
        run = lambda: eager(model, blocks.Xs, blocks.Ys)

    def block(b):
        blocks.fill(b)
        return run()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    block(1)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses = block(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    own = [e for e in prof.key_averages() if "chol_inv_kernel" in e.key or "rbf_gram_kernel" in e.key]
    res = {
        "config": "flagship" + ("" if use_kernel else ", gram kernel off"), "path": "graphed" if graphed else "eager",
        "rows": steps * cfg.batch_size, "batch": cfg.batch_size, "steps": steps,
        "steps_per_s": steps / (wall_ms / 1e3), "final_loss": float(losses[-1]),
        **summarize(prof, wall_ms),
        "unprofiled_wall_ms": plain_wall_ms, "unprofiled_steps_per_s": steps / (plain_wall_ms / 1e3),
        "port_kernels": [
            {"name": e.key[:90], "device_ms": e.device_time_total / 1e3, "calls": e.count} for e in own
        ],
        **extra,
        "card": torch.cuda.get_device_name(0),
    }
    res["unprofiled_idle_share"] = max(0.0, 1.0 - res["device_ms"] / plain_wall_ms)
    print(json.dumps(res))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    for use_kernel in (True, False):
        for graphed in (False, True):
            profile_train(args.steps, use_kernel=use_kernel, graphed=graphed)


if __name__ == "__main__":
    main()
