"""Where the training step's time goes on the card: one profiled flagship
block of scanned steps.

    python -m zigp_tpu_torch.experiments.profile_train [--steps 50]

Counterpart of ``zigp_tpu/experiments/profile_step.py``. Builds the flagship
(10 × 100 grid, B = 1000) on the CUDA device from the seeded pptr-shaped set,
once with the ``rbf_gram`` kernel on and once with it off, runs one warm-up
block of device-sampled steps, one timed block without the profiler, then
the same block (the same sampler seed, so the same shapes and kernels) under
``torch.profiler``. Prints one JSON line per run with ``profile_predict``'s
fields (the wall time of the profiled block, the summed device time of its
kernels, the device's idle share and the kernels with the most device time;
``rows`` is the rows the block trained on), the profiled block's steps and
steps/s, the unprofiled block's wall time and steps/s, the idle share of the
unprofiled block (1 − the profiled block's device time / the unprofiled
block's wall time: the profiler slows the host, not the kernels), and the
device time and calls of the port's own kernels. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..io.datasets import synthetic_pptr
from ..training import make_device_sampling_scan_step, make_optimizer
from .builders import build_onoff_pptr
from .configs import OnOffPptrConfig
from .profile_predict import summarize


def profile_train(steps: int = 50, *, use_kernel: bool = True) -> dict:
    cfg = OnOffPptrConfig()
    split = synthetic_pptr(105, 1080, seed=0)
    model = build_onoff_pptr(cfg, split, use_kernel=use_kernel)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    step = make_device_sampling_scan_step(
        make_optimizer(model, default_lr=cfg.indp_lr), t(split.Xtrain), t(split.Ytrain), cfg.batch_size
    )
    step(model, 0, steps)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(model, 1, steps)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses = step(model, 1, steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    own = [e for e in prof.key_averages() if "chol_inv_kernel" in e.key or "rbf_gram_kernel" in e.key]
    res = {
        "config": "flagship" + ("" if use_kernel else ", gram kernel off"),
        "rows": steps * cfg.batch_size, "batch": cfg.batch_size, "steps": steps,
        "steps_per_s": steps / (wall_ms / 1e3), "final_loss": float(losses[-1]),
        **summarize(prof, wall_ms),
        "unprofiled_wall_ms": plain_wall_ms, "unprofiled_steps_per_s": steps / (plain_wall_ms / 1e3),
        "port_kernels": [
            {"name": e.key[:90], "device_ms": e.device_time_total / 1e3, "calls": e.count} for e in own
        ],
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
        profile_train(args.steps, use_kernel=use_kernel)


if __name__ == "__main__":
    main()
