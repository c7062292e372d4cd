"""Where the serving path's time goes on the card: one profiled
``predict_batched`` pass per configuration.

    python -m zigp_tpu_torch.experiments.profile_predict

Builds the flagship (10 × 100, batch 4096) and champion (32 × 200, batch
16384) models on the CUDA device from the seeded pptr-shaped set, runs one
warm-up pass, then one pass under ``torch.profiler``. Prints, per config, the
wall time of the pass, the summed device time of its kernels, the device's
idle share (1 − device time / wall time; one stream, so kernels do not
overlap), and the kernels with the most device time. Needs a CUDA device.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .builders import build_onoff_pptr
from .configs import OnOffPptrConfig, best_onoff_config
from .runners import predict_batched
from ..io.datasets import synthetic_pptr


ROWS = 65_536
TOP = 12


def profile_config(name, cfg, split, batch):
    model = build_onoff_pptr(cfg, split)
    X = np.asarray(split.Xtrain[:ROWS])
    predict_batched(model.predict, X, batch=batch)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict_batched(model.predict, X, batch=batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
    ]
    dev = lambda e: float(e.device_time_total)  # µs
    device_ms = sum(dev(e) for e in kernels) / 1e3
    rows_out = sorted(kernels, key=dev, reverse=True)[:TOP]
    res = {
        "config": name, "rows": int(X.shape[0]), "batch": batch, "wall_ms": wall_ms,
        "device_ms": device_ms, "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "top": [{"name": e.key[:90], "device_ms": dev(e) / 1e3, "calls": e.count} for e in rows_out],
    }
    print(json.dumps(res))
    return res


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_predict: needs a CUDA device")
    split = synthetic_pptr(105, 1080, seed=0)
    with torch.inference_mode():
        for name, cfg, batch in (("flagship", OnOffPptrConfig(), 4096), ("champion", best_onoff_config(), 16384)):
            profile_config(name, cfg, split, batch)


if __name__ == "__main__":
    main()
