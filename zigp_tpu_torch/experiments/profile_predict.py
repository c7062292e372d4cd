"""Where the serving path's time goes on the card: one profiled pass per
configuration and path.

    python -m zigp_tpu_torch.experiments.profile_predict

Builds the flagship (10 × 100, batch 4096) and champion (32 × 200, batch
16384) models on the CUDA device from the seeded pptr-shaped set and, for
each of two paths (``graphed``: ``predict_batched``, whose first call
captures the model's chunk graph and every later chunk replays it;
``eager``: ``predict_chunks_eager``, the same
chunks launched one by one, the path before the graph), runs one warm-up
pass, one unprofiled pass and one under ``torch.profiler``. Prints, per
config and path, the wall time of the profiled pass, the summed device time
of its kernels, the device's idle share (1 − device time / wall time; one
stream, so kernels do not overlap), the kernels with the most device time,
and the unprofiled pass's wall time and idle share. Needs a CUDA device.
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


def predict_chunks_eager(predict_fn, X, batch: int, device="cuda", dtype=torch.float32):
    """``predict_batched``'s chunks launched eagerly, one by one, with the
    same padding and one copy to the host at the end: the serving path
    before the CUDA graph, kept as the measurements' yardstick."""
    Xd = torch.as_tensor(np.asarray(X), dtype=dtype).to(device)
    names, pending = None, []
    for start in range(0, X.shape[0], batch):
        chunk = Xd[start : start + batch]
        pad = batch - chunk.shape[0]
        if pad:
            chunk = torch.cat([chunk, chunk[-1:].expand(pad, -1)], dim=0)
        res = predict_fn(chunk)
        d = res._asdict() if hasattr(res, "_asdict") else dict(res)
        names = names or list(d)
        pending.append(torch.cat([d[k] for k in names], dim=-1)[: batch - pad])
    host = torch.cat(pending, dim=0).cpu().numpy()
    cols = np.cumsum([0] + [d[k].shape[-1] for k in names])
    return {k: host[:, cols[i] : cols[i + 1]] for i, k in enumerate(names)}


def profile_config(name, cfg, split, batch):
    model = build_onoff_pptr(cfg, split)
    X = np.asarray(split.Xtrain[:ROWS])
    out = []
    for path, run in (("eager", predict_chunks_eager), ("graphed", predict_batched)):
        run(model.predict, X, batch=batch)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(model.predict, X, batch=batch)  # ends in a copy to the host
        plain_wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(model.predict, X, batch=batch)
            wall_ms = (time.perf_counter() - t0) * 1e3
        res = {"config": name, "path": path, "rows": int(X.shape[0]), "batch": batch, **summarize(prof, wall_ms),
               "unprofiled_wall_ms": plain_wall_ms, "card": torch.cuda.get_device_name(0)}
        res["unprofiled_idle_share"] = max(0.0, 1.0 - res["device_ms"] / plain_wall_ms)
        print(json.dumps(res))
        out.append(res)
    return out


def summarize(prof, wall_ms: float) -> dict:
    """wall_ms, the summed device time and the number of the profiled
    kernels, the device's idle share (1 − device time / wall time; one
    stream, so kernels do not overlap), the TOP kernels by device time, and
    the device time under each user annotation, which spans kernels counted
    on their own and is never in the sum (``utils.xprof``'s aggregation of
    the profiler's ``key_averages``)."""
    from ..utils import xprof

    records = xprof.profiler_records(prof)
    s = xprof.summarize_events(records)
    row = lambda name, us, calls: {"name": name[:90], "device_ms": us / 1e3, "calls": calls}
    device_ms = s["total_us"] / 1e3
    return {
        "wall_ms": wall_ms, "device_ms": device_ms, "kernel_calls": sum(s["calls"].values()),
        "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "top": [row(name, us, s["calls"][name]) for name, us in list(s["by_op"].items())[:TOP]],
        "annotations": [row(r.name, r.us, r.calls) for r in records if r.cat in xprof.OVERLAPPING_CATS],
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_predict: needs a CUDA device")
    split = synthetic_pptr(105, 1080, seed=0)
    with torch.inference_mode():
        for name, cfg, batch in (("flagship", OnOffPptrConfig(), 4096), ("champion", best_onoff_config(), 16384)):
            profile_config(name, cfg, split, batch)


if __name__ == "__main__":
    main()
