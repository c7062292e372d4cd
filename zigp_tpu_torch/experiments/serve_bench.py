"""Serving throughput: the exported artifact against the in-process predictor.

Counterpart of ``zigp_tpu/experiments/serve_bench.py``. On the champion
configuration (32 × 200, whitened, Kronecker-factored q) it times the
``io.export`` artifact (``torch.export``, parameters in the program, the
kernels called through the registered ops ``zigp_tpu_torch::chol_inv`` and
``zigp_tpu_torch::rbf_gram``) against ``runners.predict_batched`` (every
chunk one replay of the model's captured chunk graph), with the JAX
harness's scheduling for both: X copied to the device once, fixed-shape
chunks (the last padded by repeating its last row) issued without waiting,
one copy of every result to the host at the end. Each path: one untimed
pass (the kernels' build, the chunk graph's capture), then the median of
``repeats`` timed passes. Both paths serve the same rows: the artifact's
fields must be within ``GATE`` of each field's largest magnitude in
``predict_batched``'s.

    python -m zigp_tpu_torch.experiments.serve_bench (--data PATH | --synthetic)
        [--batch 16384] [--rows 65536] [--out PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from . import measure

GATE = 1e-5  # the artifact against predict_batched, relative to each field's largest magnitude


def _time_passes(fn, repeats: int = 3):
    """(median wall seconds of ``fn()`` over ``repeats`` timed passes, the
    last pass's result), after one untimed pass."""
    fn()
    times, out = [], None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def chunked(call, Xd: torch.Tensor, batch: int):
    """A pass of ``call`` over fixed-shape chunks of ``Xd`` (on the device),
    each issued without waiting; one copy of every field to the host at the
    end: {field: (rows, k) numpy}."""
    rows = Xd.shape[0]

    def run_all():
        pending = []
        for start in range(0, rows, batch):
            chunk = Xd[start : start + batch]
            pad = batch - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk[-1:].expand(pad, -1)], dim=0)
            out = call(chunk)
            pending.append({k: v[: batch - pad] for k, v in out.items() if isinstance(v, torch.Tensor)})
        return {k: torch.cat([p[k] for p in pending]).cpu().numpy() for k in pending[0]}

    return run_all


def run(batch: int = 16384, rows: int = 65536, out=None, *, repeats: int = 3, build_kw=None, model=None,
        X=None, log_fn=print) -> dict:
    """The benchmark's JSON result; ``model`` and ``X`` (numpy) replace the
    champion built on ``build_kw``'s data and its training rows."""
    from ..io.export import export_predictor, load_predictor
    from .runners import predict_batched

    build_kw = build_kw or {}
    source = "the given model and rows"
    if model is None:
        model, (Xtrain, _), _, _ = measure.build_config("champion", **build_kw)
        X = Xtrain
        source = measure.data_source(build_kw.get("data"), build_kw.get("synthetic", False), build_kw.get("split"))
    X = np.asarray(X[:rows])
    rows = X.shape[0]
    p = next(model.parameters())
    Xd = torch.as_tensor(X, dtype=p.dtype).to(p.device)

    t_inproc, live = _time_passes(
        lambda: predict_batched(model.predict, X, batch, device=p.device, dtype=p.dtype), repeats)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "onoff.zigp")
        export_predictor(model, "onoff", X.shape[1], path)
        size_mb = os.path.getsize(path) / 1e6
        served = load_predictor(path)
        with torch.no_grad():
            t_export, art = _time_passes(chunked(lambda c: served(c, as_numpy=False), Xd, batch), repeats)
    rel = {k: float(np.max(np.abs(art[k] - live[k])) / max(float(np.max(np.abs(live[k]))), 1e-30)) for k in live}
    worst = max(rel.values())
    res = {
        "metric": "export_serving_points_per_sec",
        "batch": batch,
        "rows": rows,
        "device": measure.device_name(p.device),
        "data": source,
        "artifact_mb": size_mb,
        "export_pts_per_sec": rows / t_export,
        "in_process_pts_per_sec": rows / t_inproc,
        "export_vs_in_process": t_inproc / t_export,
        "max_rel_diff": worst,
    }
    log_fn(json.dumps(res))
    if not worst <= GATE:
        raise AssertionError(f"serve_bench: the artifact's fields differ from predict_batched's by {worst:.3e} "
                             f"of their largest magnitude (gate {GATE:.0e}): {rel}")
    if out:
        with open(out, "w") as f:
            json.dump(res, f, indent=2)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--rows", type=int, default=65536)
    ap.add_argument("--out", type=str, default=None)
    measure.add_data_args(ap)
    args = ap.parse_args(argv)
    run(args.batch, args.rows, args.out, build_kw=measure.build_kw_of(args))


if __name__ == "__main__":
    main()
