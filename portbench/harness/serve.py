"""A serving cell: a closed loop of one client calling the program's
``experiments.runners.predict_batched(model.predict, X)`` in cycles of the
mix's call sizes.

Set-up builds the served model from the seed's inputs, makes every call's
rows (``harness.traffic.ServeCalls``) and runs one whole cycle, which
captures the chunk graph and allocates every call size's buffers. The
window then calls without pause until ``--seconds`` have passed, each call
timed from its rows handed over to its 9 fields on the host. With
``--trace 1`` one cycle from 40 % of the window is profiled, each call in a
``portbench.call`` span.

The check: every call of the window keeps ``sample_rows`` of its rows,
drawn from the seed, with the program's 9 fields there. Once the window
has closed and the program's state is freed, the reference computes the
fields at those rows in float64 and the worst field's gap is compared.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from . import compare, data as D, program
from .trace import Stretch, TraceView, span, warm_profiler
from .traffic import ServeCalls


def reference_fields(cell, state, X: np.ndarray, num_data: int, device, *, dtype=torch.float64,
                     bulk="exact", factor="exact"):
    from ..reference import onoff as R

    ref = R.OnOffReference(cell.config, num_data, bulk=bulk, factor=factor)
    raws = R.initial_raws(state, dtype, device)
    out = R.predict_blocks(ref, raws, torch.as_tensor(X, dtype=dtype, device=device))
    return {k: v.to("cpu", torch.float64).numpy() for k, v in out.items()}


def inputs_of(cell, seed: int):
    cfg = cell.config
    d = D.pptr(cfg["data"], seed)
    Zs = D.grid_factors(cfg, d, seed)
    return d, D.serve_state(cfg, Zs, seed)


def run(cell, seed: int, seconds: float, trace: bool, device, t_process: float, log=None) -> dict:
    from zigp_tpu_torch.experiments.runners import predict_batched

    log = log or (lambda s: print(s, file=sys.stderr))
    cfg, traffic = cell.config, cell.traffic
    chunk, S = int(traffic["chunk"]), int(traffic["sample_rows"])
    if int(traffic.get("clients", 1)) != 1:
        raise ValueError("the serving generator drives one closed-loop client")
    d, state = inputs_of(cell, seed)
    calls = ServeCalls(traffic, d, seed)
    sampler = D.rng(seed, D.SAMPLE)
    log(f"set-up: inputs made at {time.perf_counter() - t_process:.3f} s")
    if trace:
        warm_profiler(device)
    with program.solve_precision(traffic["solve_precision"]):
        model = program.build_model(cfg, state, d.Xtrain.shape[0], device)
        log(f"set-up: model built at {time.perf_counter() - t_process:.3f} s")
        for e, v in calls.cycle(-1):  # set-up: every call size once, the chunk graph captured
            predict_batched(model.predict, calls.rows(e, v), chunk, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        log(f"set-up: a cycle served at {time.perf_counter() - t_process:.3f} s")
        stretch = Stretch(device) if trace else None
        stretch_cycle = None
        lat, kept_X, kept = [], [], []
        rows = stretch_rows = stretch_calls = stretch_chunks = 0
        marks = []  # (host time, rows served) after each call of the window
        t0 = time.perf_counter()
        c = 0
        while True:
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and (stretch is None or stretch.events is not None):
                break
            traced = stretch is not None and stretch_cycle is None and elapsed >= 0.4 * seconds
            if traced:
                stretch_cycle = c
                stretch.start()
            for e, v in calls.cycle(c):
                X = calls.rows(e, v)
                a = time.perf_counter()
                if traced:
                    with span("call"):
                        out = predict_batched(model.predict, X, chunk, device=device)
                else:
                    out = predict_batched(model.predict, X, chunk, device=device)
                lat.append(time.perf_counter() - a)
                rows += X.shape[0]
                marks.append((time.perf_counter() - t0, rows))
                pick = sampler.integers(0, X.shape[0], S)
                kept_X.append(X[pick])
                kept.append({k: v_[pick, 0] for k, v_ in out.items()})
                if traced:
                    stretch_rows += X.shape[0]
                    stretch_calls += 1
                    stretch_chunks += -(-X.shape[0] // chunk)
            if traced:
                stretch.stop()
            c += 1
        t_end = time.perf_counter()
    if len(marks) >= 8:
        edges = [(0.0, 0)] + [marks[len(marks) * i // 4 - 1] for i in range(1, 4)] + [marks[-1]]
        rates = [(b[1] - a[1]) / (b[0] - a[0]) for a, b in zip(edges, edges[1:])]
        log("window: points/s by quarter of its calls, host clock: " + " ".join(f"{r:.0f}" for r in rates))
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    result = {
        "metrics": {
            "serve_points_per_s": rows / (t_end - t0),
            "serve_call_p95_ms": float(np.percentile(np.asarray(lat), 95.0)) * 1e3,
            "setup_s": t0 - t_process,
        },
        "attempted": len(lat), "failed": 0, "memory_peak_bytes": int(memory_peak), "latencies": lat,
        "stretch": None,
    }
    if stretch is not None:
        result["stretch"] = dict(view=TraceView(stretch.events), census=stretch.census, calls=stretch_calls,
                                 rows=stretch_rows, chunks=stretch_chunks)
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    X = np.concatenate(kept_X)
    prog = {k: np.concatenate([p[k] for p in kept]) for k in kept[0]}
    t_ref = time.perf_counter()
    ref = reference_fields(cell, state, X, d.Xtrain.shape[0], device)
    log(f"check: the reference's {X.shape[0]} rows took {time.perf_counter() - t_ref:.3f} s")
    result["numbers"] = compare.serve_numbers(prog, ref)
    return result
