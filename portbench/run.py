"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program (``zigp_tpu_torch``). The cell, its configuration, traffic mix
and per-layer metrics are found by name (``harness.manifest``). With
``--trace 0`` the last line of standard output is the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics from one profiled stretch
of the window, with the device's busy and window seconds and a breakdown.
The numbers that decide ``correct`` are printed, each beside its limit, as
the last lines of standard error and under the result's last key,
``checks``.

The run fails, and prints no result, where CUDA is missing or has fewer
cards than the cell asks for, where the program is missing, or where a
module of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

FORBIDDEN = ("jax", "jaxlib", "flax", "zigp_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_process: float = T_PROCESS, log=None) -> dict:
    """Drive the cell once on ``device``: its result line (a dict) and the
    checks. No look for a chip here: ``main`` makes it."""
    from portbench.harness import compare, readings, serve, train

    kind = {"train": train, "serve": serve}[cell.kind]
    out = kind.run(cell, seed, seconds, trace, device, t_process, log=log)
    checks = compare.checks(out["numbers"], cell.limits)
    correct = all(c.ok for c in checks) and out["failed"] == 0
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_kind(device), "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        st = out["stretch"]
        view = st["view"]
        r = readings.Reading(view=view, cell=cell, census=st["census"], steps=st.get("steps", 0),
                             calls=st.get("calls", 0), chunks=st.get("chunks", 0), rows=st.get("rows", 0),
                             latencies=out.get("latencies", []))
        result["metrics"] = readings.read_metrics(r, cell.per_layer)
        dev["busy_s"] = view.busy_us / 1e6
        dev["window_s"] = view.window_us / 1e6
        result["breakdown"] = {"device_ops": view.top_ops(10), "idle_gaps": view.idle_gaps(10)}
    else:
        # ``<quantity>.<group>``: one quantity under a bound of its own for a group of cells
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {n: {"value": float(out["metrics"][n.split(".")[0]]), "unit": u} for n, u in units.items()}
    result["device"] = dev
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result, checks


def _device_kind(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    log = lambda what: print(f"set-up: {what} at {time.perf_counter() - T_PROCESS:.3f} s", file=sys.stderr)
    try:
        import torch

        from portbench.harness.manifest import Cell, load_manifest

        log("torch imported")
        cell = Cell(load_manifest(os.path.join(CHECKOUT, "BENCHMARK.json")), args.workload)
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"error: the cell asks for {cell.chips} CUDA device(s); {n} available", file=sys.stderr)
            return 2
        import zigp_tpu_torch  # the program under test, from this checkout

        if not os.path.abspath(zigp_tpu_torch.__file__).startswith(CHECKOUT + os.sep):
            print(f"error: zigp_tpu_torch is not this checkout's ({zigp_tpu_torch.__file__})", file=sys.stderr)
            return 2

        log("program imported")
        device = torch.device("cuda", 0)
        result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    except Exception:  # the run's boundary: report and fail, print no result
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"error: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for c in checks:
        print(c.line(), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
