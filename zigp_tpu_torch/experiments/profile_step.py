"""Device-time breakdown of the production training block.

Counterpart of ``zigp_tpu/experiments/profile_step.py``. Builds a named
configuration with the shared scaffold (``experiments.measure``: a fresh
copy of the model, the device sampler, the warm-up blocks and the capture
of the block's CUDA graph untimed and unprofiled), records a
``torch.profiler`` trace (``utils.profiling.trace``) around ``--blocks``
replays of ``--inner`` steps each, and prints where the card spends its
time with ``utils.xprof``: the kernel families (GEMM, the port's own
kernels by name, elementwise, reduction, copies, other; they sum to the
total) and the kernels with the most time, per step, beside the wall time
per step. ``experiments.profile_train`` is the eager-against-graphed
profile of one flagship block.

    python -m zigp_tpu_torch.experiments.profile_step (--data PATH | --synthetic)
        [--config flagship|champion|scale] [--batch B] [--inner 100] [--blocks 3]
        [--solve-precision highest|high|mixed] [--keep-trace DIR] [--out PATH.json] [--device cuda|cpu]

``--solve-precision`` sets the policy before the model is built
(``measure.solve_precision``) and goes into the summary; the 3-pass
products show as ``bf16x3_mm`` among the port's kernels.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time

from . import measure


def profile_step(
    config: str = "flagship",
    *,
    batch=None,
    num_inner: int = 100,
    num_blocks: int = 3,
    solve_precision=None,
    keep_trace=None,
    out=None,
    log_fn=print,
    build_kw=None,
) -> dict:
    from ..utils import profiling, xprof

    build_kw = build_kw or {}
    logdir = keep_trace or tempfile.mkdtemp(prefix="zigp_trace_")
    with measure.solve_precision(solve_precision) as policy:
        built = measure.build_config(config, batch_override=batch, **build_kw)
        step, model, opt = measure.prepare_step(*built, num_inner=num_inner)
        b = measure.warm_up(step)  # the warm-up blocks and the capture: not in the trace
        with profiling.trace(logdir):
            t0 = time.perf_counter()
            for k in range(num_blocks):
                losses = step(measure.block_key(b + k))
            last = measure.sync(losses)
            wall = time.perf_counter() - t0

    steps = num_blocks * num_inner
    p = next(model.parameters())
    summary = xprof.summarize_trace(logdir, steps, device_hint=measure.device_name(p.device))
    summary.update(
        config=config,
        batch=built[2],
        solve_precision=policy,
        data=measure.data_source(build_kw.get("data"), build_kw.get("synthetic", False), build_kw.get("split")),
        steps=steps,
        steps_per_sec=steps / wall,
        wall_us_per_step=1e6 * wall / steps,
        per_step_us=summary["total_us"] / steps,
        final_block_loss=last,
    )
    log_fn(xprof.format_summary(summary, steps))
    log_fn(f"wall: {summary['wall_us_per_step']:.2f} µs/step ({summary['steps_per_sec']:.1f} steps/s, the host's "
           f"replays included); profiled")
    if not keep_trace:
        shutil.rmtree(logdir, ignore_errors=True)
    if out:
        with open(out, "w") as f:
            json.dump(summary, f, indent=1)
        log_fn(f"wrote {out}")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", type=str, default="flagship", choices=measure.CONFIGS)
    ap.add_argument("--batch", type=int, default=None, help="override the config's batch size")
    ap.add_argument("--inner", type=int, default=100)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--solve-precision", type=str, default=None, choices=("highest", "high", "mixed"))
    ap.add_argument("--keep-trace", type=str, default=None,
                    help="keep the raw trace under this dir (default: tmp, deleted)")
    ap.add_argument("--out", type=str, default=None)
    measure.add_data_args(ap)
    args = ap.parse_args(argv)
    return profile_step(args.config, batch=args.batch, num_inner=args.inner, num_blocks=args.blocks,
                 solve_precision=args.solve_precision, keep_trace=args.keep_trace, out=args.out,
                 build_kw=measure.build_kw_of(args))


if __name__ == "__main__":
    main()
