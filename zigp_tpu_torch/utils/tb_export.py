"""JSONL → TensorBoard event-file converter.

Counterpart of ``zigp_tpu/utils/tb_export.py`` (a copy: the port imports
nothing of the JAX package). The reference emits TensorBoard event files
directly (tf.summary scalars at scripts/onoff.py:289,308,313,319, histograms
of every latent and gradient at :295-303,341-342, FileWriter flush at
:387-388). The port's training loops write dependency-free JSONL (utils.logging.MetricLogger) so the hot path
never touches an event-writer; this module converts a finished (or live) run
so TensorBoard can load it:

    python -m zigp_tpu_torch.utils.tb_export runs/pptr/1/metrics_onoff.jsonl [logdir]

Scalars map to ordinary scalar summaries. Histogram records are stored as
percentile summaries (p0..p100, mean/std/n) rather than raw buckets; they are
re-expanded into 6-bucket histograms with the exact percentile masses
(5/20/25/25/20/5 %), which TensorBoard's histogram/distribution dashboards
render faithfully at the fidelity the summary retains.

Uses ``tensorboardX`` when it is installed, ``torch.utils.tensorboard``
otherwise (which needs the ``tensorboard`` package); raises a clear error
when neither loads — the JSONL itself remains the source of truth.
"""

from __future__ import annotations

import json
import os
from typing import Optional


def _writer(logdir: str):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(
                "JSONL→TensorBoard export needs tensorboardX or torch; "
                "the JSONL file itself holds all the data"
            ) from e
    return SummaryWriter(logdir)


# percentile-edge masses of the stored summary: [p0,p5,p25,p50,p75,p95,p100]
_PCT_MASS = (0.05, 0.20, 0.25, 0.25, 0.20, 0.05)
_PCT_KEYS = ("p0", "p5", "p25", "p50", "p75", "p95", "p100")


def _add_histogram(writer, tag: str, summ: dict, step: int, wall: Optional[float]):
    edges = [float(summ[k]) for k in _PCT_KEYS if k in summ]
    if len(edges) != len(_PCT_KEYS):
        return
    n = int(summ.get("n", 1000))
    mean = float(summ.get("mean", edges[3]))
    std = float(summ.get("std", 0.0))
    # strictly increasing bucket limits (TensorBoard requires it); collapse
    # zero-width percentile intervals into their right edge
    limits, counts = [], []
    for i, mass in enumerate(_PCT_MASS):
        lo, hi = edges[i], edges[i + 1]
        c = mass * n
        if limits and hi <= limits[-1]:
            counts[-1] += c
        else:
            limits.append(hi)
            counts.append(c)
    writer.add_histogram_raw(
        tag,
        min=edges[0],
        max=edges[-1],
        num=n,
        sum=mean * n,
        sum_squares=(std * std + mean * mean) * n,
        bucket_limits=limits,
        bucket_counts=counts,
        global_step=step,
        walltime=wall,
    )


def export_jsonl(jsonl_path: str, logdir: Optional[str] = None) -> str:
    """Convert one MetricLogger JSONL file into a TensorBoard run directory
    (default: ``<jsonl dir>/tb``). Returns the logdir."""
    logdir = logdir or os.path.join(os.path.dirname(os.path.abspath(jsonl_path)), "tb")
    writer = _writer(logdir)
    with open(jsonl_path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            step = int(rec.get("step", 0))
            wall = rec.get("wall")
            for key, val in rec.items():
                if key in ("step", "wall"):
                    continue
                if key.startswith("hist/") and isinstance(val, dict):
                    _add_histogram(writer, key[len("hist/"):], val, step, wall)
                elif isinstance(val, (int, float)):
                    writer.add_scalar(key, float(val), global_step=step, walltime=wall)
    writer.close()
    return logdir


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="zigp_tpu_torch.utils.tb_export",
        description="Convert a MetricLogger JSONL file to TensorBoard events",
    )
    p.add_argument("jsonl", help="path to metrics.jsonl")
    p.add_argument("logdir", nargs="?", default=None,
                   help="output event dir (default: <jsonl dir>/tb)")
    args = p.parse_args(argv)
    out = export_jsonl(args.jsonl, args.logdir)
    print(f"TensorBoard events written to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
