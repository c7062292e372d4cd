"""A copy of the benchmark's files at a size a CPU test holds: the same
cells and metrics, with 12 stations over 40 hours, grids of 12 × 10 (every
station) and 4 × 10, batches of 64, blocks of 5 steps and serving calls of
36 to 100 rows.

The limits of ``correct`` are the tiny size's own (``TINY_LIMITS``), set as
the cells' are, from CPU readings at this size: the program's largest over
8 seeds, below the smallest of the control's, the half-batch fault's and
the stuck sampler's over 3 seeds (PERF.md §2 says how). A float32 grid of 4 or 12 inducing
points in space is conditioned otherwise than the cells' grids."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.harness.manifest import ROOT

KINDS = ("configs", "traffic", "workloads", "metrics", "rooflines")
TINY_LIMITS = {
    "flagship.train": {"loss1_gap": 1e-3, "grad_gap": 3e-2, "step_gap_median": 1e-3, "data_grad_gap": 1e-3, "data_gap": 1e-3,
                       "replay_loss_gap": 1e-3, "replay_data_gap": 5e-4, "replay_step_gap": 1e-2},
    "grid.train": {"loss1_gap": 5e-3, "grad_gap_median": 3e-3, "step_gap_median": 3e-3, "data_grad_gap": 8e-3,
                   "data_gap": 5e-3, "replay_loss1_gap": 2e-3, "replay_data_gap": 2e-3,
                   "replay_step_gap_median": 2e-3},
    "flagship.train_mixed": {"loss1_gap": 2e-3, "grad_gap": 5e-2, "step_gap_median": 2e-3, "data_grad_gap": 2e-3,
                             "data_gap": 2e-3, "replay_loss_gap": 1e-2, "replay_data_gap": 5e-3,
                             "replay_step_gap_median": 2e-3},
    "grid.serve": {"field_gap": 0.02},
}


def copy_root(dst: Path) -> Path:
    dst = Path(dst)
    for kind in KINDS:
        shutil.copytree(ROOT / kind, dst / kind, dirs_exist_ok=True)
    return dst


def tiny_root(dst: Path) -> Path:
    dst = copy_root(dst)
    for f in (dst / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["data"].update(n_stations=12, n_hours=40)
        c["grid"].update(num_spatial=12 if c["grid"]["spatial"] == "stations" else 4, num_temporal=10)
        c["batch_size"] = 64
        f.write_text(json.dumps(c))
    for f in (dst / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        if t["kind"] == "train":
            t.update(scan_inner=5, log_every=10, stretch_blocks=2)
        else:
            t.update(chunk=64, cycle=[{"shape": "stations_hours", "hours": 3, "rows": 36, "count": 2},
                                      {"shape": "random_rows", "rows": 100, "count": 1},
                                      {"shape": "raster", "nx": 4, "ny": 4, "hours": 5, "rows": 80, "count": 1}])
        f.write_text(json.dumps(t))
    for cell, limits in TINY_LIMITS.items():
        f = dst / "workloads" / f"{cell}.json"
        w = json.loads(f.read_text())
        w["limits"] = limits
        f.write_text(json.dumps(w))
    return dst
