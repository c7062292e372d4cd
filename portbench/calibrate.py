"""The readings that the limits of ``correct`` are set from, for one cell,
in one process on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... [--control-seeds 1 2 3] [--seconds S]

For each seed of ``--seeds``: the program's numbers (a training cell's run
stops at the first boundary of its window, since its readings need no
window; a serving cell's runs ``--seconds`` at its own load). For each seed
of ``--control-seeds``: the control (the reference put in the program's
place in the cell's ``control`` precision) and, in a training cell, the
faults, each planted in the reference put in the program's place and
started from the program's own state at the replayed block's boundary: half
the batch left out with the mean taken over the rest, and a sampler that
stops advancing (the replayed block takes block 0's rows again). A state
left unchanged reads 1 on the change by construction and needs no run.
Each reading is one JSON line on standard output; nothing here decides a
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


def half_batch(X, Y):
    n = X.shape[0] // 2
    return X[:n], Y[:n]


def train_readings(cell, seeds, control_seeds, device, log):
    import torch

    from portbench.harness import compare, train

    for seed in list(seeds) + [s for s in control_seeds if s not in seeds]:
        out = train.run(cell, seed, 0.0, False, device, time.perf_counter(), log=log)
        if seed in seeds:
            yield {"seed": seed, "side": "program", **out["numbers"]}
        if seed not in control_seeds:
            continue
        d, state, ss = train.inputs_of(cell, seed)
        at = out["readings"]["boundary"]
        ref = out["readings"]["reference"]
        sides = {
            "control": dict(dtype=torch.float32, **cell.control),
            "fault_half_batch": dict(batch_fault=half_batch),
            "fault_sampler_stuck": dict(replay_block=0),
        }
        for side, kw in sides.items():
            got = train.reference_readings(cell, d, state, ss, device, at, **kw)
            yield {"seed": seed, "side": side, **compare.train_numbers(got, ref, **cell.numbers)}


def serve_readings(cell, seeds, control_seeds, seconds, device, log):
    import numpy as np
    import torch

    from portbench.harness import compare, serve
    from portbench.harness.traffic import ServeCalls

    for seed in seeds:
        out = serve.run(cell, seed, seconds, False, device, time.perf_counter(), log=log)
        yield {"seed": seed, "side": "program", "calls": out["attempted"], **out["numbers"]}
    for seed in control_seeds:  # 65,536 rows drawn from one variant of each call shape
        d, state = serve.inputs_of(cell, seed)
        calls = ServeCalls(cell.traffic, d, seed)
        pool = np.concatenate([calls.rows(e, 0) for e in range(len(calls.entries))])
        X = pool[np.random.default_rng(seed).integers(0, pool.shape[0], 65536)]
        ref = serve.reference_fields(cell, state, X, d.Xtrain.shape[0], device)
        low = serve.reference_fields(cell, state, X, d.Xtrain.shape[0], device, dtype=torch.float32, **cell.control)
        yield {"seed": seed, "side": "control", **compare.serve_numbers(low, ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness.manifest import Cell, load_manifest

    cell = Cell(load_manifest(os.path.join(CHECKOUT, "BENCHMARK.json")), args.workload)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    log = lambda s: None
    gen = (train_readings(cell, args.seeds, args.control_seeds, device, log) if cell.kind == "train"
           else serve_readings(cell, args.seeds, args.control_seeds, args.seconds, device, log))
    for reading in gen:
        print(json.dumps({"cell": cell.name, **reading}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
