"""Time to target: the wall time the champion on/off GP takes to reach a
test RMSE.

Counterpart of ``zigp_tpu/experiments/time_to_target.py``. Trains the
champion preset (``configs.best_onoff_config``) with the device sampler
(each block one replay of its CUDA graph on the card), or with
``--hyper-every K`` the block-coordinate schedule
(``training.alternating``, each partition's cosine schedule sized to its own
update count), and pauses every ``eval_every`` steps to score the test RMSE
through ``runners.predict_batched`` (whose chunk graph, captured by the
first score, reads the parameters as they move). It records when the curve
first reaches each target:

- 0.68, the all-zeros predictor's floor on pptr (89.6 % of its targets are
  zero);
- 0.636, the reference protocol's 5-fold mean on pptr;
- within 1 % of this run's final RMSE ("converged").

The first two are pptr's: on other data (``--synthetic``) a target the
curve never reaches is reported as null. Training seconds leave out the
pauses (each waits for the card); total seconds keep them. Block b after
the first is seeded as the JAX package keys it, ``cfg.seed + done + b + 1``
(``StagedBlocks.fill_seed``), the first with ``cfg.seed``.

    python -m zigp_tpu_torch.experiments.time_to_target (--data PATH | --synthetic)
        [--fold 1] [--eval-every 2000] [--num-iter N] [--hyper-every K] [--out PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from . import measure

ZERO_TARGET = 0.68
REFERENCE_TARGET = 0.636
CHUNK = 4096


def run_time_to_target(fold: int = 1, eval_every: int = 2000, out=None, cfg=None, split=None, *, data=None,
                       synthetic: bool = False, device=None, dtype: torch.dtype = torch.float32, log_fn=print):
    """``cfg`` and ``split`` default to the champion preset on fold ``fold``
    of the data (``measure.load_split``)."""
    from ..core.config import resolve_device
    from ..training import DataSet, StagedBlocks, cosine_adam, make_optimizer, make_scan_train_step
    from ..utils import metrics
    from .builders import build_onoff_pptr
    from .configs import best_onoff_config
    from .runners import predict_batched

    device = resolve_device(device)
    source = measure.data_source(data, synthetic, split)
    if split is None:
        split = measure.load_split(data, synthetic, fold)
    cfg = cfg or best_onoff_config()
    model = build_onoff_pptr(cfg, split, device=device, dtype=dtype, use_kernel=device.type == "cuda")
    K = cfg.scan_inner or 50
    blocks = StagedBlocks(DataSet(split.Xtrain, split.Ytrain), "device", cfg.batch_size, K, device=device,
                          dtype=dtype)
    he = cfg.hyper_every or 0
    if he:
        from ..training.alternating import init_alt_optimizers, make_alternating_block

        opt = init_alt_optimizers(model, learning_rate=cfg.indp_lr, opt_factories=(
            cosine_adam(cfg.num_iter * (he - 1) // he), cosine_adam(max(1, cfg.num_iter // he))))
        block = make_alternating_block(model, opt, he)
        body = lambda: block(blocks.Xs, blocks.Ys)
    else:
        opt = make_optimizer(model, default_lr=cfg.indp_lr, schedule=cosine_adam(cfg.num_iter))
        train = make_scan_train_step(opt)
        body = lambda: train(model, blocks.Xs, blocks.Ys)
    step = measure.BlockStep(blocks.fill_seed, body, blocks.Xs)

    Xtest = np.asarray(split.Xtest, np.float32)  # the test inputs in float32, as the JAX harness scores them

    def test_rmse() -> float:
        pred = predict_batched(model.predict, Xtest, CHUNK, device=device, dtype=dtype)["gfmean"]
        return float(metrics.rmse(np.maximum(pred, 0), split.Ytest, clip_at_zero=False))

    blocks_per_eval = max(1, eval_every // K)
    num_blocks = cfg.num_iter // K

    # the first block, the capture and the first score (the chunk graph's
    # capture): one-time costs, reported apart
    t0 = time.perf_counter()
    measure.sync(step(cfg.seed))
    compile_sec = time.perf_counter() - t0
    test_rmse()
    done = 1

    curve = []
    train_sec = 0.0
    wall0 = time.perf_counter()
    while done < num_blocks:
        t0 = time.perf_counter()
        n = min(blocks_per_eval, num_blocks - done)
        for b in range(n):
            losses = step(cfg.seed + done + b + 1)
        measure.sync(losses)
        train_sec += time.perf_counter() - t0
        done += n
        curve.append({"step": done * K, "train_sec": train_sec, "total_sec": time.perf_counter() - wall0,
                      "test_rmse": test_rmse()})
        log_fn(json.dumps(curve[-1]))
    if not curve:
        raise ValueError(f"time_to_target: num_iter {cfg.num_iter} gives no block after the first (K = {K})")

    final_rmse = curve[-1]["test_rmse"]
    targets = {
        "rmse<=0.68 (zero-predictor floor)": ZERO_TARGET,
        "rmse<=0.636 (reference-protocol 5-fold mean)": REFERENCE_TARGET,
        "rmse within 1% of final": final_rmse * 1.01,
    }
    hits = {}
    for name, tgt in targets.items():
        hit = next((c for c in curve if c["test_rmse"] <= tgt), None)
        hits[name] = hit and {k: hit[k] for k in ("step", "train_sec", "total_sec", "test_rmse")}

    result = {
        "task": f"time to target test RMSE, champion preset, fold {fold}",
        "fold": fold,
        "data": source,
        "device": measure.device_name(device),
        "eval_every_steps": blocks_per_eval * K,
        "compile_sec": compile_sec,
        "final_rmse": final_rmse,
        "steps_per_sec_train_only": (num_blocks - 1) * K / train_sec,
        "targets": hits,
        "curve": curve,
    }
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    log_fn(json.dumps({k: v for k, v in result.items() if k != "curve"}, indent=1))
    return result


def main(argv=None):
    p = argparse.ArgumentParser(prog="zigp_tpu_torch.experiments.time_to_target",
                                description=__doc__.split("\n")[0])
    p.add_argument("--fold", type=int, default=1)
    p.add_argument("--eval-every", type=int, default=2000)
    p.add_argument("--num-iter", type=int, default=None, dest="num_iter",
                   help="cut the run (default: the champion's 150,000 steps)")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--hyper-every", type=int, default=0, dest="hyper_every",
                   help="block-coordinate cadence (training.alternating); 0 = joint")
    measure.add_data_args(p)
    args = p.parse_args(argv)
    kw = measure.build_kw_of(args)
    from .configs import best_onoff_config

    cfg = best_onoff_config()
    if args.hyper_every:
        cfg = dataclasses.replace(cfg, hyper_every=args.hyper_every)
    if args.num_iter:
        cfg = dataclasses.replace(cfg, num_iter=args.num_iter)
    run_time_to_target(args.fold, args.eval_every, args.out, cfg=cfg, data=kw["data"], synthetic=kw["synthetic"],
                       device=kw["device"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
