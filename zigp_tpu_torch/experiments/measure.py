"""The measurement scaffold of the experiment harnesses.

Counterpart of ``zigp_tpu/experiments/measure.py``: one copy of the timing
convention behind ``sampler_ab``, ``precision_ab``, ``alternating_ab`` and
``profile_step``, so a correction cannot leave their numbers apart:

- train a deep copy of the built model (``copy.deepcopy``): a captured block
  binds the storage of the model and optimizer it was captured on, so each
  run gets storage of its own and the built model survives the round-robin
  passes (the JAX package copies because its scanned steps donate buffers);
- leave out of the clock every block before the first replay: the eager
  warm-up blocks ``training.scan.BlockRunner`` runs on a side stream, the
  capture of the block's CUDA graph, and the kernels' first build;
- block b samples with ``block_key(b)``, the device sampler's block index;
- interleave the variants in round robin within one process and report the
  median of the repeats (small differences are trusted only from
  interleaved runs in one process).

The data: ``--data PATH`` (a ``load_pptr`` pickle; its first CV fold, as the
JAX package reads ``pptr.pickle``) or, asked for explicitly, ``--synthetic``
(``io.datasets.synthetic_pptr(105, 1080, seed=0)``); every result names
its source. On the card the factor grams are built by the ``rbf_gram``
kernel, as the command line has them (``use_kernel`` when the device is
CUDA).
"""

from __future__ import annotations

import contextlib
import copy
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

CONFIGS = ("flagship", "champion", "scale")
SYNTHETIC = "synthetic_pptr(105, 1080, seed=0)"


def analytic_matmul_flops(batch: int, num_spatial: int, num_temporal: int) -> float:
    """Logical matmul FLOPs of one training step of the paired-GP factored
    conditional (forward and backward), a copy of the JAX package's count.

    Per GP forward: V_p = L_p⁻¹Kmn_p and A_p = K_p⁻¹Kmn_p at 2·M_p²·B each
    (both factors), plus the first-stage mean and c2 contractions at
    2·Ms·Mt·B each; reverse mode doubles every product, so the total is 3 ×
    the forward. Two GPs (f and g). Elementwise work (gram exponentials,
    probit, Adam) is left out."""
    Ms, Mt, B = num_spatial, num_temporal, batch
    fwd_per_gp = 4 * B * (Ms * Ms + Mt * Mt) + 4 * B * Ms * Mt
    return 3.0 * 2.0 * fwd_per_gp


def data_source(data: Optional[str] = None, synthetic: bool = False, split=None) -> str:
    """What a run trained on, for its output."""
    if split is not None:
        return "the given split"
    return SYNTHETIC if synthetic else (data or "pptr.pickle under ZIGP_DATA_DIR")


def load_split(data: Optional[str] = None, synthetic: bool = False, fold: int = 1):
    """Fold ``fold`` of ``make_cv_splits(load_pptr(data))``, or with
    ``synthetic`` the seeded pptr-shaped split (fold-shaped already)."""
    from ..io.datasets import load_pptr, make_cv_splits, synthetic_pptr

    if synthetic:
        return synthetic_pptr(105, 1080, seed=0)
    return make_cv_splits(load_pptr(data))[fold - 1]


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def config_of(config: str):
    """(cfg, batch size) of a named configuration: ``flagship`` (10 × 100,
    B = 1000), ``champion`` (32 × 200, Kronecker-factored q, whitened,
    B = 4000), ``scale`` (105 × 250, B = 1000)."""
    from .configs import KronGridConfig, OnOffPptrConfig, best_onoff_config

    if config == "flagship":
        cfg = OnOffPptrConfig()
    elif config == "champion":
        cfg = best_onoff_config()
    elif config == "scale":
        cfg = OnOffPptrConfig(grid=KronGridConfig(num_spatial=105, num_temporal=250))
    else:
        raise ValueError(f"unknown config {config!r}")
    return cfg, cfg.batch_size


def build_config(config: str, *, batch_override: Optional[int] = None, data: Optional[str] = None,
                 synthetic: bool = False, device=None, dtype: torch.dtype = torch.float32, split=None):
    """(model, (X, Y) training arrays, batch size, cfg) of a named
    configuration (``config_of``) on ``load_split(data, synthetic)`` (or
    ``split``), the model built on ``device`` (``None`` is the CUDA card) in
    ``dtype``, with the gram kernel on the card. ``batch_override`` replaces
    the configuration's batch size (the large-batch sweeps)."""
    from ..core.config import resolve_device
    from .builders import build_onoff_pptr

    device = resolve_device(device)
    cfg, batch = config_of(config)
    split = split if split is not None else load_split(data, synthetic)
    model = build_onoff_pptr(cfg, split, device=device, dtype=dtype, use_kernel=device.type == "cuda")
    return model, (split.Xtrain, split.Ytrain), int(batch_override) if batch_override else batch, cfg


class BlockStep:
    """One block of K steps a call: ``step(key)`` fills the block's static
    inputs for ``key`` (``fill(key)``) and runs ``body()`` through a
    ``training.scan.BlockRunner`` (on the card: the eager warm-up blocks,
    then the block captured once, right after the last of them, and one
    replay a call), returning the K losses on the device. ``ready``: every
    later call is a replay (always on the CPU)."""

    def __init__(self, fill: Callable, body: Callable, Xs: torch.Tensor):
        from ..training.scan import BlockRunner

        self.fill = fill
        self.runner = BlockRunner(body, Xs)
        self.num_inner = Xs.shape[0]

    @property
    def ready(self) -> bool:
        return not self.runner.cuda or self.runner.graphed is not None

    def __call__(self, key) -> torch.Tensor:
        self.fill(key)
        losses = self.runner()
        if self.runner.wants_capture:
            self.runner.capture()
        return losses


def staged_step(model, optimizer, arrays, batch: int, num_inner: int) -> BlockStep:
    """The production device sampler (``training.scan.StagedBlocks``,
    sampler "device"): the training set on the model's device, block b's
    K·B rows drawn with one ``randint`` seeded by ``block_seed(0, b)`` and
    gathered once, outside the graph, into the static block."""
    from ..training import DataSet, StagedBlocks, make_scan_train_step

    p = next(model.parameters())
    blocks = StagedBlocks(DataSet(*arrays), "device", batch, num_inner, device=p.device, dtype=p.dtype)
    body = make_scan_train_step(optimizer)
    return BlockStep(blocks.fill, lambda: body(model, blocks.Xs, blocks.Ys), blocks.Xs)


def prepare_step(model, arrays, batch: int, cfg, step_factory: Optional[Callable] = None, *, num_inner: int = 100):
    """(step, model, optimizer) of one run: a deep copy of ``model`` with its
    own Adam (``make_optimizer`` at ``cfg.indp_lr``) and the ``BlockStep`` of
    ``step_factory(model, optimizer, arrays, batch, num_inner)`` (by default
    ``staged_step``; the A/B harnesses pass their variants')."""
    from ..training import make_optimizer

    model = copy.deepcopy(model)
    optimizer = make_optimizer(model, default_lr=cfg.indp_lr)
    step = (step_factory or staged_step)(model, optimizer, arrays, batch, num_inner)
    return step, model, optimizer


def block_key(b: int) -> int:
    """The key of block b, what ``StagedBlocks.fill`` takes: the block index.
    The port's sampler draws its rows from ``block_seed(0, b)`` with its own
    generator, not from the JAX key ``[0, b]`` of the JAX package's
    convention, so the rows differ from the JAX package's."""
    return int(b)


def sync(losses: torch.Tensor) -> float:
    """Wait for the card (``block_until_ready``) and read the last loss."""
    if losses.is_cuda:
        torch.cuda.synchronize(losses.device)
    return float(losses[-1])


def warm_up(step: BlockStep) -> int:
    """Run blocks from key 0 until the step is ``ready`` (the warm-up
    blocks and the capture) and wait for them; the next block's key."""
    b = 0
    while True:
        losses = step(block_key(b))
        b += 1
        if step.ready:
            sync(losses)
            return b


def measure_rate(step: BlockStep, model, opt_state, *, num_inner: int, num_blocks: int):
    """(steps/s, the last block's final loss): untimed blocks from key 0
    until the step is ``ready`` (the warm-up blocks and the capture), then
    ``num_blocks`` timed blocks of ``num_inner`` steps on the next keys."""
    if step.num_inner != num_inner:
        raise ValueError(f"measure_rate: the step runs blocks of {step.num_inner}, not {num_inner}")
    b = warm_up(step)
    t0 = time.perf_counter()
    for k in range(num_blocks):
        losses = step(block_key(b + k))
    last = sync(losses)
    return num_blocks * num_inner / (time.perf_counter() - t0), last


def run_round_robin(
    task: str,
    configs,
    variants,
    measure_one: Callable,
    *,
    num_inner: int,
    num_blocks: int,
    repeats: int,
    out: Optional[str] = None,
    log_fn=print,
    build_kw: Optional[dict] = None,
):
    """Interleaved round-robin A/B: for each config (built once by
    ``build_config(config, **build_kw)``), ``repeats`` passes of every
    variant in turn, the median of each, and a JSON file at ``out``.
    ``measure_one(built, variant, num_inner=, num_blocks=)`` returns (steps/s,
    the last block's loss) of one fresh run."""
    results = {c: {v: [] for v in variants} for c in configs}
    losses = {c: {v: [] for v in variants} for c in configs}  # every repeat kept
    for config in configs:
        log_fn(f"== {config} ==")
        built = build_config(config, **build_kw) if build_kw else build_config(config)
        for r in range(repeats):
            for variant in variants:  # interleaved round robin
                rate, last = measure_one(built, variant, num_inner=num_inner, num_blocks=num_blocks)
                results[config][variant].append(round(rate, 1))
                losses[config][variant].append(last)
                log_fn(f"  {variant:>8s} pass {r}: {rate:8.1f} steps/s (loss {last:.1f})")

    summary = {
        "task": task,
        "num_inner": num_inner,
        "num_blocks": num_blocks,
        "steps_per_sec_median": {
            c: {v: sorted(vals)[len(vals) // 2] for v, vals in d.items() if vals} for c, d in results.items()
        },
        "steps_per_sec_all": results,
        "final_block_loss": losses,
    }
    if build_kw:
        from ..core.config import resolve_device

        summary["data"] = data_source(build_kw.get("data"), build_kw.get("synthetic", False), build_kw.get("split"))
        summary["device"] = device_name(resolve_device(build_kw.get("device")))
    log_fn(json.dumps(summary["steps_per_sec_median"]))
    if out:
        with open(out, "w") as f:
            json.dump(summary, f, indent=1)
        log_fn(f"wrote {out}")
    return summary


def add_data_args(ap) -> None:
    """The harnesses' shared flags: ``--data``, ``--synthetic``, ``--device``."""
    ap.add_argument("--data", type=str, default=None, help="a pptr pickle (load_pptr's format); fold 1 is used")
    ap.add_argument("--synthetic", action="store_true",
                    help=f"train on {SYNTHETIC} instead of --data")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def build_kw_of(args, dtype: torch.dtype = torch.float32) -> dict:
    if args.data and args.synthetic:
        raise SystemExit("error: --data and --synthetic exclude each other")
    return dict(data=args.data, synthetic=args.synthetic, device=args.device, dtype=dtype)


@contextlib.contextmanager
def solve_precision(policy: Optional[str]):
    """``--solve-precision``: the policy (``ops.linalg.set_solve_precision``)
    in force inside, from before any model or step is built; "highest"
    again after, whatever happens, as the JAX harnesses put it back. None
    leaves the policy as it is. Yields the policy in force."""
    from ..ops import linalg

    if policy is None:
        yield linalg.solve_precision()
        return
    linalg.set_solve_precision(policy)
    try:
        yield policy
    finally:
        linalg.set_solve_precision("highest")


def losses_of(step: BlockStep, keys) -> np.ndarray:
    """The losses of the blocks of ``keys``, one after the other, on the host."""
    return np.concatenate([step(k).cpu().numpy() for k in keys])
