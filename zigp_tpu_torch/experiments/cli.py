"""Command-line experiment driver of the PyTorch port.

Counterpart of ``zigp_tpu/experiments/cli.py``, with the same subcommands
and flags:

    python -m zigp_tpu_torch.experiments toy        [--maxiter 8000] [--cpu-x64]
    python -m zigp_tpu_torch.experiments cvsplits   [--out DIR]
    python -m zigp_tpu_torch.experiments onoff      --fold 1 [--iters N] [--workdir DIR]
    python -m zigp_tpu_torch.experiments svgp       --fold 1 ...
    python -m zigp_tpu_torch.experiments classifier --fold 1 ...
    python -m zigp_tpu_torch.experiments hurdle     --fold 1 ...   (needs classifier results; --joint needs none)
    python -m zigp_tpu_torch.experiments zi         --fold 1 ...   (needs classifier+svgp results)
    python -m zigp_tpu_torch.experiments predict    --model onoff [--samples N] ...
    python -m zigp_tpu_torch.experiments export     --model onoff [--out PATH] [--fixed-batch B] ...
    python -m zigp_tpu_torch.experiments ensemble   --model onoff --size 5 ...
    python -m zigp_tpu_torch.experiments cv         --models onoff,svgp [--split kfold|forecast] [--batched] ...

Two flags are the port's own: ``--device`` (default ``cuda``; the card,
which must be present, or ``cpu``) and ``--dtype`` (default ``float32``),
the counterparts of the JAX package's platform and x64 switches; ``toy
--cpu-x64`` means ``--device cpu --dtype float64``. On the card the grams of
every RBF kernel, alone or inside a composite of the kernel zoo, are built by
the ``rbf_gram`` kernel (the runners' ``use_kernel``) and every
factorization takes ``chol_inv``'s kernels. ``toy`` reads ``toydata.mat``
from ``ZIGP_DATA_DIR``.

The mesh flags run one process per rank, under ``torchrun``:

    torchrun --nproc-per-node N -m zigp_tpu_torch.experiments onoff --mesh-data N ...
    torchrun --nproc-per-node 4 -m zigp_tpu_torch.experiments onoff --mesh-data 2 --mesh-model 2 ...
    torchrun --nproc-per-node 2 -m zigp_tpu_torch.experiments cv --batched --mesh-members 2 ...

The command line calls ``parallel.initialize`` before any work (NCCL on the
card, gloo on the CPU); a mesh that is not the launch's world ends the run
with the launch to use. Rank 0 alone prints and writes the results.

What the port does not have stops the run with a "not ported" error before
any work: ``selfcheck``, ``toy --plot`` and ``--solve-precision
high|mixed`` (left unported on purpose: ``highest`` is the port's only
precision).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import pickle
import sys

DTYPES = ("float32", "float64")


def _kernel_flag_kw(cfg, args) -> dict:
    """Config-field replacements for --kernel-temporal/-spatial/-period/
    -trust, shared by the per-fold commands and ``cv``, so a zoo spec (e.g.
    ``periodic*rbf``) applies to every variant that has the corresponding
    KernelInit fields."""
    kw = {}
    fam_t = getattr(args, "kernel_temporal", None)
    fam_s = getattr(args, "kernel_spatial", None)
    period = getattr(args, "kernel_period", None)
    trust = getattr(args, "kernel_trust", None)

    def _ki(init, family):
        repl = {"family": family} if family else {}
        if period is not None and "periodic" in (family or init.family):
            repl["period"] = (period,) * len(init.lengthscales)
        if trust:
            repl["trust"] = trust
        return dataclasses.replace(init, **repl) if repl else init

    if fam_t or period is not None or trust:
        for f in ("fk_temporal", "gk_temporal", "k_temporal"):
            if hasattr(cfg, f):
                kw[f] = _ki(getattr(cfg, f), fam_t)
    if fam_s or trust:
        for f in ("fk_spatial", "gk_spatial", "k_spatial"):
            if hasattr(cfg, f):
                kw[f] = _ki(getattr(cfg, f), fam_s)
    return kw


def _setup_logging(workdir: str, name: str):
    """Log to stdout and to ``workdir/modelsumm_{name}.log`` through the
    "zigp" logger; the handlers of an earlier call in the process are closed
    first. On a mesh only rank 0 logs."""
    from ..parallel.mesh import is_main_process

    os.makedirs(workdir, exist_ok=True)
    logger = logging.getLogger("zigp")
    logger.setLevel(logging.DEBUG)
    for h in [h for h in logger.handlers if getattr(h, "_zigp_cli", False)]:
        logger.removeHandler(h)
        h.close()
    if not is_main_process():
        return lambda msg: None
    fh = logging.FileHandler(os.path.join(workdir, f"modelsumm_{name}.log"))
    sh = logging.StreamHandler(sys.stdout)
    for h in (fh, sh):
        h._zigp_cli = True
        logger.addHandler(h)
    return logger.info


def _load_fold(args):
    from ..io.datasets import load_pptr, make_cv_splits

    splits = make_cv_splits(load_pptr(args.data))
    if not 1 <= args.fold <= len(splits):
        raise SystemExit(f"error: --fold must be in 1..{len(splits)}, got {args.fold}")
    return splits[args.fold - 1]


def _load_results(workdir: str, name: str, producer: str) -> dict:
    path = os.path.join(workdir, name)
    if not os.path.exists(path):
        raise SystemExit(
            f"error: {path} not found — run the '{producer}' experiment for this "
            f"fold/workdir first"
        )
    with open(path, "rb") as f:
        return pickle.load(f)


def _parse_grid(spec: str):
    """'SxT' → two-factor grid (S kmeans spatial ⊗ T time knots, the
    reference layout); 'LATxLONxT' → three-factor lat ⊗ lon ⊗ time."""
    from .configs import KronGridConfig

    try:
        parts = [int(x) for x in spec.lower().split("x")]
    except ValueError:
        parts = []
    if len(parts) == 2:
        return KronGridConfig(num_spatial=parts[0], num_temporal=parts[1])
    if len(parts) == 3:
        return KronGridConfig(spatial_factors=(parts[0], parts[1]), num_temporal=parts[2])
    raise SystemExit(
        f"error: --grid must be SxT (e.g. 10x100) or LATxLONxT (e.g. 6x6x100), got {spec!r}"
    )


def _placement(p):
    """The port's own flags: where and in what precision to run."""
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default: the card, which must be present) or "
                        "cpu; on the card every factor gram is built by the "
                        "rbf_gram kernel")
    p.add_argument("--dtype", type=str, default="float32", choices=DTYPES,
                   help="parameter and compute dtype (the card's kernels "
                        "take float32)")


def _common(p):
    p.add_argument("--fold", type=int, default=1, help="CV fold (1-5)")
    p.add_argument("--data", type=str, default=None, help="pptr.pickle path")
    p.add_argument("--workdir", type=str, default="runs/pptr")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--scan-inner", type=int, default=None, dest="scan_inner",
                   help="optimizer steps per CUDA-graph replay (default 50; "
                        "also the log/checkpoint sync granularity)")
    p.add_argument("--grid", type=str, default=None,
                   help="inducing grid: SxT (S kmeans spatial x T time "
                        "knots, the reference layout) or LATxLONxT for the "
                        "three-factor lat⊗lon⊗time decomposition")
    p.add_argument("--preset", type=str, default="reference",
                   choices=("reference", "reference-stable", "best"),
                   help="reference = the paper's exact config (unwhitened); "
                        "reference-stable = the same with whiten=True only; "
                        "best = the tuned/champion configs (selected by "
                        "interpolation CV; prefer reference with --split "
                        "forecast)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint in the workdir and continue")
    p.add_argument("--sampler", type=str, default=None, choices=("host", "device"),
                   help="minibatch source: host = epoch pipeline (reference "
                        "schedule); device = device-resident uniform sampling")
    p.add_argument("--optimizer", type=str, default=None, choices=("adam", "natgrad"),
                   help="adam = reference optimizer; natgrad = natural "
                        "gradient on the variational (q_mu, q_sqrt) pairs + "
                        "Adam on hyperparameters")
    p.add_argument("--natgrad-joint", action="store_true", default=None,
                   dest="natgrad_kron_joint",
                   help="with --optimizer natgrad and --q-cov kron: the exact "
                        "joint natural step on (mean, one covariance factor)")
    p.add_argument("--natgrad-gamma", type=float, default=None, dest="natgrad_gamma",
                   help="natural-gradient step size γ (post-warmup plateau)")
    p.add_argument("--natgrad-kl-cap", type=float, default=None, dest="natgrad_kl_cap",
                   help="per-step KL(q'|q) budget in nats for the kron-family "
                        "natural steps (default 10; 0 disables)")
    p.add_argument("--q-cov", type=str, default=None, dest="q_cov", choices=("diag", "kron"),
                   help="variational covariance family: diag (reference) or "
                        "kron (Kronecker-factored full covariance)")
    p.add_argument("--whiten", action="store_true", default=None, dest="whiten",
                   help="whitened variational parameterization")
    p.add_argument("--kernel-temporal", type=str, default=None, dest="kernel_temporal",
                   help="temporal-factor kernel family: rbf, matern12/32/52, "
                        "periodic, rq, linear, or a composite like "
                        "'periodic*rbf' ('*' binds tighter than '+')")
    p.add_argument("--kernel-spatial", type=str, default=None, dest="kernel_spatial",
                   help="spatial-factor kernel family (same choices as "
                        "--kernel-temporal)")
    p.add_argument("--hyper-every", type=int, default=None, dest="hyper_every",
                   help="block-coordinate training: update the "
                        "hyperparameters once every K steps, q-only steps "
                        "between (requires --sampler device; K must divide "
                        "scan_inner). 0/unset = joint training")
    p.add_argument("--recalibrate-noise", action="store_true", default=None,
                   dest="recalibrate_noise",
                   help="after training, moment-match the likelihood "
                        "variance to the train residuals (onoff/svgp)")
    p.add_argument("--kern-lr", type=float, default=None, dest="kern_lr",
                   help="hyperparameter (kernel/noise) learning rate for the "
                        "onoff model (default 1e-3)")
    p.add_argument("--kernel-trust", type=float, default=None, dest="kernel_trust",
                   help="bound every kernel's lengthscales to [init/R, "
                        "init*R] via a Sigmoid bijector; 0/unset = unbounded")
    p.add_argument("--kernel-period", type=float, default=None, dest="kernel_period",
                   help="initial period for 'periodic' temporal kernels")
    p.add_argument("--lr", type=float, default=None,
                   help="base learning rate (models with a single cfg.lr)")
    p.add_argument("--lr-schedule", type=str, default=None, dest="lr_schedule",
                   choices=("constant", "cosine"),
                   help="learning-rate schedule: constant (reference) or "
                        "cosine decay over the run")
    p.add_argument("--likelihood", type=str, default=None,
                   choices=("gaussian", "lognormal", "gamma"),
                   help="regression observation model (svgp/hurdle)")
    p.add_argument("--lognormal-variance", type=float, default=None,
                   dest="lognormal_variance",
                   help="init observation variance of log y (lognormal head)")
    p.add_argument("--gamma-shape", type=float, default=None, dest="gamma_shape",
                   help="init shape alpha of the gamma head (1 = exponential)")
    p.add_argument("--solve-precision", type=str, default=None, dest="solve_precision",
                   choices=("highest", "high", "mixed"),
                   help="precision of the solve-replacing contractions: "
                        "highest (exact float32, the port's only one); high "
                        "and mixed are not ported")
    p.add_argument("--mesh-data", type=int, default=None, dest="mesh_data",
                   help="shard the minibatch over this many ranks (data "
                        "parallelism; batch size must divide it; launch with "
                        "torchrun)")
    p.add_argument("--mesh-model", type=int, default=None, dest="mesh_model",
                   help="additionally row-shard the variational parameters "
                        "over this many ranks (tensor parallelism; uses "
                        "mesh-data × mesh-model ranks total)")
    _placement(p)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="zigp_tpu_torch.experiments")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_toy = sub.add_parser("toy", help="toy 1-D on/off GP (notebook workflow)")
    p_toy.add_argument("--maxiter", type=int, default=8000)
    p_toy.add_argument("--plot", type=str, default=None, help="save diagnostic plot here (not ported)")
    p_toy.add_argument("--cpu-x64", action="store_true", dest="cpu_x64",
                       help="run on the CPU in float64 (--device cpu --dtype float64), "
                            "the reference notebook's own numeric regime")
    _placement(p_toy)

    p_cv = sub.add_parser("cvsplits", help="write 5-fold CV splits")
    p_cv.add_argument("--out", type=str, default="runs/cv")
    p_cv.add_argument("--data", type=str, default=None)

    sub.add_parser("selfcheck", help="on-device numerics self-check (not ported: "
                                     "chip_smoke.py gates the kernels)")

    for name in ("onoff", "svgp", "classifier", "hurdle", "zi"):
        p_var = sub.add_parser(name)
        _common(p_var)
        if name == "hurdle":
            p_var.add_argument(
                "--joint", action="store_true",
                help="train the jointly-fit hurdle (gate + amount GP in one "
                     "ELBO) instead of the two-stage classifier→regression "
                     "pipeline; needs no classifier results",
            )

    p_pred = sub.add_parser(
        "predict",
        help="restore the latest checkpoint in the workdir and predict "
             "without training",
    )
    _common(p_pred)
    p_pred.add_argument("--model", type=str, default="onoff",
                        choices=("onoff", "svgp", "classifier", "hurdlej"),
                        help="which trained model to restore; config flags "
                             "(--preset/--kernel-*/...) must match training")
    p_pred.add_argument("--samples", type=int, default=0,
                        help="also draw this many predictive samples per "
                             "test point (onoff: gated y* = Φ(g*)·f* + ε; "
                             "svgp: f* + ε; classifier: Bernoulli draws; "
                             "hurdlej: mixed gate×amount draws) into the "
                             "predictions pickle's 'y_samples'")

    p_exp = sub.add_parser(
        "export",
        help="restore the latest checkpoint and write a standalone serving "
             "artifact (torch.export; params baked in, symbolic batch — load "
             "with zigp_tpu_torch.io.export.load_predictor)",
    )
    _common(p_exp)
    p_exp.add_argument("--model", type=str, default="onoff",
                       choices=("onoff", "svgp", "classifier", "hurdlej"),
                       help="which trained model to export; config flags "
                            "must match training")
    p_exp.add_argument("--out", type=str, default=None,
                       help="artifact path (default: "
                            "<workdir>/<fold>/export_<model>.zigp)")
    p_exp.add_argument("--fixed-batch", type=int, default=None, dest="fixed_batch",
                       help="pin the artifact's batch dimension instead of "
                            "exporting it symbolically")

    p_ens = sub.add_parser(
        "ensemble",
        help="train a seed ensemble of one model on one fold in a single "
             "batched run and evaluate the uniform-mixture predictive",
    )
    _common(p_ens)
    p_ens.add_argument("--model", type=str, default="onoff",
                       choices=("onoff", "svgp", "classifier", "hurdlej"))
    p_ens.add_argument("--size", type=int, default=5,
                       help="ensemble members (seeds seed..seed+size-1)")

    p_cv = sub.add_parser("cv", help="run model variants over all 5 CV folds")
    p_cv.add_argument("--models", type=str, default="onoff",
                      help="comma-separated: onoff,svgp,classifier,hurdle,"
                           "hurdlej,zi (hurdlej = jointly-trained hurdle)")
    p_cv.add_argument("--data", type=str, default=None)
    p_cv.add_argument("--split", type=str, default="kfold", choices=("kfold", "forecast"),
                      help="kfold = the reference's random 5-fold protocol "
                           "(interpolation); forecast = rolling-origin "
                           "temporal extrapolation")
    p_cv.add_argument("--origins", type=int, default=5,
                      help="with --split forecast: number of rolling origins")
    p_cv.add_argument("--horizon-frac", type=float, default=0.1, dest="horizon_frac",
                      help="with --split forecast: test-window length as a "
                           "fraction of the time range")
    p_cv.add_argument("--covariates", action="store_true",
                      help="with --split forecast: append forecast-computable "
                           "exogenous covariates (D 3 -> 8, from pre-origin "
                           "train data only) and give every model an extra "
                           "exogenous Kronecker factor (--num-exog knots)")
    p_cv.add_argument("--num-exog", type=int, default=8, dest="num_exog",
                      help="inducing knots of the exogenous covariate factor")
    p_cv.add_argument("--lr-schedule", type=str, default=None, dest="lr_schedule",
                      choices=("constant", "cosine"),
                      help="learning-rate schedule for every variant that "
                           "supports it")
    p_cv.add_argument("--indp-lr", type=float, default=None, dest="indp_lr",
                      help="variational-parameter (q) learning rate of "
                           "onoff/hurdlej")
    p_cv.add_argument("--workdir", type=str, default="runs/cv_full")
    p_cv.add_argument("--iters", type=int, default=None)
    p_cv.add_argument("--batch", type=int, default=None)
    p_cv.add_argument("--scan-inner", type=int, default=None, dest="scan_inner",
                      help="steps per CUDA-graph replay for every variant")
    p_cv.add_argument("--preset", type=str, default="reference",
                      choices=("reference", "reference-stable", "best"),
                      help="reference = the paper's exact per-variant configs "
                           "(unwhitened); reference-stable = the same with "
                           "whiten=True only; best = the tuned/champion "
                           "configs (for --split forecast prefer reference)")
    p_cv.add_argument("--solve-precision", type=str, default=None, dest="solve_precision",
                      choices=("highest", "high", "mixed"),
                      help="precision of the solve-replacing contractions "
                           "(highest only; high and mixed are not ported)")
    p_cv.add_argument("--grid", type=str, default=None,
                      help="inducing grid for every variant: SxT or LATxLONxT")
    p_cv.add_argument("--batched", action="store_true",
                      help="train all folds of each variant simultaneously as "
                           "one member stack (device-resident sampler)")
    p_cv.add_argument("--resume", action="store_true",
                      help="with --batched: restore the latest stack "
                           "checkpoint in --workdir and continue")
    p_cv.add_argument("--ensemble", type=int, default=1,
                      help="with --batched: train this many seed-ensemble "
                           "members per fold in the same stack and evaluate "
                           "each fold's uniform-mixture predictive")
    p_cv.add_argument("--optimizer", type=str, default=None, choices=("adam", "natgrad"),
                      help="optimizer for every trained variant")
    p_cv.add_argument("--q-cov", type=str, default=None, dest="q_cov", choices=("diag", "kron"),
                      help="variational covariance family for every variant")
    p_cv.add_argument("--natgrad-joint", action="store_true", default=None,
                      dest="natgrad_kron_joint",
                      help="with --optimizer natgrad and --q-cov kron: joint "
                           "natural step on (mean, one covariance factor)")
    p_cv.add_argument("--whiten", action="store_true", default=None,
                      help="whitened variational parameterization")
    p_cv.add_argument("--mesh-members", type=int, default=0, dest="mesh_members",
                      help="with --batched: shard the stacked member axis "
                           "(folds x ensemble seeds) over this many ranks "
                           "— zero per-step collectives; non-dividing member "
                           "counts are padded with discarded duplicates")
    p_cv.add_argument("--kernel-temporal", type=str, default=None, dest="kernel_temporal",
                      help="kernel family for the temporal factor of every "
                           "variant (the port has rbf)")
    p_cv.add_argument("--kernel-spatial", type=str, default=None, dest="kernel_spatial",
                      help="kernel family for the spatial factor(s)")
    p_cv.add_argument("--kernel-period", type=float, default=None, dest="kernel_period",
                      help="period init for periodic components")
    p_cv.add_argument("--kernel-trust", type=float, default=None, dest="kernel_trust",
                      help="bound kernel lengthscales to [init/R, init*R] "
                           "(Sigmoid bijector) for every variant")
    p_cv.add_argument("--recalibrate-noise", action="store_true", default=None,
                      dest="recalibrate_noise",
                      help="post-training noise recalibration for the "
                           "onoff/svgp variants")
    p_cv.add_argument("--kern-lr", type=float, default=None, dest="kern_lr",
                      help="onoff hyperparameter learning rate")
    p_cv.add_argument("--sampler", type=str, default=None, choices=("host", "device"),
                      help="minibatch source for every trained variant")
    p_cv.add_argument("--hyper-every", type=int, default=None, dest="hyper_every",
                      help="block-coordinate cadence for every variant "
                           "(requires --sampler device)")
    p_cv.add_argument("--likelihood", type=str, default=None,
                      choices=("gaussian", "lognormal", "gamma"),
                      help="regression observation model for the svgp/hurdle "
                           "variants")
    p_cv.add_argument("--lognormal-variance", type=float, default=None,
                      dest="lognormal_variance",
                      help="init observation variance of log y (lognormal)")
    p_cv.add_argument("--gamma-shape", type=float, default=None, dest="gamma_shape",
                      help="init shape alpha of the gamma head")
    _placement(p_cv)
    return parser


def _refuse_unported(args) -> None:
    """Stop with a "not ported" error for what the port does not have,
    before any data is read or any model built."""
    if args.cmd == "selfcheck":
        raise SystemExit("error: 'selfcheck' is not ported to zigp_tpu_torch (chip_smoke.py gates the kernels "
                         "on the card)")
    if args.cmd == "toy" and args.plot:
        raise SystemExit("error: toy --plot is not ported to zigp_tpu_torch yet (utils/plotting); drop the flag")
    if getattr(args, "solve_precision", None) in ("high", "mixed"):
        raise SystemExit(f"error: --solve-precision {args.solve_precision} is not ported to zigp_tpu_torch "
                         "(left out on purpose: the card's reduced-precision products are TF32, coarser "
                         "than the TPU's 3-pass bf16); highest is the port's precision")


def _placement_kw(args) -> dict:
    """The runners' device, dtype and gram-kernel keywords from --device and
    --dtype: the card must be present when asked for."""
    import torch

    from ..core.config import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError:
        raise SystemExit("error: no CUDA device is available; pass --device cpu to run on the CPU") from None
    return dict(device=device, dtype=getattr(torch, args.dtype), use_kernel=device.type == "cuda")


def _main_toy(args) -> int:
    """The toy on ``toydata.mat`` from ``ZIGP_DATA_DIR``: a missing file ends
    the run, with its path, before any work."""
    if args.cpu_x64:
        args.device, args.dtype = "cpu", "float64"
    placed = _placement_kw(args)
    from ..io import datasets

    path = os.path.join(datasets.DEFAULT_DATA_DIR, "toydata.mat")
    if not os.path.exists(path):
        raise SystemExit(f"error: {path} not found — the toy reads toydata.mat from ZIGP_DATA_DIR")
    from .configs import ToyOnOffConfig
    from .toy import run_toy

    run_toy(ToyOnOffConfig(maxiter=args.maxiter), device=placed["device"], dtype=placed["dtype"])
    return 0


def main(argv=None):
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    from ..parallel.distributed import initialize
    from ..parallel.mesh import MeshLaunchError

    initialize()
    try:
        return _main(args)
    except MeshLaunchError as e:
        raise SystemExit(f"error: {e}") from None


def _main(args) -> int:
    from ..parallel.mesh import is_main_process

    if args.cmd == "cvsplits":
        if not is_main_process():
            return 0
        from ..io.datasets import load_pptr, make_cv_splits

        splits = make_cv_splits(load_pptr(args.data))
        for i, s in enumerate(splits, start=1):
            d = os.path.join(args.out, str(i))
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "data.pickle"), "wb") as f:
                pickle.dump({"Xtrain": s.Xtrain, "Ytrain": s.Ytrain, "Xtest": s.Xtest, "Ytest": s.Ytest}, f)
            print(f"fold {i}: train {s.Xtrain.shape} test {s.Xtest.shape} -> {d}")
        return 0

    if args.cmd == "toy":
        return _main_toy(args)

    placed = _placement_kw(args)
    if args.cmd == "cv":
        return _main_cv(args, placed)

    split = _load_fold(args)
    workdir = os.path.join(args.workdir, str(args.fold))
    log = _setup_logging(workdir, args.cmd)
    if getattr(args, "solve_precision", None):
        log(f"solve precision: {args.solve_precision}")

    def _cfgkw(cfg):
        kw = {}
        if args.iters is not None:
            kw["num_iter"] = args.iters
        if args.batch is not None:
            kw["batch_size"] = args.batch
        if getattr(args, "scan_inner", None) is not None and hasattr(cfg, "scan_inner"):
            kw["scan_inner"] = args.scan_inner
        if getattr(args, "kern_lr", None) is not None and hasattr(cfg, "kern_lr"):
            kw["kern_lr"] = args.kern_lr
        if getattr(args, "recalibrate_noise", None) and hasattr(cfg, "recalibrate_noise"):
            kw["recalibrate_noise"] = True
        if getattr(args, "sampler", None) and hasattr(cfg, "sampler"):
            kw["sampler"] = args.sampler
        if getattr(args, "optimizer", None) and hasattr(cfg, "optimizer"):
            kw["optimizer"] = args.optimizer
        if getattr(args, "natgrad_kron_joint", None) and hasattr(cfg, "natgrad_kron_joint"):
            kw["natgrad_kron_joint"] = True
        if getattr(args, "natgrad_gamma", None) is not None and hasattr(cfg, "natgrad_gamma"):
            kw["natgrad_gamma"] = args.natgrad_gamma
        if getattr(args, "natgrad_kl_cap", None) is not None and hasattr(cfg, "natgrad_kl_cap"):
            kw["natgrad_kl_cap"] = args.natgrad_kl_cap
        if getattr(args, "q_cov", None) and hasattr(cfg, "q_cov"):
            kw["q_cov"] = args.q_cov
        if getattr(args, "likelihood", None) and hasattr(cfg, "likelihood"):
            kw["likelihood"] = args.likelihood
        for lk in ("lognormal_variance", "gamma_shape"):
            if getattr(args, lk, None) is not None and hasattr(cfg, lk):
                kw[lk] = getattr(args, lk)
        if getattr(args, "lr_schedule", None) is not None and hasattr(cfg, "lr_schedule"):
            kw["lr_schedule"] = "" if args.lr_schedule == "constant" else args.lr_schedule
        if getattr(args, "lr", None) is not None and hasattr(cfg, "lr"):
            kw["lr"] = args.lr
        if getattr(args, "whiten", None) and hasattr(cfg, "whiten"):
            kw["whiten"] = True
        if getattr(args, "hyper_every", None) is not None and hasattr(cfg, "hyper_every"):
            kw["hyper_every"] = args.hyper_every
        if getattr(args, "grid", None) and hasattr(cfg, "grid"):
            kw["grid"] = _parse_grid(args.grid)
        kw.update(_kernel_flag_kw(cfg, args))
        for mk in ("mesh_data", "mesh_model"):
            if getattr(args, mk, None) is not None and hasattr(cfg, mk):
                kw[mk] = getattr(args, mk)
        return dataclasses.replace(cfg, **kw)

    from .configs import REFERENCE_PRESET_WARNING, preset_configs

    _preset = getattr(args, "preset", "reference")
    _bases = preset_configs(_preset)
    if (
        _preset == "reference"
        and args.cmd in ("svgp", "hurdle")
        and not getattr(args, "whiten", False)
        and not (args.cmd == "hurdle" and getattr(args, "joint", False))
    ):
        log(REFERENCE_PRESET_WARNING)
    if args.cmd == "ensemble":
        from .ensemble import run_ensemble

        run_ensemble(split, args.model, _cfgkw(_bases[args.model]), size=args.size, workdir=workdir, log_fn=log,
                     **placed)
        return 0
    if args.cmd == "predict":
        from .runners import run_predict

        run_predict(split, args.model, _cfgkw(_bases[args.model]), workdir=workdir, log_fn=log,
                    samples=args.samples, **placed)
        return 0
    if args.cmd == "export":
        from .runners import run_export

        out = run_export(split, args.model, _cfgkw(_bases[args.model]), workdir=workdir, out=args.out,
                         batch_size=args.fixed_batch, log_fn=log, **placed)
        if is_main_process():
            print(f"artifact: {out}")
        return 0
    if args.cmd == "onoff":
        from .runners import run_onoff

        run_onoff(split, _cfgkw(_bases["onoff"]), workdir=workdir, log_fn=log, resume=args.resume, **placed)
    elif args.cmd == "svgp":
        from .runners import run_svgp

        run_svgp(split, _cfgkw(_bases["svgp"]), workdir=workdir, log_fn=log, resume=args.resume, **placed)
    elif args.cmd == "classifier":
        from .runners import run_classifier

        run_classifier(split, _cfgkw(_bases["classifier"]), workdir=workdir, log_fn=log, resume=args.resume,
                       **placed)
    elif args.cmd == "hurdle":
        if getattr(args, "joint", False):
            from .runners import run_hurdle_joint

            run_hurdle_joint(split, _cfgkw(_bases["hurdlej"]), workdir=workdir, log_fn=log, resume=args.resume,
                             **placed)
        else:
            from .configs import SvgpPptrConfig
            from .runners import run_hurdle

            clf = _load_results(workdir, "results_scgp.pickle", "classifier")
            run_hurdle(split, clf, _cfgkw(SvgpPptrConfig()), workdir=workdir, log_fn=log, **placed)
    elif args.cmd == "zi":
        from .runners import run_zero_inflated

        clf = _load_results(workdir, "results_scgp.pickle", "classifier")
        reg = _load_results(workdir, "results_svgp.pickle", "svgp")
        run_zero_inflated(split, clf, reg, workdir=workdir, log_fn=log)
    return 0


def _main_cv(args, placed: dict) -> int:
    """The ``cv`` subcommand: every variant over the folds of the KFold or
    the forecast protocol, sequential or as member stacks (``--batched``)."""
    from .cv import run_cv

    def _ckw(cfg):
        kw = {}
        if args.iters is not None:
            kw["num_iter"] = args.iters
        if args.batch is not None:
            kw["batch_size"] = args.batch
        if getattr(args, "scan_inner", None) is not None and hasattr(cfg, "scan_inner"):
            kw["scan_inner"] = args.scan_inner
        if getattr(args, "kern_lr", None) is not None and hasattr(cfg, "kern_lr"):
            kw["kern_lr"] = args.kern_lr
        if getattr(args, "indp_lr", None) is not None and hasattr(cfg, "indp_lr"):
            kw["indp_lr"] = args.indp_lr
        if getattr(args, "recalibrate_noise", None) and hasattr(cfg, "recalibrate_noise"):
            kw["recalibrate_noise"] = True
        if args.optimizer is not None:
            kw["optimizer"] = args.optimizer
        if getattr(args, "sampler", None) and hasattr(cfg, "sampler"):
            kw["sampler"] = args.sampler
        if getattr(args, "hyper_every", None) is not None and hasattr(cfg, "hyper_every"):
            kw["hyper_every"] = args.hyper_every
        if args.q_cov is not None:
            kw["q_cov"] = args.q_cov
        if getattr(args, "likelihood", None) and hasattr(cfg, "likelihood"):
            kw["likelihood"] = args.likelihood
        for lk in ("lognormal_variance", "gamma_shape"):
            if getattr(args, lk, None) is not None and hasattr(cfg, lk):
                kw[lk] = getattr(args, lk)
        if args.natgrad_kron_joint:
            kw["natgrad_kron_joint"] = True
        if args.whiten:
            kw["whiten"] = True
        if getattr(args, "lr_schedule", None) is not None and hasattr(cfg, "lr_schedule"):
            kw["lr_schedule"] = "" if args.lr_schedule == "constant" else args.lr_schedule
        if getattr(args, "grid", None) and hasattr(cfg, "grid"):
            kw["grid"] = _parse_grid(args.grid)
        if getattr(args, "covariates", False) and hasattr(cfg, "grid"):
            kw["grid"] = dataclasses.replace(kw.get("grid", cfg.grid), num_exog=args.num_exog)
        kw.update(_kernel_flag_kw(cfg, args))
        return dataclasses.replace(cfg, **kw)

    from ..io.datasets import load_pptr, make_cv_splits, make_forecast_splits
    from .configs import REFERENCE_PRESET_WARNING, preset_configs

    os.makedirs(args.workdir, exist_ok=True)
    log = _setup_logging(args.workdir, "cv")
    if args.solve_precision:
        log(f"solve precision: {args.solve_precision}")
    bases = preset_configs(args.preset)
    variants = [m.strip() for m in args.models.split(",") if m.strip()]
    if args.preset == "reference" and {"svgp", "hurdle"} & set(variants) and not args.whiten:
        log(REFERENCE_PRESET_WARNING)
    if args.split == "forecast" and args.batched:
        # rolling origins have ragged train sizes: the stacked trainer needs
        # equal-shape folds
        raise SystemExit(
            "error: --split forecast is not supported with --batched "
            "(rolling origins have unequal train sizes; the stacked "
            "trainer needs equal-shape folds) — drop --batched"
        )
    if getattr(args, "covariates", False) and args.split != "forecast":
        raise SystemExit(
            "error: --covariates requires --split forecast (the features "
            "are defined relative to a forecast origin)"
        )
    if args.split == "forecast":
        splits = make_forecast_splits(load_pptr(args.data), args.origins, horizon_frac=args.horizon_frac,
                                      covariates=getattr(args, "covariates", False))
        log(
            f"forecast protocol: {args.origins} rolling origins, "
            f"horizon {args.horizon_frac:.2f} of the time range"
            + (f", exogenous covariates on ({args.num_exog} knots)" if getattr(args, "covariates", False) else "")
        )
    else:
        splits = make_cv_splits(load_pptr(args.data))
    kwargs = dict(
        splits=splits,
        onoff_cfg=_ckw(dataclasses.replace(bases["onoff"], log_every=0)),
        svgp_cfg=_ckw(dataclasses.replace(bases["svgp"], log_every=0)),
        clf_cfg=_ckw(dataclasses.replace(bases["classifier"], log_every=0)),
        hurdlej_cfg=_ckw(dataclasses.replace(bases["hurdlej"], log_every=0)),
        workdir=args.workdir,
        log_fn=log,
        **placed,
    )
    if args.batched:
        from .cv_batched import run_cv_batched

        run_cv_batched(variants, resume=args.resume, ensemble=args.ensemble, mesh_members=args.mesh_members,
                       **kwargs)
    else:
        if args.ensemble > 1:
            raise SystemExit("error: --ensemble requires --batched")
        run_cv(variants, **kwargs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
