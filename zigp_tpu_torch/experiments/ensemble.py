"""Seed ensembles: E members of one model, differing in their seed, trained
as one stack and combined as a uniform mixture.

Counterpart of ``zigp_tpu/experiments/ensemble.py``. Members differ in
everything the seed touches: the kmeans inducing inits, the q_mu draws and
the minibatch stream (``seeds=[seed + e]``). They train through
``training.batched.fit_batched_scanned``, one stack on the card, and serve
through ``predict_batched_stacked``.

The combining rules are numpy copies of the JAX package's: exact
uniform-mixture moment matching over members,

    mean = (1/E) Σ_e mean_e
    var  = (1/E) Σ_e (var_e + mean_e²) − mean²   (law of total variance),

on the Gaussian predictive (svgp), the gated moments (onoff), the
probability (classifier) and the joint hurdle's gate and amount latent.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..io.datasets import Split
from ..training.batched import fit_batched_scanned, stack_models
from ..training.optim import cosine_adam
from .builders import (
    binarize_targets,
    build_classifier_pptr,
    build_hurdle_joint_pptr,
    build_onoff_pptr,
    build_svgp_pptr,
)
from .configs import ClassifierPptrConfig, HurdleJointConfig, OnOffPptrConfig, SvgpPptrConfig
from .cv_batched import _clf_predict, _hurdlej_fields, _onoff_predict, _stacked_predict, _svgp_predict
from .runners import _classifier_metrics, _hurdlej_metrics, _maybe_pickle, _onoff_metrics, _svgp_metrics


def mixture_moments(means: np.ndarray, variances: np.ndarray):
    """Uniform-mixture mean/variance over the leading member axis.

    means, variances: (E, N, L). Returns ((N, L), (N, L))."""
    mu = means.mean(axis=0)
    var = (variances + np.square(means)).mean(axis=0) - np.square(mu)
    return mu, np.maximum(var, 0.0)


_BUILDERS = {
    "onoff": (build_onoff_pptr, OnOffPptrConfig),
    "svgp": (build_svgp_pptr, SvgpPptrConfig),
    "classifier": (build_classifier_pptr, ClassifierPptrConfig),
    "hurdlej": (build_hurdle_joint_pptr, HurdleJointConfig),
}


def healthy_member_mask(final_losses, *, max_ratio: float = 10.0) -> np.ndarray:
    """Boolean keep-mask over ensemble members from their final training
    losses (the JAX package's rule, which derives it): a member whose final
    loss exceeds the member median by ``max_ratio`` × max(|median|, 1), or
    by 1000 × the robust spread (MAD, floored at 1e-6·scale), ended
    mid-spike and is left out. All-unknown losses keep everyone; the
    lowest-loss member is always kept."""
    fl = np.asarray(final_losses, dtype=np.float64).reshape(-1)
    mask = np.isfinite(fl)
    if not mask.any():
        return np.ones(fl.shape[0], dtype=bool)
    med = np.median(fl[mask])
    scale = max(abs(med), 1.0)
    mad = np.median(np.abs(fl[mask] - med))
    spread = max(mad, 1e-6 * scale)
    mask &= ((fl - med) <= max_ratio * scale) & ((fl - med) <= 1000.0 * spread)
    if not mask.any():
        mask[int(np.nanargmin(fl))] = True
    return mask


def _healthy(trained: list, preds_list, results: list, log_fn, label: str):
    """Filter (models, *prediction lists) by the health mask; log exclusions."""
    mask = healthy_member_mask([r.final_loss for r in results])
    if mask.all():
        return trained, preds_list
    dropped = [e for e in range(len(trained)) if not mask[e]]
    log_fn(
        f"{label}: excluding members {dropped} from the mixture "
        f"(final losses {[f'{results[e].final_loss:.3g}' for e in dropped]} "
        f"vs member median "
        f"{np.median([r.final_loss for r in results]):.3g} — ended mid-spike)"
    )
    keep = [e for e in range(len(trained)) if mask[e]]
    return [trained[e] for e in keep], [[p[e] for e in keep] for p in preds_list]


def _with_averaged(models: list, field_of: Callable):
    """A copy of member 0 with the scalar parameter ``field_of(model)``
    (a ``Parameter``) set to the members' average, in the JAX package's
    order: the constrained values averaged in float64, the raw its inverse
    cast to the model's dtype."""
    avg = float(np.mean([field_of(m).value.detach().cpu().numpy() for m in models]))
    out = copy.deepcopy(models[0])
    field_of(out).assign_(avg)
    return out


def _avg_noise_model(models: list):
    """Member 0's model with the likelihood's scalar parameter replaced by
    the members' average — the scalar the shared metric blocks read for NLPD.
    ``variance`` for the Gaussian/LogNormal heads, ``shape`` for Gamma."""
    field = "variance" if hasattr(models[0].likelihood, "variance") else "shape"
    return _with_averaged(models, lambda m: getattr(m.likelihood, field))


def _avg_amount_model(models: list):
    """Member 0's joint-hurdle model with the amount head's scalar parameter
    replaced by the members' average (``_avg_noise_model`` for models whose
    likelihood lives at ``amount_likelihood``)."""
    field = "variance" if hasattr(models[0].amount_likelihood, "variance") else "shape"
    return _with_averaged(models, lambda m: getattr(m.amount_likelihood, field))


def mix_gaussian_preds(preds: list) -> dict:
    """Uniform-mixture {fmean, fvar} over member prediction dicts."""
    mu, var = mixture_moments(np.stack([p["fmean"] for p in preds]), np.stack([p["fvar"] for p in preds]))
    return {"fmean": mu, "fvar": var}


def mix_classifier_preds(preds: list) -> dict:
    mu, var = mixture_moments(np.stack([p["pfmean"] for p in preds]), np.stack([p["pfvar"] for p in preds]))
    return {"pfmean": mu, "pfvar": var}


def mix_hurdlej_preds(preds: list) -> dict:
    """Uniform mixture for the joint hurdle: exact for the gate probability
    (mean of p_on), latent-moment-matched for the amount GP."""
    fmean, fvar = mixture_moments(np.stack([p["fmean"] for p in preds]), np.stack([p["fvar"] for p in preds]))
    return {"p_on": np.stack([p["p_on"] for p in preds]).mean(axis=0), "fmean": fmean, "fvar": fvar}


def mix_onoff_preds(preds: list) -> dict:
    """Uniform mixture of the gated predictive Φ(g)f: the total second moment
    is gfvar + gfmeanu + gfmean², so the total-variance identity applies to
    (gfvar + gfmeanu); the mixture's split between the two terms is not
    identified, so everything lands in gfvar and gfmeanu is zeroed. The
    member predictions ride along for the proper-scoring block, which
    samples the mixture exactly from them."""
    gfmean, gfvar_tot = mixture_moments(
        np.stack([p["gfmean"] for p in preds]),
        np.stack([p["gfvar"] + p["gfmeanu"] for p in preds]),
    )
    mix = dict(preds[0])
    mix["gfmean"] = gfmean
    mix["gfvar"] = gfvar_tot
    mix["gfmeanu"] = np.zeros_like(gfvar_tot)
    mix["fmean"] = np.stack([p["fmean"] for p in preds]).mean(axis=0)
    mix["pgmean"] = np.stack([p["pgmean"] for p in preds]).mean(axis=0)
    mix["member_preds"] = [dict(p) for p in preds]
    return mix


def run_ensemble(
    split: Split,
    kind: str,
    cfg=None,
    *,
    size: int = 5,
    workdir: Optional[str] = None,
    log_fn: Callable[[str], None] = print,
    device=None,
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
) -> dict:
    """Train a seed ensemble of ``size`` members of ``kind`` (onoff, svgp,
    classifier, hurdlej) on one split as one stack and score the mixture
    predictive with the single-model runner's metric block. Returns that
    runner's results plus ``member_*`` per-member metrics, ``ensemble_size``
    and ``train_time_sec`` (training alone, scoring apart).
    ``device=None`` is the CUDA card."""
    if kind not in _BUILDERS:
        raise ValueError(f"unknown ensemble kind {kind!r} (onoff|svgp|classifier|hurdlej)")
    build, default_cfg = _BUILDERS[kind]
    cfg = cfg or default_cfg()
    if getattr(cfg, "optimizer", "adam") == "natgrad":
        raise ValueError("ensembles support optimizer='adam' only")

    base_seed = getattr(cfg, "seed", 0)
    seeds = [base_seed + e for e in range(size)]
    members = [build(dataclasses.replace(cfg, seed=s), split, device=device, dtype=dtype, use_kernel=use_kernel)
               for s in seeds]
    Y = binarize_targets(split.Ytrain) if kind == "classifier" else split.Ytrain
    lr = cfg.indp_lr if kind == "onoff" else cfg.lr
    schedule = cosine_adam(cfg.num_iter) if getattr(cfg, "lr_schedule", "") == "cosine" else None

    num_inner = getattr(cfg, "scan_inner", 50) or 50
    t0 = time.time()
    res = fit_batched_scanned(
        members,
        [(split.Xtrain, Y)] * size,
        num_iter=cfg.num_iter,
        batch_size=cfg.batch_size,
        num_inner=num_inner,
        schedule=schedule,
        learning_rate=lr,
        seeds=seeds,
        log_every_blocks=max(1, cfg.log_every // num_inner) if getattr(cfg, "log_every", 0) else 0,
        log_fn=lambda m: log_fn(f"[ensemble x{size}] {m}"),
    )
    train_time = time.time() - t0
    trained = [r.model for r in res]
    stack = stack_models(trained)
    quiet = lambda s: None  # noqa: E731

    if kind == "hurdlej":
        ptr = _stacked_predict(stack, _hurdlej_fields, [split.Xtrain] * size)
        pte = _stacked_predict(stack, _hurdlej_fields, [split.Xtest] * size)
        member_metrics = [_hurdlej_metrics(trained[e], ptr[e], pte[e], split, quiet) for e in range(size)]
        keep, (kptr, kpte) = _healthy(trained, [ptr, pte], res, log_fn, "ensemble")
        results = _hurdlej_metrics(_avg_amount_model(keep), mix_hurdlej_preds(kptr), mix_hurdlej_preds(kpte),
                                   split, log_fn)
    elif kind == "svgp":
        ptr = _stacked_predict(stack, _svgp_predict, [split.Xtrain] * size)
        pte = _stacked_predict(stack, _svgp_predict, [split.Xtest] * size)
        member_metrics = [_svgp_metrics(trained[e], ptr[e], pte[e], split, quiet) for e in range(size)]
        keep, (kptr, kpte) = _healthy(trained, [ptr, pte], res, log_fn, "ensemble")
        results = _svgp_metrics(_avg_noise_model(keep), mix_gaussian_preds(kptr), mix_gaussian_preds(kpte), split,
                                log_fn)
    elif kind == "classifier":
        ptr = _stacked_predict(stack, _clf_predict, [split.Xtrain] * size)
        pte = _stacked_predict(stack, _clf_predict, [split.Xtest] * size)
        member_metrics = [_classifier_metrics(ptr[e], pte[e], split, quiet) for e in range(size)]
        _, (kptr, kpte) = _healthy(trained, [ptr, pte], res, log_fn, "ensemble")
        results = _classifier_metrics(mix_classifier_preds(kptr), mix_classifier_preds(kpte), split, log_fn)
    else:  # onoff
        pte = _stacked_predict(stack, _onoff_predict, [split.Xtest] * size)
        member_metrics = [_onoff_metrics(trained[e], pte[e], split, quiet) for e in range(size)]
        keep, (kpte,) = _healthy(trained, [pte], res, log_fn, "ensemble")
        results = _onoff_metrics(_avg_noise_model(keep), mix_onoff_preds(kpte), split, log_fn)

    results["ensemble_size"] = size
    results["train_time_sec"] = train_time
    results["steps_per_sec"] = res[0].steps_per_sec
    for key in ("test_rmse", "test_mae", "test_auc", "test_accuracy", "test_hurdle_comb_rmse", "test_hurdle_nlpd",
                "test_gate_auc"):
        vals = [m[key] for m in member_metrics if key in m]
        if vals:
            results[f"member_{key}"] = vals
            log_fn(f"members {key}: " + " ".join(f"{v:.4f}" for v in vals) + f"  (ensemble {results[key]:.4f})")
    _maybe_pickle({k: v for k, v in results.items() if k != "models"}, workdir, f"results_ensemble_{kind}.pickle")
    results["models"] = trained
    return results
