"""Batched 5-fold cross-validation: every fold of a variant trained as one
stack (``training.batched``), on the card one CUDA-graph replay per block
for all folds.

Counterpart of ``zigp_tpu/experiments/cv_batched.py``. Fold f's trajectory
is the sequential ``fit_scanned(sampler="device", sampler_seed=cfg.seed)``
run's: ``run_cv_batched`` always samples on the device, never the host's
epochs. The pptr protocol's five folds have equal train sizes, so their
models share every static field (``num_data`` included) and the data stack
unpadded. The one ragged variant, the two-stage hurdle's per-fold "on"
subsets, is padded to the longest fold (the padding never sampled) and
takes each fold's true ELBO scale as the loss's ``num_data``.

``optimizer="natgrad"`` routes to ``fit_natgrad_batched`` (equal shapes
only: the hurdle's inner regression stays on Adam); ``ensemble=E`` trains E
seeds per fold in the same stack (F × E members) and scores each fold's
uniform mixture (``experiments.ensemble``). Scoring runs on the host, as in
``run_cv``, and is timed apart from training in the logs.
``mesh_members=D`` shards the member axis over the D ranks of a ``torchrun``
launch (``training.batched``'s member-axis mesh: zero per-step collectives,
every rank gets every member back and scores them; rank 0 writes). Per-fold prediction pickles are not written (the
sequential ``run_cv`` writes them).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..io.datasets import Split, load_pptr, make_cv_splits
from ..models import hurdle_on_indices
from ..training.batched import fit_batched_scanned, predict_batched_stacked, stack_models
from .builders import binarize_targets, build_classifier_pptr, build_onoff_pptr, build_svgp_pptr
from .configs import ClassifierPptrConfig, OnOffPptrConfig, SvgpPptrConfig
from .cv import _record_scores, aggregate_summary
from .runners import (
    _classifier_metrics,
    _eval_hurdle,
    _hurdle_nlpd,
    _hurdle_probabilistic_scores,
    _log_hyperparams,
    _onoff_metrics,
    _svgp_metrics,
    run_zero_inflated,
)


# The stacked predict functions: module-level, so each stack captures its
# chunk graph once per function (``predict_batched_stacked``).
def _svgp_predict(m, X):
    return m.predict_latent(X)


def _clf_predict(m, X):
    return m.predict_class(X)


def _onoff_predict(m, X):
    return m.predict(X)


def _hurdlej_fields(m, X):
    p = m.predict(X)
    return {"p_on": p.p_on, "fmean": p.fmean, "fvar": p.fvar}


def _stacked_predict(stack, predict_fn, Xs_list: list) -> List[dict]:
    """One stacked prediction pass over the members of ``stack`` and their
    inputs; ragged inputs are padded to the longest (its last row repeated)
    and sliced back per member."""
    lens = [np.asarray(x).shape[0] for x in Xs_list]
    N = max(lens)

    def _pad(a):
        a = np.asarray(a)
        return a if a.shape[0] == N else np.concatenate([a, np.repeat(a[-1:], N - a.shape[0], axis=0)])

    preds = predict_batched_stacked(predict_fn, stack, np.stack([_pad(x) for x in Xs_list]))
    return [{k: v[: lens[f]] for k, v in p.items()} for f, p in enumerate(preds)]


def _train_stack(kind: str, models: list, datas: list, cfg, lr: float, *, workdir: Optional[str], log_fn,
                 loss_fn=None, aux=None, resume: bool = False, seeds: Optional[list] = None, mesh=None):
    """``fit_batched_scanned`` (or ``fit_natgrad_batched``) with the
    sequential runners' optimizer, cadence and checkpoint policy: the
    checkpoints of the whole stack in ``workdir/ckpt_{kind}_stack``, the
    metrics in ``workdir/metrics_{kind}_stack.jsonl``."""
    from ..io.checkpoint import CheckpointManager
    from ..training.optim import cosine_adam
    from ..utils.logging import MetricLogger

    num_inner = getattr(cfg, "scan_inner", 50) or 50
    log_blocks = max(1, cfg.log_every // num_inner) if getattr(cfg, "log_every", 0) else 0
    wrapped_log = lambda m: log_fn(f"[{kind} x{len(models)}] {m}")  # noqa: E731
    seeds = seeds or [getattr(cfg, "seed", 0)] * len(models)

    ckpt = metric = None
    if workdir:
        os.makedirs(workdir, exist_ok=True)
        if getattr(cfg, "ckpt_every", 0):
            ckpt = CheckpointManager(os.path.join(workdir, f"ckpt_{kind}_stack"), every=cfg.ckpt_every)
        metric = MetricLogger(os.path.join(workdir, f"metrics_{kind}_stack.jsonl"))
    try:
        if getattr(cfg, "optimizer", "adam") == "natgrad":
            from ..training.batched import fit_natgrad_batched

            if getattr(cfg, "hyper_every", 0):
                log_fn("warning: --hyper-every is an Adam-path schedule; the natgrad stack already alternates — "
                       "ignoring the flag")
            if loss_fn is not None or aux is not None:
                raise ValueError("batched natgrad supports equal-shape stacks only (no ragged/aux path) — train the "
                                 "hurdle inner regression with optimizer='adam' or the sequential run_cv")
            if getattr(cfg, "natgrad_kron_joint", False) and getattr(cfg, "q_cov", "diag") != "kron":
                log_fn("warning: --natgrad-joint requires q_cov='kron'; taking the diagonal-family natural step "
                       "instead")
            return fit_natgrad_batched(
                models, datas, num_iter=cfg.num_iter, batch_size=cfg.batch_size, num_inner=num_inner,
                gamma=cfg.natgrad_gamma, gamma_warmup=cfg.natgrad_warmup, adam_warmup=cfg.natgrad_adam_warmup,
                kron_joint=getattr(cfg, "natgrad_kron_joint", False), kl_cap=getattr(cfg, "natgrad_kl_cap", 10.0),
                adam_lr=lr, seeds=seeds, log_every_blocks=log_blocks, log_fn=wrapped_log, ckpt_manager=ckpt,
                metric_logger=metric, resume=resume, mesh=mesh)

        hyper_every = getattr(cfg, "hyper_every", 0) or 0
        alt_facs = None
        if hyper_every and (loss_fn is not None or aux is not None):
            # the hurdle's ragged/aux stacks keep the joint schedule
            log_fn(f"[{kind}] hyper_every is unsupported on the ragged/aux stack — training jointly")
            hyper_every = 0
        schedule = None
        if getattr(cfg, "lr_schedule", "") == "cosine":
            schedule = cosine_adam(cfg.num_iter)
            if hyper_every:
                alt_facs = (cosine_adam(cfg.num_iter * (hyper_every - 1) // hyper_every),
                            cosine_adam(max(1, cfg.num_iter // hyper_every)))
        return fit_batched_scanned(
            models, datas, num_iter=cfg.num_iter, batch_size=cfg.batch_size, num_inner=num_inner, schedule=schedule,
            loss_fn=loss_fn, aux=aux, hyper_every=hyper_every, alt_opt_factories=alt_facs, learning_rate=lr,
            seeds=seeds, log_every_blocks=log_blocks, log_fn=wrapped_log, ckpt_manager=ckpt, metric_logger=metric,
            resume=resume, mesh=mesh)
    finally:
        if metric is not None:
            metric.close()


def run_cv_batched(
    models: List[str],
    *,
    splits: Optional[List[Split]] = None,
    onoff_cfg: Optional[OnOffPptrConfig] = None,
    svgp_cfg: Optional[SvgpPptrConfig] = None,
    clf_cfg: Optional[ClassifierPptrConfig] = None,
    hurdlej_cfg=None,
    workdir: Optional[str] = None,
    log_fn: Callable[[str], None] = print,
    resume: bool = False,
    ensemble: int = 1,
    mesh_members: int = 0,
    device=None,
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
) -> dict:
    """``run_cv`` with all folds of each variant trained as one stack.

    models ⊆ {"onoff", "svgp", "classifier", "hurdle", "hurdlej", "zi"};
    "hurdle" and "zi" pull in the classifier (and "zi" the SVGP) as the
    sequential ``run_cv`` does. Returns the aggregates of ``run_cv`` and writes
    the same ``cv_summary.json``. ``ensemble`` > 1 trains that many seeds
    per fold in the same stack (F × E members, member f·E + e) and scores
    each fold's uniform mixture. ``device=None`` is the CUDA card."""
    from .ensemble import (
        _avg_amount_model,
        _avg_noise_model,
        _healthy,
        mix_classifier_preds,
        mix_gaussian_preds,
        mix_hurdlej_preds,
        mix_onoff_preds,
    )

    mesh = None
    if mesh_members:
        from ..parallel import make_mesh

        mesh = make_mesh(n_data=mesh_members, n_model=1)
    if any(getattr(c, "recalibrate_noise", False) for c in (onoff_cfg, svgp_cfg, clf_cfg) if c is not None):
        log_fn("warning: --recalibrate-noise is not implemented for run_cv_batched (its eval reuses stacked "
               "test predictions and computes no train predictions) — ignoring; use the sequential run_cv")
    splits = splits or make_cv_splits(load_pptr())
    F = len(splits)
    E = max(1, int(ensemble))
    if mesh is not None:
        log_fn(f"member-axis sharding: {F * E} members over {mesh.shape['data']} devices (zero per-step collectives)")
    need_clf = bool({"classifier", "hurdle", "zi"} & set(models))
    need_svgp = bool({"svgp", "zi"} & set(models))
    placed = dict(device=device, dtype=dtype, use_kernel=use_kernel)

    summary: Dict[str, Dict[str, List[float]]] = {}

    def record(model: str, metric: str, value: float):
        summary.setdefault(model, {}).setdefault(metric, []).append(float(value))

    def members_of(build, cfg, **kw):
        """F×E member models and their sampler seeds (member f·E + e)."""
        base = getattr(cfg, "seed", 0)
        ms, seeds = [], []
        for f in range(F):
            for e in range(E):
                c = dataclasses.replace(cfg, seed=base + e) if E > 1 else cfg
                ms.append(build(c, splits[f], **{k: v[f] for k, v in kw.items()}, **placed))
                seeds.append(base + e)
        return ms, seeds

    def per_fold(items):
        return [items[f * E : (f + 1) * E] for f in range(F)]

    def fold_inputs(xs_per_fold):
        return [xs_per_fold[m // E] for m in range(F * E)]

    def train(kind, members, seeds, datas, cfg, lr, **kw):
        t0 = time.time()
        res = _train_stack(kind, members, datas, cfg, lr, workdir=workdir, log_fn=log_fn, resume=resume, mesh=mesh,
                           seeds=seeds, **kw)
        log_fn(f"[{kind} x{len(members)}] trained in {time.time() - t0:.1f} s")
        trained = [r.model for r in res]
        return res, trained, stack_models(trained)

    def scored(kind, t0):
        log_fn(f"[{kind} x{F * E}] predicted and scored in {time.time() - t0:.1f} s")

    clf_res: List[Optional[dict]] = [None] * F
    svgp_res: List[Optional[dict]] = [None] * F

    if need_clf:
        cfg = clf_cfg or ClassifierPptrConfig()
        members, seeds = members_of(build_classifier_pptr, cfg)
        res, trained, stack = train("classifier", members, seeds,
                                    fold_inputs([(s.Xtrain, binarize_targets(s.Ytrain)) for s in splits]), cfg, cfg.lr)
        t0 = time.time()
        ptr = _stacked_predict(stack, _clf_predict, fold_inputs([s.Xtrain for s in splits]))
        pte = _stacked_predict(stack, _clf_predict, fold_inputs([s.Xtest for s in splits]))
        for f, split in enumerate(splits):
            log_fn(f"--- classifier fold {f + 1}/{F} ---")
            _log_hyperparams(per_fold(trained)[f][0], log_fn)
            if E > 1:
                _, (ktr, kte) = _healthy(per_fold(trained)[f], [per_fold(ptr)[f], per_fold(pte)[f]],
                                         per_fold(res)[f], log_fn, f"classifier fold {f + 1}")
                tr, te = mix_classifier_preds(ktr), mix_classifier_preds(kte)
            else:
                tr, te = per_fold(ptr)[f][0], per_fold(pte)[f][0]
            clf_res[f] = _classifier_metrics(tr, te, split, log_fn)
            for m in ("accuracy", "precision", "recall", "auc"):
                record("classifier", f"test_{m}", clf_res[f][f"test_{m}"])
        scored("classifier", t0)

    if need_svgp:
        cfg = svgp_cfg or SvgpPptrConfig()
        members, seeds = members_of(build_svgp_pptr, cfg)
        res, trained, stack = train("svgp", members, seeds, fold_inputs([(s.Xtrain, s.Ytrain) for s in splits]),
                                    cfg, cfg.lr)
        t0 = time.time()
        ptr = _stacked_predict(stack, _svgp_predict, fold_inputs([s.Xtrain for s in splits]))
        pte = _stacked_predict(stack, _svgp_predict, fold_inputs([s.Xtest for s in splits]))
        for f, split in enumerate(splits):
            log_fn(f"--- svgp fold {f + 1}/{F} ---")
            fold_models = per_fold(trained)[f]
            _log_hyperparams(fold_models[0], log_fn)
            if E > 1:
                keep, (ktr, kte) = _healthy(fold_models, [per_fold(ptr)[f], per_fold(pte)[f]], per_fold(res)[f],
                                            log_fn, f"svgp fold {f + 1}")
                model, tr, te = _avg_noise_model(keep), mix_gaussian_preds(ktr), mix_gaussian_preds(kte)
            else:
                model, tr, te = fold_models[0], per_fold(ptr)[f][0], per_fold(pte)[f][0]
            svgp_res[f] = _svgp_metrics(model, tr, te, split, log_fn)
            record("svgp", "test_rmse", svgp_res[f]["test_rmse"])
            record("svgp", "test_mae", svgp_res[f]["test_mae"])
            _record_scores(record, "svgp", svgp_res[f])
        scored("svgp", t0)

    if "onoff" in models:
        cfg = onoff_cfg or OnOffPptrConfig()
        members, seeds = members_of(build_onoff_pptr, cfg)
        res, trained, stack = train("onoff", members, seeds, fold_inputs([(s.Xtrain, s.Ytrain) for s in splits]),
                                    cfg, cfg.indp_lr)
        t0 = time.time()
        pte = _stacked_predict(stack, _onoff_predict, fold_inputs([s.Xtest for s in splits]))
        for f, split in enumerate(splits):
            log_fn(f"--- onoff fold {f + 1}/{F} ---")
            fold_models = per_fold(trained)[f]
            _log_hyperparams(fold_models[0], log_fn)
            if E > 1:
                keep, (kte,) = _healthy(fold_models, [per_fold(pte)[f]], per_fold(res)[f], log_fn,
                                        f"onoff fold {f + 1}")
                model, te = _avg_noise_model(keep), mix_onoff_preds(kte)
            else:
                model, te = fold_models[0], per_fold(pte)[f][0]
            out = _onoff_metrics(model, te, split, log_fn)
            record("onoff", "test_rmse", out["test_rmse"])
            record("onoff", "test_mae", out["test_mae"])
            _record_scores(record, "onoff", out)
            record("onoff", "steps_per_sec", res[f * E].steps_per_sec)
        scored("onoff", t0)

    if "hurdle" in models:
        cfg = svgp_cfg or SvgpPptrConfig()
        # per-fold classifier-"on" subsets: ragged, the padded path. A
        # positive head (lognormal, gamma) fits on the strictly positive
        # "on" points and predicts over the whole "on" subset.
        head = (getattr(cfg, "likelihood", "gaussian") or "gaussian").lower()
        subs, on_idx, fit_idx = [], [], []
        for f, split in enumerate(splits):
            tr = hurdle_on_indices(clf_res[f]["pred_train"]["pfmean"])
            te = hurdle_on_indices(clf_res[f]["pred_test"]["pfmean"])
            on_idx.append((tr, te))
            sub = Split(split.Xtrain[tr], split.Ytrain[tr], split.Xtest[te], split.Ytest[te])
            subs.append(sub)
            if head != "gaussian":
                pos = np.flatnonzero(np.asarray(sub.Ytrain, dtype=np.float64).reshape(-1) > 0)
                fit_idx.append(np.asarray(tr)[pos])
            else:
                fit_idx.append(np.asarray(tr))
        fit_data = [(splits[f].Xtrain[fit_idx[f]], splits[f].Ytrain[fit_idx[f]]) for f in range(F)]
        sizes = [x.shape[0] for x, _ in fit_data]
        hmodels, hseeds = members_of(build_svgp_pptr, cfg, subset_idx=fit_idx)
        for m in hmodels:
            # a shared static num_data, so the members stack; the true
            # per-fold ELBO scale is the loss's num_data
            m.num_data = 1
        res, trained, stack = train("hurdle", hmodels, hseeds, fold_inputs(fit_data), cfg, cfg.lr,
                                    loss_fn=lambda m, X, Y, n: m.loss(X, Y, num_data=n), aux=fold_inputs(sizes))
        t0 = time.time()
        ptr = _stacked_predict(stack, _svgp_predict, fold_inputs([s.Xtrain for s in subs]))
        pte = _stacked_predict(stack, _svgp_predict, fold_inputs([s.Xtest for s in subs]))
        for f, split in enumerate(splits):
            log_fn(f"--- hurdle fold {f + 1}/{F} ---")
            sub, (tr, te) = subs[f], on_idx[f]
            fold_models = per_fold(trained)[f]
            if E > 1:
                keep, (kptr, kpte) = _healthy(fold_models, [per_fold(ptr)[f], per_fold(pte)[f]], per_fold(res)[f],
                                              log_fn, f"hurdle fold {f + 1}")
                model, rtr, rte = _avg_noise_model(keep), mix_gaussian_preds(kptr), mix_gaussian_preds(kpte)
            else:
                model, rtr, rte = fold_models[0], per_fold(ptr)[f][0], per_fold(pte)[f][0]
            reg = _svgp_metrics(model, rtr, rte, sub, lambda m: log_fn(f"[hurdle on-subset] {m}"))
            out = _eval_hurdle(split, clf_res[f], reg, sub, tr, te, log_fn)
            record("hurdle", "test_rmse", out["test_hurdle_comb_rmse"])
            record("hurdle", "test_mae", out["test_hurdle_comb_mae"])
            nlpd = _hurdle_nlpd(model, clf_res[f]["pred_test"]["pfmean"], split)
            log_fn(f"hurdle test nlpd: {nlpd}")
            record("hurdle", "test_nlpd", nlpd)
            scores = _hurdle_probabilistic_scores(model, clf_res[f]["pred_test"]["pfmean"], split)
            log_fn(f"hurdle test crps: {scores['test_crps']}")
            _record_scores(record, "hurdle", scores)
        scored("hurdle", t0)

    if "hurdlej" in models:
        from .builders import build_hurdle_joint_pptr
        from .configs import HurdleJointConfig
        from .runners import _hurdlej_metrics

        cfg = hurdlej_cfg or HurdleJointConfig()
        members, seeds = members_of(build_hurdle_joint_pptr, cfg)
        res, trained, stack = train("hurdlej", members, seeds, fold_inputs([(s.Xtrain, s.Ytrain) for s in splits]),
                                    cfg, cfg.lr)
        t0 = time.time()
        ptr = _stacked_predict(stack, _hurdlej_fields, fold_inputs([s.Xtrain for s in splits]))
        pte = _stacked_predict(stack, _hurdlej_fields, fold_inputs([s.Xtest for s in splits]))
        for f, split in enumerate(splits):
            log_fn(f"--- hurdlej fold {f + 1}/{F} ---")
            fold_models = per_fold(trained)[f]
            _log_hyperparams(fold_models[0], log_fn)
            if E > 1:
                keep, (ktr, kte) = _healthy(fold_models, [per_fold(ptr)[f], per_fold(pte)[f]], per_fold(res)[f],
                                            log_fn, f"hurdlej fold {f + 1}")
                model, tr, te = _avg_amount_model(keep), mix_hurdlej_preds(ktr), mix_hurdlej_preds(kte)
            else:
                model, tr, te = fold_models[0], per_fold(ptr)[f][0], per_fold(pte)[f][0]
            out = _hurdlej_metrics(model, tr, te, split, log_fn)
            record("hurdlej", "test_rmse", out["test_hurdle_comb_rmse"])
            record("hurdlej", "test_mae", out["test_hurdle_comb_mae"])
            record("hurdlej", "test_nlpd", out["test_hurdle_nlpd"])
            _record_scores(record, "hurdlej", out)
            record("hurdlej", "test_gate_auc", out["test_gate_auc"])
        scored("hurdlej", t0)

    if "zi" in models:
        for f, split in enumerate(splits):
            log_fn(f"--- zi fold {f + 1}/{F} ---")
            out = run_zero_inflated(split, clf_res[f], svgp_res[f], log_fn=log_fn)
            record("zi", "test_rmse_prob", out["test_zi_prob_reg_rmse"])
            record("zi", "test_mae_prob", out["test_zi_prob_reg_mae"])
            record("zi", "test_rmse_indc", out["test_zi_indc_reg_rmse"])
            record("zi", "test_mae_indc", out["test_zi_indc_reg_mae"])
            _record_scores(record, "zi", out)

    return aggregate_summary(summary, workdir, log_fn)
