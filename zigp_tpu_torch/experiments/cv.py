"""5-fold cross-validation: the reference's pptr protocol (five
model variants over the KFold splits) as one call, with aggregate metrics.

Counterpart of ``zigp_tpu/experiments/cv.py:19-180``: ``run_cv`` drives the
port's runners fold by fold in one workdir per fold, and
``aggregate_summary`` writes ``cv_summary.json``.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..io.datasets import Split, load_pptr, make_cv_splits
from .configs import ClassifierPptrConfig, HurdleJointConfig, OnOffPptrConfig, SvgpPptrConfig
from .runners import run_classifier, run_hurdle, run_hurdle_joint, run_onoff, run_svgp, run_zero_inflated


def _agg(values: List[float]) -> Dict[str, float]:
    """NaN-aware fold aggregate: a NaN fold (an exceedance AUC where a
    threshold sees one class) is left out of mean and std but kept in
    ``folds``, as null (bare NaN is not JSON)."""
    a = np.asarray(values, dtype=np.float64)
    finite = a[np.isfinite(a)]
    out = {
        "mean": float(finite.mean()) if finite.size else float("nan"),
        "std": float(finite.std()) if finite.size else float("nan"),
        "folds": [float(v) if np.isfinite(v) else None for v in a],
    }
    if finite.size != a.size:
        out["n_finite"] = int(finite.size)
    return out


def aggregate_summary(
    summary: Dict[str, Dict[str, List[float]]],
    workdir: Optional[str],
    log_fn: Callable[[str], None],
) -> dict:
    """Fold lists → {mean, std, folds}, written to ``cv_summary.json`` and
    logged. A metric that is NaN on every fold is dropped. Rank 0 alone
    writes on a mesh."""
    from ..parallel.mesh import is_main_process

    aggregates = {
        model: {metric: _agg(vals) for metric, vals in per_model.items() if np.isfinite(vals).any()}
        for model, per_model in summary.items()
    }
    if workdir and is_main_process():
        os.makedirs(workdir, exist_ok=True)
        with open(os.path.join(workdir, "cv_summary.json"), "w") as f:
            json.dump(aggregates, f, indent=2)
    for model, per_model in aggregates.items():
        for metric, agg in per_model.items():
            log_fn(f"{model}.{metric}: {agg['mean']:.4f} ± {agg['std']:.4f}")
    return aggregates


def _record_scores(record, model: str, res: dict) -> None:
    """CRPS (with its cross-check) and the per-threshold exceedance scores
    (test_brier_τ, test_excauc_τ), where the runner reports them."""
    if "test_crps" not in res:
        return
    record(model, "test_crps", res["test_crps"])
    if "test_crps_mc" in res:
        record(model, "test_crps_mc", res["test_crps_mc"])
    for tau, s in res.get("test_exceedance", {}).items():
        record(model, f"test_brier_{tau}", s["brier"])
        record(model, f"test_excauc_{tau}", s["auc"])


def run_cv(
    models: List[str],
    *,
    splits: Optional[List[Split]] = None,
    onoff_cfg: Optional[OnOffPptrConfig] = None,
    svgp_cfg: Optional[SvgpPptrConfig] = None,
    clf_cfg: Optional[ClassifierPptrConfig] = None,
    hurdlej_cfg: Optional[HurdleJointConfig] = None,
    workdir: Optional[str] = None,
    log_fn: Callable[[str], None] = print,
    device=None,
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
) -> dict:
    """Run the variants ``models`` ⊆ {"onoff", "svgp", "classifier",
    "hurdle", "hurdlej", "zi"} over every fold (``splits``, by default the
    5 folds of ``load_pptr()``), in ``workdir/<fold>``. "hurdle" and "zi"
    pull in the classifier, "zi" the SVGP too; "hurdlej" needs neither. A
    run interrupted by Ctrl-C stops the sweep."""
    splits = splits or make_cv_splits(load_pptr())
    need_clf = bool({"classifier", "hurdle", "zi"} & set(models))
    need_svgp = bool({"svgp", "zi"} & set(models))
    kw = dict(log_fn=log_fn, device=device, dtype=dtype, use_kernel=use_kernel)
    summary: Dict[str, Dict[str, List[float]]] = {}

    def record(model: str, metric: str, value: float):
        summary.setdefault(model, {}).setdefault(metric, []).append(float(value))

    def check(res: dict, what: str, fold: int):
        # a partial fold recorded as trained would corrupt the summary
        if res.get("interrupted"):
            log_fn(f"fold {fold} {what} was interrupted — aborting the CV sweep")
            raise KeyboardInterrupt

    for k, split in enumerate(splits, start=1):
        fold_dir = os.path.join(workdir, str(k)) if workdir else None
        log_fn(f"===== fold {k}/{len(splits)} =====")
        clf = reg = None
        if need_clf:
            clf = run_classifier(split, clf_cfg, workdir=fold_dir, **kw)
            check(clf, "classifier", k)
            for m in ("accuracy", "precision", "recall", "auc"):
                record("classifier", f"test_{m}", clf[f"test_{m}"])
        if need_svgp:
            reg = run_svgp(split, svgp_cfg, workdir=fold_dir, **kw)
            check(reg, "svgp", k)
            record("svgp", "test_rmse", reg["test_rmse"])
            record("svgp", "test_mae", reg["test_mae"])
            _record_scores(record, "svgp", reg)
        if "onoff" in models:
            res = run_onoff(split, onoff_cfg, workdir=fold_dir, **kw)
            check(res, "onoff", k)
            record("onoff", "test_rmse", res["test_rmse"])
            record("onoff", "test_mae", res["test_mae"])
            _record_scores(record, "onoff", res)
            record("onoff", "steps_per_sec", res["steps_per_sec"])
        if "hurdle" in models:
            res = run_hurdle(split, clf, svgp_cfg, workdir=fold_dir, **kw)
            check(res, "hurdle", k)
            record("hurdle", "test_rmse", res["test_hurdle_comb_rmse"])
            record("hurdle", "test_mae", res["test_hurdle_comb_mae"])
            record("hurdle", "test_nlpd", res["test_hurdle_nlpd"])
            _record_scores(record, "hurdle", res)
        if "hurdlej" in models:
            res = run_hurdle_joint(split, hurdlej_cfg, workdir=fold_dir, **kw)
            check(res, "hurdlej", k)
            record("hurdlej", "test_rmse", res["test_hurdle_comb_rmse"])
            record("hurdlej", "test_mae", res["test_hurdle_comb_mae"])
            record("hurdlej", "test_nlpd", res["test_hurdle_nlpd"])
            _record_scores(record, "hurdlej", res)
            record("hurdlej", "test_gate_auc", res["test_gate_auc"])
            record("hurdlej", "steps_per_sec", res["steps_per_sec"])
        if "zi" in models:
            res = run_zero_inflated(split, clf, reg, workdir=fold_dir, log_fn=log_fn)
            record("zi", "test_rmse_prob", res["test_zi_prob_reg_rmse"])
            record("zi", "test_mae_prob", res["test_zi_prob_reg_mae"])
            record("zi", "test_rmse_indc", res["test_zi_indc_reg_rmse"])
            record("zi", "test_mae_indc", res["test_zi_indc_reg_mae"])
            _record_scores(record, "zi", res)
    return aggregate_summary(summary, workdir, log_fn)
