"""The port's experiment layer against the JAX package's, on the CPU.

- ``utils.metrics`` (the port's copy) equal to ``zigp_tpu.utils.metrics`` on
  seeded inputs, for every function the runners call; the composites the
  same;
- ``make_cv_splits`` (a numpy KFold) equal to scikit-learn's folds and to
  the JAX package's splits;
- the configs' fields and defaults, and each builder's initial raws, equal
  to the JAX package's;
- the fold protocol end to end in float64 on a tiny split: ``run_cv`` over
  one fold with every variant (``run_classifier``, ``run_svgp``,
  ``run_onoff`` with its noise recalibrated, ``run_hurdle``,
  ``run_hurdle_joint``, ``run_zero_inflated``), and ``run_hurdle`` with the
  LogNormal head, through both packages from the same inits on the same
  batches: the same metric keys, each value within rtol 1e-7 (the two
  trainings agree to about 1e-10 after 20 steps), index sets equal, the
  same CV aggregates;
- ``_fit_auto``'s checkpoints and metric logs named by the model's kind, so
  two kinds share a workdir and neither restores the other's checkpoint.
"""

import dataclasses
import functools
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.experiments import builders as jbuilders
from zigp_tpu.experiments import configs as jconfigs
from zigp_tpu.experiments import cv as jcv
from zigp_tpu.experiments import runners as jrunners
from zigp_tpu.io.datasets import Split as JSplit
from zigp_tpu.io.datasets import make_cv_splits as jmake_cv_splits
from zigp_tpu.models import composites as jcomposites
from zigp_tpu.training.data import DataSet as JDataSet
from zigp_tpu.utils import metrics as jmetrics
from zigp_tpu_torch.experiments import builders as tbuilders
from zigp_tpu_torch.experiments import configs as tconfigs
from zigp_tpu_torch.experiments import cv as tcv
from zigp_tpu_torch.experiments import runners as trunners
from zigp_tpu_torch.io.convert import dump_arrays
from zigp_tpu_torch.io.datasets import Split, kfold_indices, make_cv_splits
from zigp_tpu_torch.likelihoods import LogNormal
from zigp_tpu_torch.models import KronSVGP
from zigp_tpu_torch.models import composites as tcomposites
from zigp_tpu_torch.training import DataSet
from zigp_tpu_torch.utils import metrics as tmetrics

from .test_torch_train import _jraws
from .torch_helpers import jax_scan_unroll, one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _lean_run():
    """One torch thread, and the JAX anchors' scans compiled at unroll 1
    (``torch_helpers.one_torch_thread``, ``jax_scan_unroll``)."""
    with one_torch_thread(), jax_scan_unroll(1):
        yield


RTOL = 1e-7  # runner metrics, port against JAX, both trained in float64
CPU64 = dict(device="cpu", dtype=torch.float64)


def _same(got, want, path="", rtol=0.0):
    """Recursive equality of results: the same dict keys, arrays and numbers
    within ``rtol`` (0: equal)."""
    if isinstance(want, dict):
        assert set(got) == set(want), f"{path}: keys {sorted(set(got) ^ set(want))}"
        for k in want:
            _same(got[k], want[k], f"{path}.{k}", rtol)
    elif isinstance(want, (list, tuple)) and not np.isscalar(want):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}[{i}]", rtol)
    elif want is None or isinstance(want, (bool, str)):
        assert got == want, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, f"{path}: shape {g.shape} vs {w.shape}"
        if rtol == 0.0 or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * 1e-3 * max(np.nanmax(np.abs(w), initial=0), 1e-300),
                                       equal_nan=True, err_msg=path)


# ---------------------------------------------------------------------------
# metrics and composites
# ---------------------------------------------------------------------------


def _metric_inputs():
    rng = np.random.RandomState(0)
    n = 300
    y = np.where(rng.rand(n, 1) < 0.6, 0.0, rng.exponential(1.5, (n, 1)))
    fm, fv = 0.3 * rng.randn(n, 1), 0.05 + 0.3 * rng.rand(n, 1)
    p = rng.rand(n, 1)
    gm, gv = rng.randn(n, 1), 0.1 + rng.rand(n, 1)
    pred = {"fmean": fm, "fvar": fv, "gmean": gm, "gvar": gv, "pgmean": p}
    pos = y.reshape(-1) > 0
    return dict(y=y, yb=(y > 0).astype(np.float64), fm=fm, fv=fv, p=p, pred=pred, pos=pos,
                samples=rng.exponential(1.0, (64, n)) * (rng.rand(64, n) < 0.5))


HEAD_KW = {"gaussian": {"noise_var": 0.2}, "lognormal": {"noise_var": 0.4}, "gamma": {"shape": 1.3}}

METRIC_CASES = {
    "rmse": lambda m, d: m.rmse(d["fm"], d["y"]),
    "rmse unclipped": lambda m, d: m.rmse(d["fm"], d["y"], clip_at_zero=False),
    "mae": lambda m, d: m.mae(d["fm"], d["y"]),
    "mae unclipped": lambda m, d: m.mae(d["fm"], d["y"], clip_at_zero=False),
    "accuracy": lambda m, d: m.accuracy(d["p"], d["yb"]),
    "precision": lambda m, d: m.precision(d["p"], d["yb"]),
    "recall": lambda m, d: m.recall(d["p"], d["yb"]),
    "roc_auc": lambda m, d: m.roc_auc(d["p"], d["yb"]),
    "gaussian_nlpd": lambda m, d: m.gaussian_nlpd(d["fm"], d["fv"], d["y"], noise_var=0.1),
    "gaussian_nlpd_pointwise": lambda m, d: m.gaussian_nlpd_pointwise(d["fm"], d["fv"], d["y"], noise_var=0.1),
    "lognormal_mean_var": lambda m, d: m.lognormal_mean_var(d["fm"], d["fv"], noise_var=0.4),
    "gamma_mean_var": lambda m, d: m.gamma_mean_var(d["fm"], d["fv"], shape=1.3),
    "lognormal_nlpd": lambda m, d: m.lognormal_nlpd(d["fm"][d["pos"]], d["fv"][d["pos"]], d["y"][d["pos"]],
                                                    noise_var=0.4),
    "lognormal_nlpd_pointwise": lambda m, d: m.lognormal_nlpd_pointwise(d["fm"][d["pos"]], d["fv"][d["pos"]],
                                                                        d["y"][d["pos"]], noise_var=0.4),
    "gamma_nlpd": lambda m, d: m.gamma_nlpd(d["fm"][d["pos"]], d["fv"][d["pos"]], d["y"][d["pos"]], shape=1.3),
    "gamma_nlpd_pointwise": lambda m, d: m.gamma_nlpd_pointwise(d["fm"][d["pos"]], d["fv"][d["pos"]],
                                                                d["y"][d["pos"]], shape=1.3),
    "crps_gaussian": lambda m, d: m.crps_gaussian(d["fm"], d["fv"], d["y"], noise_var=0.1),
    "crps_gated": lambda m, d: m.crps_gated(d["pred"], d["y"], noise_var=0.1),
    "crps_from_samples": lambda m, d: m.crps_from_samples(d["samples"], d["y"]),
    "sample_gated_predictive": lambda m, d: m.sample_gated_predictive(d["pred"], noise_var=0.1, num_samples=32),
    "exceedance_summary_gaussian": lambda m, d: m.exceedance_summary_gaussian(d["fm"], d["fv"], d["y"],
                                                                              noise_var=0.1),
    "exceedance_summary_gated": lambda m, d: m.exceedance_summary_gated(d["pred"], d["y"], noise_var=0.1),
    "hurdle_nlpd": lambda m, d: m.hurdle_nlpd(d["p"], m.lognormal_nlpd_pointwise(
        d["fm"][d["pos"]], d["fv"][d["pos"]], d["y"][d["pos"]], noise_var=0.4), d["y"]),
}
for _head, _kw in HEAD_KW.items():
    METRIC_CASES[f"crps_hurdle {_head}"] = functools.partial(
        lambda m, d, h, kw: m.crps_hurdle(d["p"], d["fm"], d["fv"], d["y"], head=h, **kw), h=_head, kw=_kw)
    METRIC_CASES[f"sample_hurdle_predictive {_head}"] = functools.partial(
        lambda m, d, h, kw: m.sample_hurdle_predictive(d["p"], d["fm"], d["fv"], head=h, num_samples=32, **kw),
        h=_head, kw=_kw)
    METRIC_CASES[f"exceedance_summary_hurdle {_head}"] = functools.partial(
        lambda m, d, h, kw: m.exceedance_summary_hurdle(d["p"], d["fm"], d["fv"], d["y"], head=h, **kw),
        h=_head, kw=_kw)


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metrics_copy_equals_jax(case):
    d = _metric_inputs()
    _same(METRIC_CASES[case](tmetrics, d), METRIC_CASES[case](jmetrics, d), case)


def test_composites_equal_jax():
    d = _metric_inputs()
    reg = d["fm"] + 1.0
    _same(tuple(tcomposites.zero_inflated_combine(d["p"], reg)), tuple(jcomposites.zero_inflated_combine(d["p"], reg)))
    on = tcomposites.hurdle_on_indices(d["p"])
    np.testing.assert_array_equal(on, jcomposites.hurdle_on_indices(d["p"]))
    _same(tcomposites.hurdle_combine(d["p"], reg[on], on), jcomposites.hurdle_combine(d["p"], reg[on], on))


# ---------------------------------------------------------------------------
# CV splits and configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,seed", [(23, 5, 1234), (100, 5, 0), (7, 3, 5), (131_600, 5, 1234)])
def test_kfold_equals_sklearn(n, k, seed):
    from sklearn.model_selection import KFold

    want = list(KFold(n_splits=k, shuffle=True, random_state=seed).split(np.zeros((n, 1))))
    got = kfold_indices(n, k, seed)
    assert len(got) == k
    for (tr, te), (wtr, wte) in zip(got, want):
        np.testing.assert_array_equal(tr, wtr)
        np.testing.assert_array_equal(te, wte)


def test_make_cv_splits_equals_jax():
    rng = np.random.RandomState(4)
    data = Split(rng.rand(41, 3) * 1000, rng.rand(41, 1), rng.rand(12, 3) * 1000, rng.rand(12, 1))
    got = make_cv_splits(data)
    want = jmake_cv_splits(JSplit(data.Xtrain, data.Ytrain, data.Xtest, data.Ytest))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        for f in ("Xtrain", "Ytrain", "Xtest", "Ytest"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _configs_match(got, want):
    """The port's config equal to the JAX one, field for field, but for the
    kernel-zoo fields (``KernelInit.period``, ``alpha``) the port lacks."""
    def drop(d):
        return {k: drop(v) for k, v in d.items() if k not in ("period", "alpha")} if isinstance(d, dict) else d

    assert drop(dataclasses.asdict(got)) == drop(dataclasses.asdict(want))


@pytest.mark.parametrize("name", ["OnOffPptrConfig", "SvgpPptrConfig", "ClassifierPptrConfig", "HurdleJointConfig",
                                  "best_onoff_config", "tuned_svgp_config", "tuned_classifier_config"])
def test_configs_equal_jax(name):
    _configs_match(getattr(tconfigs, name)(), getattr(jconfigs, name)())


@pytest.mark.parametrize("preset", ["best", "reference", "reference-stable"])
def test_preset_configs_equal_jax(preset):
    got, want = tconfigs.preset_configs(preset), jconfigs.preset_configs(preset)
    assert set(got) == set(want)
    for k in want:
        _configs_match(got[k], want[k])


# ---------------------------------------------------------------------------
# builders and the fold protocol, end to end
# ---------------------------------------------------------------------------


def _tiny_split(seed=0, ntrain=200, ntest=60):
    """A small zero-inflated split on the unit cube, about half the targets
    exact zeros (the JAX hurdle tests' generator)."""
    rng = np.random.RandomState(seed)

    def gen(n):
        X = rng.rand(n, 3)
        gate = (np.cos(5 * X[:, 2:3]) + 0.3 * rng.randn(n, 1)) > 0
        return X, np.maximum((1.0 + np.sin(3 * X[:, 2:3]) + X[:, 0:1]) * gate, 0.0)

    return Split(*gen(ntrain), *gen(ntest))


def _tiny(cfg_cls, pkg, **kw):
    grid = pkg.KronGridConfig(num_spatial=3, num_temporal=6)
    base = dict(grid=grid, num_iter=20, scan_inner=10, batch_size=32, log_every=10)
    if cfg_cls != "OnOffPptrConfig":
        base["lr"] = 1e-2
    return getattr(pkg, cfg_cls)(**{**base, **kw})


def _jsplit(s):
    return JSplit(s.Xtrain, s.Ytrain, s.Xtest, s.Ytest)


@pytest.mark.parametrize("family", ["svgp gaussian", "svgp lognormal subset", "svgp gamma", "classifier",
                                    "hurdlej lognormal", "hurdlej gamma", "hurdlej gaussian"])
def test_builders_start_from_the_jax_inits(family):
    split = _tiny_split()
    kind, head = family.split(" ")[0], family.split(" ")[1] if " " in family else None
    if kind == "svgp":
        pos = np.flatnonzero(split.Ytrain.reshape(-1) > 0)
        idx = pos[::2] if family.endswith("subset") else (pos if head != "gaussian" else None)
        jm = jbuilders.build_svgp_pptr(_tiny("SvgpPptrConfig", jconfigs, likelihood=head), _jsplit(split),
                                       subset_idx=idx)
        tm = tbuilders.build_svgp_pptr(_tiny("SvgpPptrConfig", tconfigs, likelihood=head), split, subset_idx=idx,
                                       **CPU64)
    elif kind == "classifier":
        jm = jbuilders.build_classifier_pptr(_tiny("ClassifierPptrConfig", jconfigs), _jsplit(split))
        tm = tbuilders.build_classifier_pptr(_tiny("ClassifierPptrConfig", tconfigs), split, **CPU64)
    else:
        jm = jbuilders.build_hurdle_joint_pptr(_tiny("HurdleJointConfig", jconfigs, likelihood=head), _jsplit(split))
        tm = tbuilders.build_hurdle_joint_pptr(_tiny("HurdleJointConfig", tconfigs, likelihood=head), split, **CPU64)
    _same(dump_arrays(tm), _jraws(jm), rtol=1e-14)  # the softplus inverse: numpy here, XLA there


def _cfgs(pkg):
    return {
        "clf_cfg": _tiny("ClassifierPptrConfig", pkg),
        "svgp_cfg": _tiny("SvgpPptrConfig", pkg),
        "hurdlej_cfg": _tiny("HurdleJointConfig", pkg),
        "onoff_cfg": _tiny("OnOffPptrConfig", pkg, recalibrate_noise=True, monitor_every=0),
    }


MODELS = ["onoff", "svgp", "classifier", "hurdle", "hurdlej", "zi"]
RUNNERS = {"classifier": "run_classifier", "svgp": "run_svgp", "onoff": "run_onoff", "hurdle": "run_hurdle",
           "hurdlej": "run_hurdle_joint", "zi": "run_zero_inflated"}


def _run_cv_recording(cv_module, runners_module, split, **kw):
    """``run_cv`` over one fold with every runner's results recorded:
    ({variant: results}, the CV aggregates)."""
    results = {}
    mp = pytest.MonkeyPatch()
    for variant, name in RUNNERS.items():
        def recorded(*a, _fn=getattr(runners_module, name), _v=variant, **k):
            results[_v] = _fn(*a, **k)
            return results[_v]

        # run_cv binds the runners at import, the JAX one run_hurdle_joint at call
        for module in (cv_module, runners_module):
            if hasattr(module, name):
                mp.setattr(module, name, recorded)
    try:
        aggregates = cv_module.run_cv(MODELS, splits=[split], log_fn=lambda s: None, **kw)
    finally:
        mp.undo()
    return results, aggregates


@pytest.fixture(scope="module")
def numpy_batches():
    """Both packages' runners draw their minibatches from the numpy DataSet
    (the port's copy of the JAX one), whichever data set ``make_dataset``
    would give: the same kind in both, whether or not a worker's native
    library loaded. ``tests/test_torch_native.py`` holds ``run_onoff`` on the
    native batches of both."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jrunners, "make_dataset", lambda x, y, seed=121, **kw: JDataSet(x, y, seed=seed))
    mp.setattr(trunners, "make_dataset", lambda x, y, seed=121, **kw: DataSet(x, y, seed=seed))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def protocols(numpy_batches, tmp_path_factory):
    """The fold protocol of every variant through ``run_cv`` on one fold, in
    both packages (the port's in a workdir)."""
    split = _tiny_split()
    wd = str(tmp_path_factory.mktemp("cv"))
    want = _run_cv_recording(jcv, jrunners, _jsplit(split), **_cfgs(jconfigs))
    got = _run_cv_recording(tcv, trunners, split, workdir=wd, **_cfgs(tconfigs), **CPU64)
    return split, got, want, wd


UNTIMED = ("model", "steps_per_sec", "train_time_sec")


def _results_match(got: dict, want: dict, variant: str):
    _same({k: v for k, v in got.items() if k not in UNTIMED}, {k: v for k, v in want.items() if k not in UNTIMED},
          variant, rtol=RTOL)


@pytest.mark.parametrize("variant", MODELS)
def test_runner_metrics_match_jax(protocols, variant):
    _, (got, _), (want, _), wd = protocols
    _results_match(got[variant], want[variant], variant)
    name = {"classifier": "scgp"}.get(variant, variant)
    with open(os.path.join(wd, "1", f"results_{name}.pickle"), "rb") as f:
        assert set(pickle.load(f)) == set(got[variant]) - {"model"}


def test_run_cv_matches_jax(protocols):
    _, (_, got), (_, want), wd = protocols
    untimed = lambda agg: {m: {k: v for k, v in per.items() if k != "steps_per_sec"} for m, per in agg.items()}
    assert all("steps_per_sec" in got[m] for m in ("onoff", "hurdlej"))
    _same(untimed(got), untimed(want), "cv", rtol=RTOL)
    assert set(got) == set(MODELS) and os.path.exists(os.path.join(wd, "cv_summary.json"))


def test_run_hurdle_lognormal_head_matches_jax(protocols):
    """The two-stage hurdle with a positive head: fit on the strictly
    positive "on" points, predict at all of them."""
    split, (got, _), (want, _), _ = protocols
    cfg = dict(likelihood="lognormal", batch_size=16)  # a small on-subset
    quiet = lambda s: None
    g = trunners.run_hurdle(split, got["classifier"], _tiny("SvgpPptrConfig", tconfigs, **cfg), log_fn=quiet,
                            **CPU64)
    w = jrunners.run_hurdle(_jsplit(split), want["classifier"], _tiny("SvgpPptrConfig", jconfigs, **cfg),
                            log_fn=quiet)
    _results_match(g, w, "hurdle lognormal")
    assert len(g["train_pred_on_idx"]) > 0 and isinstance(g["model"].likelihood, type(got["hurdlej"][
        "model"].amount_likelihood))


def test_onoff_noise_recalibrated_in_place(protocols):
    _, (got, _), (want, _), _ = protocols
    raw = got["onoff"]["model"].likelihood.variance.raw
    assert got["onoff"]["model"].likelihood.variance.value.item() == pytest.approx(
        float(want["onoff"]["model"].likelihood.variance.value), rel=RTOL)
    ptr = raw.data_ptr()
    trunners.recalibrate_noise(got["onoff"]["model"], protocols[0], "onoff", log_fn=lambda s: None)
    assert raw.data_ptr() == ptr  # the same storage: a captured graph stays valid
    lognormal = KronSVGP(got["svgp"]["model"].gp, LogNormal.create(0.5), None, 10)
    with pytest.raises(ValueError, match="Gaussian"):  # its noise is not on the y scale
        trunners.recalibrate_noise(lognormal, protocols[0], "svgp")


def test_aggregate_summary_equals_jax(tmp_path):
    """NaN folds left out of mean and std and kept as null, an all-NaN
    metric dropped, the JSON written."""
    summary = {"a": {"x": [1.0, 2.0, 4.0], "y": [np.nan, 3.0, 5.0], "z": [np.nan, np.nan, np.nan]},
               "b": {"x": [0.5, 0.25, 0.125]}}
    got = tcv.aggregate_summary(summary, str(tmp_path), lambda s: None)
    _same(got, jcv.aggregate_summary(summary, None, lambda s: None))
    assert "z" not in got["a"] and got["a"]["y"]["folds"][0] is None and got["a"]["y"]["n_finite"] == 2
    assert os.path.exists(tmp_path / "cv_summary.json")


# ---------------------------------------------------------------------------
# _fit_auto's artifacts, by kind
# ---------------------------------------------------------------------------


def test_two_kinds_share_a_workdir_without_restoring_each_other(tmp_path):
    """A classifier's checkpoints and metrics sit beside an SVGP's in one
    fold workdir; resuming each restores its own kind (a restore of the
    other's would fail on its names, or train from the wrong state)."""
    split = _tiny_split()
    wd = str(tmp_path)
    logs = {"svgp": [], "classifier": []}
    quiet = lambda s: None
    clf_cfg = _tiny("ClassifierPptrConfig", tconfigs, ckpt_every=10)
    svgp_cfg = _tiny("SvgpPptrConfig", tconfigs, ckpt_every=10)
    first = {"classifier": trunners.run_classifier(split, clf_cfg, workdir=wd, log_fn=quiet, **CPU64),
             "svgp": trunners.run_svgp(split, svgp_cfg, workdir=wd, log_fn=quiet, **CPU64)}
    assert {"ckpt_classifier", "ckpt_svgp", "metrics_classifier.jsonl", "metrics_svgp.jsonl"} <= set(os.listdir(wd))
    longer = dict(num_iter=30)
    again = {
        "svgp": trunners.run_svgp(split, dataclasses.replace(svgp_cfg, **longer), workdir=wd, resume=True,
                                  log_fn=logs["svgp"].append, **CPU64),
        "classifier": trunners.run_classifier(split, dataclasses.replace(clf_cfg, **longer), workdir=wd, resume=True,
                                              log_fn=logs["classifier"].append, **CPU64),
    }
    for kind in ("svgp", "classifier"):
        assert "resumed from checkpoint at step 20" in logs[kind], kind
        assert sorted(os.listdir(os.path.join(wd, f"ckpt_{kind}"))) == [
            "step_0000000000", "step_0000000010", "step_0000000020", "step_0000000030"]
        assert type(again[kind]["model"].likelihood) is type(first[kind]["model"].likelihood)
        assert len(again[kind]["losses"]) == 1  # the 10 steps past the checkpoint, one log point
