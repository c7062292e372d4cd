"""The port's seed ensembles (``experiments.ensemble``) against the JAX
package's, on the CPU in float64: the numpy combining rules
(``mixture_moments``, ``healthy_member_mask``, the four mixers) equal to
JAX's; ``run_ensemble`` of every kind on JAX's own rows at rtol 1e-6 (the
results, the member metrics and the pickle); a one-member ensemble equal to
the port's own runner on the device sampler; the natural-gradient refusal;
and the on/off metric block scoring a mixture through its members' gated
predictives, as JAX's does."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zigp_tpu.experiments import configs as jconfigs
from zigp_tpu.experiments import ensemble as jens
from zigp_tpu.experiments import runners as jrunners
from zigp_tpu.io.datasets import Split as JSplit
from zigp_tpu_torch.experiments import configs as tconfigs
from zigp_tpu_torch.experiments import ensemble as tens
from zigp_tpu_torch.experiments import runners as trunners
from zigp_tpu_torch.io.datasets import Split

from .test_torch_cv_batched import _cfgs
from .test_torch_runners import _same
from .torch_helpers import jax_rows_as_port, one_torch_thread_per_module  # noqa: F401 (fixtures)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

CPU64 = dict(device="cpu", dtype=torch.float64)
quiet = lambda s: None  # noqa: E731


def _split(cls, seed=1, N=48, Nt=20):
    r = np.random.RandomState(seed)
    return cls(r.rand(N, 3), np.maximum(r.randn(N, 1) + 0.7, 0.0), r.rand(Nt, 3),
               np.maximum(r.randn(Nt, 1) + 0.7, 0.0))


@pytest.mark.parametrize("E", [1, 3])
def test_mixture_moments_match_jax(E):
    r = np.random.RandomState(E)
    means, varis = r.randn(E, 7, 1), r.rand(E, 7, 1) + 0.1
    for a, b in zip(tens.mixture_moments(means, varis), jens.mixture_moments(means, varis)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("losses", [
    [2.1e5, 1.9e5, 2.3e5, 2.0e5],
    [2.1e5, 1.9e5, 4.1e8, 2.0e5],
    [float("nan")] * 3,
    [1e9, 5e8, 7e9],
    [-5000.0, -5010.0, -4990.0, 40000.0],
    [0.5, -0.3, 0.1, 2e4],
    [1e6, 1e6 + 27.0, 1e6 + 3.0, 1e6 + 11.0],
    [3.0, float("nan"), 3.1],
])
def test_healthy_member_mask_matches_jax(losses):
    np.testing.assert_array_equal(tens.healthy_member_mask(losses), jens.healthy_member_mask(losses))


def _member_preds(E, n=9, seed=0):
    r = np.random.RandomState(seed)
    keys = ("gfmean", "gfvar", "gfmeanu", "fmean", "fvar", "gmean", "gvar", "pgmean", "pgvar", "pfmean", "pfvar",
            "p_on")
    return [{k: (r.rand(n, 1) if "var" in k or k.startswith("p") else r.randn(n, 1)) for k in keys}
            for _ in range(E)]


@pytest.mark.parametrize("mix", ["mix_gaussian_preds", "mix_classifier_preds", "mix_hurdlej_preds",
                                 "mix_onoff_preds"])
def test_mixers_match_jax(mix):
    preds = _member_preds(3)
    _same(getattr(tens, mix)(preds), getattr(jens, mix)(preds), mix, rtol=0)


def test_onoff_metrics_score_a_mixture_as_jax():
    """The mixture's CRPS, its cross-check and the exceedance scores come
    from its members' gated predictives (``member_preds``); scoring the
    moment-matched fields alone, as before this slice, gave other values."""
    split = _split(Split, N=9, Nt=9)
    preds = _member_preds(3)
    for p in preds:
        p["gfvar"], p["gfmeanu"], p["pgmean"] = p["gfvar"] + 0.1, p["gfmeanu"] * 0.1, np.clip(p["pgmean"], 0.05, 0.95)
    mix = tens.mix_onoff_preds(preds)
    model = SimpleNamespace(likelihood=SimpleNamespace(variance=SimpleNamespace(value=0.05)))  # the noise read
    got = trunners._onoff_metrics(model, mix, split, quiet)
    want = jrunners._onoff_metrics(model, jens.mix_onoff_preds(preds), JSplit(*vars(split).values()), quiet)
    _same({k: v for k, v in got.items() if k != "pred_test"}, {k: v for k, v in want.items() if k != "pred_test"},
          "onoff mixture", rtol=1e-12)
    single = trunners._onoff_metrics(model, {k: v for k, v in mix.items() if k != "member_preds"}, split, quiet)
    assert single["test_crps"] != got["test_crps"]


KINDS = {"svgp": "svgp_cfg", "classifier": "clf_cfg", "onoff": "onoff_cfg", "hurdlej": "hurdlej_cfg"}


@pytest.mark.parametrize("kind", list(KINDS))
def test_run_ensemble_matches_jax(kind, tmp_path, jax_rows_as_port):
    """Three seeds of ``kind`` as one stack (the classifier at 40 steps):
    the mixture's results, every member's metrics, the ensemble size and
    the pickle, at rtol 1e-6."""
    tweak = dict(num_iter=40) if kind == "classifier" else {}
    tcfg = dataclasses.replace(_cfgs(tconfigs)[KINDS[kind]], **tweak)
    jcfg = dataclasses.replace(_cfgs(jconfigs)[KINDS[kind]], **tweak)
    got = tens.run_ensemble(_split(Split), kind, tcfg, size=3, workdir=str(tmp_path), log_fn=quiet, **CPU64)
    want = jens.run_ensemble(_split(JSplit), kind, jcfg, size=3, log_fn=quiet)
    untimed = ("models", "train_time_sec", "steps_per_sec")
    _same({k: v for k, v in got.items() if k not in untimed}, {k: v for k, v in want.items() if k not in untimed},
          kind, rtol=1e-6)
    assert got["ensemble_size"] == 3 and len(got["models"]) == 3
    assert (tmp_path / f"results_ensemble_{kind}.pickle").exists()


def test_one_member_ensemble_equals_the_runner():
    """A one-member ensemble trains the runner's model on the runner's
    device-sampled rows: the same metrics."""
    cfg = _cfgs(tconfigs)["svgp_cfg"]
    single = trunners.run_svgp(_split(Split), cfg, log_fn=quiet, **CPU64)
    ens = tens.run_ensemble(_split(Split), "svgp", cfg, size=1, log_fn=quiet, **CPU64)
    for key in ("test_rmse", "test_nlpd", "test_crps"):
        np.testing.assert_allclose(ens[key], single[key], rtol=1e-10)


def test_refusals():
    cfg = dataclasses.replace(_cfgs(tconfigs)["svgp_cfg"], optimizer="natgrad")
    with pytest.raises(ValueError, match="adam"):
        tens.run_ensemble(_split(Split), "svgp", cfg, size=2, log_fn=quiet, **CPU64)
    with pytest.raises(ValueError, match="unknown ensemble kind"):
        tens.run_ensemble(_split(Split), "zi", None, size=2, log_fn=quiet, **CPU64)
