"""The port's batched CV (``experiments.cv_batched.run_cv_batched``)
against the JAX package's, on the CPU in float64, on JAX's own rows
(``torch_helpers.jax_rows_as_port``): the summary of all six variants,
with one member per fold and with ``ensemble=2``, and the natural-gradient
route, at rtol 1e-6 (the JAX tests' tolerance between the batched and the
sequential runs); the stack's checkpoints and a resumed run; the
refusals (the member-axis mesh, a ragged natural-gradient stack)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from zigp_tpu.experiments import configs as jconfigs
from zigp_tpu.experiments.cv_batched import run_cv_batched as jrun_cv_batched
from zigp_tpu.io.datasets import Split as JSplit
from zigp_tpu_torch.experiments import configs as tconfigs
from zigp_tpu_torch.experiments.cv_batched import run_cv_batched
from zigp_tpu_torch.io.datasets import Split

from .torch_helpers import draw_jax_rows, jax_scan_unroll, one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _lean_run():
    """One torch thread, and the JAX anchors' scans compiled at unroll 1
    (``torch_helpers.one_torch_thread``, ``jax_scan_unroll``)."""
    with one_torch_thread(), jax_scan_unroll(1):
        yield


CPU64 = dict(device="cpu", dtype=torch.float64)
MODELS = ["onoff", "svgp", "classifier", "hurdle", "hurdlej", "zi"]
quiet = lambda s: None  # noqa: E731


def _splits(cls, F=2, N=48, Nt=20, seed=3):
    """The JAX tests' tiny folds: X (n, 3) on the unit cube, zero-inflated
    positive targets, equal train and test sizes across folds."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(F):
        Xtr, Xte = r.rand(N, 3), r.rand(Nt, 3)
        out.append(cls(Xtr, np.maximum(r.randn(N, 1) + 0.7, 0.0), Xte, np.maximum(r.randn(Nt, 1) + 0.7, 0.0)))
    return out


def _cfgs(pkg, **svgp):
    """The JAX tests' configs: kernel inits sized for the unit cube, 8 steps
    in blocks of 4 on the device sampler, the classifier at 200 steps."""
    sp, tm = pkg.KernelInit((0.5, 0.5), 1.0), pkg.KernelInit((0.5,), 1.0)
    tiny = dict(num_iter=8, batch_size=8, scan_inner=4, log_every=0, ckpt_every=0,
                grid=pkg.KronGridConfig(num_spatial=4, num_temporal=3), sampler="device")
    return dict(
        onoff_cfg=pkg.OnOffPptrConfig(**tiny, monitor_every=0, fk_spatial=sp, fk_temporal=tm, gk_spatial=sp,
                                      gk_temporal=tm),
        svgp_cfg=dataclasses.replace(pkg.SvgpPptrConfig(**tiny, k_spatial=sp, k_temporal=tm), **svgp),
        clf_cfg=dataclasses.replace(pkg.ClassifierPptrConfig(**tiny, k_spatial=sp, k_temporal=tm), num_iter=200,
                                    batch_size=24, lr=5e-2),
        hurdlej_cfg=pkg.HurdleJointConfig(**tiny, k_spatial=sp, k_temporal=tm, gk_spatial=sp, gk_temporal=tm),
    )


def _same_summary(got, want, rtol=1e-6):
    assert set(got) == set(want)
    for model in want:
        assert set(got[model]) == set(want[model]), model
        for metric, agg in want[model].items():
            if metric == "steps_per_sec":
                continue
            a = np.array([np.nan if v is None else v for v in got[model][metric]["folds"]], dtype=np.float64)
            b = np.array([np.nan if v is None else v for v in agg["folds"]], dtype=np.float64)
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-12, err_msg=f"{model}.{metric}")


def _both(models, tmp_path, ensemble=1, **svgp):
    mp = pytest.MonkeyPatch()
    from zigp_tpu_torch.training import scan as tscan

    mp.setattr(tscan, "_draw", draw_jax_rows)
    try:
        want = jrun_cv_batched(models, splits=_splits(JSplit), log_fn=quiet, ensemble=ensemble,
                               **_cfgs(jconfigs, **svgp))
        logs = []
        got = run_cv_batched(models, splits=_splits(Split), log_fn=logs.append, ensemble=ensemble,
                             workdir=str(tmp_path), **_cfgs(tconfigs, **svgp), **CPU64)
    finally:
        mp.undo()
    return got, want, logs


@pytest.mark.parametrize("case", ["all six", "ensemble=2", "natgrad svgp"])
def test_run_cv_batched_matches_jax(case, tmp_path):
    """One stack per variant: the six variants with one member per fold
    (the two-stage hurdle's ragged stack with per-fold num_data), then
    ``ensemble=2`` of the six (F × E members, each fold's mixture scored;
    the on/off mixture through its members' gated predictives, the noise
    and amount heads averaged), then the natural-gradient SVGP stack."""
    if case == "all six":
        got, want, logs = _both(MODELS, tmp_path)
    elif case == "ensemble=2":
        got, want, logs = _both(MODELS, tmp_path, ensemble=2)
    else:
        got, want, logs = _both(["svgp"], tmp_path, optimizer="natgrad", num_iter=16, natgrad_warmup=8,
                                natgrad_adam_warmup=4, natgrad_gamma=0.05)
    _same_summary(got, want)
    with open(tmp_path / "cv_summary.json") as f:
        assert set(json.load(f)) == set(want)
    for kind in got:
        if kind != "zi":
            assert any(line.startswith(f"[{kind} x") and "trained in" in line for line in logs), kind
            assert any(line.startswith(f"[{kind} x") and "scored in" in line for line in logs), kind


def test_stack_checkpoints_and_resume(tmp_path):
    """With ``ckpt_every`` the stack's checkpoints sit in
    ``workdir/ckpt_svgp_stack`` (the JAX layout) beside its metrics; a
    resumed completed run trains nothing and gives the same summary."""
    cfgs = _cfgs(tconfigs, ckpt_every=4, log_every=4)
    kw = dict(splits=_splits(Split), svgp_cfg=cfgs["svgp_cfg"], workdir=str(tmp_path), **CPU64)
    first = run_cv_batched(["svgp"], log_fn=quiet, **kw)
    assert sorted(os.listdir(tmp_path / "ckpt_svgp_stack")) == [f"step_{s:010d}" for s in (0, 4, 8)]
    assert (tmp_path / "metrics_svgp_stack.jsonl").exists()
    logs = []
    again = run_cv_batched(["svgp"], log_fn=logs.append, resume=True, **kw)
    assert "[svgp x2] checkpoint is already at or past num_iter; nothing to train" in logs
    _same_summary(again, first, rtol=0)


def test_refusals():
    splits = _splits(Split)
    cfgs = _cfgs(tconfigs, optimizer="natgrad")
    with pytest.raises(ValueError, match="equal-shape"):
        run_cv_batched(["hurdle"], splits=splits, svgp_cfg=cfgs["svgp_cfg"], clf_cfg=cfgs["clf_cfg"], log_fn=quiet,
                       **CPU64)
