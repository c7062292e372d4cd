"""The port's measurement scaffold (``experiments/measure.py``) and the
harnesses on it (``sampler_ab``, ``alternating_ab``, ``precision_ab``,
``profile_step``, ``scale_utilization``, ``serve_bench``,
``time_to_target``), on the CPU at tiny sizes.

- ``analytic_matmul_flops`` equals the JAX package's; ``run_round_robin``
  interleaves as the JAX one does (``tests/test_measure.py``'s fake runs)
  and gives the same summary; the named configurations are the JAX
  package's;
- ``prepare_step``'s blocks equal ``fit_scanned``'s device-sampler blocks on
  the same seed, bit for bit; ``measure_rate`` times the blocks after the
  warm-up;
- ``sampler_ab``: ``fused`` gives ``staged``'s losses bit for bit;
  ``perstep``'s draws are a function of the block key; ``alternating_ab``'s
  ``alt<K>`` equals ``fit_scanned(alternating=K)`` bit for bit;
- ``precision_ab``, ``profile_step`` and ``scale_utilization`` run under
  ``high`` / ``mixed`` in float32, through the 3-pass product, record the
  policy and put "highest" back;
- ``profile_step``'s summary: categories summing to the total, per-step
  numbers; ``scale_utilization``'s counted FLOPs and null shares off the
  card; ``serve_bench``'s artifact within 1e-5 of ``predict_batched``;
- ``time_to_target`` against the JAX package's on JAX's own rows
  (``tests/torch_helpers.jax_rows_as_port``), float64: the curve's steps
  equal and its test RMSEs within rtol 1e-8, the targets reached at the same
  steps.
"""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from zigp_tpu.experiments import configs as jconfigs
from zigp_tpu.experiments import measure as jmeasure
from zigp_tpu.experiments import time_to_target as jttt
from zigp_tpu_torch.experiments import (
    alternating_ab,
    measure,
    precision_ab,
    profile_step,
    sampler_ab,
    scale_utilization,
    serve_bench,
    time_to_target,
)
from zigp_tpu_torch.experiments import configs as tconfigs
from zigp_tpu_torch.experiments.builders import build_onoff_pptr
from zigp_tpu_torch.training import DataSet, fit_scanned, make_optimizer

from .test_torch_runners import _jsplit, _tiny_split
from .torch_helpers import jax_rows_as_port, one_torch_thread_per_module  # noqa: F401 (fixtures)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

CPU64 = dict(device="cpu", dtype=torch.float64)


def _tiny_cfg(pkg=tconfigs, **kw):
    base = dict(grid=pkg.KronGridConfig(num_spatial=3, num_temporal=5), batch_size=16)
    return pkg.OnOffPptrConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def built():
    """(model, arrays, batch, cfg) of a tiny on/off model, float64 on the CPU."""
    split = _tiny_split()
    cfg = _tiny_cfg()
    return build_onoff_pptr(cfg, split, **CPU64), (split.Xtrain, split.Ytrain), 16, cfg


@pytest.fixture
def tiny_configs(monkeypatch):
    """Every named configuration at the tiny grid and batch, on a tiny split."""
    config_of = measure.config_of
    monkeypatch.setattr(measure, "config_of", lambda name: (
        dataclasses.replace(config_of(name)[0], grid=tconfigs.KronGridConfig(num_spatial=3, num_temporal=5),
                            batch_size=16), 16))
    return dict(split=_tiny_split(), **CPU64)


@pytest.mark.parametrize("args", [(1000, 10, 100), (4000, 32, 200), (8192, 105, 250)])
def test_analytic_flops_are_jax(args):
    assert measure.analytic_matmul_flops(*args) == jmeasure.analytic_matmul_flops(*args)


def test_block_key_is_the_block_index():
    assert measure.block_key(7) == 7 and isinstance(measure.block_key(np.int64(3)), int)


@pytest.mark.parametrize("name, want", [("flagship", lambda c: c.OnOffPptrConfig()),
                                        ("champion", lambda c: c.best_onoff_config()),
                                        ("scale", lambda c: c.OnOffPptrConfig(grid=c.KronGridConfig(105, 250)))])
def test_named_configs_are_jax(name, want):
    cfg, batch = measure.config_of(name)
    jcfg = want(jconfigs)
    assert dataclasses.asdict(cfg) == {k: v for k, v in dataclasses.asdict(jcfg).items()
                                       if k in dataclasses.asdict(cfg)}
    assert batch == jcfg.batch_size


def test_run_round_robin_interleaves_and_summarizes_as_jax(monkeypatch, tmp_path):
    def fake(order):
        def measure_one(built, variant, *, num_inner, num_blocks):
            order.append(variant)
            return {"a": 100.0, "b": 200.0}[variant] + len(order), 1.5
        return measure_one

    summaries = []
    for module in (measure, jmeasure):
        builds, order = [], []
        monkeypatch.setattr(module, "build_config", lambda c, _b=builds: _b.append(c) or ("m", c))
        summaries.append(module.run_round_robin("fake ab", ("cfg1",), ("a", "b"), fake(order), num_inner=5,
                                                num_blocks=2, repeats=3, out=str(tmp_path / "ab.json"),
                                                log_fn=lambda *_: None))
        assert builds == ["cfg1"] and order == ["a", "b"] * 3
        assert json.loads((tmp_path / "ab.json").read_text())["task"] == "fake ab"
    assert summaries[0] == summaries[1]


def test_prepare_step_blocks_equal_fit_scanned_on_the_same_seed(built):
    model, arrays, batch, cfg = built
    step, m, opt = measure.prepare_step(model, arrays, batch, cfg, num_inner=2)
    got = measure.losses_of(step, range(3))
    ref = copy.deepcopy(model)
    res = fit_scanned(ref, DataSet(*arrays), num_iter=6, batch_size=batch, num_inner=2,
                      optimizer=make_optimizer(ref, default_lr=cfg.indp_lr), sampler="device", sampler_seed=0,
                      log_every_blocks=0, log_fn=lambda s: None)
    np.testing.assert_array_equal(got, res.step_losses.numpy())
    for (n, a), b in zip(m.named_parameters(), ref.parameters()):
        assert torch.equal(a, b), n
    assert m is not model and step.ready
    rate, last = measure.measure_rate(step, m, opt, num_inner=2, num_blocks=1)
    assert rate > 0 and np.isfinite(last)
    with pytest.raises(ValueError, match="blocks of 2"):
        measure.measure_rate(step, m, opt, num_inner=5, num_blocks=1)


def test_sampler_variants(built):
    def losses(variant, keys=range(3)):
        step, _, _ = measure.prepare_step(*built, step_factory=sampler_ab._FACTORIES[variant], num_inner=4)
        return measure.losses_of(step, keys)

    staged = losses("staged")
    np.testing.assert_array_equal(losses("fused"), staged)
    per = losses("perstep", [5, 5])
    assert np.isfinite(per).all() and not np.array_equal(per[:4], per[4:])  # the state moved between
    step, _, _ = measure.prepare_step(*built, step_factory=sampler_ab._FACTORIES["perstep"], num_inner=4)
    np.testing.assert_array_equal(measure.losses_of(step, [5]), per[:4])


def test_alternating_variant_equals_fit_scanned_alternating(built):
    model, arrays, batch, cfg = built
    step, _, _ = alternating_ab._prepare(built, "alt2", 4)
    got = measure.losses_of(step, range(2))
    ref = copy.deepcopy(model)
    res = fit_scanned(ref, DataSet(*arrays), num_iter=8, batch_size=batch, num_inner=4, learning_rate=cfg.indp_lr,
                      sampler="device", sampler_seed=0, alternating=2, log_every_blocks=0, log_fn=lambda s: None)
    np.testing.assert_array_equal(got, res.step_losses.numpy())


def test_harness_runs_in_round_robin(tiny_configs):
    out = sampler_ab.run_sampler_ab(configs=("flagship",), variants=("staged", "fused", "perstep"), num_inner=4,
                                    num_blocks=1, repeats=1, log_fn=lambda s: None, build_kw=tiny_configs)
    losses = out["final_block_loss"]["flagship"]
    assert losses["staged"] == losses["fused"] and out["device"] == "cpu" and out["data"]
    out = alternating_ab.run_alternating_ab(configs=("scale",), variants=("joint", "alt2"), num_inner=4,
                                            num_blocks=1, repeats=1, log_fn=lambda s: None, build_kw=tiny_configs)
    assert set(out["steps_per_sec_median"]["scale"]) == {"joint", "alt2"}
    out = precision_ab.run_precision_ab(configs=("champion",), num_inner=4, num_blocks=1, repeats=1,
                                        log_fn=lambda s: None, build_kw=tiny_configs)
    assert list(out["steps_per_sec_median"]["champion"]) == ["highest", "mixed"]  # the JAX harness's default


PRECISION_RUNS = {
    "precision_ab mixed": "mixed",
    "profile_step high": "high",
    "scale_utilization mixed": "mixed",
}


@pytest.mark.parametrize("run", list(PRECISION_RUNS))
def test_reduced_precision_runs_and_records_its_policy(run, tiny_configs, tmp_path):
    """float32 at the tiny grid: the 3-pass products run under the policy
    (their plain version on the CPU), the summary names it, and "highest"
    is back when the harness returns."""
    from zigp_tpu_torch.ops import linalg
    from zigp_tpu_torch.ops.cuda import bf16x3

    policy = PRECISION_RUNS[run]
    kw = {**tiny_configs, "dtype": torch.float32}
    calls = []
    product = bf16x3.bf16x3_mm_cuda
    quiet = dict(num_inner=4, num_blocks=1, log_fn=lambda s: None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bf16x3, "bf16x3_mm_cuda", lambda a, b: calls.append(linalg.solve_precision()) or product(a, b))
        if run.startswith("precision_ab"):
            out = precision_ab.run_precision_ab(configs=("champion",), policies=("highest", policy), repeats=1,
                                                build_kw=kw, **quiet)
            assert list(out["steps_per_sec_median"]["champion"]) == ["highest", policy]
        elif run.startswith("profile_step"):
            s = profile_step.profile_step("flagship", solve_precision=policy, build_kw=kw, **quiet)
            assert s["solve_precision"] == policy and s["steps"] == 4
        else:
            kw.pop("split")
            rows = scale_utilization.probe(batches=(16,), solve_precision=policy, build_kw=kw, split=_tiny_split(),
                                           grid=(3, 5), repeats=1, **quiet)
            assert rows[0]["solve_precision"] == policy
    assert calls and set(calls) == {policy}
    assert linalg.solve_precision() == "highest"


def test_profile_step_summary(tiny_configs, tmp_path):
    s = profile_step.profile_step("flagship", num_inner=4, num_blocks=2, build_kw=tiny_configs, log_fn=lambda x: None,
                                  keep_trace=str(tmp_path / "trace"), out=str(tmp_path / "s.json"))
    assert s["steps"] == 8 and s["batch"] == 16 and s["solve_precision"] == "highest"
    assert s["device_plane"] == "cpu operators (self time)"
    assert sum(s["by_category"].values()) == pytest.approx(s["total_us"], rel=1e-12)
    assert s["per_step_us"] == pytest.approx(s["total_us"] / 8) and s["steps_per_sec"] > 0
    assert json.loads((tmp_path / "s.json").read_text())["final_block_loss"] == s["final_block_loss"]


def test_scale_utilization_counts_flops():
    rows = scale_utilization.probe(batches=(16, 32), num_inner=4, num_blocks=1, log_fn=lambda s: None,
                                   build_kw=CPU64, split=_tiny_split(), grid=(3, 5), repeats=1)
    assert [r["batch"] for r in rows] == [16, 32]
    for r in rows:
        assert r["flops_per_step_counted"] > 0 and r["mfu_f32_counted"] is None and r["peak_f32_flops"] is None
        assert r["flops_per_step_analytic"] == measure.analytic_matmul_flops(r["batch"], 3, 5)
    assert rows[1]["flops_per_step_counted"] > rows[0]["flops_per_step_counted"]
    assert scale_utilization.PEAK_F32["NVIDIA H100 80GB HBM3"] == 67e12


def test_serve_bench_artifact_matches_predict_batched(built):
    model, (X, _), _, _ = built
    res = serve_bench.run(batch=64, rows=150, model=model, X=X, repeats=1, log_fn=lambda s: None)
    assert res["rows"] == 150 and res["max_rel_diff"] <= serve_bench.GATE and res["artifact_mb"] > 0
    assert res["device"] == "cpu" and res["export_pts_per_sec"] > 0


def test_time_to_target_matches_jax(jax_rows_as_port):  # noqa: F811
    import jax

    split = _tiny_split()
    kw = dict(num_iter=8, batch_size=32, scan_inner=2, whiten=True, sampler="device")  # JAX's compile is the cost
    want = jttt.run_time_to_target(eval_every=4, cfg=_tiny_cfg(jconfigs, **kw), split=_jsplit(split))
    got = time_to_target.run_time_to_target(eval_every=4, cfg=_tiny_cfg(tconfigs, **kw), split=split,
                                            log_fn=lambda s: None, **CPU64)
    assert jax.config.jax_enable_x64
    assert [c["step"] for c in got["curve"]] == [c["step"] for c in want["curve"]] == [6, 8]
    np.testing.assert_allclose([c["test_rmse"] for c in got["curve"]], [c["test_rmse"] for c in want["curve"]],
                               rtol=1e-8)
    assert {k: v and v["step"] for k, v in got["targets"].items()} == {k: v and v["step"]
                                                                       for k, v in want["targets"].items()}
    assert got["eval_every_steps"] == want["eval_every_steps"] and got["data"] == "the given split"
