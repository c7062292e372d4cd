"""The port's production training loop against the JAX package's, on the CPU.

The scenarios of ``tests/test_recovery.py`` and
``tests/test_scan_production.py``, run through both packages in float64 on
the golden Kron on/off fixture with the same raws (``io.convert``) and the
same batches:

- ``fit_scanned`` with a checkpoint manager, a metric logger with
  histograms and a callback: the same checkpoint steps, log lines, metric
  records and callback steps, the losses at rtol 1e-8;
- a NaN in block 3 restored from the same step, then the same losses at
  rtol 1e-8; a NaN in the last block restored and not re-stamped;
- a resumed run equal to the uninterrupted one bit for bit on the port, and
  to the JAX package's at rtol 1e-8, with the host and the device samplers
  (the JAX device sampler fed the port's indices: the two generators
  differ);
- Ctrl-C between blocks → checkpoint → ``interrupted``, and inside a block →
  re-raised; the silent-NaN ``FloatingPointError``;
- the per-step ``fit`` against JAX ``fit``, with its own NaN restore;
- the on-device cosine lr at every step against ``cosine_scale`` and optax;
- ``train_onoff_pptr`` with a workdir: checkpoints, metrics, resume, and the
  per-step fit when ``scan_inner`` is 0 or longer than the run.

On the CPU every block is the eager one; the CUDA graph that replays it on
the card is held against it by ``tests/test_torch_cuda.py``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zigp_tpu.io.checkpoint import CheckpointManager as JCheckpointManager
from zigp_tpu.training import fit as jfit
from zigp_tpu.training import fit_scanned as jfit_scanned
from zigp_tpu.training.data import DataSet as JDataSet
from zigp_tpu.training.optim import make_optimizer as jmake_optimizer
from zigp_tpu.utils.logging import MetricLogger as JMetricLogger
from zigp_tpu_torch.core import parameters as tparams
from zigp_tpu_torch.experiments.runners import train_onoff_pptr
from zigp_tpu_torch.io.checkpoint import CheckpointManager
from zigp_tpu_torch.io.convert import dump_arrays
from zigp_tpu_torch.io.datasets import synthetic_pptr
from zigp_tpu_torch.training import DataSet, cosine_adam, fit, fit_scanned, make_optimizer
from zigp_tpu_torch.training.optim import cosine_scale
from zigp_tpu_torch.training.scan import block_seed
from zigp_tpu_torch.utils.logging import MetricLogger

from .test_golden import _kron_fixture
from .test_torch_train import _jraws, _pair_models, _small_cfg
from .torch_helpers import one_torch_thread_per_module  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

LR = 1e-2
B, K = 8, 2  # K = 2 keeps the JAX package's scan compile short


def _data():
    Zs, X, Y, _, _ = _kron_fixture()
    return X, Y


def _poisoned(base, at):
    """A DataSet (of ``base``'s package) whose ``at``-th batch has a NaN target."""
    X, Y = _data()

    class Poisoned(base):
        def __init__(self):
            super().__init__(X, Y, seed=0)
            self.calls = 0

        def next_batch(self, b, shuffle=True):
            self.calls += 1
            bx, by = super().next_batch(b, shuffle)
            if self.calls == at:
                by = by.copy()
                by[0, 0] = np.nan
            return bx, by

    return Poisoned()


def _pair(seed=7):
    """Both packages' model, optimizer and DataSet on the same raws and rows."""
    jm, tm = _pair_models()
    X, Y = _data()
    return (jm, jmake_optimizer(jm, default_lr=LR), JDataSet(X, Y, seed=seed),
            tm, make_optimizer(tm, default_lr=LR), DataSet(X, Y, seed=seed))


def _close_to_jax(tres, jres, rtol=1e-8):
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=rtol)
    want = _jraws(jres.model)
    for key, got in dump_arrays(tres.model).items():
        np.testing.assert_allclose(got, want[key], rtol=rtol, atol=rtol * 1e-3 * np.abs(want[key]).max(), err_msg=key)


def _checkpointed_run(directory, fn, model, opt, ds, Mgr, Logger):
    """12 steps in blocks of K with checkpoints every 4, a metric logger with
    histograms every 4 and a callback every 4: (result, log lines, callback
    steps, checkpoint names, metric records)."""
    logs, calls = [], []
    mgr, logger = Mgr(os.path.join(directory, "ck"), every=4), Logger(os.path.join(directory, "m.jsonl"))
    res = fn(model, ds, num_iter=12, batch_size=B, num_inner=K, optimizer=opt, log_fn=logs.append,
             ckpt_manager=mgr, metric_logger=logger, hist_every=4,
             callback=lambda step, m: calls.append(step), callback_every=4)
    logger.close()
    records = [json.loads(line) for line in open(os.path.join(directory, "m.jsonl"))]
    return res, logs, calls, sorted(os.listdir(mgr.directory)), records


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's checkpointed 12-step run (host sampler), once for
    the module: checkpoints, logs and histograms leave its trajectory the
    uninterrupted one, so the resume test holds the port against it too."""
    jm, jopt, jds, *_ = _pair()
    return _checkpointed_run(str(tmp_path_factory.mktemp("jax")), jfit_scanned, jm, jopt, jds, JCheckpointManager,
                             JMetricLogger)


def test_fit_scanned_checkpoints_logs_metrics_and_callbacks_match_jax(tmp_path, jax_run):
    *_, tm, topt, tds = _pair()
    (jres, *jrest) = jax_run
    (tres, *trest) = _checkpointed_run(str(tmp_path), fit_scanned, tm, topt, tds, CheckpointManager, MetricLogger)
    assert trest[:3] == jrest[:3]  # log lines, callback steps, checkpoint steps
    assert trest[2] == ["step_0000000000", "step_0000000004", "step_0000000008", "step_0000000012"]
    assert tres.interrupted is False and np.isfinite(tres.final_loss)
    _close_to_jax(tres, jres)
    assert len(trest[3]) == len(jrest[3]) == 12  # 6 scalar records, 2 × 3 histogram records
    for t, j in zip(trest[3], jrest[3]):
        assert set(t) == set(j) and t["step"] == j["step"]
        for k, v in j.items():
            if k.startswith("hist/"):
                for stat, x in v.items():
                    np.testing.assert_allclose(t[k][stat], x, rtol=1e-7, atol=1e-9, err_msg=f"{k} {stat}")
            elif k != "wall":
                np.testing.assert_allclose(t[k], v, rtol=1e-8, err_msg=k)


@pytest.mark.parametrize("poison_at, num_iter", [(6, 12), (6, 6)], ids=["block 3 of 6", "the last block"])
def test_nan_restore_matches_jax(tmp_path, poison_at, num_iter):
    """A NaN target in block 3's last batch (the value the check reads; an
    earlier one is absorbed by zero_nans) restores from the same step in
    both packages. In the last block the restored state is not re-stamped at
    the end and the final loss reads NaN."""
    out = {}
    for name, fn, base, Mgr, model in (("jax", jfit_scanned, JDataSet, JCheckpointManager, _pair_models()[0]),
                                       ("port", fit_scanned, DataSet, CheckpointManager, _pair_models()[1])):
        logs = []
        mgr = Mgr(str(tmp_path / name), every=4)
        res = fn(model, _poisoned(base, poison_at), num_iter=num_iter, batch_size=B, num_inner=K, learning_rate=LR,
                 log_fn=logs.append, ckpt_manager=mgr)
        out[name] = res, logs, mgr.latest_step()
    (jres, jlogs, jlatest), (tres, tlogs, tlatest) = out["jax"], out["port"]
    assert tlogs == jlogs and tlatest == jlatest
    assert "step        6  NON-FINITE loss" in tlogs and "restored from checkpoint at step 4" in tlogs
    _close_to_jax(tres, jres)
    if num_iter == 6:
        assert tlatest == 4 and np.isnan(tres.final_loss) and np.isnan(jres.final_loss)
        assert any("final checkpoint stays" in line for line in tlogs)
    assert all(torch.isfinite(p).all() for p in tres.model.parameters())


def _device_indices(seed, blocks, N):
    """The port's device-sampler indices of ``blocks`` blocks, (blocks, K·B)."""
    g = torch.Generator()
    return np.stack([torch.randint(0, N, (K * B,), generator=g.manual_seed(block_seed(seed, b))).numpy()
                     for b in range(blocks)])


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_resume_equals_the_uninterrupted_run_and_jax(tmp_path, sampler, monkeypatch, jax_run):
    """12 steps straight, and 6 with checkpoints then 6 more from the
    checkpoint (a fresh model, optimizer and stream; the host stream skipped
    past 6 batches): the same bits on the port, and the JAX package's
    uninterrupted run at rtol 1e-8."""
    kw = dict(batch_size=B, num_inner=K, log_fn=lambda s: None, sampler=sampler, sampler_seed=5)
    _, _, _, tm, topt, tds = _pair()
    full = fit_scanned(tm, tds, num_iter=12, optimizer=topt, **kw)

    _, _, _, tm, topt, tds = _pair()
    mgr = CheckpointManager(str(tmp_path / "ck"), every=6)
    fit_scanned(tm, tds, num_iter=6, optimizer=topt, ckpt_manager=mgr, **kw)
    assert mgr.latest_step() == 6
    _, _, _, tm2, topt2, tds2 = _pair()
    _, _, start = mgr.restore_latest(tm2, topt2)
    if sampler == "host":
        tds2.skip(B, start)
    resumed = fit_scanned(tm2, tds2, num_iter=6, optimizer=topt2, start_step=start, **kw)
    assert torch.equal(resumed.step_losses, full.step_losses[6:])
    for (n, a), b in zip(full.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), n

    if sampler == "host":
        _close_to_jax(full, jax_run[0])
        return
    # the JAX sampler draws the port's rows
    table = jnp.asarray(_device_indices(5, 6, _data()[0].shape[0]))
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: table[key[1]])
    jm, jopt, jds, *_ = _pair()
    _close_to_jax(full, jfit_scanned(jm, jds, num_iter=12, optimizer=jopt, **kw))


def test_keyboard_interrupt_between_blocks_checkpoints_for_resume(tmp_path):
    """Ctrl-C at the 3rd log point (step 6) checkpoints there, as the JAX
    test pins; the resumed run then equals the uninterrupted one."""
    _, _, _, tm, topt, tds = _pair()
    full = fit_scanned(tm, tds, num_iter=12, batch_size=B, num_inner=K, optimizer=topt, log_fn=lambda s: None)

    calls = {"n": 0, "last": ""}

    def exploding_log(msg):
        if "loss" in msg:
            calls["n"] += 1
            if calls["n"] == 3:
                raise KeyboardInterrupt
        calls["last"] = msg

    _, _, _, tm, topt, tds = _pair()
    mgr = CheckpointManager(str(tmp_path / "ck"), every=1000)
    res = fit_scanned(tm, tds, num_iter=12, batch_size=B, num_inner=K, optimizer=topt, ckpt_manager=mgr,
                      log_fn=exploding_log)
    assert res.interrupted is True and mgr.latest_step() == 6 and "interrupted" in calls["last"]
    _, _, _, tm2, topt2, tds2 = _pair()
    mgr.restore_latest(tm2, topt2)
    tds2.skip(B, 6)
    resumed = fit_scanned(tm2, tds2, num_iter=6, batch_size=B, num_inner=K, optimizer=topt2, start_step=6,
                          log_fn=lambda s: None)
    assert torch.equal(resumed.step_losses, full.step_losses[6:])


def test_keyboard_interrupt_inside_a_block_reraises(tmp_path):
    """Mid-block there is no state between steps to save: re-raise, leaving
    the last periodic checkpoint as the resume point."""
    _, _, _, tm, topt, tds = _pair()
    n = {"calls": 0}

    def loss_fn(m, X, Y):
        n["calls"] += 1
        if n["calls"] == 5:  # the first step of block 3
            raise KeyboardInterrupt
        return m.loss(X, Y)

    mgr = CheckpointManager(str(tmp_path / "ck"), every=2)
    logs = []
    with pytest.raises(KeyboardInterrupt):
        fit_scanned(tm, tds, num_iter=12, batch_size=B, num_inner=K, optimizer=topt, ckpt_manager=mgr,
                    loss_fn=loss_fn, log_fn=logs.append)
    assert mgr.latest_step() == 4 and any("inside a step" in line for line in logs)


def test_completed_run_is_not_interrupted_and_silent_nan_raises():
    _, _, _, tm, topt, tds = _pair()
    res = fit_scanned(tm, tds, num_iter=4, batch_size=B, num_inner=K, optimizer=topt, log_every_blocks=0,
                      log_fn=lambda s: None)
    assert res.interrupted is False and np.isfinite(res.final_loss) and res.losses == []
    with pytest.raises(FloatingPointError, match="non-finite"):
        fit_scanned(tm, tds, num_iter=4, batch_size=B, num_inner=K, log_every_blocks=0, log_fn=lambda s: None,
                    loss_fn=lambda m, X, Y: m.loss(X, Y) * np.nan)


def test_per_step_fit_matches_jax(tmp_path):
    """fit with checkpoints every 4 steps and a NaN target at step 6: the
    same checks, restore, logs, checkpoints and losses."""
    out = {}
    for name, fn, base, Mgr, model in (("jax", jfit, JDataSet, JCheckpointManager, _pair_models()[0]),
                                       ("port", fit, DataSet, CheckpointManager, _pair_models()[1])):
        logs, calls = [], []
        mgr = Mgr(str(tmp_path / name), every=4)
        res = fn(model, _poisoned(base, 7), num_iter=10, batch_size=B, learning_rate=LR, log_every=3,
                 log_fn=logs.append, ckpt_manager=mgr, callback=lambda i, m, loss, calls=calls: calls.append(i))
        out[name] = res, logs, calls, sorted(os.listdir(mgr.directory))
    (jres, *jrest), (tres, *trest) = out["jax"], out["port"]
    assert trest == jrest
    assert "restored from checkpoint at step 4" in trest[0] and 6 not in trest[1]
    _close_to_jax(tres, jres)
    np.testing.assert_allclose(tres.final_loss, jres.final_loss, rtol=1e-8)


@pytest.mark.parametrize("warmup", [0, 5])
def test_cosine_lr_on_the_device_at_every_step(warmup):
    """The lr tensor each update reads (its storage fixed) is the base lr
    times ``cosine_scale`` at the number of updates taken, and optax's
    schedule at that count; the first update reads step 0's."""
    lr, total = 3e-3, 30
    if warmup:
        sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total, end_value=lr * 0.01)
    else:
        sched = optax.cosine_decay_schedule(lr, total, alpha=0.01)
    p = tparams.param(np.ones(2))
    opt = make_optimizer(p, default_lr=lr, schedule=cosine_adam(total, warmup=warmup))
    lr_t = opt.adam.param_groups[0]["lr"]
    ptr = lr_t.data_ptr()
    for step in range(total + 5):
        assert float(opt.step_count) == step
        got = float(lr_t)
        np.testing.assert_allclose(got, lr * cosine_scale(step, total, warmup=warmup), rtol=1e-12, atol=1e-18)
        np.testing.assert_allclose(got, float(sched(step)), rtol=1e-12, atol=1e-18)
        p.raw.grad = torch.ones(2, dtype=torch.float64)
        opt.step()
    assert opt.adam.param_groups[0]["lr"] is lr_t and lr_t.data_ptr() == ptr


def test_cosine_scale_in_float32_follows_float64():
    """The card evaluates the schedule in float32 from the float32 step
    count: within 4 float32 ulps of 1 (the scale's largest value; the cosine
    of a rounded argument) of the float64 value at every step."""
    for warmup in (0, 100):
        s = torch.arange(0, 2001, dtype=torch.float32)
        got = torch.stack([cosine_scale(x, 1500, warmup=warmup) for x in s]).double().numpy()
        want = np.array([cosine_scale(int(x), 1500, warmup=warmup) for x in s])
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * np.finfo(np.float32).eps)


def _cfg(**kw):
    return _small_cfg(num_iter=30, scan_inner=10, ckpt_every=10, log_every=10, monitor_every=10, **kw)


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_train_onoff_pptr_workdir_interrupt_and_resume(tmp_path, sampler):
    """A run stopped by Ctrl-C after block 2 (the monitor callback) resumes
    from its checkpoint to the uninterrupted run's bits; a finished run's
    resume trains nothing."""
    split = synthetic_pptr(8, 24, seed=0)
    cfg = _cfg(sampler=sampler)
    kw = dict(device="cpu", dtype=torch.float64, log_fn=lambda s: None)
    full = train_onoff_pptr(cfg, split, **kw)

    def stop(step, model):
        if step == 20:
            raise KeyboardInterrupt

    wd = str(tmp_path / "run")
    first = train_onoff_pptr(cfg, split, workdir=wd, monitor_cb=stop, **kw)
    assert first.interrupted and sorted(os.listdir(os.path.join(wd, "ckpt_onoff"))) == [
        "step_0000000000", "step_0000000010", "step_0000000020"]
    logs = []
    resumed = train_onoff_pptr(cfg, split, workdir=wd, resume=True, **{**kw, "log_fn": logs.append})
    assert "resumed from checkpoint at step 20" in logs
    assert torch.equal(resumed.step_losses, full.step_losses[20:])
    for (n, a), b in zip(full.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), n
    records = [json.loads(line) for line in open(os.path.join(wd, "metrics_onoff.jsonl"))]
    assert [r["step"] for r in records] == [10, 20, 30] and all({"loss", "elbo", "kl", "var_exp"} <= set(r)
                                                                for r in records)
    logs = []
    again = train_onoff_pptr(cfg, split, workdir=wd, resume=True, **{**kw, "log_fn": logs.append})
    assert "checkpoint is already at or past num_iter; nothing to train" in logs and again.step_losses is None


@pytest.mark.parametrize("override", [{"scan_inner": 0}, {"num_iter": 5}], ids=["scan_inner 0", "num_iter 5"])
def test_train_onoff_pptr_takes_the_per_step_fit(override):
    """The JAX package's per-step path where a block does not fit the run
    (these raised NotImplementedError before the loop was ported): the
    same steps as ``fit`` on the entry's DataSet."""
    split = synthetic_pptr(8, 24, seed=0)
    cfg = dataclasses.replace(_small_cfg(num_iter=12), **override)
    res = train_onoff_pptr(cfg, split, device="cpu", dtype=torch.float64, log_fn=lambda s: None)
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr

    model = build_onoff_pptr(cfg, split, device="cpu", dtype=torch.float64)
    ref = fit(model, DataSet(split.Xtrain, split.Ytrain), num_iter=cfg.num_iter, batch_size=cfg.batch_size,
              optimizer=make_optimizer(model, default_lr=cfg.indp_lr), log_every=cfg.log_every, log_fn=lambda s: None)
    assert res.step_losses.shape == (cfg.num_iter,)
    assert torch.equal(res.step_losses, ref.step_losses)


@pytest.mark.parametrize("what", ["exact Owen's T", "trust-bounded lengthscales"])
def test_a_warm_step_turns_no_host_value_into_a_tensor(monkeypatch, what):
    """After one step, a step builds no tensor from host data: on the card
    that is a host-to-device copy, which a CUDA graph capture refuses (the
    champion's exact Owen's T made one every step, as did a trust bound's
    Sigmoid)."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.experiments.configs import KernelInit

    split = synthetic_pptr(8, 24, seed=0)
    cfg = _small_cfg(exact_owen_t=True) if what.startswith("exact") else _small_cfg(
        fk_spatial=KernelInit((8.0, 8.0), 20.0, trust=3.0), gk_temporal=KernelInit((0.005,), 10.0, trust=2.0))
    model = build_onoff_pptr(cfg, split, device="cpu", dtype=torch.float64)
    X, Y = (torch.as_tensor(a[:32]) for a in (split.Xtrain, split.Ytrain))
    model.loss(X, Y).backward()
    as_tensor = torch.as_tensor

    def guarded(data, *args, **kw):
        if not isinstance(data, torch.Tensor):
            raise AssertionError(f"a host value became a tensor inside the step: {type(data)}")
        return as_tensor(data, *args, **kw)

    monkeypatch.setattr(torch, "as_tensor", guarded)
    monkeypatch.setattr(torch, "tensor", lambda *a, **k: pytest.fail("torch.tensor inside the step"))
    model.loss(X, Y).backward()


def test_capture_block_keeps_its_body_alive(monkeypatch):
    """A captured block reads and writes the storage its body's closure holds
    (the model, the optimizer): ``capture_block`` keeps the body, so a
    caller that lets them go cannot leave the graph writing into freed
    memory (a later graph's replay crashed the card's process that way).
    The graph is faked here; the card's test replays a real one."""
    import contextlib
    import gc
    import weakref

    from zigp_tpu_torch.ops.cuda import graphs
    from zigp_tpu_torch.training import capture_block, make_scan_train_step

    class FakeGraph:
        @contextlib.contextmanager
        def capture(self):
            yield

        def replay(self):
            pass

    monkeypatch.setattr(graphs, "CountedGraph", FakeGraph)

    def make():
        _, tm = _pair_models()
        train = make_scan_train_step(make_optimizer(tm, default_lr=LR))
        X, Y = (torch.as_tensor(a[:B]) for a in _data())
        return capture_block(lambda: train(tm, X[None], Y[None])), weakref.ref(tm)

    step, alive = make()  # the caller keeps no model, optimizer or body
    gc.collect()
    assert alive() is not None
    del step
    gc.collect()
    assert alive() is None
