"""The port's block-coordinate (alternating) schedule against the JAX
package's, on the CPU in float64.

- ``partition_model`` gives the JAX partition, name for name and in order,
  for the on/off (diagonal and Kronecker q), SVGP and joint hurdle models;
- one alternating dispatch (K = 8, ``hyper_every`` = 4, with and without
  the per-partition cosine schedules) equals ``make_alternating_device_step``
  at rtol 1e-8 in the losses and every raw, on the rows JAX's own
  ``jax.random.randint(block_key, (K·B,), 0, N)`` draws, staged into the
  port's block (the two samplers differ by design);
- a q-only step calls ``chol_inv`` zero times and leaves every hyper raw
  bit-identical (the factorizations counted through
  ``ops.linalg.chol_inv_forward``, the one forward every route takes);
- ``fit_scanned(alternating=K)`` with checkpoints, metrics, NaN restore,
  resume and Ctrl-C against the JAX package's run (rows again JAX's), and
  its guard rails;
- ``_fit_auto`` routes ``hyper_every`` for the on/off, SVGP, classifier and
  joint hurdle configs, with the JAX runner's guard rails.

On the CPU every block is the eager one; ``tests/test_torch_cuda.py`` holds
the captured block on the card.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.core.parameters import is_parameter
from zigp_tpu.experiments import builders as jbuilders
from zigp_tpu.experiments import configs as jconfigs
from zigp_tpu.io.checkpoint import CheckpointManager as JCheckpointManager
from zigp_tpu.training import fit_scanned as jfit_scanned
from zigp_tpu.training.alternating import make_alternating_device_step, partition_model as jpartition
from zigp_tpu.training.data import DataSet as JDataSet
from zigp_tpu.training.optim import cosine_adam as jcosine_adam
from zigp_tpu.utils.logging import MetricLogger as JMetricLogger
from zigp_tpu_torch.experiments import builders as tbuilders
from zigp_tpu_torch.experiments import configs as tconfigs
from zigp_tpu_torch.experiments import runners as trunners
from zigp_tpu_torch.io.checkpoint import CheckpointManager
from zigp_tpu_torch.io.convert import dump_arrays, jax_key, load_jax_arrays
from zigp_tpu_torch.io.datasets import Split
from zigp_tpu_torch.ops import linalg as tlinalg
from zigp_tpu_torch.training import (
    AdamPair,
    DataSet,
    cosine_adam,
    fit_scanned,
    init_alt_optimizers,
    make_alternating_block,
    partition_model,
)
from zigp_tpu_torch.utils.logging import MetricLogger

from .test_torch_runners import _jsplit, _tiny, _tiny_split
from .test_torch_train import _jraws
from .torch_helpers import jax_rows, jax_rows_as_port, one_torch_thread_per_module  # noqa: F401 (fixtures)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

CPU64 = dict(device="cpu", dtype=torch.float64)
LR = 1e-2
B = 16

BUILD = {
    "onoff": ("OnOffPptrConfig", "build_onoff_pptr", {}),
    "onoff kron": ("OnOffPptrConfig", "build_onoff_pptr", {"q_cov": "kron", "whiten": True}),
    "svgp": ("SvgpPptrConfig", "build_svgp_pptr", {}),
    "hurdlej": ("HurdleJointConfig", "build_hurdle_joint_pptr", {"likelihood": "lognormal"}),
    "classifier": ("ClassifierPptrConfig", "build_classifier_pptr", {}),
}


def models(kind, split=None, perturb=True, **kw):
    """The JAX and the port's model of ``kind`` from the tiny config, on the
    same raws; ``perturb`` moves them off the init by seeded noise, so the
    q partition is not at its symmetric start."""
    split = split or _tiny_split()
    cls, build, extra = BUILD[kind]
    jm = getattr(jbuilders, build)(_tiny(cls, jconfigs, **extra, **kw), _jsplit(split))
    tm = getattr(tbuilders, build)(_tiny(cls, tconfigs, **extra, **kw), split, **CPU64)
    arrays = _jraws(jm)
    if perturb:
        rng = np.random.RandomState(3)
        for k, a in arrays.items():
            if ".q_mu" in k or ".q_sqrt_factors" in k or (".q_sqrt" in k and "kron" not in kind):
                arrays[k] = a + 0.05 * rng.randn(*a.shape)
    load_jax_arrays(tm, arrays)
    jleaves, treedef = jax.tree_util.tree_flatten_with_path(jm)
    jm = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(arrays[jax.tree_util.keystr(p)]) for p, _ in jleaves])
    return jm, tm, split


def close_to_jax(tm, jm, rtol=1e-8):
    want = _jraws(jm)
    got = dump_arrays(tm)
    assert set(got) == set(want)
    for key, a in got.items():
        np.testing.assert_allclose(a, want[key], rtol=rtol, atol=rtol * 1e-3 * max(np.abs(want[key]).max(), 1e-300),
                                   err_msg=key)


@pytest.mark.parametrize("kind", ["onoff", "onoff kron", "svgp", "hurdlej"])
def test_partition_names_and_order_match_jax(kind):
    jm, tm, _ = models(kind, perturb=False)
    jq, jh, _ = jpartition(jm)
    tq, th = partition_model(tm)
    flat = jax.tree_util.tree_flatten_with_path(jm, is_leaf=is_parameter)[0]
    jpaths = lambda leaves: [jax.tree_util.keystr(p) for p, l in flat if any(l is y for y in leaves)]
    assert [jax_key(n)[: -len(".raw")] for n, _ in tq] == jpaths(jq) and len(tq) == len(jq)
    assert [jax_key(n)[: -len(".raw")] for n, _ in th] == jpaths(jh) and len(th) == len(jh)


@pytest.mark.parametrize("case", ["diag constant", "kron cosine"])
def test_one_dispatch_matches_make_alternating_device_step(case):
    """K = 8 steps in two groups of 4 (hyper step, factor state, three
    q-only steps), the losses and every raw at rtol 1e-8."""
    kind = "onoff kron" if "kron" in case else "onoff"
    jm, tm, split = models(kind)
    K, H = 8, 4
    jfac = (jcosine_adam(6), jcosine_adam(2)) if "cosine" in case else None
    tfac = (cosine_adam(6), cosine_adam(2)) if "cosine" in case else None
    X, Y = split.Xtrain, split.Ytrain
    step, st0 = make_alternating_device_step(jm, jnp.asarray(X), jnp.asarray(Y), B, hyper_every=H,
                                             learning_rate=LR, opt_factories=jfac)
    jout, _, jlosses = step(jm, st0, jnp.asarray(np.array([0, 3], dtype=np.uint32)), K)

    idx = jax_rows([0, 3], K * B, X.shape[0])
    Xs = torch.as_tensor(X[idx].reshape(K, B, -1))
    Ys = torch.as_tensor(Y[idx].reshape(K, B, -1))
    block = make_alternating_block(tm, init_alt_optimizers(tm, learning_rate=LR, opt_factories=tfac), H)
    losses = block(Xs, Ys)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-8)
    close_to_jax(tm, jout)


def test_q_only_steps_never_factor_and_leave_hypers_bit_identical(monkeypatch):
    """Two groups of 4: a factorization in each hyper step and its factor
    state (one call a factor for the stacked pair: 4 a group), none in the
    q-only steps, whose every hyper raw is the hyper step's to the bit."""
    _, tm, split = models("onoff kron")
    calls = []
    forward = tlinalg.chol_inv_forward

    def counted(K):
        calls.append(K.shape[-1])
        return forward(K)

    monkeypatch.setattr(tlinalg, "chol_inv_forward", counted)
    q, h = partition_model(tm)
    seen = []
    loss = tm.loss

    def watched(X, Y, **kw):
        seen.append((len(calls), "factor_state" in kw, [raw.detach().clone() for _, raw in h]))
        return loss(X, Y, **kw)

    monkeypatch.setattr(tm, "loss", watched)
    block = make_alternating_block(tm, init_alt_optimizers(tm, learning_rate=LR), 4)
    rng = np.random.RandomState(0)
    idx = rng.randint(0, split.Xtrain.shape[0], 8 * B)
    block(torch.as_tensor(split.Xtrain[idx].reshape(8, B, -1)), torch.as_tensor(split.Ytrain[idx].reshape(8, B, -1)))
    assert len(calls) == 8 and sorted(set(calls)) == [3, 6]  # 2 groups × (loss + factor_state) × 2 factors
    assert [s[1] for s in seen] == [False, True, True, True] * 2
    for g in (0, 4):
        hyper_calls, after_factor_state = seen[g][0], seen[g + 1][0]
        assert after_factor_state == hyper_calls + 4  # the hyper step's 2, the factor state's 2
        for k in (g + 2, g + 3):
            assert seen[k][0] == after_factor_state  # a q-only step factors nothing
            for a, b in zip(seen[g + 1][2], seen[k][2]):
                assert torch.equal(a, b)
    changed = [not torch.equal(a, b) for a, b in zip(seen[0][2], seen[1][2])]
    assert any(changed)  # the hyper step moved the hypers


def test_a_q_only_backward_reaches_no_hyper_raw():
    """``backward(inputs=q)`` leaves every hyper raw's gradient untouched: the
    q-only step runs no backward into the grams."""
    _, tm, split = models("onoff")
    opt = init_alt_optimizers(tm, learning_rate=LR)
    q, h = partition_model(tm)
    X, Y = (torch.as_tensor(a[:B]) for a in (split.Xtrain, split.Ytrain))
    with torch.no_grad():
        state = tm.factor_state()
    opt.h.zero_grad()
    opt.q.zero_grad()
    tm.loss(X, Y, factor_state=state).backward(inputs=[r for _, r in q if r.requires_grad])
    assert not opt.h.grads.flat.any() and opt.q.grads.flat.any()


def test_alternating_validation_errors():
    _, tm, split = models("onoff", perturb=False)
    ds = DataSet(split.Xtrain, split.Ytrain)
    kw = dict(num_iter=8, batch_size=B, log_fn=lambda s: None)
    with pytest.raises(ValueError, match="hyper_every must be"):
        make_alternating_block(tm, init_alt_optimizers(tm), 1)

    class NoFactorState(torch.nn.Module):
        def loss(self, X, Y):
            return torch.zeros(())

    with pytest.raises(ValueError, match="the Kronecker families"):
        make_alternating_block(NoFactorState(), init_alt_optimizers(tm), 4)
    block = make_alternating_block(tm, init_alt_optimizers(tm), 4)
    with pytest.raises(ValueError, match="divide"):
        block(torch.zeros(6, B, 3, dtype=torch.float64), torch.zeros(6, B, 1, dtype=torch.float64))
    with pytest.raises(ValueError, match="sampler='device'"):
        fit_scanned(tm, ds, num_inner=8, sampler="host", alternating=4, **kw)
    with pytest.raises(ValueError, match="loss_fn=None"):
        fit_scanned(tm, ds, num_inner=8, sampler="device", alternating=4, loss_fn=lambda m, X, Y: m.loss(X, Y), **kw)
    with pytest.raises(ValueError, match="must divide by hyper_every"):
        fit_scanned(tm, ds, num_inner=6, sampler="device", alternating=4, **kw)
    with pytest.raises(ValueError, match="hyper_every must be"):
        fit_scanned(tm, ds, num_inner=8, sampler="device", alternating=1, **kw)


def _poisoned(base, split, at):
    """A DataSet of ``base``'s package whose ``arrays`` (the device
    sampler's source) hold a NaN target in row ``at``."""
    Y = split.Ytrain.copy()
    Y[at, 0] = np.nan
    return base(split.Xtrain, Y, seed=0)


def _run(fn, model, ds, directory, Mgr, Logger, **kw):
    logs = []
    mgr = Mgr(os.path.join(directory, "ck"), every=8)
    logger = Logger(os.path.join(directory, "m.jsonl"))
    res = fn(model, ds, num_iter=24, batch_size=B, num_inner=8, learning_rate=LR, sampler="device", sampler_seed=4,
             alternating=4, log_every_blocks=1, log_fn=logs.append, ckpt_manager=mgr, metric_logger=logger, **kw)
    logger.close()
    records = [json.loads(line) for line in open(os.path.join(directory, "m.jsonl"))]
    return res, logs, sorted(os.listdir(mgr.directory)), records, mgr


@pytest.mark.parametrize("poison", [False, True], ids=["clean", "NaN restored"])
def test_fit_scanned_alternating_checkpoints_metrics_and_nan_restore_match_jax(tmp_path, jax_rows_as_port, poison):
    """24 steps in blocks of 8 (two groups of 4 each) with checkpoints every
    8 and a metric logger: the same log lines, checkpoints and records as the
    JAX run, the losses and raws at rtol 1e-8; with a NaN row, the same
    NON-FINITE block restored from the same checkpoint."""
    jm, tm, split = models("onoff kron")
    N = split.Xtrain.shape[0]
    # a row of block 1's last minibatch that block 0 never draws
    at = next(r for r in jax_rows([4, 1], 8 * B, N)[-B:] if r not in set(jax_rows([4, 0], 8 * B, N)))
    jds = _poisoned(JDataSet, split, at) if poison else JDataSet(split.Xtrain, split.Ytrain, seed=0)
    tds = _poisoned(DataSet, split, at) if poison else DataSet(split.Xtrain, split.Ytrain, seed=0)
    jres, jlogs, jck, jrec, _ = _run(jfit_scanned, jm, jds, str(tmp_path / "j"), JCheckpointManager, JMetricLogger)
    tres, tlogs, tck, trec, mgr = _run(fit_scanned, tm, tds, str(tmp_path / "t"), CheckpointManager, MetricLogger)
    assert tlogs == jlogs and tck == jck
    if poison:
        assert "step       16  NON-FINITE loss" in tlogs and "restored from checkpoint at step 8" in tlogs
        return
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-8)
    close_to_jax(tres.model, jres.model)
    assert [sorted(r) for r in trec] == [sorted(r) for r in jrec]
    for t, j in zip(trec, jrec):
        for k in set(j) - {"wall"}:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-8, err_msg=k)
    assert isinstance(tres.optimizer, AdamPair)
    # the pair's state restores in place, the step counts included
    _, tm2, _ = models("onoff kron")
    opt2 = init_alt_optimizers(tm2, learning_rate=LR)
    _, _, step = mgr.restore_latest(tm2, opt2)
    assert step == 24 and float(opt2.h.step_count) == 6 and float(opt2.q.step_count) == 18
    for (n, a), b in zip(tres.model.named_parameters(), tm2.parameters()):
        assert torch.equal(a, b), n
    with pytest.raises(KeyError):
        mgr.restore_latest(tm2, init_alt_optimizers(tm2).q)  # a pair's checkpoint is no single Adam's


def test_fit_scanned_alternating_resume_equals_the_uninterrupted_run():
    """16 steps straight, and 8 with a checkpoint then 8 more from it (a
    fresh model and pair): the same bits."""
    kw = dict(batch_size=B, num_inner=8, learning_rate=LR, sampler="device", sampler_seed=2, alternating=4,
              log_fn=lambda s: None)
    _, tm, split = models("onoff kron")
    full = fit_scanned(tm, DataSet(split.Xtrain, split.Ytrain), num_iter=16, **kw)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        _, tm1, _ = models("onoff kron")
        mgr = CheckpointManager(d, every=8)
        fit_scanned(tm1, DataSet(split.Xtrain, split.Ytrain), num_iter=8, ckpt_manager=mgr, **kw)
        _, tm2, _ = models("onoff kron")
        opt = init_alt_optimizers(tm2, learning_rate=LR)
        _, _, start = mgr.restore_latest(tm2, opt)
        resumed = fit_scanned(tm2, DataSet(split.Xtrain, split.Ytrain), num_iter=8, optimizer=opt,
                              start_step=start, **kw)
    assert torch.equal(resumed.step_losses, full.step_losses[8:])
    for (n, a), b in zip(full.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), n


def test_fit_scanned_alternating_ctrl_c_checkpoints(tmp_path):
    _, tm, split = models("onoff")
    mgr = CheckpointManager(str(tmp_path / "ck"), every=1000)
    n = {"logs": 0}

    def exploding(msg):
        if "loss" in msg:
            n["logs"] += 1
            if n["logs"] == 2:
                raise KeyboardInterrupt
        n["last"] = msg

    res = fit_scanned(tm, DataSet(split.Xtrain, split.Ytrain), num_iter=32, batch_size=B, num_inner=8,
                      sampler="device", alternating=4, log_fn=exploding, ckpt_manager=mgr)
    assert res.interrupted and mgr.latest_step() == 16 and "interrupted" in n["last"]


def _route_cfg(kind, **kw):
    cls = BUILD[kind][0]
    return _tiny(cls, tconfigs, **BUILD[kind][2], **kw)


@pytest.mark.parametrize("kind", ["onoff", "svgp", "classifier", "hurdlej"])
def test_fit_auto_routes_hyper_every(kind, tmp_path):
    """``_fit_auto`` with ``hyper_every``: the pair of optimizers, a
    checkpoint holding it, cosine over each partition's own count, and the
    JAX runner's guard rails."""
    _, tm, split = models(kind, perturb=False)
    cfg = _route_cfg(kind, hyper_every=5, sampler="device", lr_schedule="cosine", ckpt_every=10)
    ds = DataSet(split.Xtrain, split.Ytrain if kind != "classifier" else (split.Ytrain > 0).astype(float))
    res = trunners._fit_auto(tm, ds, cfg, learning_rate=1e-2, log_fn=lambda s: None, kind=kind,
                             workdir=str(tmp_path))
    assert isinstance(res.optimizer, AdamPair) and res.step_losses.shape == (20,)
    assert torch.isfinite(res.step_losses).all()
    assert float(res.optimizer.h.step_count) == 4 and float(res.optimizer.q.step_count) == 16
    assert sorted(os.listdir(tmp_path / f"ckpt_{kind}")) == [f"step_{s:010d}" for s in (0, 10, 20)]
    # q's schedule spans 20·4/5 = 16 updates, h's 20/5 = 4: both at their end
    for opt in (res.optimizer.h, res.optimizer.q):
        np.testing.assert_allclose(float(opt.adam.param_groups[0]["lr"]) / opt.adam.param_groups[0]["base_lr"],
                                   0.01, rtol=1e-12)
    with pytest.raises(SystemExit, match="requires --sampler device"):
        trunners._fit_auto(tm, ds, dataclasses.replace(cfg, sampler="host"), learning_rate=1e-2,
                           log_fn=lambda s: None, kind=kind)
    with pytest.raises(SystemExit, match="requires the scanned path"):
        trunners._fit_auto(tm, ds, dataclasses.replace(cfg, scan_inner=0), learning_rate=1e-2,
                           log_fn=lambda s: None, kind=kind)


def test_train_onoff_pptr_hyper_every_matches_jax_run_onoff_training(jax_rows_as_port):
    """``train_onoff_pptr`` with the README's recipe shape (device sampler,
    ``hyper_every``, ``kern_lr``, cosine) against the JAX runner's
    ``_fit_auto`` on the same raws and rows: the losses and raws at
    rtol 1e-8."""
    from zigp_tpu.experiments import runners as jrunners
    from zigp_tpu.io.native import make_dataset

    kw = dict(hyper_every=5, sampler="device", kern_lr=2e-2, lr_schedule="cosine", log_every=10)
    jm, tm, split = models("onoff", **kw)
    jcfg = _tiny("OnOffPptrConfig", jconfigs, **kw)
    jres = jrunners._fit_auto(jm, make_dataset(split.Xtrain, split.Ytrain), jcfg, learning_rate=jcfg.indp_lr,
                              log_fn=lambda s: None, kind="onoff")
    tres = trunners.train_onoff_pptr(_tiny("OnOffPptrConfig", tconfigs, **kw), split, model=tm,
                                     log_fn=lambda s: None, **CPU64)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-8)
    close_to_jax(tres.model, jres.model)
