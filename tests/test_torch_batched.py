"""The port's batched member stack against the JAX package's, on the CPU in
float64.

- ``fit_batched_scanned`` against JAX's for q_cov diag and kron, the
  ragged stack (``num_rows`` and an ``aux`` ``num_data``), and
  ``hyper_every`` (``make_batched_alternating_step``), at rtol 1e-8 on
  JAX's own rows (``torch_helpers.jax_rows_as_port``); the same raws go in
  through ``io.convert.load_jax_stack``;
- ``fit_natgrad_batched`` for the diagonal family and ``kron_joint``, one
  member's KL budget binding and the other's not;
- member f of the port's stack equal to the port's own sequential
  ``fit_scanned(sampler="device", sampler_seed=seeds[f])`` (rtol 1e-10);
- ``predict_batched_stacked`` against each member's ``predict``;
- ``stack_models``/``unstack_model``, ``load_jax_stack``/``dump_stack`` and
  their refusals; the final NaN gate; checkpoints with a NaN restore (the
  JAX run's log lines); a resumed completed run as a no-op;
- the vmap rules of ``ops.linalg._CholInv`` and ``ops.cuda.rbf_gram.
  _RBFGram``: one call per factor whatever F (counted by monkeypatch), and
  per-member outputs and gradients equal to separate calls.

On the CPU every block is the eager one; ``tests/test_torch_cuda.py`` holds
the captured stack on the card.
"""

import copy
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.experiments import builders as jbuilders
from zigp_tpu.experiments import configs as jconfigs
from zigp_tpu.io.checkpoint import CheckpointManager as JCheckpointManager
from zigp_tpu.likelihoods import Gaussian as JGaussian
from zigp_tpu.models import KronSVGP as JKronSVGP
from zigp_tpu.ops.kernels import RBF as JRBF
from zigp_tpu.training import batched as jbatched
from zigp_tpu.utils.logging import MetricLogger as JMetricLogger
from zigp_tpu_torch.experiments import builders as tbuilders
from zigp_tpu_torch.experiments import configs as tconfigs
from zigp_tpu_torch.io.checkpoint import CheckpointManager
from zigp_tpu_torch.io.convert import dump_arrays, dump_stack, load_jax_arrays, load_jax_stack
from zigp_tpu_torch.likelihoods import Gaussian as TGaussian
from zigp_tpu_torch.models import KronSVGP as TKronSVGP
from zigp_tpu_torch.ops import linalg as tlinalg
from zigp_tpu_torch.ops.cuda import rbf_gram as trbf
from zigp_tpu_torch.ops.kernels import RBF as TRBF
from zigp_tpu_torch.training import (
    DataSet,
    fit_batched_scanned,
    fit_natgrad_batched,
    fit_scanned,
    over_members,
    predict_batched_stacked,
    stack_models,
    unstack_model,
)
from zigp_tpu_torch.training import natgrad as tng
from zigp_tpu_torch.utils.logging import MetricLogger

from .test_torch_alternating import close_to_jax, models
from .test_torch_runners import _jsplit, _tiny, _tiny_split
from .test_torch_train import _jraws, _with_raws
from .torch_helpers import jax_rows_as_port  # noqa: F401 (a fixture)

CPU64 = dict(device="cpu", dtype=torch.float64)
LR = 1e-2
B = 16
quiet = lambda s: None  # noqa: E731


def stacked_pair(kind, F=3, **kw):
    """F JAX models and the port's of ``kind`` (each on its own split), the
    port's raws loaded from JAX's stacked pytree through ``load_jax_stack``:
    (JAX models, port models, datas)."""
    jms, tms, datas = [], [], []
    for f in range(F):
        jm, tm, split = models(kind, split=_tiny_split(seed=10 + f), **kw)
        jms.append(jm)
        tms.append(tm)
        datas.append((split.Xtrain, split.Ytrain))
    stack = stack_models(tms)
    load_jax_stack(stack, _jraws(jbatched.stack_pytrees(jms)))
    return jms, [unstack_model(stack, f) for f in range(F)], datas


def members_close(tres, jres, rtol=1e-8):
    for t, j in zip(tres, jres):
        close_to_jax(t.model, j.model, rtol=rtol)
        np.testing.assert_allclose(t.final_loss, j.final_loss, rtol=rtol)


@pytest.mark.parametrize("kind", ["onoff", "onoff kron"])
def test_fit_batched_scanned_matches_jax(kind, jax_rows_as_port):
    """3 members, 12 steps in blocks of 4, on JAX's rows: every member's
    raws, final loss and logged losses at rtol 1e-8."""
    jms, tms, datas = stacked_pair(kind)
    kw = dict(num_iter=12, batch_size=B, num_inner=4, learning_rate=LR, seeds=[0, 1, 2], log_every_blocks=1)
    jlogs, tlogs = [], []
    jres = jbatched.fit_batched_scanned(jms, datas, log_fn=jlogs.append, **kw)
    tres = fit_batched_scanned(tms, datas, log_fn=tlogs.append, **kw)
    members_close(tres, jres)
    for t, j in zip(tres, jres):
        np.testing.assert_allclose(t.losses, j.losses, rtol=1e-8)
    assert len(tlogs) == len(jlogs) == 3 and all(t.split("[")[0] == j.split("[")[0] for t, j in zip(tlogs, jlogs))


def test_ragged_stack_with_num_rows_and_aux_matches_jax(jax_rows_as_port):
    """Members of 40, 60 and 52 rows, padded to 60 and drawn from their own
    rows only, each ELBO scaled by its true num_data through ``aux``."""
    sizes = [40, 60, 52]
    jms, tms, datas = [], [], []
    for f, n in enumerate(sizes):
        jm, tm, split = models("svgp", split=_tiny_split(seed=20 + f, ntrain=n))
        jms.append(jm.replace(num_data=1))
        tm.num_data = 1
        tms.append(tm)
        datas.append((split.Xtrain, split.Ytrain))
    kw = dict(num_iter=8, batch_size=12, num_inner=4, learning_rate=LR, seeds=[0, 1, 2], log_every_blocks=0,
              log_fn=quiet)
    jres = jbatched.fit_batched_scanned(jms, datas, loss_fn=lambda m, X, Y, n: m.loss(X, Y, num_data=n),
                                        aux=jnp.asarray(np.array(sizes, dtype=np.int32)), **kw)
    tres = fit_batched_scanned(tms, datas, loss_fn=lambda m, X, Y, n: m.loss(X, Y, num_data=n), aux=sizes, **kw)
    members_close(tres, jres)


def test_hyper_every_stack_matches_jax(jax_rows_as_port):
    """The block-coordinate schedule on the stack (16 steps, blocks of 8,
    groups of 4) against JAX's ``make_batched_alternating_step``."""
    jms, tms, datas = stacked_pair("onoff kron", F=2)
    kw = dict(num_iter=16, batch_size=B, num_inner=8, learning_rate=LR, seeds=[3, 4], log_every_blocks=0,
              log_fn=quiet, hyper_every=4)
    members_close(fit_batched_scanned(tms, datas, **kw), jbatched.fit_batched_scanned(jms, datas, **kw))
    with pytest.raises(ValueError, match="loss_fn/aux"):
        fit_batched_scanned(tms, datas, **{**kw, "aux": [1, 2]})
    with pytest.raises(ValueError, match="must divide"):
        fit_batched_scanned(tms, datas, **{**kw, "hyper_every": 3})


def _svgp_pair(seed, q_cov, scale):
    """The JAX test's whitened KronSVGP (6 × 5 grid) in both packages, q_mu
    scaled by ``scale``: a large mean takes large natural steps."""
    r = np.random.RandomState(seed)
    Zs = [r.rand(6, 2), np.linspace(0, 1, 5)[:, None]]
    jm = JKronSVGP.create([JRBF.create([1.0, 1.0], 2.0), JRBF.create([0.3], 2.0)], Zs, JGaussian.create(0.1),
                          num_data=60, jitter=1e-6, seed=seed, whiten=True, q_cov=q_cov)
    tm = TKronSVGP.create([TRBF.create([1.0, 1.0], 2.0), TRBF.create([0.3], 2.0)], Zs, TGaussian.create(0.1),
                          num_data=60, jitter=1e-6, seed=seed, whiten=True, q_cov=q_cov)
    arrays = _jraws(jm)
    arrays = {k: a * scale if ".q_mu" in k else a for k, a in arrays.items()}
    load_jax_arrays(tm, arrays)
    return _with_raws(jm, arrays), tm


def _data(seed, N=60):
    r = np.random.RandomState(seed)
    return r.rand(N, 3), np.maximum(r.randn(N, 1), 0.0)


@pytest.mark.parametrize("kron_joint", [False, True], ids=["diag", "kron_joint"])
def test_fit_natgrad_batched_matches_jax_with_per_member_kl_budget(kron_joint, jax_rows_as_port, monkeypatch):
    """Adam warm-start, γ ramp and the natural steps of 2 members against
    JAX's ``fit_natgrad_batched``; with ``kron_joint`` the KL budget of the
    joint step binds for member 0 (a large mean) at some step and never for
    member 1, watched by rerunning each call's step at a budget that never
    binds. Both at rtol 1e-8."""
    q_cov = "kron" if kron_joint else "diag"
    pairs = [_svgp_pair(0, q_cov, 30.0), _svgp_pair(1, q_cov, 1.0)]
    datas = [_data(500), _data(501)]
    kw = dict(num_iter=16, batch_size=12, num_inner=4, gamma=0.01, gamma_warmup=4, adam_warmup=4, adam_lr=1e-2,
              kron_joint=kron_joint, kl_cap=10.0, seeds=[0, 1], log_every_blocks=0, log_fn=quiet)
    bound = np.zeros(2, bool)
    step = tng.natgrad_update_block_kron

    def watched(q_mu, C_factors, p, dmu, dC, lr, **k):
        capped = step(q_mu, C_factors, p, dmu, dC, lr, **k)
        free = step(q_mu, C_factors, p, dmu, dC, lr, **{**k, "kl_cap": 1e30})  # the same arithmetic, never binding
        bound[:] |= (capped[0] != free[0]).flatten(1).any(1).reshape(-1, 2).any(0).numpy()  # (U·F) -> F
        return capped

    monkeypatch.setattr(tng, "natgrad_update_block_kron", watched)
    jres = jbatched.fit_natgrad_batched([j for j, _ in pairs], datas, **kw)
    tres = fit_natgrad_batched([t for _, t in pairs], datas, **kw)
    members_close(tres, jres)
    if kron_joint:
        assert bound.tolist() == [True, False]


def test_members_equal_their_sequential_runs():
    """Member f of the stack follows ``fit_scanned(sampler="device",
    sampler_seed=seeds[f])`` of the port itself: raws and losses at rtol
    1e-10 (the vmapped products sum as the single ones do, to rounding)."""
    _, tms, datas = stacked_pair("onoff", F=3, perturb=True)
    seqs = [copy.deepcopy(m) for m in tms]
    kw = dict(num_iter=12, batch_size=B, num_inner=4, learning_rate=LR, log_fn=quiet)
    res = fit_batched_scanned(tms, datas, seeds=[5, 6, 7], log_every_blocks=0, **kw)
    for f, m in enumerate(seqs):
        one = fit_scanned(m, DataSet(*datas[f]), sampler="device", sampler_seed=5 + f, log_every_blocks=0, **kw)
        for (n, a), b in zip(res[f].model.named_parameters(), one.model.parameters()):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-10, atol=1e-13, err_msg=n)
        np.testing.assert_allclose(res[f].final_loss, one.final_loss, rtol=1e-10)


def test_predict_batched_stacked_matches_each_member():
    """37 rows per member in chunks of 16 (the last padded): each member's
    fields equal its own ``predict``."""
    _, tms, _ = stacked_pair("onoff", F=2)
    stack = stack_models(tms)
    rng = np.random.RandomState(3)
    Xs = rng.rand(2, 37, 3)
    fn = lambda m, X: m.predict(X)  # noqa: E731
    preds = predict_batched_stacked(fn, stack, Xs, batch=16)
    assert len(stack._stacked_predictors) == 1
    predict_batched_stacked(fn, stack, Xs, batch=16)  # the same predictor again
    assert len(stack._stacked_predictors) == 1
    for f, m in enumerate(tms):
        with torch.no_grad():
            ref = m.predict(torch.as_tensor(Xs[f]))._asdict()
        for k, v in preds[f].items():
            assert v.shape == (37, 1)
            np.testing.assert_allclose(v, ref[k].numpy(), rtol=1e-12, atol=1e-14, err_msg=k)
    with pytest.raises(ValueError, match="members"):
        predict_batched_stacked(fn, stack, Xs[:1])


def test_stack_unstack_round_trip_and_refusals():
    _, tms, _ = stacked_pair("onoff", F=3)
    stack = stack_models(tms)
    assert stack.stack_size == 3
    for f, m in enumerate(tms):
        back = unstack_model(stack, f)
        assert not hasattr(back, "stack_size")
        for (n, a), (n2, b) in zip(back.named_parameters(), m.named_parameters()):
            assert n == n2 and torch.equal(a, b) and a.requires_grad == b.requires_grad
            assert a.data_ptr() != b.data_ptr()
    arrays = dump_stack(stack)
    assert all(a.shape[0] == 3 for a in arrays.values())
    with pytest.raises(KeyError, match="missing"):
        load_jax_stack(stack, {k: v for k, v in list(arrays.items())[1:]})
    with pytest.raises(ValueError, match="shape"):
        load_jax_stack(stack, {k: v[:2] for k, v in arrays.items()})
    with pytest.raises(TypeError, match="not a member stack"):
        load_jax_stack(tms[0], dump_arrays(tms[0]))
    other = copy.deepcopy(tms[1])
    other.num_data = other.num_data + 1  # a static field
    with pytest.raises(ValueError, match="cannot stack"):
        stack_models([tms[0], other])
    _, wide, _ = models("onoff", split=_tiny_split(seed=11))
    wide.f.q_mu.raw = torch.nn.Parameter(torch.zeros(wide.f.q_mu.raw.shape[0] + 1, 1, dtype=torch.float64))
    with pytest.raises(ValueError, match="mismatched shapes"):
        stack_models([tms[0], wide])


def test_final_nan_gate():
    _, tms, datas = stacked_pair("svgp", F=2)
    with pytest.raises(FloatingPointError, match="non-finite losses in members"):
        fit_batched_scanned(tms, datas, num_iter=4, batch_size=8, num_inner=2, log_every_blocks=0, log_fn=quiet,
                            loss_fn=lambda m, X, Y, a: m.loss(X, Y) * np.nan)


def _poisoned(datas, member, row):
    X, Y = datas[member]
    Y = Y.copy()
    Y[row, 0] = np.nan
    return [d if f != member else (X, Y) for f, d in enumerate(datas)]


def test_checkpoints_and_nan_restore_log_as_jax(tmp_path, jax_rows_as_port):
    """12 steps in blocks of 4, checkpoints every 4, a metric logger; member
    1 reads a NaN row in block 2's last step only: the same log lines, checkpoints and
    records as the JAX run, the whole stack restored from step 4."""
    from .torch_helpers import jax_rows

    jms, tms, datas = stacked_pair("svgp", F=2)
    N = datas[1][0].shape[0]
    seen = set(jax_rows([1, 0], 4 * B, N)) | set(jax_rows([1, 1], 4 * B, N))
    row = next(r for r in jax_rows([1, 2], 4 * B, N)[-B:] if r not in seen)  # block 2's last minibatch
    datas = _poisoned(datas, 1, row)

    def run(fit, ms, Mgr, Logger, d):
        logs = []
        mgr = Mgr(str(tmp_path / d / "ck"), every=4)
        logger = Logger(str(tmp_path / d / "m.jsonl"))
        res = fit(ms, datas, num_iter=12, batch_size=B, num_inner=4, learning_rate=LR, seeds=[0, 1],
                  log_every_blocks=1, log_fn=logs.append, ckpt_manager=mgr, metric_logger=logger)
        logger.close()
        recs = [json.loads(line) for line in open(tmp_path / d / "m.jsonl")]
        return res, logs, sorted(os.listdir(mgr.directory)), recs

    jres, jlogs, jck, jrec = run(jbatched.fit_batched_scanned, jms, JCheckpointManager, JMetricLogger, "j")
    tres, tlogs, tck, trec = run(fit_batched_scanned, tms, CheckpointManager, MetricLogger, "t")
    assert "step       12  NON-FINITE loss in members [1]" in tlogs
    assert "restored the stack from checkpoint at step 8" in tlogs
    assert [line.split("[")[0] for line in tlogs] == [line.split("[")[0] for line in jlogs]
    assert [line for line in tlogs if "losses" not in line] == [line for line in jlogs if "losses" not in line]
    assert tck == jck and [sorted(r) for r in trec] == [sorted(r) for r in jrec]
    assert all(np.isnan(r.final_loss) for r in tres)
    for t, j in zip(tres, jres):
        close_to_jax(t.model, j.model)


def test_resumed_completed_run_is_a_noop(tmp_path):
    _, tms, datas = stacked_pair("svgp", F=3)
    mgr = CheckpointManager(str(tmp_path / "ck"), every=8)
    kw = dict(num_iter=8, batch_size=B, num_inner=4, learning_rate=LR, seeds=[0, 1, 2], log_every_blocks=0)
    first = fit_batched_scanned([copy.deepcopy(m) for m in tms], datas, log_fn=quiet, ckpt_manager=mgr, **kw)
    assert mgr.latest_step() == 8
    logs = []
    again = fit_batched_scanned(tms, datas, log_fn=logs.append, ckpt_manager=mgr, resume=True, **kw)
    assert logs == ["resumed the stacked run from step 8", "checkpoint is already at or past num_iter; nothing to train"]
    assert mgr.latest_step() == 8
    for a, b in zip(first, again):
        for p, q in zip(a.model.parameters(), b.model.parameters()):
            assert torch.equal(p, q)
        assert np.isfinite(b.final_loss)


@pytest.fixture
def chol_inv_calls(monkeypatch):
    calls = []
    forward = tlinalg.chol_inv_forward

    def counted(K):
        calls.append(tuple(K.shape))
        return forward(K)

    monkeypatch.setattr(tlinalg, "chol_inv_forward", counted)
    return calls


@pytest.mark.parametrize("F", [1, 2, 3])
def test_vmap_rule_factors_every_member_in_one_call(F, chol_inv_calls):
    """A stacked loss calls ``chol_inv`` once per factor whatever F, on the
    (F·2, n, n) batch of the f/g pair; the stacked factor state the same."""
    _, tms, datas = stacked_pair("onoff", F=F)
    stack = stack_models(tms)
    X = torch.as_tensor(np.stack([d[0][:B] for d in datas]))
    Y = torch.as_tensor(np.stack([d[1][:B] for d in datas]))
    over_members(stack, lambda m, X, Y: m.loss(X, Y), X, Y).sum().backward()
    sizes = [Z.shape[0] for Z in tms[0].f.Zs]
    assert chol_inv_calls == [(2 * F, n, n) for n in sizes]
    chol_inv_calls.clear()
    with torch.no_grad():
        over_members(stack, lambda m: m.factor_state())
    assert chol_inv_calls == [(2 * F, n, n) for n in sizes]


def test_vmap_rules_equal_separate_calls(monkeypatch):
    """``chol_inv`` and ``rbf_gram`` under ``torch.func.vmap`` (an unbatched
    input expanded, a batched one moved to the front) equal one call per
    member, outputs and gradients, and make one call each."""
    rng = np.random.RandomState(0)
    F, G, n = 3, 2, 6
    A = rng.randn(F, G, n, n)
    K = torch.as_tensor(A @ A.transpose(0, 1, 3, 2) + n * np.eye(n), dtype=torch.float64).requires_grad_(True)
    cot = torch.as_tensor(rng.randn(F, G, n, n))
    L, Li = torch.func.vmap(tlinalg.chol_inv, in_dims=1, out_dims=1)(K.transpose(0, 1))
    (torch.sum(L.transpose(0, 1) * cot) + torch.sum(Li.transpose(0, 1) * cot)).backward()
    for f in range(F):
        Kf = K[f].detach().clone().requires_grad_(True)
        Lf, Lif = tlinalg.chol_inv(Kf)
        (torch.sum(Lf * cot[f]) + torch.sum(Lif * cot[f])).backward()
        np.testing.assert_allclose(L[:, f].detach().numpy(), Lf.detach().numpy(), rtol=1e-13)
        np.testing.assert_allclose(K.grad[f].numpy(), Kf.grad.numpy(), rtol=1e-10, atol=1e-13)

    calls = []
    cuda = trbf.rbf_gram_cuda
    monkeypatch.setattr(trbf, "rbf_gram_cuda", lambda *a: calls.append(a[0].shape) or cuda(*a))
    Z = torch.as_tensor(rng.rand(F, G, 5, 2)).requires_grad_(True)
    Xb = torch.as_tensor(rng.rand(7, 2))  # one batch shared by every member (unbatched under the vmap)
    ell = torch.as_tensor(0.5 + rng.rand(F, G, 2)).requires_grad_(True)
    var = torch.as_tensor(1.0 + rng.rand(F, G)).requires_grad_(True)
    Kg = torch.func.vmap(trbf.rbf_gram, in_dims=(0, None, 0, 0))(Z, Xb, ell, var)
    assert calls == [torch.Size([F * G, 5, 2])]
    gcot = torch.as_tensor(rng.randn(F, G, 5, 7))
    torch.sum(Kg * gcot).backward()
    for f in range(F):
        Zf, lf, vf = (t[f].detach().clone().requires_grad_(True) for t in (Z, ell, var))
        Kf = trbf.rbf_gram(Zf, Xb, lf, vf)
        torch.sum(Kf * gcot[f]).backward()
        np.testing.assert_allclose(Kg[f].detach().numpy(), Kf.detach().numpy(), rtol=1e-13)
        for a, b in ((Z.grad[f], Zf.grad), (ell.grad[f], lf.grad), (var.grad[f], vf.grad)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-13)


def test_classifier_stack_with_the_gram_kernel_matches_jax(jax_rows_as_port):
    """The tuned classifier's route (the gram kernel's Function, G = 1 per
    member, under the vmap rule) on a stack of 2 against JAX's stack."""
    jms, tms, datas = [], [], []
    for f in range(2):
        split = _tiny_split(seed=30 + f)
        jm, tm, _ = models("classifier", split=split)
        for k in tm.gp.kernels:
            k.use_kernel = True
        jms.append(jm)
        tms.append(tm)
        datas.append((split.Xtrain, (split.Ytrain > 0).astype(np.float64)))
    kw = dict(num_iter=8, batch_size=B, num_inner=4, learning_rate=LR, seeds=[0, 1], log_every_blocks=0,
              log_fn=quiet)
    members_close(fit_batched_scanned(tms, datas, **kw), jbatched.fit_batched_scanned(jms, datas, **kw))


def test_the_tiny_builders_agree():
    """The JAX and port builders the cases above start from give the same
    raws for every member seed (the comparison's premise)."""
    for f in range(2):
        split = _tiny_split(seed=10 + f)

        jm = jbuilders.build_onoff_pptr(_tiny("OnOffPptrConfig", jconfigs), _jsplit(split))
        tm = tbuilders.build_onoff_pptr(_tiny("OnOffPptrConfig", tconfigs), split, **CPU64)
        got, want = dump_arrays(tm), _jraws(jm)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-14, err_msg=k)
