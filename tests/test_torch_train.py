"""The port's training slice against the JAX package, on the CPU.

The same numpy-seeded inputs go through both packages in float64 (the
repository's conftest turns on JAX's x64):

- the three KLs at rtol 1e-12 (the same formulas on the same factors);
- the on/off ELBO of the golden fixture (``tests/test_golden.py:32-68``)
  equals ``GOLDEN_KRON_ONOFF_ELBO`` at rtol 1e-10, paired and unpaired;
- the ELBO's gradient of every raw against ``jax.grad`` at rtol 1e-8: the
  port's chol_inv backward is the JAX custom VJP's matmul rule, and the two
  differ only in the order of summation;
- 20 scanned Adam steps against ``zigp_tpu.training.make_scan_train_step``
  on the same staged block, losses and final raws at rtol 1e-8;
- the optimizer's NaN and inf handling, its groups and its cosine schedule
  against optax, and the ``DataSet`` batches against the JAX ``DataSet``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zigp_tpu.core import parameters as jparams
from zigp_tpu.likelihoods import OnOffGaussian as JOnOffGaussian
from zigp_tpu.models import KronOnOffSVGP as JKronOnOffSVGP
from zigp_tpu.ops import gauss_kl as jkl
from zigp_tpu.ops.kernels import RBF as JRBF
from zigp_tpu.training import make_optimizer as jmake_optimizer
from zigp_tpu.training import make_scan_train_step as jmake_scan_train_step
from zigp_tpu.training.data import DataSet as JDataSet
from zigp_tpu.training.optim import cosine_adam as jcosine_adam
from zigp_tpu_torch.core import parameters as tparams
from zigp_tpu_torch.experiments import configs as tconfigs
from zigp_tpu_torch.experiments.runners import train_onoff_pptr
from zigp_tpu_torch.io.convert import dump_arrays, jax_key, load_jax_arrays
from zigp_tpu_torch.io.datasets import synthetic_pptr
from zigp_tpu_torch.likelihoods import OnOffGaussian as TOnOffGaussian
from zigp_tpu_torch.models import KronOnOffSVGP as TKronOnOffSVGP
from zigp_tpu_torch.ops import gauss_kl as tkl
from zigp_tpu_torch.ops import linalg as tlinalg
from zigp_tpu_torch.ops.kernels import RBF as TRBF
from zigp_tpu_torch.training import (
    DataSet,
    StagedBlocks,
    cosine_adam,
    fit_scanned,
    make_optimizer,
    make_scan_train_step,
)
from zigp_tpu_torch.training.scan import block_seed

from .test_golden import GOLDEN_KRON_ONOFF_ELBO, _kron_fixture


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _jraws(jmodel):
    return {jax.tree_util.keystr(p): np.array(l) for p, l in jax.tree_util.tree_flatten_with_path(jmodel)[0]}


def _with_raws(jmodel, arrays):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jmodel)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(arrays[jax.tree_util.keystr(p)]) for p, _ in leaves]
    )


# ---------------------------------------------------------------------------
# the KLs
# ---------------------------------------------------------------------------


def _spd(rng, n):
    A = rng.randn(n, n)
    return A @ A.T + n * np.eye(n)


@pytest.mark.parametrize("white", [True, False])
@pytest.mark.parametrize("full", [False, True])
def test_gauss_kl_matches_jax(white, full):
    rng = np.random.RandomState(int(white) + 2 * int(full))
    M, L = 6, 2
    q_mu = rng.randn(2, M, L)
    q_sqrt = rng.randn(2, M, M, L) if full else 0.5 + rng.rand(2, M, L)
    K = None if white else np.stack([_spd(rng, M) for _ in range(2)])
    got = tkl.gauss_kl(_t(q_mu), _t(q_sqrt), None if white else _t(K))
    assert got.shape == (2,)
    for g in range(2):
        want = jkl.gauss_kl(jnp.asarray(q_mu[g]), jnp.asarray(q_sqrt[g]), None if white else jnp.asarray(K[g]))
        np.testing.assert_allclose(float(got[g]), float(want), rtol=1e-12)


def _factor_grams(rng, sizes):
    return [np.stack([_spd(rng, m) for _ in range(2)]) for m in sizes]


def test_gauss_kl_kron_matches_jax():
    rng = np.random.RandomState(5)
    sizes = (3, 4, 2)
    M = int(np.prod(sizes))
    Ks = _factor_grams(rng, sizes)
    q_mu = rng.randn(2, M, 1)
    q_sqrt = 0.3 + rng.rand(2, M, 1)
    got = tkl.gauss_kl_kron(_t(q_mu), _t(q_sqrt), [_t(K) for K in Ks])
    state = tuple(tuple(x) for x in zip(*[tlinalg.chol_inv(_t(K)) for K in Ks]))
    shared = tkl.gauss_kl_kron(_t(q_mu), _t(q_sqrt), factor_state=state)
    for g in range(2):
        want = jkl.gauss_kl_kron(jnp.asarray(q_mu[g]), jnp.asarray(q_sqrt[g]), [jnp.asarray(K[g]) for K in Ks])
        np.testing.assert_allclose(float(got[g]), float(want), rtol=1e-12)
        np.testing.assert_allclose(float(shared[g]), float(want), rtol=1e-12)


@pytest.mark.parametrize("white", [True, False])
def test_gauss_kl_kron_full_matches_jax(white):
    rng = np.random.RandomState(7 + int(white))
    sizes = (3, 5)
    M = int(np.prod(sizes))
    Ks = _factor_grams(rng, sizes)
    Cs = [rng.randn(2, m, m) for m in sizes]
    Cs[0][:, 1, 1] = 0.0  # the tiny clamp on log|diag C|
    q_mu = rng.randn(2, M, 1)
    got = tkl.gauss_kl_kron_full(_t(q_mu), [_t(C) for C in Cs], None if white else [_t(K) for K in Ks])
    for g in range(2):
        want = jkl.gauss_kl_kron_full(
            jnp.asarray(q_mu[g]), [jnp.asarray(C[g]) for C in Cs], None if white else [jnp.asarray(K[g]) for K in Ks]
        )
        assert np.isfinite(float(want))
        np.testing.assert_allclose(float(got[g]), float(want), rtol=1e-12)


@pytest.mark.parametrize("whiten", [False, True])
@pytest.mark.parametrize("q_cov", ["diag", "kron"])
def test_prior_kl_four_branches(whiten, q_cov):
    jm, tm = _pair_models(whiten=whiten, q_cov=q_cov, perturb=True)
    with torch.no_grad():
        np.testing.assert_allclose(float(tm.prior_kl()), float(jm.prior_kl()), rtol=1e-10)
        np.testing.assert_allclose(float(tm.f.prior_kl()), float(jm.f.prior_kl()), rtol=1e-10)


# ---------------------------------------------------------------------------
# the ELBO and its gradients
# ---------------------------------------------------------------------------


def _pair_models(*, whiten=False, q_cov="diag", perturb=False, kern_lr=None, golden_q_mu=True):
    """The golden Kron on/off fixture in both packages, with the JAX raws
    carried into the port; ``perturb`` moves every raw off its init by seeded
    noise (the frozen q_sqrt of the kron family stays)."""
    Zs, X, Y, q_mu, _ = _kron_fixture()
    jks = lambda v: [JRBF.create([0.5, 0.5], v, lr=kern_lr), JRBF.create([0.2], v, lr=kern_lr)]
    tks = lambda v: [TRBF.create([0.5, 0.5], v, lr=kern_lr), TRBF.create([0.2], v, lr=kern_lr)]
    kw = dict(num_data=100, jitter=1e-5, seed=0, whiten=whiten, q_cov=q_cov)
    jm = JKronOnOffSVGP.create(jks(1.0), Zs, jks(2.0), [Z.copy() for Z in Zs], JOnOffGaussian.create(0.01), **kw)
    tm = TKronOnOffSVGP.create(tks(1.0), Zs, tks(2.0), [Z.copy() for Z in Zs], TOnOffGaussian.create(0.01), **kw)
    arrays = _jraws(jm)
    if golden_q_mu:
        arrays[".f.q_mu.raw"] = q_mu
        arrays[".g.q_mu.raw"] = q_mu * 0.5
    if perturb:
        rng = np.random.RandomState(11)
        for k, a in arrays.items():
            if k.startswith(".likelihood"):
                continue
            scale = 0.02 if ".Zs" in k else 0.1
            if ".q_sqrt" in k and q_cov == "kron" and ".q_sqrt_factors" not in k:
                continue
            arrays[k] = a + scale * rng.randn(*a.shape)
    load_jax_arrays(tm, arrays)
    return _with_raws(jm, arrays), tm


def test_elbo_equals_golden_paired_and_unpaired():
    Zs, X, Y, q_mu, _ = _kron_fixture()
    _, tm = _pair_models()
    assert tm._pairable()
    with torch.no_grad():
        paired = float(tm.elbo(_t(X), _t(Y)))
        tm.pair_gps = False
        unpaired = float(tm.elbo(_t(X), _t(Y)))
    np.testing.assert_allclose(paired, GOLDEN_KRON_ONOFF_ELBO, rtol=1e-10)
    np.testing.assert_allclose(unpaired, GOLDEN_KRON_ONOFF_ELBO, rtol=1e-10)


def test_elbo_overrides_match_jax():
    """``num_data`` and a precomputed ``factor_state``, paired and unpaired."""
    Zs, X, Y, _, _ = _kron_fixture()
    jm, tm = _pair_models(perturb=True)
    want = float(jm.elbo(jnp.asarray(X), jnp.asarray(Y), num_data=37))
    with torch.no_grad():
        for pair in (True, False):
            tm.pair_gps = pair
            st = tm.factor_state()
            got = float(tm.elbo(_t(X), _t(Y), num_data=37, factor_state=st))
            np.testing.assert_allclose(got, want, rtol=1e-10)
            np.testing.assert_allclose(float(tm.loss(_t(X), _t(Y), num_data=37)), -want, rtol=1e-10)


def _grads_match(jm, tm, X, Y, rtol=1e-8):
    jg = _jraws(jax.jit(jax.grad(lambda m, x, y: m.elbo(x, y)))(jm, jnp.asarray(X), jnp.asarray(Y)))
    tm.zero_grad()
    tm.elbo(_t(X), _t(Y)).backward()
    checked = 0
    for name, p in tm.named_parameters():
        key = jax_key(name)
        if not p.requires_grad:
            assert p.grad is None, key
            continue
        want = jg[key]
        scale = np.abs(want).max()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=rtol, atol=rtol * 1e-3 * scale, err_msg=key)
        checked += 1
    return checked


@pytest.mark.parametrize("pair", [True, False])
def test_elbo_gradients_match_jax_golden_fixture(pair):
    Zs, X, Y, _, _ = _kron_fixture()
    jm, tm = _pair_models()
    tm.pair_gps = pair
    assert _grads_match(jm, tm, X, Y) == 17  # 2 × (2 kernels × 2 + 2 Zs + q_mu + q_sqrt) + noise


def test_elbo_gradients_match_jax_whitened_kron():
    Zs, X, Y, _, _ = _kron_fixture()
    jm, tm = _pair_models(whiten=True, q_cov="kron", perturb=True)
    assert _grads_match(jm, tm, X, Y) == 19  # q_sqrt frozen, two C factors per GP


def _chol_inv_reference(K):
    L = torch.linalg.cholesky(K)
    eye = torch.eye(K.shape[-1], dtype=K.dtype).expand_as(K)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def test_chol_inv_backward_matches_autograd_of_torch_linalg():
    rng = np.random.RandomState(3)
    K = _t(np.stack([_spd(rng, 9) for _ in range(2)]))
    dL, dLinv = _t(rng.randn(2, 9, 9)), _t(rng.randn(2, 9, 9))
    grads = []
    for fn in (tlinalg.chol_inv, _chol_inv_reference):
        Kr = K.clone().requires_grad_(True)
        L, Linv = fn(Kr)
        (g,) = torch.autograd.grad((L * dL).sum() + (Linv * dLinv).sum(), Kr)
        grads.append(g)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-9, atol=1e-12)
    for only in ("L", "Linv"):  # one output unused: its cotangent is None
        Kr = K.clone().requires_grad_(True)
        L, Linv = tlinalg.chol_inv(Kr)
        (g,) = torch.autograd.grad((L if only == "L" else Linv).sum(), Kr)
        Kr2 = K.clone().requires_grad_(True)
        L2, Linv2 = _chol_inv_reference(Kr2)
        (g2,) = torch.autograd.grad((L2 if only == "L" else Linv2).sum(), Kr2)
        np.testing.assert_allclose(g.numpy(), g2.numpy(), rtol=1e-9, atol=1e-12)


def test_chol_inv_grads_through_gram_match_autograd():
    """Gradients of inducing locations through gram -> chol_inv -> the
    downstream algebra, as ``tests/test_pallas.py:160-183`` checks the JAX
    custom VJP."""
    rng = np.random.RandomState(4)
    Z0 = rng.randn(2, 7, 2)

    def build(Z):
        d = torch.sum((Z[..., :, None, :] - Z[..., None, :, :]) ** 2, -1)
        return torch.exp(-0.5 * d) + 0.1 * torch.eye(7, dtype=Z.dtype)

    def f(Z, fn):
        L, Linv = fn(build(Z))
        return torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1))) + torch.sum(torch.square(Linv @ Z))

    out = []
    for fn in (tlinalg.chol_inv, _chol_inv_reference):
        Z = _t(Z0).requires_grad_(True)
        v = f(Z, fn)
        (g,) = torch.autograd.grad(v, Z)
        out.append((v.item(), g.numpy()))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-10)
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=1e-8, atol=1e-10)


# ---------------------------------------------------------------------------
# the optimizer and the scanned steps
# ---------------------------------------------------------------------------


def _staged_block(K=20, B=16, seed=0):
    """K minibatches of the golden fixture's inputs, drawn with numpy."""
    Zs, X, Y, _, _ = _kron_fixture()
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, X.shape[0], size=(K, B))
    return X[idx], Y[idx]


@pytest.mark.parametrize(
    "case", ["golden", "golden_cosine", "kron_lr_groups_frozen_q_sqrt"]
)
def test_scan_train_steps_match_jax(case):
    if case.startswith("golden"):
        jm, tm = _pair_models()
    else:  # kernels in their own lr group, q_sqrt frozen (kron family), whitened
        jm, tm = _pair_models(whiten=True, q_cov="kron", perturb=True, kern_lr=1e-2)
    sched = case == "golden_cosine"
    jopt = jmake_optimizer(jm, default_lr=1e-3, **({"opt_factory": jcosine_adam(20)} if sched else {}))
    topt = make_optimizer(tm, default_lr=1e-3, schedule=cosine_adam(20) if sched else None)
    if case.startswith("kron"):
        assert sorted(g["label"] for g in topt.adam.param_groups) == ["default", "lr:0.01"]
        assert not tm.f.q_sqrt.raw.requires_grad
    Xs, Ys = _staged_block()
    before = _jraws(jm)  # the JAX step donates the model's buffers
    jm2, _, jlosses = jmake_scan_train_step(jopt, unroll=1)(jm, jopt.init(jm), jnp.asarray(Xs), jnp.asarray(Ys))
    tlosses = make_scan_train_step(topt)(tm, _t(Xs), _t(Ys))
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=1e-8)
    assert abs(float(tlosses[-1]) - float(tlosses[0])) > 1e-3 * abs(float(tlosses[0]))  # it trained
    want = _jraws(jm2)
    for key, got in dump_arrays(tm).items():
        np.testing.assert_allclose(got, want[key], rtol=1e-8, atol=1e-12, err_msg=key)
    if case.startswith("kron"):
        np.testing.assert_array_equal(dump_arrays(tm)[".f.q_sqrt.raw"], before[".f.q_sqrt.raw"])


def test_lr_labels_and_groups_match_jax():
    jm, tm = _pair_models(whiten=True, q_cov="kron", kern_lr=1e-2)
    jlabels = _jraws(jax.tree_util.tree_map(np.asarray, jparams.lr_labels(jm)))
    tlabels = {jax_key(k): v for k, v in tparams.lr_labels(tm).items()}
    assert tlabels == {k: str(v) for k, v in jlabels.items()}
    assert tparams.collect_lrs(tm, 1e-3) == jparams.collect_lrs(jm, 1e-3)


def test_zero_nans_zeroes_nan_only_as_optax():
    p = tparams.param(np.zeros(3))
    opt = make_optimizer(p, default_lr=0.1)
    g = np.array([np.nan, np.inf, 1.0])
    p.raw.grad = _t(g).clone()
    opt.step()
    tx = optax.chain(optax.zero_nans(), optax.adam(0.1))
    upd, _ = tx.update(jnp.asarray(g), tx.init(jnp.zeros(3)))
    want = np.asarray(optax.apply_updates(jnp.zeros(3), upd))
    assert p.raw.grad[0] == 0.0 and p.raw.grad[1] == np.inf
    np.testing.assert_allclose(p.raw.detach().numpy(), want, rtol=1e-12)
    raw = p.raw.detach().numpy()
    assert raw[0] == 0.0 and np.isnan(raw[1]) and np.isnan(want[1])


@pytest.mark.parametrize("warmup", [0, 5])
def test_cosine_schedule_matches_optax(warmup):
    lr, total = 3e-3, 30
    if warmup:
        sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total, end_value=lr * 0.01)
    else:
        sched = optax.cosine_decay_schedule(lr, total, alpha=0.01)
    p = tparams.param(np.ones(2))
    opt = make_optimizer(p, default_lr=lr, schedule=cosine_adam(total, warmup=warmup))
    for step in range(total + 5):
        np.testing.assert_allclose(opt.adam.param_groups[0]["lr"], float(sched(step)), rtol=1e-12, atol=1e-18)
        p.raw.grad = torch.ones(2, dtype=torch.float64)
        opt.step()


def test_dataset_batches_match_jax_across_epochs():
    rng = np.random.RandomState(2)
    x, y = rng.randn(25, 3), rng.randn(25, 1)
    jd, td = JDataSet(x, y, seed=5), DataSet(x, y, seed=5)
    for _ in range(10):  # 70 rows: two epoch wraps
        (jx, jy), (tx, ty) = jd.next_batch(7), td.next_batch(7)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    assert td.epochs_completed == jd.epochs_completed == 2


# ---------------------------------------------------------------------------
# the device sampler, fit_scanned and the training entry
# ---------------------------------------------------------------------------


def test_device_sampler_is_one_gather_of_seeded_indices():
    """A device-sampled block (``StagedBlocks.fill``) holds the rows its
    block's seeded generator picks, in one gather; the scanned step on it
    equals the step on those rows; the same block picks the same rows."""
    Zs, X, Y, _, _ = _kron_fixture()
    _, tm = _pair_models()
    _, tm2 = _pair_models()
    blocks = StagedBlocks(DataSet(X, Y), "device", 8, 5, device="cpu", dtype=torch.float64, sampler_seed=3)
    blocks.fill(7)
    losses = make_scan_train_step(make_optimizer(tm))(tm, blocks.Xs, blocks.Ys)
    idx = torch.randint(0, X.shape[0], (40,), generator=torch.Generator().manual_seed(block_seed(3, 7)))
    ref = make_scan_train_step(make_optimizer(tm2))(tm2, _t(X)[idx].reshape(5, 8, 3), _t(Y)[idx].reshape(5, 8, 1))
    np.testing.assert_array_equal(losses.numpy(), ref.numpy())
    first = blocks.Xs.clone()
    blocks.fill(8)
    assert not torch.equal(blocks.Xs, first)
    blocks.fill(7)
    assert torch.equal(blocks.Xs, first)


def _small_cfg(**kw):
    cfg = tconfigs.OnOffPptrConfig(grid=tconfigs.KronGridConfig(4, 12), num_iter=30, scan_inner=10, batch_size=32,
                                   log_every=10)
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_train_onoff_pptr_runs_on_cpu(sampler):
    split = synthetic_pptr(8, 24, seed=0)
    logs = []
    res = train_onoff_pptr(_small_cfg(sampler=sampler), split, device="cpu", dtype=torch.float64,
                           log_fn=logs.append)
    assert res.step_losses.shape == (30,) and torch.isfinite(res.step_losses).all()
    assert len(res.losses) == len(logs) == 3
    assert res.final_loss == float(res.step_losses[-1])


def test_train_onoff_pptr_host_sampler_matches_fit_scanned_on_staged_batches():
    """The entry's host sampler is the JAX package's DataSet schedule."""
    split = synthetic_pptr(8, 24, seed=0)
    cfg = _small_cfg(num_iter=20)
    res = train_onoff_pptr(cfg, split, device="cpu", dtype=torch.float64, log_fn=lambda s: None)
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr

    model = build_onoff_pptr(cfg, split, device="cpu", dtype=torch.float64)
    jd = JDataSet(split.Xtrain, split.Ytrain, seed=121)
    xs, ys = zip(*[jd.next_batch(cfg.batch_size) for _ in range(20)])
    ref = make_scan_train_step(make_optimizer(model, default_lr=cfg.indp_lr))(model, _t(np.stack(xs)), _t(np.stack(ys)))
    np.testing.assert_allclose(res.step_losses.numpy(), ref.numpy(), rtol=1e-12)


def test_fit_scanned_raises_on_a_non_finite_end():
    _, tm = _pair_models()
    x, y = _kron_fixture()[1:3]
    with pytest.raises(FloatingPointError):
        fit_scanned(tm, DataSet(x, y * np.nan), num_iter=2, batch_size=4, num_inner=2, log_fn=lambda s: None)
