"""The port's natural-gradient training against the JAX package's, on the
CPU in float64.

- ``natgrad_update_diag``, ``_mean_kron`` and ``_block_kron`` at rtol 1e-10
  for every p of a 2- and a 3-factor grid, with and without ``kl_cap``, on
  a sign-flipped C_p, and on a step out of the positive-definite cone that
  must revert; the joint step stacked for a pair (G = 2) equals the two
  separate steps;
- the Cholesky pullback (``ops.linalg.chol_vjp``) against ``jax.vjp`` of
  ``jnp.linalg.cholesky`` at rtol 1e-10;
- ``gamma_schedule`` bit for bit;
- K staged natural steps (diagonal, mean-only Kronecker, ``kron_joint``)
  against ``NaturalGradientTrainer.make_scan_step`` at rtol 1e-8, and the
  device ``hyper_every`` block against ``make_device_scan_step`` on JAX's
  rows; the factorizations a step makes, counted through
  ``ops.linalg.chol_inv_forward`` (none from the loss of a q-only step);
- ``fit_natgrad_scanned`` (Adam warm-start, γ ramp, ``kron_joint``, the
  device sampler) against the JAX run, and the production scenarios of
  ``tests/test_natgrad_production.py``: checkpoints and metrics, NaN
  restore, resume equal to the uninterrupted run (both samplers), the
  completed-run no-op, Ctrl-C, the silent-NaN raise, small budgets and the
  validation errors;
- ``_fit_auto`` routes ``optimizer="natgrad"`` (``kron_joint`` on and off,
  with and without ``hyper_every``) for the on/off, SVGP, classifier and
  joint hurdle configs, with the JAX runner's guard rails.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.likelihoods import Gaussian as JGaussian
from zigp_tpu.models import KronSVGP as JKronSVGP
from zigp_tpu.ops.kernels import RBF as JRBF
from zigp_tpu.training import natgrad as jng
from zigp_tpu.training.data import DataSet as JDataSet
from zigp_tpu_torch.experiments import runners as trunners
from zigp_tpu_torch.io.checkpoint import CheckpointManager, restore
from zigp_tpu_torch.io.convert import load_jax_arrays
from zigp_tpu_torch.likelihoods import Gaussian as TGaussian
from zigp_tpu_torch.models import KronSVGP as TKronSVGP
from zigp_tpu_torch.ops import linalg as tlinalg
from zigp_tpu_torch.ops.kernels import RBF as TRBF
from zigp_tpu_torch.training import DataSet
from zigp_tpu_torch.training import natgrad as tng
from zigp_tpu_torch.utils.logging import MetricLogger

from .test_torch_alternating import _route_cfg, close_to_jax, jax_rows, models
from .test_torch_train import _jraws
from .torch_helpers import jax_scan_unroll, one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _lean_run():
    """One torch thread, and the JAX anchors' scans compiled at unroll 1
    (``torch_helpers.one_torch_thread``, ``jax_scan_unroll``)."""
    with one_torch_thread(), jax_scan_unroll(1):
        yield


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _spd(rng, n):
    A = rng.randn(n, n)
    return A @ A.T + n * np.eye(n)


# ---------------------------------------------------------------------------
# the three natural steps, the Cholesky pullback, the γ schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_mean_step", [0.0, 10.0])
def test_update_diag_matches_jax(max_mean_step):
    rng = np.random.RandomState(0)
    M = 40
    m, s = rng.randn(M, 1), 0.2 + rng.rand(M, 1)
    gm, gs = 5 * rng.randn(M, 1), 5 * rng.randn(M, 1)
    gs[3, 0], gm[7, 0] = np.nan, np.inf  # the fallbacks
    for lr in (0.01, 0.5, 30.0):  # the last hits the variance clamp and the precision bound
        want = jng.natgrad_update_diag(jnp.asarray(m), jnp.asarray(s), jnp.asarray(gm), jnp.asarray(gs), lr,
                                       max_mean_step=max_mean_step)
        got = tng.natgrad_update_diag(_t(m), _t(s), _t(gm), _t(gs), lr, max_mean_step=max_mean_step)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10)


@pytest.mark.parametrize("sizes", [(3, 4), (2, 3, 2)], ids=["2 factors", "3 factors"])
@pytest.mark.parametrize("kl_cap", [None, 0.5])
def test_update_mean_kron_matches_jax(sizes, kl_cap):
    rng = np.random.RandomState(1)
    M = int(np.prod(sizes))
    Cs = [np.linalg.cholesky(_spd(rng, n)) * 0.3 for n in sizes]
    m, g = rng.randn(M, 1), rng.randn(M, 1)
    for lr in (0.01, 1.0):
        want = jng.natgrad_update_mean_kron(jnp.asarray(m), [jnp.asarray(C) for C in Cs], jnp.asarray(g), lr,
                                            max_mean_step=10.0, kl_cap=kl_cap)
        got = tng.natgrad_update_mean_kron(_t(m), [_t(C) for C in Cs], _t(g), lr, max_mean_step=10.0, kl_cap=kl_cap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)


def _block_case(rng, sizes, p, flip):
    Cs = [np.linalg.cholesky(_spd(rng, n) / n) for n in sizes]
    if flip:  # the tril raw leaves the diagonal's sign free
        Cs[p] = Cs[p] * np.where(np.arange(sizes[p]) % 2, -1.0, 1.0)[None, :]
    M = int(np.prod(sizes))
    return Cs, rng.randn(M, 1), 0.3 * rng.randn(M, 1), 0.3 * rng.randn(sizes[p], sizes[p])


@pytest.mark.parametrize("sizes", [(3, 4), (2, 3, 2)], ids=["2 factors", "3 factors"])
@pytest.mark.parametrize("kl_cap", [None, 0.05], ids=["no cap", "cap"])
def test_update_block_kron_matches_jax(sizes, kl_cap):
    """Every p, a plain and a sign-flipped C_p, γ small and large: where the
    cap binds, the refinement's second map-back is taken."""
    rng = np.random.RandomState(2)
    for p in range(len(sizes)):
        for flip in (False, True):
            Cs, m, gm, gC = _block_case(rng, sizes, p, flip)
            for lr in (0.02, 0.4):
                want = jng.natgrad_update_block_kron(jnp.asarray(m), [jnp.asarray(C) for C in Cs], p,
                                                     jnp.asarray(gm), jnp.asarray(gC), lr, max_mean_step=10.0,
                                                     kl_cap=kl_cap)
                got = tng.natgrad_update_block_kron(_t(m), [_t(C) for C in Cs], p, _t(gm), _t(gC), lr,
                                                    max_mean_step=10.0, kl_cap=kl_cap)
                for a, b in zip(got, want):
                    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-13,
                                               err_msg=f"p={p} flip={flip} lr={lr}")


def test_update_block_kron_out_of_the_cone_reverts():
    """A step that leaves the positive-definite cone (a large γ, no KL
    budget) keeps the previous (m, C_p) in both packages."""
    rng = np.random.RandomState(3)
    Cs, m, gm, gC = _block_case(rng, (3, 4), 1, False)
    want = jng.natgrad_update_block_kron(jnp.asarray(m), [jnp.asarray(C) for C in Cs], 1, jnp.asarray(gm),
                                         jnp.asarray(20 * gC), 1e4)
    got = tng.natgrad_update_block_kron(_t(m), [_t(C) for C in Cs], 1, _t(gm), _t(20 * gC), 1e4)
    A = np.linalg.inv(Cs[1] @ Cs[1].T)
    D = np.asarray(tlinalg.chol_vjp(*tlinalg.chol_inv_forward(_t(Cs[1] @ Cs[1].T)), _t(np.tril(20 * gC))))
    assert np.linalg.eigvalsh(A + (2 * 1e4 / 3) * 0.5 * (D + D.T)).min() < 0  # the raw step is not PD
    np.testing.assert_array_equal(got[0].numpy(), m)
    np.testing.assert_array_equal(got[1].numpy(), np.tril(Cs[1]))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_update_block_kron_stacked_pair_equals_two_calls():
    rng = np.random.RandomState(4)
    cases = [_block_case(rng, (3, 4), 0, flip) for flip in (False, True)]
    stack = lambda xs: torch.stack([_t(x) for x in xs])
    got = tng.natgrad_update_block_kron(stack([c[1] for c in cases]), [stack([c[0][q] for c in cases]) for q in (0, 1)],
                                        0, stack([c[2] for c in cases]), stack([c[3] for c in cases]),
                                        torch.tensor(0.3, dtype=torch.float64), max_mean_step=10.0, kl_cap=0.05)
    for i, (Cs, m, gm, gC) in enumerate(cases):
        one = tng.natgrad_update_block_kron(_t(m), [_t(C) for C in Cs], 0, _t(gm), _t(gC), 0.3, max_mean_step=10.0,
                                            kl_cap=0.05)
        for a, b in zip(got, one):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("n", [1, 4, 9])
def test_cholesky_pullback_matches_jax_vjp(n):
    rng = np.random.RandomState(n)
    K, G = _spd(rng, n), rng.randn(n, n)
    _, vjp = jax.vjp(jnp.linalg.cholesky, jnp.asarray(K))
    want = np.asarray(vjp(jnp.asarray(np.tril(G)))[0])
    L, Linv = tlinalg.chol_inv_forward(_t(K))
    np.testing.assert_allclose(tlinalg.chol_vjp(L, Linv, _t(np.tril(G))).numpy(), want, rtol=1e-10, atol=1e-14)


def test_chol_inv_forward_gives_nan_on_a_non_pd_matrix():
    K = _t(np.array([[1.0, 2.0], [2.0, 1.0]]))
    L, Linv = tlinalg.chol_inv_forward(torch.stack([K, torch.eye(2, dtype=torch.float64)]))
    assert torch.isnan(L[0]).all() and torch.isnan(Linv[0]).all() and torch.equal(L[1], torch.eye(2).double())


@pytest.mark.parametrize("gamma, warmup, gamma_init", [(0.1, 2000, 1e-4), (0.5, 37, 1e-3), (1.0, 0, 1e-4)])
def test_gamma_schedule_is_jax_bit_for_bit(gamma, warmup, gamma_init):
    steps = np.arange(0, warmup + 60)
    want = np.asarray(jng.gamma_schedule(jnp.asarray(steps, jnp.int32), gamma=gamma, warmup=warmup,
                                         gamma_init=gamma_init))
    got = tng.gamma_schedule(steps, gamma=gamma, warmup=warmup, gamma_init=gamma_init)
    assert got.dtype == np.float32 == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the trainer's blocks
# ---------------------------------------------------------------------------

FAMILIES = {
    "diag": (dict(), dict()),
    "mean kron": (dict(q_cov="kron", whiten=True), dict()),
    "kron_joint": (dict(q_cov="kron", whiten=True), dict(kron_joint=True)),
}
TRAINER = dict(gamma=0.05, adam_lr=1e-2, gamma_warmup=6, gamma_init=1e-3, max_mean_step=10.0, kl_cap=10.0)

# Where the KL budget binds, the joint step's pre-scale lands the candidate's
# exact KL within about 1e-8 of the cap, and whether the refinement maps back
# once more (its ``lax.cond`` on rescale < 1, a move of the same 1e-8) is
# decided by rounding: the JAX package's own jitted and eager steps then part
# at about 1e-8 on this fixture (a step of the kron_joint block). The port
# takes the eager JAX step's operations in its order and matches it at about
# 1e-16 a step, so the joint blocks are held against the JAX trainer's steps
# with its natural step run with jit off (``jax_steps``; its gradients and
# Adam stay jitted); ``test_update_block_kron_matches_jax`` holds the step
# itself, cap binding, at rtol 1e-10. The other families run the JAX
# package's jitted blocks whole.


def jax_steps(jt, model, Xs, Ys, gammas, steps, hyper_every=0):
    """The JAX trainer's block, step for step: ``_step_body`` (and with
    ``hyper_every`` the groups of ``make_device_scan_step``'s block: the
    factor state, then ``_q_only_step``), each gradient and Adam update
    jitted, each natural step (``_natgrad_apply``) run with jit off (see
    REFINEMENT_AT_THE_CAP). Returns (model, losses)."""
    import optax

    from zigp_tpu.training.alternating import partition_model as jpartition

    def natural(m, grads, k):
        with jax.disable_jit():
            return jt._natgrad_apply(m, grads, gammas[k], int(steps[k]))

    _, _, merge = jpartition(model)
    vg = jax.jit(jax.value_and_grad(lambda m, X, Y: m.loss(X, Y)))
    qvg = jax.jit(jax.value_and_grad(lambda q, h, X, Y, st: merge(q, h).loss(X, Y, factor_state=st)))
    adam = jax.jit(jt.adam.update)
    factor_state = jax.jit(lambda m: jax.lax.stop_gradient(m.factor_state()))
    state, losses, H = jt.init(model), [], hyper_every or 1
    for g0 in range(0, Xs.shape[0], H):
        loss, grads = vg(model, Xs[g0], Ys[g0])
        updates, state = adam(grads, state, model)
        model = natural(optax.apply_updates(model, updates), grads, g0)
        losses.append(loss)
        if hyper_every:
            st = factor_state(model)
        for k in range(g0 + 1, g0 + H):
            q, h, merge = jpartition(model)
            loss, gq = qvg(q, h, Xs[k], Ys[k], st)
            model = natural(model, merge(gq, jax.tree_util.tree_map(jnp.zeros_like, h)), k)
            losses.append(loss)
    return model, np.asarray(losses)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_staged_block_matches_make_scan_step(family, monkeypatch):
    """K steps on one staged block at the ramp's γ: the losses and every
    raw at rtol 1e-8; each step's factorizations counted (the joint step's
    four a factor pair: chol Σ_p, two map-backs, chol Σ′)."""
    model_kw, trainer_kw = FAMILIES[family]
    jm, tm, split = models("onoff", **model_kw)
    K, Bn = 4, 16
    rng = np.random.RandomState(5)
    idx = rng.randint(0, split.Xtrain.shape[0], K * Bn)
    Xs, Ys = split.Xtrain[idx].reshape(K, Bn, -1), split.Ytrain[idx].reshape(K, Bn, -1)
    jt = jng.NaturalGradientTrainer(jm, **TRAINER, **trainer_kw)
    steps = np.arange(1, 1 + K)
    if family == "kron_joint":  # see REFINEMENT_AT_THE_CAP
        jout, jlosses = jax_steps(jt, jm, jnp.asarray(Xs), jnp.asarray(Ys), jt.gamma_at(jnp.asarray(steps)), steps)
    else:
        jout, _, jlosses = jt.make_scan_step()(jm, jt.init(jm), jnp.asarray(Xs), jnp.asarray(Ys),
                                               jt.gamma_at(jnp.asarray(steps, jnp.int32)),
                                               jnp.asarray(steps, jnp.int32))
    calls = []
    forward = tlinalg.chol_inv_forward
    monkeypatch.setattr(tlinalg, "chol_inv_forward", lambda A: calls.append(A.shape) or forward(A))
    tt = tng.NaturalGradientTrainer(tm, **TRAINER, **trainer_kw)
    losses = tt.block(_t(Xs), _t(Ys), torch.from_numpy(tt.gamma_at(steps)), start=1)  # γ float32, as in JAX
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-8)
    close_to_jax(tm, jout)
    per_step = 2 + (4 if family == "kron_joint" else 0)  # the loss's two factors, the joint step's four
    assert len(calls) == K * per_step and all(s[0] == 2 for s in calls)  # f and g stacked in every call


@pytest.mark.parametrize("family", ["diag", "kron_joint"])
def test_device_hyper_every_block_matches_make_device_scan_step(family, monkeypatch):
    """K = 8 in two groups of 4 (a full step, the factor state, three
    natural q-only steps) on JAX's rows: rtol 1e-8; a q-only step's loss
    factors nothing, its natural step what the family's step needs."""
    model_kw, trainer_kw = FAMILIES[family]
    jm, tm, split = models("onoff", **model_kw)
    K, Bn, H = 8, 16, 4
    X, Y = split.Xtrain, split.Ytrain
    jt = jng.NaturalGradientTrainer(jm, **TRAINER, **trainer_kw)
    steps = np.arange(2, 2 + K)
    idx = jax_rows([1, 7], K * Bn, X.shape[0])
    if family == "kron_joint":  # see REFINEMENT_AT_THE_CAP
        jout, jlosses = jax_steps(jt, jm, jnp.asarray(X[idx].reshape(K, Bn, -1)), jnp.asarray(Y[idx].reshape(K, Bn, -1)),
                                  jt.gamma_at(jnp.asarray(steps)), steps, hyper_every=H)
    else:
        jout, _, jlosses = jt.make_device_scan_step(jnp.asarray(X), jnp.asarray(Y), Bn, hyper_every=H)(
            jm, jt.init(jm), jnp.asarray(np.array([1, 7], np.uint32)), jt.gamma_at(jnp.asarray(steps, jnp.int32)),
            jnp.asarray(steps, jnp.int32))
    calls = []
    forward = tlinalg.chol_inv_forward
    monkeypatch.setattr(tlinalg, "chol_inv_forward", lambda A: calls.append(A.shape) or forward(A))
    tt = tng.NaturalGradientTrainer(tm, **TRAINER, **trainer_kw)
    hyper = [raw for raw in tm.parameters() if raw.requires_grad and all(raw is not p for p in tt.natural.params)]
    snap = []
    q_only = tt.q_only_step

    def watched(*a, **kw):
        snap.append((len(calls), [r.detach().clone() for r in hyper]))
        out = q_only(*a, **kw)
        snap.append((len(calls), [r.detach().clone() for r in hyper]))
        return out

    monkeypatch.setattr(tt, "q_only_step", watched)
    losses = tt.block(_t(X[idx].reshape(K, Bn, -1)), _t(Y[idx].reshape(K, Bn, -1)), torch.from_numpy(tt.gamma_at(steps)), start=2,
                      hyper_every=H)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-8)
    close_to_jax(tm, jout)
    natural = 4 if family == "kron_joint" else 0
    for (before, h0), (after, h1) in zip(snap[::2], snap[1::2]):
        assert after - before == natural  # the loss of a q-only step factors nothing
        assert all(torch.equal(a, b) for a, b in zip(h0, h1))
    # two groups: the full step's loss (2) and natural step, the factor state (2), three q-only natural steps
    assert len(calls) == 2 * (2 + natural + 2 + 3 * natural)


# ---------------------------------------------------------------------------
# fit_natgrad_scanned
# ---------------------------------------------------------------------------


def _svgp(N, seed=0, pkg="t", **kw):
    """The JAX production tests' small KronSVGP, in either package, on the
    same init."""
    rng = np.random.RandomState(seed)
    Zs = [rng.rand(3, 2), np.linspace(0, 1, 5)[:, None]]
    if pkg == "j":
        ks = [JRBF.create([1.0, 1.0], 1.0), JRBF.create([0.3], 1.0)]
        return JKronSVGP.create(ks, Zs, JGaussian.create(0.1), num_data=N, jitter=1e-6, seed=seed, **kw)
    ks = [TRBF.create([1.0, 1.0], 1.0), TRBF.create([0.3], 1.0)]
    return TKronSVGP.create(ks, Zs, TGaussian.create(0.1), num_data=N, jitter=1e-6, seed=seed, **kw)


KW = dict(batch_size=16, num_inner=5, gamma=0.01, gamma_warmup=0, adam_warmup=0, log_fn=lambda s: None)


def _data(N, seed=0, nan=False):
    rng = np.random.RandomState(seed)
    X, Y = rng.rand(N, 3), rng.rand(N, 1)
    if nan:
        Y[:] = np.nan
    return X, Y


@pytest.mark.parametrize("case", ["diag host", "kron_joint device"])
def test_fit_natgrad_scanned_matches_jax(case, tmp_path, monkeypatch):
    """Warm-start, γ ramp, logs, checkpoints and the block keys of the JAX
    run: the losses and raws at rtol 1e-8 (the device sampler's rows JAX's)."""
    from zigp_tpu.io.checkpoint import CheckpointManager as JCheckpointManager
    from zigp_tpu_torch.training import scan as tscan

    device = "device" in case
    kw = dict(q_cov="kron", whiten=True) if "kron" in case else {}
    N = 60
    X, Y = _data(N, 1)
    jm, tm = _svgp(N, pkg="j", **kw), _svgp(N, **kw)
    load_jax_arrays(tm, _jraws(jm))
    if device:
        monkeypatch.setattr(tscan, "_draw", lambda g, seed, n, count: torch.from_numpy(
            jax_rows([seed >> 32, seed & 0xFFFFFFFF], count, n).copy()))
    args = dict(num_iter=30, batch_size=16, num_inner=6, gamma=0.05, gamma_warmup=10, gamma_init=1e-3,
                adam_lr=1e-2, adam_warmup=9, kron_joint="kron" in case, log_every_blocks=1,
                sampler="device" if device else "host", sampler_seed=3)
    jlogs, tlogs = [], []
    jres = jng.fit_natgrad_scanned(jm, JDataSet(X, Y, seed=2), log_fn=jlogs.append,
                                   ckpt_manager=JCheckpointManager(str(tmp_path / "j"), every=12), **args)
    tres = tng.fit_natgrad_scanned(tm, DataSet(X, Y, seed=2), log_fn=tlogs.append,
                                   ckpt_manager=CheckpointManager(str(tmp_path / "t"), every=12), **args)
    assert tlogs == [line for line in jlogs if "graph" not in line]
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-8)
    close_to_jax(tres.model, jres.model)


def test_natgrad_writes_checkpoints_and_metrics(tmp_path):
    N = 40
    X, Y = _data(N)
    mgr = CheckpointManager(str(tmp_path / "ck"), every=10)
    logger = MetricLogger(str(tmp_path / "m.jsonl"))
    tng.fit_natgrad_scanned(_svgp(N), DataSet(X, Y), num_iter=20, ckpt_manager=mgr, metric_logger=logger,
                            log_every_blocks=1, **KW)
    logger.close()
    assert mgr.latest_step() == 20
    import json

    records = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert records and all("gamma" in r and "elbo" in r for r in records)
    assert [r["step"] for r in records] == [5, 10, 15, 20]


def test_natgrad_recovers_from_nan(tmp_path):
    N = 30
    X, Y = _data(N)

    class Poisoned(DataSet):
        calls = 0

        def next_batch(self, b, shuffle=True):
            self.calls += 1
            bx, by = super().next_batch(b, shuffle)
            if self.calls == 15:  # the last batch of the 3rd block
                by = by.copy()
                by[0, 0] = np.nan
            return bx, by

    mgr = CheckpointManager(str(tmp_path / "ck"), every=5)
    logs = []
    res = tng.fit_natgrad_scanned(_svgp(N), Poisoned(X, Y, seed=0), num_iter=30, ckpt_manager=mgr,
                                  log_every_blocks=1, **{**KW, "log_fn": logs.append})
    assert "step       15  NON-FINITE loss" in logs and "restored from checkpoint at step 10" in logs
    assert all(torch.isfinite(p).all() for p in res.model.parameters())
    for d in os.listdir(mgr.directory):  # poisoned state never checkpointed
        m, _, _ = restore(os.path.join(mgr.directory, d), _svgp(N))
        assert all(torch.isfinite(p).all() for p in m.parameters())


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_natgrad_resume_reproduces_the_uninterrupted_run(tmp_path, sampler):
    N = 50
    X, Y = _data(N)
    kw = {**KW, "sampler": sampler, "sampler_seed": 5, "adam_warmup": 5, "gamma_warmup": 8}
    full = tng.fit_natgrad_scanned(_svgp(N), DataSet(X, Y, seed=7), num_iter=40, **kw)
    mgr = CheckpointManager(str(tmp_path / "ck"), every=20)
    tng.fit_natgrad_scanned(_svgp(N), DataSet(X, Y, seed=7), num_iter=20, ckpt_manager=mgr, **kw)
    assert mgr.latest_step() == 20
    resumed = tng.fit_natgrad_scanned(_svgp(N), DataSet(X, Y, seed=7), num_iter=40, ckpt_manager=mgr, resume=True,
                                      **kw)
    assert torch.equal(resumed.step_losses, full.step_losses[-resumed.step_losses.shape[0]:])
    for (n, a), b in zip(full.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), n


def test_natgrad_interrupt_checkpoints_and_flags(tmp_path):
    N = 50
    X, Y = _data(N)
    mgr = CheckpointManager(str(tmp_path / "ck"), every=1000)
    seen = {"n": 0}

    def exploding(msg):
        if "loss" in msg:
            seen["n"] += 1
            if seen["n"] == 3:
                raise KeyboardInterrupt
        seen["last"] = msg

    res = tng.fit_natgrad_scanned(_svgp(N), DataSet(X, Y, seed=7), num_iter=50, ckpt_manager=mgr,
                                  log_every_blocks=1, **{**KW, "log_fn": exploding})
    assert mgr.latest_step() == 15 and "interrupted" in seen["last"] and res.interrupted


def test_natgrad_raises_on_silent_nan_and_completed_resume_is_a_noop(tmp_path):
    N = 40
    with pytest.raises(FloatingPointError, match="non-finite"):
        tng.fit_natgrad_scanned(_svgp(N), DataSet(*_data(30, nan=True)), num_iter=10, log_every_blocks=0, **KW)
    X, Y = _data(N)
    mgr = CheckpointManager(str(tmp_path / "ck"), every=10)
    first = tng.fit_natgrad_scanned(_svgp(N), DataSet(X, Y), num_iter=20, ckpt_manager=mgr, **KW)
    logs = []
    again = tng.fit_natgrad_scanned(_svgp(N), DataSet(X, Y), num_iter=20, ckpt_manager=mgr, resume=True,
                                    **{**KW, "log_fn": logs.append})
    assert any("nothing to train" in line for line in logs) and mgr.latest_step() == 20
    for a, b in zip(first.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)
    assert np.isfinite(again.final_loss) and again.step_losses is None


def test_natgrad_small_budgets_and_validation_errors():
    N = 40
    X, Y = _data(N)
    # a budget of 12 with a 1000-step warm-up: 6 Adam steps, then 6 natural steps in one block
    res = tng.fit_natgrad_scanned(_svgp(N), DataSet(X, Y), num_iter=12, batch_size=8, num_inner=50, gamma=0.01,
                                  adam_warmup=1000, log_fn=lambda s: None)
    assert res.step_losses.shape == (6,) and np.isfinite(res.final_loss)
    kw = dict(num_iter=8, batch_size=8, num_inner=4, gamma=0.01, gamma_warmup=0, adam_warmup=0,
              log_fn=lambda s: None)
    with pytest.raises(ValueError, match="sampler='device'"):
        tng.fit_natgrad_scanned(_svgp(N), DataSet(X, Y), hyper_every=4, **kw)
    with pytest.raises(ValueError, match="divide"):
        tng.fit_natgrad_scanned(_svgp(N), DataSet(X, Y), sampler="device", hyper_every=3, **kw)
    with pytest.raises(ValueError, match="hyper_every must be"):
        tng.fit_natgrad_scanned(_svgp(N), DataSet(X, Y), sampler="device", hyper_every=1, **kw)

    class Dense(torch.nn.Module):  # a model without the Kronecker factor state
        def loss(self, X, Y):
            return torch.zeros(())

    with pytest.raises(ValueError, match="Kron-family"):
        tng.fit_natgrad_scanned(Dense(), DataSet(X, Y), sampler="device", hyper_every=4, **kw)
    tt = tng.NaturalGradientTrainer(_svgp(N), kl_cap=0.0)
    assert tt.kl_cap is None and tng.NaturalGradientTrainer(_svgp(N), kl_cap=-1.0).kl_cap is None


def test_natgrad_adam_is_one_group_without_the_variational_raws():
    """The JAX trainer's ``optax.adam(adam_lr)`` over every trainable raw
    but the natural step's: per-parameter lrs do not apply; in the mean
    mode the covariance factors train under Adam, in the joint mode under
    the natural step."""
    jm, tm, _ = models("onoff", q_cov="kron", whiten=True, kern_lr=0.5)
    for joint in (False, True):
        tt = tng.NaturalGradientTrainer(tm, adam_lr=3e-3, kron_joint=joint)
        assert [g["lr"].item() for g in tt.adam.adam.param_groups] == [3e-3]
        factors = [n for n in tt.adam.names if "q_sqrt_factors" in n]
        assert bool(factors) == (not joint)
        assert not any(".q_mu" in n or n.endswith("q_sqrt.raw") for n in tt.adam.names)


@pytest.mark.parametrize("kind", ["onoff", "svgp", "classifier", "hurdlej"])
@pytest.mark.parametrize("variant", ["diag", "kron_joint hyper_every"])
def test_fit_auto_routes_natgrad(kind, variant, tmp_path):
    kron = "kron" in variant
    cfg = _route_cfg(kind, optimizer="natgrad", natgrad_adam_warmup=10, natgrad_warmup=5, natgrad_gamma=0.05,
                     natgrad_kron_joint=kron, q_cov="kron" if kron else "diag", whiten=kron, ckpt_every=10,
                     sampler="device" if kron else "host", hyper_every=5 if kron else 0)
    _, tm, split = models(kind, perturb=False, q_cov=cfg.q_cov, whiten=kron)
    ds = DataSet(split.Xtrain, split.Ytrain if kind != "classifier" else (split.Ytrain > 0).astype(float))
    logs = []
    res = trunners._fit_auto(tm, ds, cfg, learning_rate=1e-2, log_fn=logs.append, kind=kind, workdir=str(tmp_path))
    assert res.step_losses.shape == (10,) and torch.isfinite(res.step_losses).all()
    assert sorted(os.listdir(tmp_path / f"ckpt_{kind}")) == ["step_0000000010", "step_0000000020"]
    assert os.path.exists(tmp_path / f"metrics_{kind}.jsonl")
    if kind == "onoff":
        again = trunners._fit_auto(tm, ds, cfg, learning_rate=1e-2, log_fn=logs.append, kind=kind,
                                   workdir=str(tmp_path), resume=True)
        assert "checkpoint is already at or past num_iter; nothing to train" in logs
        assert np.isfinite(again.final_loss)
        with pytest.raises(SystemExit, match="requires --sampler device"):
            trunners._fit_auto(tm, ds, dataclasses.replace(cfg, sampler="host", hyper_every=5), learning_rate=1e-2,
                               log_fn=lambda s: None, kind=kind)
        trunners._fit_auto(tm, ds, dataclasses.replace(cfg, q_cov="diag", natgrad_kron_joint=True, hyper_every=0),
                           learning_rate=1e-2, log_fn=logs.append, kind=kind)
        assert any("--natgrad-joint requires q_cov='kron'" in line for line in logs)
