"""The port's kernel zoo against the JAX package's, on the CPU in float64.

- Each family and composite (Matérn 1/2, 3/2, 5/2, periodic, rational
  quadratic, linear, white, constant, ``periodic*rbf``,
  ``periodic*rbf+linear``, ``active_dims``): K, the cross-gram and Kdiag at
  rtol 1e-12 and the gradients of every raw against ``jax.grad`` at rtol
  1e-9, on the same raws (``io.convert``); a stacked (2, ...) evaluation
  equal to two single ones; Matérn's gradient finite at r = 0 under autograd
  and under ``torch.func.vmap``.
- ``make_kernel`` of every ``_FAMILIES`` name and of the composites, with
  ``trust`` and a period, against the JAX package's: the tree, the values, the
  Sigmoid intervals and the optimizer groups.
- ``KronOnOffSVGP`` on a 3 × 8 grid with a ``periodic*rbf`` temporal
  factor: the ELBO at rtol 1e-10, gradients at rtol 1e-8, five scanned Adam
  steps at rtol 1e-8; an f of ``matern12`` and a g of ``matern52`` run
  unpaired, as in JAX; a same-family pair is one stacked pass, one
  ``chol_inv`` call per factor.
- One step of an F = 2 member stack with ``matern32`` equal to each
  member's own step; ``export_predictor`` of the ``periodic*rbf`` model
  against ``predict``; a warm zoo step that builds no tensor from host data.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.core import bijectors as jbij
from zigp_tpu.core.parameters import collect_lrs as jcollect_lrs
from zigp_tpu.core.parameters import lr_labels as jlr_labels
from zigp_tpu.experiments import builders as jbuilders
from zigp_tpu.experiments import configs as jconfigs
from zigp_tpu.ops import kernels as jk
from zigp_tpu.training import make_optimizer as jmake_optimizer
from zigp_tpu.training import make_scan_train_step as jmake_scan_train_step
from zigp_tpu_torch.core.parameters import collect_lrs, lr_labels
from zigp_tpu_torch.experiments import builders as tbuilders
from zigp_tpu_torch.experiments import configs as tconfigs
from zigp_tpu_torch.io.convert import dump_arrays, jax_key, load_jax_arrays
from zigp_tpu_torch.io.export import export_predictor, load_predictor
from zigp_tpu_torch.models.kron import _stack
from zigp_tpu_torch.ops import kernels as tk
from zigp_tpu_torch.ops import linalg as tlinalg
from zigp_tpu_torch.training import (
    DataSet,
    fit_batched_scanned,
    fit_scanned,
    make_optimizer,
    make_scan_train_step,
    stack_models,
    unstack_model,
)

from .test_torch_runners import _jsplit, _tiny, _tiny_split
from .test_torch_train import _jraws, _with_raws
from .torch_helpers import one_torch_thread_per_module  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

CPU64 = dict(device="cpu", dtype=torch.float64)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


# one jitted function for every JAX model of the file: compiled once per model structure
_jax_elbo_and_grad = jax.jit(jax.value_and_grad(lambda m, X, Y: m.elbo(X, Y)))


# ---------------------------------------------------------------------------
# family by family
# ---------------------------------------------------------------------------

ELL, VAR, PERIOD = [0.4, 0.7, 0.5], 1.3, [0.5, 0.9, 0.3]


def _pair(name):
    """The same kernel in both packages (JAX's, the port's), created with
    the same arguments; D = 3 inputs."""
    if name == "white":
        return jk.White.create(0.3), tk.White.create(0.3)
    if name == "constant":
        return jk.Constant.create(0.7), tk.Constant.create(0.7)
    if name.endswith("active_dims"):
        fam, dims = name.split(" ")[0], (0, 2)
        if fam == "rbf":
            return jk.RBF.create(ELL[:2], VAR, active_dims=dims), tk.RBF.create(ELL[:2], VAR, active_dims=dims)
        if fam == "matern32":
            return (jk.Matern.create(ELL[:2], VAR, nu="3/2", active_dims=dims),
                    tk.Matern.create(ELL[:2], VAR, nu="3/2", active_dims=dims))
        if fam == "periodic":
            return (jk.Periodic.create(ELL[:1], PERIOD[:1], VAR, active_dims=(2,)),
                    tk.Periodic.create(ELL[:1], PERIOD[:1], VAR, active_dims=(2,)))
        return (jk.Linear.create([0.5, 2.0], active_dims=(1, 2)), tk.Linear.create([0.5, 2.0], active_dims=(1, 2)))
    init = dict(lengthscales=tuple(ELL), variance=VAR, family=name, period=tuple(PERIOD), alpha=0.8)
    return (jbuilders.make_kernel(jconfigs.KernelInit(**init)),
            tbuilders.make_kernel(tconfigs.KernelInit(**init)))


FAMILIES = ["rbf", "matern12", "matern32", "matern52", "periodic", "rq", "linear", "white", "constant",
            "periodic*rbf", "periodic*rbf+linear", "matern32+rq*matern52", "rbf active_dims",
            "matern32 active_dims", "periodic active_dims", "linear active_dims"]


def _same_raws(name, seed=0):
    """The pair with the JAX raws moved off the init by seeded noise and
    carried into the port by name."""
    jkern, tkern = _pair(name)
    rng = np.random.RandomState(seed)
    arrays = {k: a + 0.2 * rng.randn(*np.shape(a)) for k, a in _jraws(jkern).items()}
    load_jax_arrays(tkern, arrays)
    return _with_raws(jkern, arrays), tkern


@pytest.mark.parametrize("name", FAMILIES)
def test_family_matches_jax(name):
    rng = np.random.RandomState(1)
    X, X2 = rng.rand(7, 3), rng.rand(5, 3)
    C1, C2, c3 = rng.randn(7, 7), rng.randn(7, 5), rng.randn(7)
    jkern, tkern = _same_raws(name)
    Xj, X2j = jnp.asarray(X), jnp.asarray(X2)

    def jloss(k):
        return (jnp.sum(k.K(Xj) * C1) + jnp.sum(k.K(Xj, X2j) * C2)
                + jnp.sum(jnp.broadcast_to(k.Kdiag(Xj), (7,)) * c3))

    jK, jKx, jKd, jgrads = jax.jit(lambda k: (k.K(Xj), k.K(Xj, X2j), k.Kdiag(Xj), jax.grad(jloss)(k)))(jkern)
    for got, want in ((tkern.K(_t(X)), jK), (tkern.K(_t(X), _t(X2)), jKx), (tkern.Kdiag(_t(X)), jKd)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12, atol=1e-15 * np.abs(want).max())
    jgrads = _jraws(jgrads)
    loss = (torch.sum(tkern.K(_t(X)) * _t(C1)) + torch.sum(tkern.K(_t(X), _t(X2)) * _t(C2))
            + torch.sum(tkern.Kdiag(_t(X)) * _t(c3)))
    loss.backward()
    for n, p in tkern.named_parameters():
        want = jgrads[jax_key(n)]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-9, atol=1e-12 * max(np.abs(want).max(), 1.0),
                                   err_msg=n)


@pytest.mark.parametrize("name", ["matern12", "periodic*rbf+linear", "white", "constant", "rbf active_dims"])
def test_stacked_evaluation_equals_single_ones(name):
    """The values of two kernels stacked on a leading dim of 2 (the f/g
    pair's layout) give the two grams at once: K_mm of per-kernel inputs,
    K_mn against inputs shared by the pair, and Kdiag."""
    ka, kb = _same_raws(name, 2)[1], _same_raws(name, 3)[1]
    rng = np.random.RandomState(4)
    Z, X = _t(rng.rand(2, 6, 3)), _t(rng.rand(9, 3))
    vals = _stack([ka.values(), kb.values()])
    flags = ka.kernel_flags()
    with torch.no_grad():
        for got, want in ((vals.K(Z, use_kernel=flags), [ka.K(Z[0]), kb.K(Z[1])]),
                          (vals.K(Z, X, use_kernel=flags), [ka.K(Z[0], X), kb.K(Z[1], X)]),
                          (vals.Kdiag(X), [ka.Kdiag(X), kb.Kdiag(X)])):
            np.testing.assert_allclose(got.numpy(), torch.stack(want).numpy(), rtol=1e-14, atol=1e-300)


@pytest.mark.parametrize("nu", ["1/2", "3/2", "5/2"])
def test_matern_gradient_finite_at_zero_distance_under_autograd_and_vmap(nu):
    """``tests/test_kernel_family.py``'s check: identical rows, so r = 0
    on every entry; the gradient of the lengthscales stays finite."""
    X = _t(np.repeat(np.random.RandomState(0).randn(1, 2), 4, axis=0))
    k = tk.Matern.create([1.0, 1.0], 1.0, nu=nu)
    torch.sum(k.K(X)).backward()
    assert torch.isfinite(k.lengthscales.raw.grad).all()
    nu2 = tk._NU2[nu]
    f = lambda ell, v: torch.sum(tk.MaternValues(ell, v, nu2).K(X))
    g = torch.func.vmap(torch.func.grad(f))(_t(np.ones((3, 2))), _t(np.ones(3)))
    assert torch.isfinite(g).all() and g.shape == (3, 2)


def test_signature_carries_the_family_tree_and_static_fields():
    m12, m52 = tk.Matern.create([1.0], 1.0, nu="1/2"), tk.Matern.create([1.0], 1.0, nu="5/2")
    assert m12.signature() != m52.signature()
    assert tk.RBF.create([1.0], 1.0, active_dims=(0,)).signature() != tk.RBF.create([1.0], 1.0).signature()
    on, off = tk.RBF.create([1.0], 1.0, use_kernel=True), tk.RBF.create([1.0], 1.0)
    assert tk.Product(tk.Periodic.create([1.0], [1.0], 1.0), on).kernel_flags() == (False, True)
    assert tk.flag_leaves(((False, True), False)) == [False, True, False]
    assert on.signature() != off.signature()


# ---------------------------------------------------------------------------
# make_kernel against the JAX package's
# ---------------------------------------------------------------------------

SPECS = sorted(tbuilders._FAMILIES) + ["periodic*rbf", "periodic*rbf+linear", "rq+matern12*periodic"]


def _tree(k):
    if isinstance(k, (jk.Sum, jk.Product, tk.Sum, tk.Product)):
        return type(k).__name__, _tree(k.k1), _tree(k.k2)
    return type(k).__name__.replace("SquaredExponential", "RBF")


@pytest.mark.parametrize("trust", [0.0, 4.0])
@pytest.mark.parametrize("spec", SPECS)
def test_make_kernel_matches_jax(spec, trust):
    assert set(tbuilders._FAMILIES) == set(jbuilders._FAMILIES)
    init = dict(lengthscales=(0.005,), variance=20.0, family=spec, period=(0.001,), alpha=0.7, trust=trust)
    jkern = jbuilders.make_kernel(jconfigs.KernelInit(**init), lr=2e-3)
    tkern = tbuilders.make_kernel(tconfigs.KernelInit(**init), lr=2e-3, use_kernel=True)
    assert _tree(tkern) == _tree(jkern)
    jflat = jax.tree_util.tree_flatten_with_path(jkern, is_leaf=lambda x: hasattr(x, "bijector"))[0]
    jparams = {jax.tree_util.keystr(p): leaf for p, leaf in jflat}
    tparams = {jax_key(n): m for n, m in tkern.named_modules() if hasattr(m, "bijector")}
    assert list(tparams) == list(jparams)
    for key, jp in jparams.items():
        tp = tparams[key]
        np.testing.assert_allclose(tp.value.detach().numpy(), np.asarray(jp.value), rtol=1e-14, err_msg=key)
        np.testing.assert_array_equal(tp.raw.detach().numpy(), np.asarray(jp.raw), err_msg=key)
        if isinstance(jp.bijector, jbij.Sigmoid):
            np.testing.assert_array_equal(np.atleast_1d(tp.bijector.lo), np.atleast_1d(jp.bijector.lo))
            np.testing.assert_array_equal(np.atleast_1d(tp.bijector.hi), np.atleast_1d(jp.bijector.hi))
        else:
            assert type(tp.bijector).__name__ == type(jp.bijector).__name__, key
        assert tp.lr == jp.lr == 2e-3
    assert set(lr_labels(tkern).values()) == set(jax.tree_util.tree_leaves(jlr_labels(jkern)))
    assert collect_lrs(tkern, 1e-3) == jcollect_lrs(jkern, 1e-3)
    X = np.linspace(4.368, 5.447, 9)[:, None]
    np.testing.assert_allclose(tkern.K(_t(X)).detach().numpy(), np.asarray(jkern.K(jnp.asarray(X))), rtol=1e-12,
                               atol=1e-14 * 20.0 ** 2)
    rbf_leaves = [m for m in tkern.modules() if isinstance(m, tk.RBF)]
    assert all(m.use_kernel for m in rbf_leaves)
    assert sum(tk.flag_leaves(tkern.kernel_flags())) == len(rbf_leaves)


def test_make_kernel_product_binds_tighter_and_refuses():
    tkern = tbuilders.make_kernel(tconfigs.KernelInit((0.4,), 1.0, family="periodic*rbf+linear", period=(0.5,)))
    assert isinstance(tkern, tk.Sum) and isinstance(tkern.k1, tk.Product) and isinstance(tkern.k2, tk.Linear)
    X = _t(np.random.RandomState(0).rand(6, 1))
    parts = [tbuilders.make_kernel(tconfigs.KernelInit((0.4,), 1.0, family=f, period=(0.5,)))
             for f in ("periodic", "rbf", "linear")]
    want = parts[0].K(X) * parts[1].K(X) + parts[2].K(X)
    np.testing.assert_allclose(tkern.K(X).detach().numpy(), want.detach().numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="unknown kernel family"):
        tbuilders.make_kernel(tconfigs.KernelInit((0.4,), 1.0, family="spline"))
    with pytest.raises(ValueError, match="trust must be"):
        tbuilders.make_kernel(tconfigs.KernelInit((0.4,), 1.0, family="periodic", trust=0.5))


def test_trust_bounds_hold_the_walls():
    """``tests/test_kernel_family.py``'s interval check on the port: raws
    moved by ±1e3 keep the period and the lengthscales inside [init/4,
    init·4], the variance unbounded, the gram finite."""
    k = tbuilders.make_kernel(tconfigs.KernelInit((0.005,), 20.0, family="periodic*rbf", period=(0.001,),
                                                  trust=4.0), lr=2e-3)
    with torch.no_grad():
        for p in k.parameters():
            p.add_(1e3)
    with torch.no_grad():
        assert float(k.k1.period.value) <= 0.004 + 1e-12 and float(k.k1.lengthscales.value) <= 0.02 + 1e-12
        assert float(k.k1.variance.value) > 1e3
        assert torch.isfinite(k.K(_t(np.random.RandomState(0).rand(6, 1)))).all()


# ---------------------------------------------------------------------------
# the Kronecker models with the zoo
# ---------------------------------------------------------------------------

def _zoo_models(f_temporal="periodic*rbf", g_temporal=None, use_kernel=False, split=None):
    """The on/off model of the tiny config on a 3 × 8 grid with zoo
    temporal factors in both packages, the port's raws carried from JAX's
    (moved off the init by seeded noise)."""
    split = split or _tiny_split()

    def cfg(pkg):
        ki = lambda fam, v: pkg.KernelInit((0.3,), v, family=fam, period=(0.4,), alpha=0.8)
        return _tiny("OnOffPptrConfig", pkg, grid=pkg.KronGridConfig(num_spatial=3, num_temporal=8),
                     fk_spatial=pkg.KernelInit((0.6, 0.6), 2.0), gk_spatial=pkg.KernelInit((0.6, 0.6), 1.0),
                     fk_temporal=ki(f_temporal, 2.0), gk_temporal=ki(g_temporal or f_temporal, 1.0), jitter=1e-6)

    jm = jbuilders.build_onoff_pptr(cfg(jconfigs), _jsplit(split))
    tm = tbuilders.build_onoff_pptr(cfg(tconfigs), split, use_kernel=use_kernel, **CPU64)
    rng = np.random.RandomState(3)
    arrays = {k: a + (0.05 * rng.randn(*a.shape) if ".Zs" not in k else 0.0) for k, a in _jraws(jm).items()}
    load_jax_arrays(tm, arrays)
    return _with_raws(jm, arrays), tm, split


def _elbo_and_grads_match(jm, tm, X, Y):
    jelbo, jg = _jax_elbo_and_grad(jm, jnp.asarray(X), jnp.asarray(Y))
    jg = _jraws(jg)
    elbo = tm.elbo(_t(X), _t(Y))
    elbo.backward()
    np.testing.assert_allclose(float(elbo), float(jelbo), rtol=1e-10)
    for name, p in tm.named_parameters():
        if p.requires_grad:
            want = jg[jax_key(name)]
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-8, atol=1e-11 * np.abs(want).max(),
                                       err_msg=name)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_kron_onoff_with_periodic_rbf_matches_jax(use_kernel):
    """``use_kernel`` builds the RBF leaf's grams through ``rbf_gram``'s
    Function (its plain version on the CPU) inside the product."""
    jm, tm, split = _zoo_models(use_kernel=use_kernel)
    assert tm._pairable() and jm._pairable()
    assert tm.f.kernel_flags()[1] == (False, use_kernel)
    X, Y = split.Xtrain[:40], split.Ytrain[:40]
    _elbo_and_grads_match(jm, tm, X, Y)


def test_five_adam_steps_with_periodic_rbf_match_jax():
    jm, tm, split = _zoo_models()
    idx = np.random.RandomState(0).randint(0, split.Xtrain.shape[0], size=(5, 16))
    Xs, Ys = split.Xtrain[idx], split.Ytrain[idx]
    jopt = jmake_optimizer(jm, default_lr=1e-2)
    jm2, _, jlosses = jmake_scan_train_step(jopt, unroll=1)(jm, jopt.init(jm), jnp.asarray(Xs), jnp.asarray(Ys))
    tlosses = make_scan_train_step(make_optimizer(tm, default_lr=1e-2))(tm, _t(Xs), _t(Ys))
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=1e-8)
    want = _jraws(jm2)
    for key, got in dump_arrays(tm).items():
        np.testing.assert_allclose(got, want[key], rtol=1e-8, atol=1e-12, err_msg=key)


@pytest.fixture
def chol_inv_calls(monkeypatch):
    calls = []
    forward = tlinalg.chol_inv_forward

    def counted(K):
        calls.append(tuple(K.shape))
        return forward(K)

    monkeypatch.setattr(tlinalg, "chol_inv_forward", counted)
    return calls


def test_different_matern_orders_run_unpaired_as_jax(chol_inv_calls):
    jm, tm, split = _zoo_models("matern12", "matern52")
    assert not tm._pairable() and not jm._pairable()
    _elbo_and_grads_match(jm, tm, split.Xtrain[:40], split.Ytrain[:40])
    assert chol_inv_calls == [(1, 3, 3), (1, 8, 8)] * 2  # f's factors, then g's


def test_same_family_pair_is_one_stacked_pass(chol_inv_calls):
    _, tm, split = _zoo_models("matern32")
    assert tm._pairable()
    tm.loss(_t(split.Xtrain[:16]), _t(split.Ytrain[:16])).backward()
    assert chol_inv_calls == [(2, 3, 3), (2, 8, 8)]


def test_member_stack_step_with_matern32_equals_sequential_steps():
    """Two members, one step each: the stack's raws and losses equal each
    member's own ``fit_scanned`` step on the device sampler's rows."""
    members = [_zoo_models("matern32", split=_tiny_split(seed=10 + f))[1:] for f in range(2)]
    models = [m for m, _ in members]
    datas = [(s.Xtrain, s.Ytrain) for _, s in members]
    seqs = [copy.deepcopy(m) for m in models]
    kw = dict(num_iter=1, batch_size=16, num_inner=1, learning_rate=1e-2, log_fn=lambda s: None)
    res = fit_batched_scanned(models, datas, seeds=[5, 6], log_every_blocks=0, **kw)
    for f, m in enumerate(seqs):
        one = fit_scanned(m, DataSet(*datas[f]), sampler="device", sampler_seed=5 + f, log_every_blocks=0, **kw)
        for (n, a), b in zip(res[f].model.named_parameters(), one.model.parameters()):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-10, atol=1e-13, err_msg=n)
        np.testing.assert_allclose(res[f].final_loss, one.final_loss, rtol=1e-10)
    stack = stack_models(seqs)
    assert [type(k).__name__ for k in unstack_model(stack, 0).f.kernels] == ["SquaredExponential", "Matern"]


def test_export_with_periodic_rbf_serves_predict(tmp_path):
    _, tm, split = _zoo_models(use_kernel=True)
    path = export_predictor(tm, "onoff", 3, str(tmp_path / "zoo.zigp"))
    served = load_predictor(path)
    X = split.Xtest[:11]
    with torch.no_grad():
        want = tm.predict(_t(X))._asdict()
    got = served(X)
    for k, v in want.items():
        scale = max(np.abs(v.numpy()).max(), 1e-300)
        assert np.abs(got[k] - v.numpy()).max() <= 1e-12 * scale, k


def test_a_warm_zoo_step_turns_no_host_value_into_a_tensor(monkeypatch):
    """Every family in one model (active_dims included), after a first
    step: the next builds no tensor from host data (a host-to-device copy on
    the card, which a CUDA graph capture refuses)."""
    _, tm, split = _zoo_models("periodic*rbf+linear", "matern52+rq*periodic")
    tm.f.kernels[0] = tk.Sum(tk.RBF.create([0.6], 1.0, active_dims=(1,)),
                             tk.Matern.create([0.6], 1.0, nu="1/2", active_dims=(0,)))
    tm.g.kernels[0] = tk.Sum(tk.White.create(0.1), tk.Product(
        tk.Periodic.create([0.5, 0.5], [0.4, 0.4], 1.0), tk.RBF.create([0.6, 0.6], 1.0, active_dims=(1, 0))))
    tm.double()
    X, Y = _t(split.Xtrain[:16]), _t(split.Ytrain[:16])
    tm.loss(X, Y).backward()
    as_tensor = torch.as_tensor

    def guarded(data, *args, **kw):
        if not isinstance(data, torch.Tensor):
            raise AssertionError(f"a host value became a tensor inside the step: {type(data)}")
        return as_tensor(data, *args, **kw)

    monkeypatch.setattr(torch, "as_tensor", guarded)
    monkeypatch.setattr(torch, "tensor", lambda *a, **k: pytest.fail("torch.tensor inside the step"))
    loss = tm.loss(X, Y)
    loss.backward()
    assert torch.isfinite(loss)
