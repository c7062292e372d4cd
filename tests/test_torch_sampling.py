"""The port's samplers, the full-covariance conditional and the forecast
protocol's splits against the JAX package, on the CPU in float64.

The two packages' generators give different numbers by design, so each
sampler's pure core (``sample_y_from``, ``gated_y_from``,
``predict_f_samples_from``, ``predict_y_samples_from``) is fed the standard
normals, uniforms and gammas that the JAX sampler draws from its own key
splits, regenerated here with ``jax.random``, and held to rtol 1e-10. The
drawing shells are held by their moments (the Gamma head over 20,000
draws). The models come from the two packages' builders on one tiny split,
the JAX raws moved off the init by seeded noise and carried into the port by
name (``io.convert``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu import likelihoods as jlik
from zigp_tpu.experiments import builders as jbuilders
from zigp_tpu.experiments import configs as jconfigs
from zigp_tpu.io import datasets as jdatasets
from zigp_tpu.models.onoff import OnOffPrediction as JOnOffPrediction
from zigp_tpu.models.onoff import gated_y_samples as jgated_y_samples
from zigp_tpu.ops import conditionals as jcond
from zigp_tpu_torch import likelihoods as tlik
from zigp_tpu_torch.experiments import builders as tbuilders
from zigp_tpu_torch.experiments import configs as tconfigs
from zigp_tpu_torch.io import datasets as tdatasets
from zigp_tpu_torch.io.convert import load_jax_arrays
from zigp_tpu_torch.models import OnOffPrediction, gated_y_from, gated_y_samples
from zigp_tpu_torch.ops import conditionals as tcond

from .test_torch_train import _jraws, _with_raws
from .torch_helpers import one_torch_thread_per_module  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

RTOL = 1e-10
CPU64 = dict(device="cpu", dtype=torch.float64)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _split(seed=0, ntrain=120, ntest=9):
    rng = np.random.RandomState(seed)

    def gen(n):
        X = rng.rand(n, 3)
        gate = (np.cos(5 * X[:, 2:3]) + 0.3 * rng.randn(n, 1)) > 0
        return X, np.maximum((1.0 + np.sin(3 * X[:, 2:3]) + X[:, 0:1]) * gate, 0.0)

    return tdatasets.Split(*gen(ntrain), *gen(ntest))


def _pair(kind, seed=0, **kw):
    """(JAX model, port model) of ``kind`` built from one tiny config on one
    split, with the same raws moved off the init by seeded noise."""
    split = _split()
    jsplit = jdatasets.Split(split.Xtrain, split.Ytrain, split.Xtest, split.Ytest)
    name, jb, tb = {
        "svgp": ("SvgpPptrConfig", jbuilders.build_svgp_pptr, tbuilders.build_svgp_pptr),
        "onoff": ("OnOffPptrConfig", jbuilders.build_onoff_pptr, tbuilders.build_onoff_pptr),
        "hurdlej": ("HurdleJointConfig", jbuilders.build_hurdle_joint_pptr, tbuilders.build_hurdle_joint_pptr),
    }[kind]
    cfg = lambda pkg: getattr(pkg, name)(grid=pkg.KronGridConfig(3, 5), **kw)
    jm = jb(cfg(jconfigs), jsplit)
    tm = tb(cfg(tconfigs), split, **CPU64)
    rng = np.random.RandomState(seed)
    raws = {k: a if (".q_sqrt.raw" in k and kw.get("q_cov") == "kron") else a + 0.1 * rng.randn(*np.shape(a))
            for k, a in _jraws(jm).items()}
    jm = _with_raws(jm, raws)
    load_jax_arrays(tm, raws)
    return jm, tm, split.Xtest


# ---------------------------------------------------------------------------
# the regression heads' sample_y
# ---------------------------------------------------------------------------


def _heads(name):
    return {
        "gaussian": (jlik.Gaussian.create(0.3), tlik.Gaussian.create(0.3)),
        "lognormal": (jlik.LogNormal.create(0.4), tlik.LogNormal.create(0.4)),
        "gamma": (jlik.Gamma.create(1.7), tlik.Gamma.create(1.7)),
    }[name]


def _jax_draws(name, key, shape, jl):
    if name == "gamma":
        return jax.random.gamma(key, jl.shape.value, shape, dtype=jnp.float64)
    return jax.random.normal(key, shape, dtype=jnp.float64)


@pytest.mark.parametrize("name", ["gaussian", "lognormal", "gamma"])
def test_sample_y_core_on_jax_draws(name):
    jl, tl = _heads(name)
    F = np.random.RandomState(1).randn(5, 7, 1) * 0.5
    key = jax.random.PRNGKey(3)
    want = np.asarray(jl.sample_y(key, jnp.asarray(F)))
    got = tl.sample_y_from(_t(F), _t(_jax_draws(name, key, F.shape, jl)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("name", ["gaussian", "lognormal", "gamma"])
def test_sample_y_draws_have_the_head_moments(name):
    """20,000 draws at f = 0.3: the Gamma head's mean e^f and variance
    e^{2f}/α, the Gaussian's f and σ², the LogNormal's exp(f + σ²/2)."""
    _, tl = _heads(name)
    n, f = 20_000, 0.3
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        y = tl.sample_y(gen, torch.full((n,), f, dtype=torch.float64)).numpy()
    if name == "gamma":
        a = float(tl.shape.value)
        mean, var = np.exp(f), np.exp(2 * f) / a
    elif name == "gaussian":
        mean, var = f, float(tl.variance.value)
    else:
        s2 = float(tl.variance.value)
        mean, var = np.exp(f + s2 / 2), (np.exp(s2) - 1) * np.exp(2 * f + s2)
    assert abs(y.mean() - mean) < 5 * np.sqrt(var / n)
    assert abs(y.var() / var - 1) < 0.08
    if name != "gaussian":
        assert np.all(y > 0)


# ---------------------------------------------------------------------------
# the gated sampler and the models' samplers
# ---------------------------------------------------------------------------


def test_gated_y_core_on_jax_draws():
    rng = np.random.RandomState(2)
    fields = [rng.randn(6, 1) for _ in range(9)]
    fields[4], fields[6] = np.abs(fields[4]), np.abs(fields[6])  # fvar, gvar
    fields[1] = -fields[1] ** 2  # a negative variance where f32 rounding would leave one: clipped
    key, S, noise = jax.random.PRNGKey(7), 4, 0.05
    want = np.asarray(jax.jit(lambda f, k: jgated_y_samples(JOnOffPrediction(*f), noise, k, S))(fields, key))
    kf, kg, ke = jax.random.split(key, 3)
    z = [_t(jax.random.normal(k, (S, 6, 1), dtype=jnp.float64)) for k in (kf, kg, ke)]
    got = gated_y_from(OnOffPrediction(*map(_t, fields)), _t(noise), *z)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_gated_y_samples_match_the_prediction_moments():
    """The shell: E[y*] = E[Φ(g)]·E[f] (the unclipped gate) over 20,000
    draws per point."""
    p = OnOffPrediction(*(torch.full((3, 1), v, dtype=torch.float64) for v in
                          (0, 0, 0, 1.5, 0.2, 0.4, 0.3, 0, 0)))
    gen = torch.Generator().manual_seed(1)
    y = gated_y_samples(p, 0.01, gen, 20_000).numpy()
    e_phi = float(torch.special.ndtr(torch.tensor(0.4 / np.sqrt(1.3))))
    assert y.shape == (20_000, 3, 1)
    assert np.all(np.abs(y.mean(0) - e_phi * 1.5) < 5 * y.std(0) / np.sqrt(20_000))


@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("family", ["diag", "kron whitened"])
def test_svgp_f_samples_core_on_jax_draws(full_cov, family):
    kw = dict(q_cov="kron", whiten=True) if family == "kron whitened" else {}
    jm, tm, X = _pair("svgp", **kw)
    key, S = jax.random.PRNGKey(11), 5
    want = np.asarray(jax.jit(lambda m, k, x: m.predict_f_samples(k, x, S, full_cov=full_cov))(jm, key, X))
    shape = (S, X.shape[0]) if full_cov else (S, X.shape[0], 1)
    eps = _t(jax.random.normal(key, shape, dtype=jnp.float64))
    with torch.no_grad():
        got = tm.predict_f_samples_from(_t(X), eps, full_cov=full_cov)
        gen = torch.Generator().manual_seed(0)
        drawn = tm.predict_f_samples(gen, _t(X), S, full_cov=full_cov)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert drawn.shape == got.shape and torch.isfinite(drawn).all()


def test_full_cov_samples_give_nan_on_an_indefinite_covariance(monkeypatch):
    """The joint sampler's Cholesky of a covariance that is not positive
    definite gives NaN, as JAX's does, and does not raise (it did)."""
    _, tm, X = _pair("svgp")
    predict_f = tm.gp.predict_f

    def indefinite(Xnew, factor_state=None, *, full_cov=False):
        mu, cov = predict_f(Xnew, factor_state, full_cov=full_cov)
        return mu, -cov  # negative definite

    monkeypatch.setattr(tm.gp, "predict_f", indefinite)
    with torch.no_grad():
        got = tm.predict_f_samples_from(_t(X), torch.ones(3, X.shape[0], dtype=torch.float64), full_cov=True)
    assert torch.isnan(got).all()


def test_onoff_y_samples_core_on_jax_draws():
    jm, tm, X = _pair("onoff")
    key, S = jax.random.PRNGKey(5), 6
    want = np.asarray(jax.jit(lambda m, k, x: m.predict_y_samples(k, x, S))(jm, key, X))
    kf, kg, ke = jax.random.split(key, 3)
    z = [_t(jax.random.normal(k, (S, X.shape[0], 1), dtype=jnp.float64)) for k in (kf, kg, ke)]
    with torch.no_grad():
        got = tm.predict_y_samples_from(_t(X), *z)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("head", ["lognormal", "gamma", "gaussian"])
def test_hurdle_y_samples_core_on_jax_draws(head):
    jm, tm, X = _pair("hurdlej", likelihood=head)
    key, S = jax.random.PRNGKey(9), 6
    want = np.asarray(jax.jit(lambda m, k, x: m.predict_y_samples(k, x, S))(jm, key, X))
    k_f, k_y, k_gate = jax.random.split(key, 3)
    shape = (S, X.shape[0], 1)
    eps = _t(jax.random.normal(k_f, shape, dtype=jnp.float64))
    amount = _t(_jax_draws(head, k_y, shape, jm.amount_likelihood))
    u = _t(jax.random.uniform(k_gate, shape, dtype=jnp.float64))
    with torch.no_grad():
        got = tm.predict_y_samples_from(_t(X), eps, amount, u)
        drawn = tm.predict_y_samples(torch.Generator().manual_seed(0), _t(X), S)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert (want == 0).any() and drawn.shape == shape and torch.isfinite(drawn).all()


# ---------------------------------------------------------------------------
# the full-covariance conditional
# ---------------------------------------------------------------------------


def _conditional_inputs(q_cov, seed=4):
    rng = np.random.RandomState(seed)
    Zs = [rng.rand(3, 2), rng.rand(4, 1)]
    X = rng.rand(7, 3)
    q_mu = rng.randn(12, 1) * 0.3
    q_sqrt = np.abs(rng.randn(12, 1)) * 0.5 + 0.1
    Cs = [np.tril(rng.randn(n, n) * 0.3) + np.eye(n) for n in (3, 4)] if q_cov == "kron" else None
    return Zs, X, q_mu, q_sqrt, Cs


@pytest.mark.parametrize("whiten", [False, True])
@pytest.mark.parametrize("q_cov", ["diag", "kron"])
def test_full_cov_conditional_equals_jax(q_cov, whiten):
    from zigp_tpu.ops.kernels import RBF as JRBF
    from zigp_tpu_torch.ops.kernels import RBF as TRBF

    Zs, X, q_mu, q_sqrt, Cs = _conditional_inputs(q_cov)
    specs = [([0.5, 0.7], 1.2), ([0.3], 0.8)]
    masks = [(0, 1), (2,)]
    jk = [JRBF.create(l, v) for l, v in specs]
    jmu, jcov = jax.jit(lambda *a: jcond.kron_conditional(
        *a[:5], masks, jitter=1e-6, whiten=whiten, q_sqrt_factors=a[5], full_cov=True))(
        X, jk, Zs, q_mu, q_sqrt, Cs)
    tvals = [type(k.values())(k.values().lengthscales[None].double(), k.values().variance[None].double())
             for k in (TRBF.create(l, v) for l, v in specs)]
    args = (_t(X), tvals, [_t(Z)[None] for Z in Zs], _t(q_mu)[None], _t(q_sqrt)[None], masks)
    kw = dict(jitter=1e-6, whiten=whiten, q_sqrt_factors=None if Cs is None else [_t(C)[None] for C in Cs])
    with torch.no_grad():
        mu, cov = tcond.kron_conditional(*args, full_cov=True, **kw)
        mu_d, var_d = tcond.kron_conditional(*args, **kw)
    assert cov.shape == (1, 7, 7, 1)
    np.testing.assert_allclose(mu[0].numpy(), np.asarray(jmu), rtol=RTOL)
    np.testing.assert_allclose(cov[0].numpy(), np.asarray(jcov), rtol=1e-9, atol=1e-12 * np.abs(jcov).max())
    # the diagonal is the marginal path's variance
    np.testing.assert_allclose(torch.diagonal(cov[0, :, :, 0]).numpy(), var_d[0, :, 0].numpy(), rtol=1e-9)
    np.testing.assert_allclose(mu_d[0].numpy(), mu[0].numpy(), rtol=RTOL)


# ---------------------------------------------------------------------------
# the forecast protocol's splits
# ---------------------------------------------------------------------------


def _raw_pptr():
    s = tdatasets.synthetic_pptr(12, 160, seed=3)
    Xtr, Xte = s.Xtrain.copy(), s.Xtest.copy()
    Xtr[:, 2] *= 1000
    Xte[:, 2] *= 1000
    return tdatasets.Split(Xtr, s.Ytrain, Xte, s.Ytest)


@pytest.mark.parametrize("covariates", [False, True])
@pytest.mark.parametrize("origins,horizon", [(5, 0.1), (2, 0.2)])
def test_forecast_splits_equal_jax(covariates, origins, horizon):
    raw = _raw_pptr()
    got = tdatasets.make_forecast_splits(raw, origins, horizon_frac=horizon, covariates=covariates)
    want = jdatasets.make_forecast_splits(jdatasets.Split(*dataclasses.astuple(raw)), origins, horizon_frac=horizon,
                                          covariates=covariates)
    assert len(got) == len(want) == origins
    for a, b in zip(got, want):
        for f in ("Xtrain", "Ytrain", "Xtest", "Ytest"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.Xtrain.shape[1] == (8 if covariates else 3)


def test_forecast_covariates_equal_jax_with_an_unseen_station():
    """A test station the train rows never saw takes the fallbacks."""
    raw = _raw_pptr()
    Xtr, Ytr = raw.Xtrain.copy(), raw.Ytrain
    Xtr[:, 2] /= 1000
    Xte = np.concatenate([Xtr[:5], [[61.0, 25.0, Xtr[0, 2]]]])
    cut = float(np.median(Xtr[:, 2]))
    got = tdatasets.augment_forecast_covariates(Xtr, Ytr, Xte, cut, wet_window=24)
    want = jdatasets.augment_forecast_covariates(Xtr, Ytr, Xte, cut, wet_window=24)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_forecast_splits_refuse_an_empty_window():
    with pytest.raises(ValueError, match="empty train"):
        tdatasets.make_forecast_splits(_raw_pptr(), 2, start_frac=0.0)


def test_save_pptr_round_trips_through_the_cv_splits(tmp_path):
    s = tdatasets.synthetic_pptr(6, 30, seed=0)
    path = tdatasets.save_pptr(s, str(tmp_path / "pptr.pickle"))
    back = tdatasets.load_pptr(path)
    np.testing.assert_allclose(back.Xtrain[:, 2] / 1000.0, s.Xtrain[:, 2], rtol=1e-15)
    folds = tdatasets.make_cv_splits(back)
    t = np.concatenate([s.Xtrain[:, 2], s.Xtest[:, 2]])
    assert np.isclose(min(f.Xtrain[:, 2].min() for f in folds), t.min())
