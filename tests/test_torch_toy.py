"""The port's dense models, scipy L-BFGS and the toy workflow against the JAX
package's, on the CPU in float64.

- ``SVGP`` (Gaussian and Bernoulli) and ``OnOffSVGP``, diagonal and full q,
  whitened and not: the ELBO at rtol 1e-10 and every raw's gradient
  against ``jax.grad`` at rtol 1e-8 on the same raws (``io.convert``); the
  JAX package's numpy oracles (``tests/oracles.py``) as the anchor.
- The dense ``conditional`` with and without ``full_cov``; the samplers'
  cores fed JAX's own draws; ``gauss_kl`` on a matrix that is not positive
  definite gives NaN in both packages, as does a joint sample through an
  indefinite covariance.
- The toy: ``build_toy_model`` and the initial ELBO on a 450 × 1 synthetic
  on/off set (``io.datasets.synthetic_toydata``) at rtol 1e-10; 20
  iterations of ``scipy_optimize`` in both packages (the final ELBO at rtol
  1e-6 and the same ``nit``); frozen parameters unmoved; ``run_toy``'s Adam
  branch for 10 steps; ``toy --cpu-x64`` through the command line with the
  set written as ``toydata.mat`` under ``ZIGP_DATA_DIR``, and its exit for
  a missing file.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu import likelihoods as jlik
from zigp_tpu.experiments import toy as jtoy
from zigp_tpu.io import datasets as jdatasets
from zigp_tpu.models import OnOffSVGP as JOnOffSVGP
from zigp_tpu.models import SVGP as JSVGP
from zigp_tpu.ops import conditionals as jcond
from zigp_tpu.ops import gauss_kl as jgauss_kl
from zigp_tpu.ops.kernels import RBF as JRBF
from zigp_tpu.training.scipy_opt import scipy_optimize as jscipy_optimize
from zigp_tpu_torch import likelihoods as tlik
from zigp_tpu_torch.experiments import cli as tcli
from zigp_tpu_torch.experiments import toy as ttoy
from zigp_tpu_torch.experiments.configs import ToyOnOffConfig
from zigp_tpu_torch.io import datasets as tdatasets
from zigp_tpu_torch.io.convert import jax_key, load_jax_arrays
from zigp_tpu_torch.models import SVGP, OnOffSVGP
from zigp_tpu_torch.ops import conditionals as tcond
from zigp_tpu_torch.ops import gauss_kl as tgauss_kl
from zigp_tpu_torch.ops.kernels import RBF as TRBF
from zigp_tpu_torch.training import scipy_optimize

from .oracles import SEKernelNp, conditional_dense, gauss_kl_dense, onoff_elbo_dense
from .test_torch_train import _jraws, _with_raws
from .torch_helpers import one_torch_thread_per_module  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


# one jitted function for every JAX model of the file: compiled once per model structure
_jax_elbo_and_grad = jax.jit(jax.value_and_grad(lambda m, X, Y: m.elbo(X, Y)))


def _problem(seed=0, N=30, M=6):
    """``tests/test_models.py``'s toy problem: 1-D inputs on [0, 10]."""
    rng = np.random.RandomState(seed)
    X = rng.rand(N, 1) * 10
    Y = np.sin(X) + rng.randn(N, 1) * 0.1
    return X, Y, np.linspace(0, 10, M)[:, None]


def _carry(jm, tm, seed):
    """JAX's raws moved off the init by seeded noise, into both models."""
    rng = np.random.RandomState(seed)
    arrays = {k: a + 0.1 * rng.randn(*np.shape(a)) for k, a in _jraws(jm).items()}
    load_jax_arrays(tm, arrays)
    return _with_raws(jm, arrays)


def _dense_models(kind, whiten, q_diag, seed=0):
    X, Y, Z = _problem(seed)
    kw = dict(num_data=X.shape[0], jitter=1e-6, whiten=whiten, q_diag=q_diag)
    if kind == "onoff":
        jm = JOnOffSVGP.create(JRBF.create([2.0], 1.0), JRBF.create([2.0], 5.0), jlik.OnOffGaussian.create(0.01), Z,
                               Z.copy(), **kw)
        tm = OnOffSVGP.create(TRBF.create([2.0], 1.0), TRBF.create([2.0], 5.0), tlik.OnOffGaussian.create(0.01), Z,
                              Z.copy(), **kw)
        Y = np.where(X > 5, 0.0, Y)
    else:
        head = (lambda pkg: pkg.Gaussian.create(0.1)) if kind == "gaussian" else (lambda pkg: pkg.Bernoulli.create())
        jm = JSVGP.create(JRBF.create([2.0], 1.0), head(jlik), Z, mean_const=0.2, **kw)
        tm = SVGP.create(TRBF.create([2.0], 1.0), head(tlik), Z, mean_const=0.2, **kw)
        if kind == "bernoulli":
            Y = (Y > 0).astype(np.float64)
    return _carry(jm, tm, seed + 1), tm, X, Y


@pytest.mark.parametrize("whiten", [False, True])
@pytest.mark.parametrize("q_diag", [True, False])
@pytest.mark.parametrize("kind", ["gaussian", "bernoulli", "onoff"])
def test_dense_elbo_and_gradients_match_jax(kind, whiten, q_diag):
    jm, tm, X, Y = _dense_models(kind, whiten, q_diag)
    jelbo, jg = _jax_elbo_and_grad(jm, jnp.asarray(X), jnp.asarray(Y))
    jg = _jraws(jg)
    elbo = tm.elbo(_t(X), _t(Y))
    elbo.backward()
    np.testing.assert_allclose(float(elbo), float(jelbo), rtol=1e-10)
    for name, p in tm.named_parameters():
        want = jg[jax_key(name)]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-8, atol=1e-11 * max(np.abs(want).max(), 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["svgp", "onoff"])
def test_dense_elbo_matches_the_numpy_oracle(kind):
    """``tests/test_models.py``'s oracles at the models' inits."""
    X, Y, Z = _problem(0)
    rng = np.random.RandomState(0)
    u_fm, u_gm = rng.randn(6, 1) * 0.01, rng.randn(6, 1) * 0.01
    if kind == "onoff":
        tm = OnOffSVGP.create(TRBF.create([2.0], 1.0), TRBF.create([2.0], 5.0), tlik.OnOffGaussian.create(0.01), Z,
                              Z, num_data=X.shape[0], jitter=1e-6, u_fm_init=u_fm, u_gm_init=u_gm)
        want = onoff_elbo_dense(X, Y, SEKernelNp(np.array([2.0]), 1.0), SEKernelNp(np.array([2.0]), 5.0), Z, Z,
                                u_fm, u_gm, np.ones((6, 1)), np.ones((6, 1)), noisevar=0.01, num_data=X.shape[0],
                                jitter=1e-6)
    else:
        tm = SVGP.create(TRBF.create([2.0], 1.0), tlik.Gaussian.create(0.01), Z, num_data=X.shape[0], jitter=1e-6,
                         q_mu_init=u_fm)
        k = SEKernelNp(np.array([2.0]), 1.0)
        kl = gauss_kl_dense(u_fm, np.ones((6, 1)), k.K(Z) + np.eye(6) * 1e-6)
        fmean, fvar = conditional_dense(X, Z, k, u_fm, q_sqrt=np.ones((6, 1)), jitter=1e-6)
        want = np.sum(-0.5 * np.log(2 * np.pi) - 0.5 * np.log(0.01) - 0.5 * ((Y - fmean) ** 2 + fvar) / 0.01) - kl
    with torch.no_grad():
        np.testing.assert_allclose(float(tm.elbo(_t(X), _t(Y))), want, rtol=1e-6)


@pytest.mark.parametrize("q", ["none", "diag", "full"])
@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("whiten", [False, True])
def test_dense_conditional_matches_jax(q, full_cov, whiten):
    rng = np.random.RandomState(5)
    Xnew, Z, f = rng.rand(9, 2) * 3, rng.rand(5, 2) * 3, rng.randn(5, 2)
    q_sqrt = {"none": None, "diag": 0.3 + rng.rand(5, 2), "full": rng.randn(5, 5, 2)}[q]
    jkern, tkern = JRBF.create([1.1, 0.8], 1.7), TRBF.create([1.1, 0.8], 1.7)
    want = jcond.conditional(jnp.asarray(Xnew), jnp.asarray(Z), jkern, jnp.asarray(f), full_cov=full_cov,
                             q_sqrt=None if q_sqrt is None else jnp.asarray(q_sqrt), whiten=whiten, jitter=1e-6)
    with torch.no_grad():
        got = tcond.conditional(_t(Xnew), _t(Z), tkern, _t(f), full_cov=full_cov,
                                q_sqrt=None if q_sqrt is None else _t(q_sqrt), whiten=whiten, jitter=1e-6)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12 * np.abs(np.asarray(w)).max())


@pytest.mark.parametrize("full_cov", [False, True])
def test_svgp_samples_from_jax_draws(full_cov):
    jm, tm, X, _ = _dense_models("gaussian", False, False)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(lambda m, x: m.predict_f_samples(key, x, 4, full_cov=full_cov))(jm, jnp.asarray(X[:8])))
    eps = np.asarray(jax.random.normal(key, (4, 8, 1), dtype=jnp.float64))
    with torch.no_grad():
        got = tm.predict_f_samples_from(_t(X[:8]), _t(eps), full_cov=full_cov).numpy()
        drawn = tm.predict_f_samples(torch.Generator().manual_seed(0), _t(X[:8]), 4, full_cov=full_cov)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    assert drawn.shape == (4, 8, 1) and torch.isfinite(drawn).all()


def test_onoff_y_samples_from_jax_draws():
    jm, tm, X, _ = _dense_models("onoff", False, True)
    key = jax.random.PRNGKey(7)
    want, jpred = jax.jit(lambda m, x: (m.predict_y_samples(key, x, 5), m.predict(x)))(jm, jnp.asarray(X[:8]))
    want = np.asarray(want)
    shape = (5, 8, 1)
    zf, zg, ze = (np.asarray(jax.random.normal(k, shape, dtype=jnp.float64)) for k in jax.random.split(key, 3))
    with torch.no_grad():
        got = tm.predict_y_samples_from(_t(X[:8]), _t(zf), _t(zg), _t(ze)).numpy()
        drawn = tm.predict_y_samples(torch.Generator().manual_seed(0), _t(X[:8]), 5)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)
    assert drawn.shape == shape and torch.isfinite(drawn).all()
    pred = tm.predict(_t(X[:8]))
    for field in pred._fields:
        np.testing.assert_allclose(getattr(pred, field).detach().numpy(), np.asarray(getattr(jpred, field)),
                                   rtol=1e-10, atol=1e-13, err_msg=field)


def test_gauss_kl_gives_nan_on_a_matrix_that_is_not_positive_definite():
    """K = [[1, 2], [2, 1]] has eigenvalues 3 and −1: JAX's Cholesky gives
    NaN and so must the port's (it raised before)."""
    K = np.array([[1.0, 2.0], [2.0, 1.0]])
    q_mu, q_sqrt = np.array([[0.3], [-0.2]]), np.array([[0.9], [1.1]])
    want = float(jgauss_kl.gauss_kl(jnp.asarray(q_mu), jnp.asarray(q_sqrt), jnp.asarray(K)))
    got = tgauss_kl.gauss_kl(_t(q_mu)[None], _t(q_sqrt)[None], _t(K)[None])
    assert np.isnan(want) and torch.isnan(got).all()


def test_joint_samples_give_nan_on_an_indefinite_covariance(monkeypatch):
    """``SVGP.predict_f_samples_from(full_cov=True)`` through a covariance
    that is not positive definite: NaN, not a raise, as JAX's."""
    jm, tm, X, _ = _dense_models("gaussian", False, True)
    bad = lambda fmean, fcov: (fmean, fcov - 10.0 * torch.eye(fcov.shape[0], dtype=fcov.dtype)[:, :, None])
    predict_f = tm.predict_f
    monkeypatch.setattr(tm, "predict_f", lambda Xn, full_cov=False: bad(*predict_f(Xn, full_cov=full_cov)))
    with torch.no_grad():
        out = tm.predict_f_samples_from(_t(X[:6]), torch.ones(2, 6, 1, dtype=torch.float64), full_cov=True)
    assert torch.isnan(out).all()


# ---------------------------------------------------------------------------
# the toy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def toyset():
    return tdatasets.synthetic_toydata(seed=0)


@pytest.fixture
def toydir(toyset, tmp_path, monkeypatch):
    """The synthetic set as ``toydata.mat`` in a directory both packages
    read as their data directory."""
    tdatasets.save_toydata(*toyset, str(tmp_path / "toydata.mat"))
    monkeypatch.setattr(tdatasets, "DEFAULT_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jdatasets, "DEFAULT_DATA_DIR", str(tmp_path))
    return tmp_path


def _toy_pair(toyset):
    x, y, _ = toyset
    jm, _, _ = jtoy.build_toy_model(jtoy.ToyOnOffConfig(), x, y)
    tm, _, _ = ttoy.build_toy_model(ToyOnOffConfig(), x, y, device="cpu", dtype=torch.float64)
    return jm, tm, x, y


def test_toy_model_and_initial_elbo_match_jax(toyset, toydir):
    jm, tm, x, y = _toy_pair(toyset)
    assert x.shape == (450, 1) and tm.Zf.shape == (9, 1)
    load_jax_arrays(tm, _jraws(jm))  # the same values: a no-op unless the inits differ
    tm2, _, _ = ttoy.build_toy_model(device="cpu", dtype=torch.float64)  # from toydata.mat
    for (n, a), b in zip(tm.named_parameters(), tm2.parameters()):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy(), err_msg=n)
    jelbo, jg = _jax_elbo_and_grad(jm, jnp.asarray(x), jnp.asarray(y))
    elbo = tm.elbo(_t(x), _t(y))
    elbo.backward()
    np.testing.assert_allclose(float(elbo), float(jelbo), rtol=1e-10)
    jg = _jraws(jg)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[jax_key(name)], rtol=1e-8, atol=1e-10, err_msg=name)


def test_twenty_lbfgs_iterations_match_jax(toyset):
    jm, tm, x, y = _toy_pair(toyset)
    X, Y = jnp.asarray(x), jnp.asarray(y)
    _, jres = jscipy_optimize(jm, lambda m: m.loss(X, Y), maxiter=20, options={"maxcor": 100})
    with torch.no_grad():
        elbo0 = float(tm.elbo(_t(x), _t(y)))
    tm2, res = scipy_optimize(tm, lambda m: m.loss(_t(x), _t(y)), maxiter=20, options={"maxcor": 100})
    assert res.nit == jres.nit == 20
    with torch.no_grad():
        elbo = float(tm2.elbo(_t(x), _t(y)))
    np.testing.assert_allclose(elbo, -jres.fun, rtol=1e-6)  # the loss at JAX's result
    assert elbo > elbo0 + 1.0  # it optimized


def test_frozen_parameters_are_unmoved(toyset):
    _, tm, x, y = _toy_pair(toyset)
    frozen = [tm.Zf.raw, tm.likelihood.variance.raw]
    for p in frozen:
        p.requires_grad_(False)
    before = [p.detach().clone() for p in frozen]
    moving = tm.u_fm.raw.detach().clone()
    scipy_optimize(tm, lambda m: m.loss(_t(x), _t(y)), maxiter=5)
    for p, b in zip(frozen, before):
        assert torch.equal(p, b)
    assert not torch.equal(tm.u_fm.raw, moving)


def test_run_toy_adam_branch_matches_jax(toydir):
    cfg = dict(optimizer="adam", maxiter=10)
    want = jtoy.run_toy(jtoy.ToyOnOffConfig(**cfg), log_fn=lambda s: None)
    logs = []
    got = ttoy.run_toy(ToyOnOffConfig(**cfg), log_fn=logs.append, device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(got["initial_elbo"], want["initial_elbo"], rtol=1e-10)
    np.testing.assert_allclose(got["elbo"], want["elbo"], rtol=1e-8)
    assert got["elbo"] != got["initial_elbo"] and got["result"] is None
    np.testing.assert_allclose(got["prediction"].gfmean.numpy(), np.asarray(want["prediction"].gfmean), rtol=1e-7,
                               atol=1e-9)
    assert logs[0].startswith("initial ELBO") and logs[-1].startswith("final ELBO")


def test_toy_cpu_x64_through_the_command_line(toyset, tmp_path):
    """``python -m zigp_tpu_torch.experiments toy --cpu-x64`` in its own
    process, reading the set from ``ZIGP_DATA_DIR``."""
    tdatasets.save_toydata(*toyset, str(tmp_path / "toydata.mat"))
    env = {**os.environ, "ZIGP_DATA_DIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-m", "zigp_tpu_torch.experiments", "toy", "--cpu-x64", "--maxiter", "5"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("initial ELBO:") and "L-BFGS-B: 5 iterations" in out.stdout
    assert lines[-1].startswith("final ELBO:")


def test_toy_without_toydata_exits_with_the_path(tmp_path, monkeypatch):
    monkeypatch.setattr(tdatasets, "DEFAULT_DATA_DIR", str(tmp_path))
    with pytest.raises(SystemExit, match=f"{tmp_path}/toydata.mat not found"):
        tcli.main(["toy", "--cpu-x64"])
