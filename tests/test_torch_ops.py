"""The port's ops against the JAX package's, on the same seeded numpy inputs.

Float64 throughout (tests/conftest.py turns on JAX's x64), rtol 1e-9: the
formulas are the same and only the order of summation differs between XLA
and torch. The float32 ``add_jitter`` check is at rtol 1e-6, a few f32 ulps,
for the same reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.ops import conditionals as jcond
from zigp_tpu.ops import linalg as jlinalg
from zigp_tpu.ops import probit as jprobit
from zigp_tpu.ops.kernels import RBF as JRBF
from zigp_tpu_torch.core import bijectors as tbij
from zigp_tpu_torch.ops import conditionals as tcond
from zigp_tpu_torch.ops import linalg as tlinalg
from zigp_tpu_torch.ops import probit as tprobit
from zigp_tpu_torch.ops.kernels import RBF as TRBF
from zigp_tpu_torch.ops.kernels import RBFValues

from .torch_helpers import one_torch_thread_per_module  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

RTOL = 1e-9


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _close(a, b, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("D", [1, 2, 3, 20])
def test_rbf_K_Kdiag(D):
    rng = np.random.RandomState(D)
    X, X2 = rng.randn(15, D), rng.randn(9, D)
    ell, var = 0.5 + rng.rand(D), 2.7
    jk = JRBF.create(list(ell), var)
    tk = TRBF.create(list(ell), var)
    _close(tk.lengthscales.raw.detach(), jk.lengthscales.raw)
    with torch.no_grad():
        _close(tk.K(_t(X), _t(X2)), jk.K(jnp.asarray(X), jnp.asarray(X2)))
        _close(tk.K(_t(X)), jk.K(jnp.asarray(X)))
        _close(tk.Kdiag(_t(X)), jk.Kdiag(jnp.asarray(X)))


def test_rbf_batched_values_match_per_gp():
    """A stacked pair of hyperparameters gives each GP's own gram."""
    rng = np.random.RandomState(0)
    Z = rng.randn(2, 7, 2)
    X = rng.randn(11, 2)
    ell = 0.5 + rng.rand(2, 2)
    var = np.array([1.5, 3.0])
    K = RBFValues(_t(ell), _t(var)).K(_t(Z), _t(X))
    assert K.shape == (2, 7, 11)
    for g in range(2):
        _close(K[g], JRBF.create(list(ell[g]), var[g]).K(jnp.asarray(Z[g]), jnp.asarray(X)))


@pytest.mark.parametrize("name", ["softplus", "exp", "sigmoid", "fill_tril"])
def test_bijectors_match_jax(name):
    from zigp_tpu.core import bijectors as jbij

    rng = np.random.RandomState(1)
    make = {
        "softplus": lambda m: m.Softplus(),
        "exp": lambda m: m.Exp(),
        "sigmoid": lambda m: m.Sigmoid([0.1, 0.2, 0.3], [1.0, 2.0, 3.0]),
        "fill_tril": lambda m: m.FillLowerTriangular(),
    }[name]
    jb, tb = make(jbij), make(tbij)
    y = {"fill_tril": rng.randn(3, 3)}.get(name, np.array([0.3, 0.5, 0.9]))
    raw_j = np.asarray(jb.inverse(y))
    raw_t = tb.inverse(y)
    _close(raw_t, raw_j)
    _close(tb.forward(_t(raw_t)), jb.forward(jnp.asarray(raw_j)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_add_jitter(dtype):
    rng = np.random.RandomState(2)
    A = rng.randn(2, 6, 6)
    K = (A @ A.transpose(0, 2, 1) + 20.0 * np.eye(6)).astype(dtype)
    out = tlinalg.add_jitter(torch.as_tensor(K), 1e-5)
    ref = np.stack([np.asarray(jlinalg.add_jitter(jnp.asarray(k), 1e-5)) for k in K])
    assert out.dtype == torch.from_numpy(K).dtype
    _close(out, ref, rtol=RTOL if dtype == np.float64 else 1e-6, atol=0)
    if dtype == np.float32:  # the relative term: 2e-4 · mean(diag K)
        extra = out.double().numpy() - K.astype(np.float64)
        expect = 1e-5 + 2e-4 * np.mean(np.diagonal(K, axis1=1, axis2=2), axis=1)
        _close(np.diagonal(extra, axis1=1, axis2=2), np.repeat(expect[:, None], 6, 1), rtol=1e-3, atol=0)
    else:
        _close(out.numpy() - K, np.broadcast_to(1e-5 * np.eye(6), K.shape), rtol=RTOL, atol=1e-15)


def _tri_inverses(rng, sizes, batch=()):
    out = []
    for s in sizes:
        A = rng.randn(*batch, s, s)
        L = np.linalg.cholesky(A @ np.swapaxes(A, -1, -2) + s * np.eye(s))
        out.append(np.linalg.inv(L))
    return out


@pytest.mark.parametrize("sizes", [(3, 4), (2, 3, 5)])
@pytest.mark.parametrize("ncol", [1, 3])
def test_kron_linv_lower_and_solve(sizes, ncol):
    rng = np.random.RandomState(len(sizes) + ncol)
    Linvs = _tri_inverses(rng, sizes)
    b = rng.randn(int(np.prod(sizes)), ncol)
    jl = [jnp.asarray(L) for L in Linvs]
    tl = [_t(L) for L in Linvs]
    _close(tlinalg.kron_linv_lower(tl, _t(b)), jlinalg.kron_linv_lower(jl, jnp.asarray(b)))
    _close(tlinalg.kron_linv_solve(tl, _t(b)), jlinalg.kron_linv_solve(jl, jnp.asarray(b)))


def test_kron_linv_solve_batched():
    rng = np.random.RandomState(9)
    sizes = (3, 4)
    Linvs = _tri_inverses(rng, sizes, batch=(2,))
    b = rng.randn(2, 12, 1)
    out = tlinalg.kron_linv_solve([_t(L) for L in Linvs], _t(b))
    for g in range(2):
        _close(out[g], jlinalg.kron_linv_solve([jnp.asarray(L[g]) for L in Linvs], jnp.asarray(b[g])))


def _conditional_inputs(rng, G):
    """Two factors (2-D spatial, 1-D temporal) per GP, G GPs, with knots
    spread against the lengthscales so the grams are well conditioned (the
    unwhitened mean sums terms cond(K) larger than itself)."""
    sizes = (4, 6)
    Zs = [2.0 * rng.randn(G, 4, 2), np.linspace(0.0, 3.0, 6)[None, :, None] + 0.1 * rng.rand(G, 6, 1)]
    ells = [0.8 + rng.rand(G, 2), 0.6 + rng.rand(G, 1)]
    vars_ = [1.0 + rng.rand(G), 2.0 + rng.rand(G)]
    M = int(np.prod(sizes))
    q_mu = rng.randn(G, M, 1)
    q_sqrt = 0.5 + rng.rand(G, M, 1)
    facs = [np.tril(rng.randn(G, s, s)) + 2.0 * np.eye(s) for s in sizes]
    X = np.concatenate([rng.randn(13, 2), rng.rand(13, 1) * 3.0], axis=1)
    return Zs, ells, vars_, q_mu, q_sqrt, facs, X


@pytest.mark.parametrize("whiten", [False, True])
@pytest.mark.parametrize("q_cov", ["diag", "kron"])
def test_kron_conditional_four_branches(whiten, q_cov):
    rng = np.random.RandomState(int(whiten) + 2 * (q_cov == "kron"))
    G = 2
    Zs, ells, vars_, q_mu, q_sqrt, facs, X = _conditional_inputs(rng, G)
    masks = [(0, 1), (2,)]
    mu, var = tcond.kron_conditional(
        _t(X),
        [RBFValues(_t(e), _t(v)) for e, v in zip(ells, vars_)],
        [_t(Z) for Z in Zs],
        _t(q_mu),
        _t(q_sqrt),
        [torch.tensor(m) for m in masks],
        jitter=1e-6,
        whiten=whiten,
        q_sqrt_factors=[_t(C) for C in facs] if q_cov == "kron" else None,
    )
    assert mu.shape == var.shape == (G, 13, 1)
    for g in range(G):
        kerns = [JRBF.create(list(e[g]), v[g]) for e, v in zip(ells, vars_)]
        jmu, jvar = jcond.kron_conditional(
            jnp.asarray(X),
            kerns,
            [jnp.asarray(Z[g]) for Z in Zs],
            jnp.asarray(q_mu[g]),
            jnp.asarray(q_sqrt[g]),
            masks,
            jitter=1e-6,
            whiten=whiten,
            q_sqrt_factors=[jnp.asarray(C[g]) for C in facs] if q_cov == "kron" else None,
        )
        _close(mu[g], jmu)
        _close(var[g], jvar)


@pytest.mark.parametrize("exact", [False, True])
def test_probit_expectations(exact):
    rng = np.random.RandomState(4)
    gmean = 3.0 * rng.randn(50, 1)
    gvar = np.exp(2.0 * rng.randn(50, 1))
    t = tprobit.probit_expectations(_t(gmean), _t(gvar), exact=exact)
    j = jprobit.probit_expectations(jnp.asarray(gmean), jnp.asarray(gvar), exact=exact)
    for a, b in zip(t, j):
        _close(a, b)


def test_owen_t_exact_matches_scipy():
    from scipy.special import owens_t

    rng = np.random.RandomState(5)
    h, a = 2.0 * rng.rand(40), rng.rand(40)
    _close(tprobit.owen_t_exact(_t(h), _t(a)), owens_t(h, a), rtol=1e-9, atol=1e-13)


def test_likelihood_variational_expectations():
    from zigp_tpu.likelihoods import Gaussian as JGaussian
    from zigp_tpu.likelihoods import OnOffGaussian as JOnOff
    from zigp_tpu_torch.likelihoods import Gaussian as TGaussian
    from zigp_tpu_torch.likelihoods import OnOffGaussian as TOnOff

    rng = np.random.RandomState(6)
    Fmu, Y = rng.randn(20, 1), rng.randn(20, 1)
    Fvar, Fmuvar = rng.rand(20, 1), rng.rand(20, 1)
    with torch.no_grad():
        _close(
            TGaussian.create(0.3).variational_expectations(_t(Fmu), _t(Fvar), _t(Y)),
            JGaussian.create(0.3).variational_expectations(jnp.asarray(Fmu), jnp.asarray(Fvar), jnp.asarray(Y)),
        )
        _close(
            TOnOff.create(0.3).variational_expectations(_t(Fmu), _t(Fvar), _t(Fmuvar), _t(Y)),
            JOnOff.create(0.3).variational_expectations(
                jnp.asarray(Fmu), jnp.asarray(Fvar), jnp.asarray(Fmuvar), jnp.asarray(Y)
            ),
        )
