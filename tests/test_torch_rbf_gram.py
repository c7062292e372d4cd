"""The port's RBF gram (``ops.cuda.rbf_gram``) against the JAX package, on
the CPU, where the wrapper runs its plain version.

- The plain version against the Pallas ``rbf_gram`` in interpret mode, in
  float32 at ``tests/test_pallas.py:19-25``'s rtol 2e-5 and atol 1e-6, and
  against ``SquaredExponential.K`` in float64 at rtol 1e-12.
- The autograd Function's gradients against ``jax.grad`` of the XLA gram in
  float64 (rtol 1e-10: the same derivatives, summed in another order).
- The plain backward ``rbf_gram_bwd_plain`` (what the CUDA backward kernel
  computes) against ``jax.vjp`` of the XLA gram in float64 at rtol 1e-10,
  over the layouts (X and Z per kernel or shared, K(X, X)), D = 1, 2, 3, 5
  and the gradients asked; the Function's backward on CPU tensors is the
  plain backward, and launches nothing.
- At the pptr time column (t ≈ 5, ℓ = 0.005), the Function's float32 dℓ is
  within 1e-3 of float64; the JAX VJP's float32 expansion form is not. The
  second is a fact of the reference (ROADMAP Queue 3), recorded here.
- ``use_kernel`` on the CPU gives the plain gram, and the f/g pair still
  stacks; the flag reaches every factor, the covariate factor (D > 3) too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.ops.kernels import RBF as JRBF
from zigp_tpu.ops.pallas.rbf_gram import rbf_gram as jax_rbf_gram
from zigp_tpu_torch.io.datasets import synthetic_pptr
from zigp_tpu_torch.ops.cuda import rbf_gram as rg
from zigp_tpu_torch.ops.kernels import RBF as TRBF
from zigp_tpu_torch.ops.kernels import RBFValues

from .torch_helpers import one_torch_thread_per_module  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

T_SPAN = (4.368, 5.447)  # the pptr time column, hours ÷ 1000


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("D", [1, 2, 3, 5])
def test_plain_matches_pallas_interpret_f32(D):
    rng = np.random.RandomState(D)
    X = rng.randn(2, 70, D).astype(np.float32)
    Z = rng.randn(33, D).astype(np.float32)  # shared by the pair, as x_p is
    ell = (0.6 + rng.rand(2, D)).astype(np.float32)
    var = np.array([1.7, 0.4], np.float32)
    got = rg.rbf_gram_plain(_t(X, torch.float32), _t(Z, torch.float32), _t(ell, torch.float32), _t(var, torch.float32))
    assert got.shape == (2, 70, 33) and got.dtype == torch.float32
    for g in range(2):
        want = jax_rbf_gram(jnp.asarray(X[g]), jnp.asarray(Z), jnp.asarray(ell[g]), var[g], True)
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_plain_matches_squared_exponential_f64(D):
    rng = np.random.RandomState(10 + D)
    X, Z = rng.randn(2, 15, D), rng.randn(2, 9, D)
    ell, var = 0.5 + rng.rand(2, D), np.array([2.7, 0.3])
    got = rg.rbf_gram_plain(_t(X), _t(Z), _t(ell), _t(var))
    for g in range(2):
        want = JRBF.create(list(ell[g]), var[g]).K(jnp.asarray(X[g]), jnp.asarray(Z[g]))
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)


def _jax_xla_gram(X, Z, ell, var):
    d = jnp.sum(((X[:, None, :] - Z[None, :, :]) / ell) ** 2, -1)
    return var * jnp.exp(-0.5 * d)


@pytest.mark.parametrize("layout", ["cross", "shared_data", "symmetric"])
def test_function_gradients_match_jax_grad_f64(layout):
    """cross: X and Z both batched; shared_data: Z is the minibatch (2-D,
    no grad), as K_mn's x_p; symmetric: K(Z, Z), as K_mm."""
    rng = np.random.RandomState({"cross": 0, "shared_data": 1, "symmetric": 2}[layout])
    X = rng.randn(2, 12, 2)
    Z = X if layout == "symmetric" else (rng.randn(7, 2) if layout == "shared_data" else rng.randn(2, 7, 2))
    ell, var = 0.7 + rng.rand(2, 2), np.array([1.3, 0.6])
    cot = rng.randn(2, 12, Z.shape[-2])

    Xt = _t(X).requires_grad_(True)
    Zt = Xt if layout == "symmetric" else _t(Z).requires_grad_(layout == "cross")
    lt, vt = _t(ell).requires_grad_(True), _t(var).requires_grad_(True)
    torch.sum(torch.sin(RBFValues(lt, vt).K(Xt, Zt, use_kernel=True)) * _t(cot)).backward()

    def loss(X, Z, ell, var):
        Zb = X if layout == "symmetric" else Z
        return sum(
            jnp.sum(jnp.sin(_jax_xla_gram(X[g], Zb if Zb.ndim == 2 else Zb[g], ell[g], var[g])) * cot[g])
            for g in range(2)
        )

    jg = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (X, Z, ell, var)))
    np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(jg[0]), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg[2]), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(jg[3]), rtol=1e-10, atol=1e-13)
    if layout == "cross":
        np.testing.assert_allclose(Zt.grad.numpy(), np.asarray(jg[1]), rtol=1e-10, atol=1e-13)
    if layout == "shared_data":
        assert Zt.grad is None


BWD_NEEDS = {"all": (True, True, True, True), "X and Z": (True, True, False, False),
             "ell and var": (False, False, True, True), "X alone": (True, False, False, False)}


@functools.lru_cache(maxsize=None)
def _bwd_case(layout, D):
    """Inputs of G = 2 kernels and JAX's vjp of the XLA gram at them, for
    every gradient (one JAX call for the four choices of what is asked)."""
    rng = np.random.RandomState(D)
    G, N, M = 2, 6, 5
    X = rng.randn(N, D) if layout == "shared X" else rng.randn(G, N, D)
    Z = X if layout == "K(X, X)" else rng.randn(M, D) if layout == "shared Z" else rng.randn(G, M, D)
    ell, var = 0.5 + rng.rand(G, D), 1.0 + rng.rand(G)
    gK = rng.randn(G, N, Z.shape[-2])
    per_g = lambda T, g: T if T.ndim == 2 else T[g]

    def gram(X, Z, ell, var):
        return jnp.stack([_jax_xla_gram(per_g(X, g), per_g(Z, g), ell[g], var[g]) for g in range(G)])

    K, vjp = jax.vjp(jax.jit(gram), *(jnp.asarray(a) for a in (X, Z, ell, var)))
    return (X, Z, ell, var, np.array(K), gK), [np.asarray(a) for a in vjp(jnp.asarray(gK))]


@pytest.mark.parametrize("needs", list(BWD_NEEDS))
@pytest.mark.parametrize("D", [1, 2, 3, 5])
@pytest.mark.parametrize("layout", ["per kernel", "shared X", "shared Z", "K(X, X)"])
def test_bwd_plain_matches_jax_vjp_f64(layout, D, needs):
    """(dX, dZ, dℓ, dσ²) of sum(gK ⊙ K) for G = 2 kernels; a shared (2-D)
    side's gradient is the sum over the kernels, as JAX's vjp gives it;
    what is not asked for is None."""
    (X, Z, ell, var, K, gK), want = _bwd_case(layout, D)
    Xt = _t(X)
    Zt = Xt if layout == "K(X, X)" else _t(Z)
    got = rg.rbf_gram_bwd_plain(Xt, Zt, _t(ell), _t(var), _t(K), _t(gK), BWD_NEEDS[needs])
    for name, asked, a, b in zip(("dX", "dZ", "dell", "dvar"), BWD_NEEDS[needs], got, want):
        if not asked:
            assert a is None, name
            continue
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-13, err_msg=name)


def test_function_backward_on_cpu_is_the_plain_backward(monkeypatch):
    calls = []
    plain = rg.rbf_gram_bwd_plain
    monkeypatch.setattr(rg, "rbf_gram_bwd_plain", lambda *a: calls.append(a[-1]) or plain(*a))
    rng = np.random.RandomState(4)
    Z = _t(rng.randn(2, 5, 2)).requires_grad_(True)
    ell, var = _t(0.5 + rng.rand(2, 2)).requires_grad_(True), _t(1.0 + rng.rand(2))
    before = rg.rbf_gram_bwd_cuda.launches
    rg.rbf_gram(Z, _t(rng.randn(7, 2)), ell, var).sum().backward()
    assert calls == [(True, False, True, False)]  # Z, the shared data, ell, var
    assert rg.rbf_gram_bwd_cuda.launches == before
    assert Z.grad is not None and ell.grad is not None


def test_single_kernel_and_shared_lengthscale():
    """Unbatched values ((D,) and ()) give an (N, M) gram; a single
    lengthscale is shared by all input dimensions and its gradient summed."""
    rng = np.random.RandomState(3)
    X, Z = rng.randn(6, 2), rng.randn(4, 2)
    ell = _t([0.8]).requires_grad_(True)
    K = rg.rbf_gram(_t(X), _t(Z), ell, _t(1.5))
    assert K.shape == (6, 4)
    K.sum().backward()
    jg = jax.grad(lambda l: jnp.sum(_jax_xla_gram(jnp.asarray(X), jnp.asarray(Z), l, 1.5)))(jnp.asarray([0.8]))
    np.testing.assert_allclose(K.detach().numpy(), np.asarray(_jax_xla_gram(X, Z, 0.8, 1.5)), rtol=1e-12)
    np.testing.assert_allclose(ell.grad.numpy(), np.asarray(jg), rtol=1e-10)


def _time_column_case(n=1000, m=100, seed=0):
    rng = np.random.RandomState(seed)
    X = T_SPAN[0] + (T_SPAN[1] - T_SPAN[0]) * rng.rand(n, 1)
    Z = np.linspace(*T_SPAN, m)[:, None]
    return X, Z, rng.randn(n, m)


def test_dell_f32_at_the_time_column_difference_form_vs_jax_expansion():
    """t ≈ 5, ℓ = 0.005, var 20, 1000 points × 100 knots, a fixed cotangent.
    The float64 oracle sums W (x − z)² / ℓ³ directly."""
    X, Z, gK = _time_column_case()
    ell, var = 0.005, 20.0
    d = X[:, None, 0] - Z[None, :, 0]
    want = np.sum(gK * var * np.exp(-0.5 * d**2 / ell**2) * d**2) / ell**3

    lt = _t([ell], torch.float32).requires_grad_(True)
    K = rg.rbf_gram(_t(X, torch.float32), _t(Z, torch.float32), lt, _t(var, torch.float32))
    torch.sum(K * _t(gK, torch.float32)).backward()
    port_err = abs(float(lt.grad[0]) - want) / abs(want)
    assert port_err < 1e-3

    f32 = lambda a: jnp.asarray(a, jnp.float32)
    _, vjp = jax.vjp(lambda l: jax_rbf_gram(f32(X), f32(Z), l, jnp.float32(var), True), f32([ell]))
    jax_err = abs(float(vjp(f32(gK))[0][0]) - want) / abs(want)
    # a recorded fact of the reference, not a port requirement: its float32
    # expansion form loses dℓ here (ROADMAP Queue 3)
    assert jax_err > 1e-2 > 10 * port_err


def test_use_kernel_on_cpu_gives_the_plain_gram_and_the_pair_stacks():
    from zigp_tpu_torch.experiments import configs as tconfigs
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr

    split = synthetic_pptr(8, 24, seed=0)
    cfg = tconfigs.OnOffPptrConfig(grid=tconfigs.KronGridConfig(4, 12))
    on = build_onoff_pptr(cfg, split, device="cpu", dtype=torch.float64, use_kernel=True)
    off = build_onoff_pptr(cfg, split, device="cpu", dtype=torch.float64)
    assert on.f.kernel_flags() == (True, True) and off.f.kernel_flags() == (False, False)
    assert on._pairable() and on.f.signature() != off.f.signature()
    X, Y = _t(split.Xtrain[:32]), _t(split.Ytrain[:32])
    before = rg.rbf_gram_cuda.launches
    with torch.no_grad():
        for Ka, Kb in zip(on.f.gram_factors(), off.f.gram_factors()):
            np.testing.assert_allclose(Ka.numpy(), Kb.numpy(), rtol=1e-12, atol=1e-14)
        paired = float(on.elbo(X, Y))
        on.pair_gps = False
        unpaired = float(on.elbo(X, Y))
        np.testing.assert_allclose(paired, float(off.elbo(X, Y)), rtol=1e-10)
    np.testing.assert_allclose(paired, unpaired, rtol=1e-12)
    assert rg.rbf_gram_cuda.launches == before  # CPU tensors launch nothing


def test_use_kernel_reaches_the_covariate_factor():
    """Inputs with 4 covariate columns add a factor over them; the flag is
    on for it as for the others, and its gram and the ELBO are the flag-off
    model's."""
    from zigp_tpu_torch.experiments import configs as tconfigs
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.io.datasets import Split

    split = synthetic_pptr(8, 24, seed=0)
    rng = np.random.RandomState(1)
    split = Split(np.hstack([split.Xtrain, rng.randn(len(split.Xtrain), 4)]), split.Ytrain,
                  np.hstack([split.Xtest, rng.randn(len(split.Xtest), 4)]), split.Ytest)
    cfg = tconfigs.OnOffPptrConfig(grid=tconfigs.KronGridConfig(4, 12, num_exog=5))
    on = build_onoff_pptr(cfg, split, device="cpu", dtype=torch.float64, use_kernel=True)
    off = build_onoff_pptr(cfg, split, device="cpu", dtype=torch.float64)
    assert on.f.kernel_flags() == on.g.kernel_flags() == (True, True, True)
    assert [Z.shape[-1] for Z in on.f.Zs] == [2, 1, 4]
    X, Y = _t(split.Xtrain[:32]), _t(split.Ytrain[:32])
    with torch.no_grad():
        for Ka, Kb in zip(on.f.gram_factors(), off.f.gram_factors()):
            np.testing.assert_allclose(Ka.numpy(), Kb.numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(float(on.elbo(X, Y)), float(off.elbo(X, Y)), rtol=1e-10)
