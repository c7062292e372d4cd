"""The port's plain triangular inverses and ``chol_inv_stacked`` against the
JAX package, on the CPU.

``tri_inv_newton`` and ``tri_inv_dc`` are plain jnp in the JAX package and
plain torch in the port, the same algorithms: float64 on both sides must
agree to rtol 1e-10 (atol 1e-12 of the largest entry: both are exact
inverses up to rounding). Newton's documented float32 overflow on a dense
temporal factor is reproduced on both sides. ``chol_inv_stacked`` and its
gradient must equal the JAX function and ``jax.grad`` to rtol 1e-8, the
tolerance of the port's other gradient tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.ops import linalg as jlinalg
from zigp_tpu.ops.pallas import chol_inv as jchol_inv
from zigp_tpu_torch.ops import linalg
from zigp_tpu_torch.ops.cuda import chol_inv as ci

from .torch_helpers import one_torch_thread_per_module  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

NS = [1, 2, 3, 10, 100, 105, 128, 250]
# jitted: eager JAX dispatches (and compiles) every op of the DC levels alone
jax_tri_inv_dc = jax.jit(jchol_inv.tri_inv_dc)
jax_tri_inv_newton = jax.jit(jchol_inv.tri_inv_newton)


def _factor(n, seed):
    A = np.random.RandomState(seed).randn(2, n, n)
    return np.linalg.cholesky(A @ A.transpose(0, 2, 1) + n * np.eye(n))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", ["tri_inv_newton", "tri_inv_dc"])
def test_tri_inv_matches_jax_f64(n, name):
    L = _factor(n, seed=n)
    port = getattr(ci, name)(torch.as_tensor(L)).numpy()
    ref = np.asarray({"tri_inv_newton": jax_tri_inv_newton, "tri_inv_dc": jax_tri_inv_dc}[name](jnp.asarray(L)))
    np.testing.assert_allclose(port, ref, rtol=1e-10, atol=1e-12 * np.abs(ref).max())
    np.testing.assert_allclose(port, np.linalg.inv(L), rtol=1e-8, atol=1e-12)
    assert np.all(np.triu(port, 1) == 0)


def test_tri_inv_newton_overflows_on_dense_temporal_factor():
    """``tests/test_pallas.py:255-273`` on both sides: the tightly spaced 1-D
    RBF factor's inverse is bounded, but Newton's truncated-Neumann
    intermediates overflow float32; the divide-and-conquer inverse is finite
    and within 1e-3."""
    n = 256
    x = np.linspace(0, 1, n)[:, None]
    K = 20.0 * np.exp(-0.5 * (x - x.T) ** 2 / 0.1**2) + (1e-5 + 2e-4 * 20.0) * np.eye(n)
    L = np.linalg.cholesky(K).astype(np.float32)
    ref = np.linalg.inv(L.astype(np.float64))
    for newton, dc in ((ci.tri_inv_newton(torch.as_tensor(L)).numpy(), ci.tri_inv_dc(torch.as_tensor(L)).numpy()),
                       (np.asarray(jax_tri_inv_newton(jnp.asarray(L))), np.asarray(jax_tri_inv_dc(jnp.asarray(L))))):
        assert not np.isfinite(newton).all()
        assert np.isfinite(dc).all()
        assert np.max(np.abs(dc - ref)) / np.max(np.abs(ref)) < 1e-3


def _grams(seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for n in (4, 9, 6):
        A = rng.randn(2, n, n)
        out.append(A @ A.transpose(0, 2, 1) + n * np.eye(n))
    return out


def test_chol_inv_stacked_matches_jax_f64():
    Ks = _grams()
    port = linalg.chol_inv_stacked([torch.as_tensor(K) for K in Ks])
    ref = jlinalg.chol_inv_stacked([jnp.asarray(K) for K in Ks])
    assert len(port) == len(ref) == 3
    for (L, Li), (Lj, Lij), K in zip(port, ref, Ks):
        assert L.shape == K.shape and Li.shape == K.shape
        np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(Li.numpy(), np.asarray(Lij), rtol=1e-8, atol=1e-12)
    (L1, Li1), = linalg.chol_inv_stacked([torch.as_tensor(Ks[0])])
    np.testing.assert_allclose(L1.numpy(), np.linalg.cholesky(Ks[0]), rtol=1e-10, atol=1e-12)


def test_chol_inv_stacked_gradient_matches_jax_grad():
    Ks = _grams(1)
    rng = np.random.RandomState(2)
    W = [(rng.randn(*K.shape), rng.randn(*K.shape)) for K in Ks]

    def jax_loss(*Ks):
        return sum(jnp.sum(jnp.asarray(a) * L) + jnp.sum(jnp.asarray(b) * Li)
                   for (L, Li), (a, b) in zip(jlinalg.chol_inv_stacked(list(Ks)), W))

    g_ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(K) for K in Ks))
    Kt = [torch.as_tensor(K).requires_grad_(True) for K in Ks]
    loss = sum(torch.sum(torch.as_tensor(a) * L) + torch.sum(torch.as_tensor(b) * Li)
               for (L, Li), (a, b) in zip(linalg.chol_inv_stacked(Kt), W))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jax_loss(*(jnp.asarray(K) for K in Ks))), rtol=1e-10)
    for K, g in zip(Kt, g_ref):
        np.testing.assert_allclose(K.grad.numpy(), np.asarray(g), rtol=1e-8, atol=1e-12)
