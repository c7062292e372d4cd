"""The port's chol_inv against the Pallas kernels of the JAX package.

On the CPU the port's CUDA wrapper runs its plain version, the kernel's
algorithm in torch; the Pallas kernels run in interpret mode. In float32 the
tolerance is the Pallas tests' own (``tests/test_pallas.py``: rtol 2e-4,
atol 1e-4): both are f32 factorizations of the same matrices, rounding in
different orders. In float64 the plain version must match numpy's LAPACK
Cholesky and inverse to rtol 1e-10 on these well-conditioned inputs.

The kernel itself runs only on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.ops.pallas.chol_inv import chol_inv_blocked as jax_chol_inv_blocked
from zigp_tpu.ops.pallas.chol_inv import chol_inv_pallas
from zigp_tpu_torch.ops import linalg
from zigp_tpu_torch.ops.cuda import chol_inv as ci


def _spd(rng, shape):
    *batch, n, _ = shape
    A = rng.randn(*batch, n, n)
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


@pytest.mark.parametrize("n", [5, 10, 12, 32, 100])
def test_plain_matches_pallas_f32(n):
    K = _spd(np.random.RandomState(n), (2, n, n)).astype(np.float32)
    L, Linv = ci.chol_inv_cuda(torch.as_tensor(K))  # CPU tensor: the plain version
    Lp, Linvp = chol_inv_pallas(jnp.asarray(K), interpret=True)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lp), rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(Linv.numpy(), np.asarray(Linvp), rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("n", [1, 7, 64, 128])
def test_plain_matches_numpy_f64(n):
    K = _spd(np.random.RandomState(100 + n), (3, n, n))
    L, Linv = ci.chol_inv_plain(torch.as_tensor(K))
    L0 = np.linalg.cholesky(K)
    np.testing.assert_allclose(L.numpy(), L0, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(Linv.numpy(), np.linalg.inv(L0), rtol=1e-10, atol=1e-12)
    assert np.all(np.triu(L.numpy(), 1) == 0) and np.all(np.triu(Linv.numpy(), 1) == 0)


@pytest.mark.parametrize("n", [130, 200, 250])
def test_blocked_matches_pallas_blocked_f32(n):
    K = _spd(np.random.RandomState(n), (2, n, n)).astype(np.float32)
    L, Linv = ci.chol_inv_blocked(torch.as_tensor(K))
    Lp, Linvp = jax_chol_inv_blocked(jnp.asarray(K), interpret=True)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lp), rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(Linv.numpy(), np.asarray(Linvp), rtol=2e-4, atol=1e-4)
    assert np.all(np.triu(L.numpy(), 1) == 0) and np.all(np.triu(Linv.numpy(), 1) == 0)


def test_blocked_matches_numpy_f64():
    K = _spd(np.random.RandomState(7), (2, 300, 300))
    L, Linv = ci.chol_inv_blocked(torch.as_tensor(K))
    L0 = np.linalg.cholesky(K)
    np.testing.assert_allclose(L.numpy(), L0, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(Linv.numpy(), np.linalg.inv(L0), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize(
    "n, offsets", [(130, [0, 72, 130]), (200, [0, 104, 200]), (250, [0, 128, 250]), (512, [0, 128, 256, 384, 512])]
)
def test_block_offsets_match_jax_rule(n, offsets):
    assert ci.block_offsets(n) == offsets


def test_nan_on_non_psd():
    K = np.eye(12, dtype=np.float32)[None]
    K[0, 7, 7] = -1.0
    L, Linv = ci.chol_inv_cuda(torch.as_tensor(K))
    assert torch.isnan(L[0, 7:, 7:]).any()
    assert torch.isnan(Linv[0, 7:, :]).any()
    # the rows before the failing pivot are untouched
    assert torch.equal(L[0, :7, :7], torch.eye(7))


@pytest.mark.parametrize(
    "n, dtype, device, route",
    [
        (10, torch.float32, "cuda", "kernel"),
        (128, torch.float32, "cuda", "kernel"),
        (129, torch.float32, "cuda", "blocked"),
        (512, torch.float32, "cuda", "blocked"),
        (513, torch.float32, "cuda", "library"),
        (100, torch.float64, "cuda", "library"),
        (100, torch.float32, "cpu", "library"),
        (200, torch.float32, "cpu", "library"),
    ],
)
def test_dispatch_rule(n, dtype, device, route):
    assert linalg.chol_inv_route(n, dtype, device) == route


def test_chol_inv_cpu_library_route_matches_numpy():
    K = _spd(np.random.RandomState(3), (2, 20, 20))
    L, Linv = linalg.chol_inv(torch.as_tensor(K))
    L0 = np.linalg.cholesky(K)
    np.testing.assert_allclose(L.numpy(), L0, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(Linv.numpy(), np.linalg.inv(L0), rtol=1e-10, atol=1e-12)


def test_cpu_wrapper_counts_no_launch():
    before = ci.chol_inv_cuda.launches
    ci.chol_inv_cuda(torch.eye(4)[None])
    assert ci.chol_inv_cuda.launches == before
