"""The port's L-only Cholesky (``ops/cuda/cholesky.py`` and ``chol_cuda``)
against the Pallas kernels of the JAX package.

On the CPU the CUDA wrappers run ``chol_plain``, the kernel's algorithm in
torch: ``rank`` columns per step, each column absorbing the step's earlier
columns before its pivot. The Pallas kernels run in interpret mode. In
float32 the tolerance is the Pallas tests' own (``tests/test_pallas.py``:
rtol 2e-4, atol 1e-4): both are f32 factorizations of the same matrices,
rounding in different orders. In float64 the plain version must match
numpy's LAPACK Cholesky to rtol 1e-10 on these well-conditioned inputs, at
every rank: n = 105 is a multiple of none of 2, 4 and 8, so a step whose
columns absorb each other in the wrong order fails there.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.ops.pallas.chol_inv import chol_pallas
from zigp_tpu.ops.pallas.cholesky import batched_small_cholesky, small_cholesky
from zigp_tpu_torch.ops.cuda import chol_inv as ci
from zigp_tpu_torch.ops.cuda import cholesky as sc

from .torch_helpers import one_torch_thread_per_module  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")


def _spd(rng, shape):
    *batch, n, _ = shape
    A = rng.randn(*batch, n, n)
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


def test_small_cholesky_matches_pallas_f32():
    K = _spd(np.random.RandomState(24), (24, 24)).astype(np.float32)
    L = sc.small_cholesky_cuda(torch.as_tensor(K))
    Lp = small_cholesky(jnp.asarray(K), interpret=True)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lp), rtol=2e-4, atol=1e-4)
    assert np.all(np.triu(L.numpy(), 1) == 0)


def test_batched_small_cholesky_matches_pallas_f32():
    K = _spd(np.random.RandomState(16), (5, 16, 16)).astype(np.float32)
    L = sc.batched_small_cholesky_cuda(torch.as_tensor(K))
    Lp = batched_small_cholesky(jnp.asarray(K), interpret=True)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lp), rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("n", [10, 32])
@pytest.mark.parametrize("rank", [2, 4, 8])
def test_chol_matches_chol_pallas_f32(n, rank):
    K = _spd(np.random.RandomState(n + rank), (2, n, n)).astype(np.float32)
    L = ci.chol_cuda(torch.as_tensor(K), rank=rank)  # CPU tensor: the plain version
    Lp = chol_pallas(jnp.asarray(K), interpret=True, rank=rank)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lp), rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("n", [100, 105])
@pytest.mark.parametrize("rank", [1, 2, 3, 4, 8, 128])
def test_chol_matches_numpy_f64(n, rank):
    K = _spd(np.random.RandomState(n), (2, n, n))
    L = ci.chol_cuda(torch.as_tensor(K), rank=rank).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(K), rtol=1e-10, atol=1e-12)
    assert np.all(np.triu(L, 1) == 0)


@pytest.mark.parametrize("n", [1, 100, 105])
def test_small_cholesky_matches_numpy_f64(n):
    K = _spd(np.random.RandomState(n), (3, n, n))
    L0 = np.linalg.cholesky(K)
    np.testing.assert_allclose(sc.small_cholesky_cuda(torch.as_tensor(K[0])).numpy(), L0[0], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(sc.batched_small_cholesky_cuda(torch.as_tensor(K)).numpy(), L0, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("rank", [1, 2, 4, 8])
def test_nan_on_non_psd(rank):
    """No pivot clamp: NaN from the failing pivot on, rows before it as they
    were, like ``small_cholesky`` and ``chol_pallas``."""
    K = np.eye(12, dtype=np.float32)[None].repeat(2, 0)
    K[:, 7, 7] = -1.0
    L = ci.chol_cuda(torch.as_tensor(K), rank=rank).numpy()
    assert np.isnan(L[:, 7:, 7:]).any()
    np.testing.assert_array_equal(L[:, :7, :7], np.broadcast_to(np.eye(7), (2, 7, 7)))
    Lp = np.asarray(chol_pallas(jnp.asarray(K), interpret=True, rank=rank))
    assert np.isnan(Lp[:, 7:, 7:]).any()
    L1 = sc.small_cholesky_cuda(torch.as_tensor(K[0])).numpy()
    assert np.isnan(L1[7:, 7:]).any() and np.array_equal(L1[:7, :7], np.eye(7))


def test_wrappers_check_shape_and_rank():
    K = torch.as_tensor(_spd(np.random.RandomState(0), (2, 6, 6)))
    with pytest.raises(ValueError):
        sc.small_cholesky_cuda(K)
    with pytest.raises(ValueError):
        sc.batched_small_cholesky_cuda(K[0])
    for rank in (0, -1, 2.0, True):
        with pytest.raises(ValueError):
            ci.chol_cuda(K, rank=rank)


@pytest.mark.parametrize("n", [10, 33, 100])
@pytest.mark.parametrize("nb", sc.NBS)
def test_chol_plain_at_kernel_width_matches_chol_pallas_f32(n, nb):
    """chol_plain at a width the kernel is built for is the kernel's order
    of operations; chol_pallas at the same rank is the TPU kernel's."""
    K = _spd(np.random.RandomState(n * nb), (2, n, n)).astype(np.float32)
    L = sc.chol_plain(torch.as_tensor(K), nb)
    Lp = chol_pallas(jnp.asarray(K), interpret=True, rank=nb)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lp), rtol=2e-4, atol=1e-4)
    assert np.all(np.triu(L.numpy(), 1) == 0)


@pytest.mark.parametrize("n", [240, 338])
@pytest.mark.parametrize("nb", sc.NBS)
def test_chol_plain_at_kernel_width_matches_numpy_f64(n, nb):
    """Past chol_inv.cu's limit and past chol.cu's shared-memory limit."""
    K = _spd(np.random.RandomState(n + nb), (1, n, n))
    np.testing.assert_allclose(sc.chol_plain(torch.as_tensor(K), nb).numpy(), np.linalg.cholesky(K), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("nb", sc.NBS)
def test_chol_plain_at_kernel_width_nan_on_non_psd(nb):
    K = np.eye(40, dtype=np.float32)[None].repeat(2, 0)
    K[:, 37, 37] = -1.0
    L = sc.chol_plain(torch.as_tensor(K), nb)
    assert torch.isnan(L[:, 37:, 37:]).any() and torch.equal(L[:, :37, :37], torch.eye(37).expand(2, 37, 37))


def test_launch_refuses_a_cpu_tensor_and_an_unbuilt_width():
    with pytest.raises(ValueError):
        sc.launch_chol(torch.eye(4)[None], "test")
    with pytest.raises(ValueError):
        sc.launch_chol(torch.eye(4)[None], "test", nb=32)
