"""The port's CUDA kernel on the card: needs an NVIDIA GPU, skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch (the repository's conftest imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The kernel and the plain version run the same algorithm in float32 on the
same inputs, so they differ only by rounding (the kernel fuses multiply-adds):
on these well-conditioned matrices the relative Frobenius distance is held to
1e-5, about 100 float32 ulps.
"""

import numpy as np
import pytest
import torch

from zigp_tpu_torch.ops import linalg
from zigp_tpu_torch.ops.cuda import chol_inv as ci

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spd(n, G=2, seed=0):
    A = np.random.RandomState(seed).randn(G, n, n)
    return (A @ A.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


def _rel(a, b):
    return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))


@pytest.mark.parametrize("n", [1, 5, 10, 32, 100, 127, 128])
def test_kernel_matches_plain(cuda, n):
    K = torch.as_tensor(_spd(n, seed=n), device=cuda)
    before = ci.chol_inv_cuda.launches
    with torch.inference_mode():
        L, Linv = ci.chol_inv_cuda(K)
        Lp, Linvp = ci.chol_inv_plain(K)
    torch.cuda.synchronize()
    assert ci.chol_inv_cuda.launches == before + 1
    assert _rel(L, Lp) < 1e-5 and _rel(Linv, Linvp) < 1e-5
    assert torch.all(torch.triu(L, 1) == 0) and torch.all(torch.triu(Linv, 1) == 0)


@pytest.mark.parametrize("n", [200, 250])
def test_blocked_on_card_matches_plain(cuda, n):
    K = torch.as_tensor(_spd(n, seed=n), device=cuda)
    with torch.inference_mode():
        L, Linv = linalg.chol_inv(K)
        Lp, Linvp = ci.chol_inv_plain(K)
    assert _rel(L, Lp) < 1e-5 and _rel(Linv, Linvp) < 1e-5


def test_kernel_nan_on_non_psd(cuda):
    K = torch.eye(12, device=cuda)[None].repeat(2, 1, 1)
    K[:, 7, 7] = -1.0
    L, Linv = ci.chol_inv_cuda(K)
    assert torch.isnan(L[:, 7:, 7:]).any() and torch.isnan(Linv[:, 7:, :]).any()


def test_wrapper_raises_on_requires_grad(cuda):
    K = torch.eye(8, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ci.chol_inv_cuda(K)


def test_wrapper_raises_on_what_the_kernel_cannot_take(cuda):
    with pytest.raises(TypeError):
        ci.chol_inv_cuda(torch.eye(8, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        ci.chol_inv_cuda(torch.eye(129, device=cuda))
    with pytest.raises(ValueError):
        ci.chol_inv_cuda(torch.eye(16, device=cuda)[::2, ::2])
