"""Dense and Kronecker-factored linear algebra for the serving path.

Counterpart of ``zigp_tpu/ops/linalg.py``: ``add_jitter``, the ``chol_inv``
dispatch, and the factored Kronecker solves against precomputed triangular
inverses. The JAX package routes every solve-replacing product through
``hdot``/``bdot`` to pin it at exact float32; here those are plain matmuls,
exact in float32 because ``core.config`` turns TF32 off at import.

Every function takes leading batch dimensions, which is how the on/off model
runs its f and g GPs through one pass (the JAX package's ``vmap``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .cuda.chol_inv import BLOCKED_MAX_N, MAX_N, chol_inv_blocked, chol_inv_cuda


def add_jitter(K: torch.Tensor, jitter: float, *, relative_f32: float = 2.0e-4) -> torch.Tensor:
    """K + jitter·I, plus ``relative_f32 · mean(diag K)`` in float32 only.

    The absolute jitters are tuned for float64; an f32 gram with diag ≈ 20
    and near-duplicate rows carries rounding eigen-perturbations of order
    M·eps·σ², which the relative term (about 1600 f32 eps) absorbs. Float64
    grams get the absolute jitter alone, so the f64 parity path is the
    reference's."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    if K.dtype == torch.float32 and relative_f32:
        mean_diag = torch.diagonal(K, dim1=-2, dim2=-1).mean(-1)
        return K + (jitter + relative_f32 * mean_diag)[..., None, None] * eye
    return K + jitter * eye


def chol_inv_route(n: int, dtype: torch.dtype, device_type: str) -> str:
    """Which implementation ``chol_inv`` takes (``zigp_tpu/ops/linalg.py:
    138-151``): float32 on the card goes to the CUDA kernel for n ≤ 128 and
    to the blocked routine for n ≤ 512; anything else, the CPU included, to
    the library Cholesky and triangular solve, where the JAX package leaves
    it to XLA."""
    if dtype == torch.float32 and device_type == "cuda":
        if n <= MAX_N:
            return "kernel"
        if n <= BLOCKED_MAX_N:
            return "blocked"
    return "library"


def chol_inv(K: torch.Tensor):
    """(L, L⁻¹) with L = chol(K), batched over leading dims. Forward only on
    the card (see ``ops.cuda.chol_inv``)."""
    route = chol_inv_route(K.shape[-1], K.dtype, K.device.type)
    if route == "kernel":
        return chol_inv_cuda(K.contiguous())
    if route == "blocked":
        return chol_inv_blocked(K)
    L = torch.linalg.cholesky(K)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device).expand_as(K)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def _apply_factor_mats(mats: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(⊗_p mats[p]) x without forming the product: x (..., N, K) with
    N = Π M_p, mats[p] (..., M_p, M_p). Each factor is applied as a matmul
    on x reshaped to (M_p, N / M_p) per column, then its index is rotated to
    the back; after all factors the row-major order is restored (the
    reshape-shuffle matvec of ``zigp_tpu``'s ``_apply_factor_ops``)."""
    *batch, N, K = x.shape
    b = x.transpose(-1, -2)  # (..., K, N): columns are independent
    for A in mats:
        s = A.shape[-1]
        X = b.reshape(*batch, K, s, N // s)
        b = (A.unsqueeze(-3) @ X).transpose(-1, -2).reshape(*batch, K, N)
    return b.transpose(-1, -2)


def kron_linv_lower(Linvs: Sequence[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    """x = (⊗_p L_p)⁻¹ b given the triangular inverses L_p⁻¹: matmuls only."""
    return _apply_factor_mats(Linvs, b)


def kron_linv_solve(Linvs: Sequence[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    """x = (⊗_p K_p)⁻¹ b = (⊗ L_p⁻ᵀ)(⊗ L_p⁻¹) b given the triangular inverses."""
    half = kron_linv_lower(Linvs, b)
    return _apply_factor_mats([Li.transpose(-1, -2) for Li in Linvs], half)
