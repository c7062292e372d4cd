"""Hand-written CUDA kernels for Hopper (sm_90a), built from ``csrc/`` at
first use (``_build``) and bound with ctypes: ``chol_inv`` (L and L⁻¹, one
CTA a matrix to n = 238 and one thread-block cluster a matrix to 512),
``cholesky`` (L only, any number of columns per step), ``rbf_gram`` (the
gram and its gradient),
``kron_matvec`` (the two-factor Kronecker matvec) and ``bf16x3`` (the 3-pass
bf16 product of the solve-precision policy, the TPU's Precision.HIGH)."""

from .bf16x3 import bf16x3_mm_cuda, bf16x3_mm_plain

from .chol_inv import (
    chol_cuda,
    chol_inv_blocked,
    chol_inv_blocked_plain,
    chol_inv_cluster_plain,
    chol_inv_cuda,
    chol_inv_plain,
    tri_inv_dc,
    tri_inv_newton,
)
from .cholesky import batched_small_cholesky_cuda, chol_plain, small_cholesky_cuda
from .kron_matvec import kron_mv_2_cuda, kron_mv_2_plain
from .rbf_gram import rbf_gram_bwd_cuda, rbf_gram_bwd_plain, rbf_gram_cuda, rbf_gram_plain  # not the Function: it would hide the module

__all__ = [
    "chol_inv_cuda",
    "chol_inv_plain",
    "chol_inv_blocked",
    "chol_inv_blocked_plain",
    "chol_inv_cluster_plain",
    "rbf_gram_cuda",
    "rbf_gram_plain",
    "rbf_gram_bwd_cuda",
    "rbf_gram_bwd_plain",
    # the JAX package's A/B alternatives to chol_inv (ops/pallas/__init__.py)
    "small_cholesky_cuda",
    "batched_small_cholesky_cuda",
    "chol_cuda",
    "chol_plain",
    "tri_inv_newton",
    "tri_inv_dc",
    "kron_mv_2_cuda",
    "kron_mv_2_plain",
    # the 3-pass bf16 product (no Pallas kernel: XLA's Precision.HIGH dot)
    "bf16x3_mm_cuda",
    "bf16x3_mm_plain",
]
