"""(L, L⁻¹) of a batch of small SPD matrices: the hand-written CUDA kernel,
its plain PyTorch version, and the blocked routine for 128 < n ≤ 512.

Counterpart of ``zigp_tpu/ops/pallas/chol_inv.py``:

- ``chol_inv_cuda`` replaces ``chol_inv_pallas``. On a CUDA float32 tensor it
  launches ``csrc/chol_inv.cu`` (one CTA per matrix, n ≤ 128, A and L⁻¹ in
  shared memory); on a CPU tensor it runs ``chol_inv_plain``. There is no
  fallback: a CUDA tensor the kernel cannot take raises.
- ``chol_inv_plain`` is the same algorithm in torch: a right-looking
  Cholesky, one column per step, with forward substitution on I carried
  along. No pivot clamp, so a non-PSD input gives NaN from the failing pivot
  on, as the TPU kernel does.
- ``chol_inv_blocked`` replaces ``chol_inv_blocked``: ragged diagonal blocks
  of at most 128 go through ``chol_inv_cuda`` (so the kernel on the card and
  the plain version on the CPU); the panels, trailing Schur updates and the
  block forward substitution are float32 matmuls, exact because
  ``core.config`` turns TF32 off at import.

The kernel is forward-only in this package: gradients through ``chol_inv``
come with training, as a ``torch.autograd.Function`` whose backward is the
matmul-only rule of ``zigp_tpu/ops/linalg.py:177-211``. Until then the CUDA
wrapper raises on an input that requires grad, so no wrong gradient flows.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

MAX_N = 128  # the kernel's limit: A and L⁻¹ of one matrix in shared memory
BLOCKED_MAX_N = 512

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        from . import _build

        fn = _build.load("chol_inv").zigp_chol_inv_f32
        fn.argtypes = [
            ctypes.c_void_p,  # K
            ctypes.c_void_p,  # L
            ctypes.c_void_p,  # Linv
            ctypes.c_int,  # n
            ctypes.c_int,  # G
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def chol_inv_plain(K: torch.Tensor):
    """(L, L⁻¹) of (..., n, n) SPD ``K`` in any float dtype: the kernel's
    algorithm, column by column. Step j takes the pivot √A[j,j], scales
    column j of L and row j of L⁻¹ by it, then applies the rank-1 update to
    the trailing block and the forward-substitution update to the rows of
    L⁻¹ below j."""
    n = K.shape[-1]
    A = K.clone()
    B = torch.eye(n, dtype=K.dtype, device=K.device).expand_as(K).clone()
    for j in range(n):
        piv = torch.sqrt(A[..., j, j])
        col = A[..., j + 1 :, j] / piv[..., None]
        row = B[..., j, : j + 1] / piv[..., None]
        A[..., j, j] = piv
        A[..., j + 1 :, j] = col
        B[..., j, : j + 1] = row
        A[..., j + 1 :, j + 1 :] -= col[..., :, None] * col[..., None, :]
        B[..., j + 1 :, : j + 1] -= col[..., :, None] * row[..., None, :]
    return torch.tril(A), torch.tril(B)


def chol_inv_cuda(K: torch.Tensor):
    """(L, L⁻¹) of (..., n, n) SPD ``K``. A CUDA tensor goes to the kernel
    (float32, contiguous, n ≤ 128, no grad; anything else raises); a CPU
    tensor goes to ``chol_inv_plain``. Each kernel launch adds one to
    ``chol_inv_cuda.launches`` and to ``chol_inv_cuda.launches_by_n[n]``."""
    if K.device.type == "cpu":
        return chol_inv_plain(K)
    if K.device.type != "cuda":
        raise ValueError(f"chol_inv_cuda: unsupported device {K.device}")
    if K.dtype != torch.float32:
        raise TypeError(f"chol_inv_cuda: the kernel takes float32, got {K.dtype}")
    if K.ndim < 2 or K.shape[-1] != K.shape[-2]:
        raise ValueError(f"chol_inv_cuda: expected (..., n, n), got {tuple(K.shape)}")
    n = K.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"chol_inv_cuda: the kernel takes 1 <= n <= {MAX_N}, got n={n}")
    if not K.is_contiguous():
        raise ValueError("chol_inv_cuda: input must be contiguous")
    if K.requires_grad:
        raise RuntimeError(
            "chol_inv_cuda is forward-only: its backward comes with the training "
            "port; call it under torch.no_grad() or torch.inference_mode()"
        )
    G = K.numel() // (n * n)
    L = torch.empty_like(K)
    Linv = torch.empty_like(K)
    if G == 0:
        return L, Linv
    fn = _kernel_fn()
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        err = fn(K.data_ptr(), L.data_ptr(), Linv.data_ptr(), n, G, stream)
    if err != 0:
        raise RuntimeError(f"chol_inv kernel launch failed: cudaError {err} (n={n}, G={G})")
    chol_inv_cuda.launches += 1
    chol_inv_cuda.launches_by_n[n] += 1
    return L, Linv


chol_inv_cuda.launches = 0
chol_inv_cuda.launches_by_n = Counter()


def block_offsets(n: int) -> list[int]:
    """Ragged adaptive diagonal blocks: n split evenly into ⌈n/128⌉ blocks,
    the size rounded up to a multiple of 8 (n=200 → 104 + 96), as
    ``zigp_tpu``'s ``chol_inv_blocked`` does. Returns the block offsets
    [0, ..., n]."""
    nblk = -(-n // MAX_N)
    even = -(-n // nblk)
    nb = -(-even // 8) * 8
    return list(range(0, n, nb)) + [n]


def chol_inv_blocked(K: torch.Tensor):
    """Blocked (L, L⁻¹) of (..., n, n) SPD ``K``, for 128 < n ≤ 512: a
    right-looking block Cholesky whose diagonal blocks go through
    ``chol_inv_cuda``, then L⁻¹ by block forward substitution,
    (L⁻¹)_ij = −L_ii⁻¹ Σ_k L_ik (L⁻¹)_kj."""
    n = K.shape[-1]
    offs = block_offsets(n)
    nblk = len(offs) - 1
    blocks = [slice(offs[i], offs[i + 1]) for i in range(nblk)]
    A = K.clone()
    L = torch.zeros_like(K)
    Linv = torch.zeros_like(K)
    mT = lambda a: a.transpose(-1, -2)

    Ld_inv = []
    for i, d in enumerate(blocks):
        Lii, Linv_ii = chol_inv_cuda(A[..., d, d].contiguous())
        L[..., d, d] = Lii
        Ld_inv.append(Linv_ii)
        if i + 1 < nblk:
            t = slice(offs[i + 1], n)
            Ati = A[..., t, d]
            P = Ati @ mT(Linv_ii)  # panel L[t, i] = A[t, i] L_ii⁻ᵀ
            # One step of refinement against L_ii: a product with the explicit
            # inverse errs by about cond(L_ii)·eps, a triangular solve by eps;
            # the step brings the panel back to the solve's accuracy. Without
            # it the f32 error of L at n = 512 was 3.5x cuSOLVER's on an H100.
            P = P + (Ati - P @ mT(Lii)) @ mT(Linv_ii)
            L[..., t, d] = P
            A[..., t, t] -= P @ mT(P)

    for i, di in enumerate(blocks):
        Linv[..., di, di] = Ld_inv[i]
        for j in range(i - 1, -1, -1):
            dj = blocks[j]
            S = sum(L[..., di, blocks[k]] @ Linv[..., blocks[k], dj] for k in range(j, i))
            Linv[..., di, dj] = -(Ld_inv[i] @ S)
    return L, Linv
