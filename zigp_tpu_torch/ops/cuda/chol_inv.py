"""(L, L⁻¹) of a batch of small SPD matrices: the hand-written CUDA kernel,
its plain PyTorch version, and the blocked routine for the larger n.

Counterpart of ``zigp_tpu/ops/pallas/chol_inv.py``:

- ``chol_inv_cuda`` replaces ``chol_inv_pallas``. On a CUDA float32 tensor it
  launches ``csrc/chol_inv.cu`` (one CTA per matrix, n ≤ ``MAX_N``, A and L⁻¹
  as row-padded triangles in shared memory, the blocked register-tiled
  factorization of ``csrc/chol_tile.cuh`` at ``NB`` columns a step); on a CPU
  tensor it runs ``chol_inv_plain``. There is no fallback: a CUDA tensor the
  kernel cannot take raises.
- ``chol_inv_plain`` is the algorithm in torch: a right-looking Cholesky with
  forward substitution on I carried along, ``nb`` columns a step (nb = 1 is
  the column algorithm; nb = ``NB`` takes the kernel's operations in the
  kernel's order, dividing where the kernel multiplies by the pivot's
  reciprocal, so the two agree to rounding). No pivot clamp, so a non-PSD input gives NaN from the failing pivot
  on, as the TPU kernel does.
- ``chol_inv_blocked`` replaces ``chol_inv_blocked``: ragged diagonal blocks
  of at most ``BLOCK_N`` (the JAX package's rule) go through
  ``chol_inv_cuda`` (so the kernel on the card and the plain version on the
  CPU); the panels, trailing Schur updates and the block forward
  substitution are float32 matmuls, exact because ``core.config`` turns TF32
  off at import. ``ops.linalg`` sends it the n the kernel does not take, up
  to ``BLOCKED_MAX_N``.

These are forward functions. Gradients go through ``ops.linalg.chol_inv``, a
``torch.autograd.Function`` that calls them on a detached input and whose
backward is the matmul-only rule of ``zigp_tpu/ops/linalg.py:177-211``.

The L-only alternatives the JAX package keeps beside ``chol_inv_pallas`` as
its measured A/B record are here too:

- ``chol_cuda`` replaces ``chol_pallas``: L only, from ``csrc/chol.cu``
  (``cholesky.py``, the same tiled factorization at ``cholesky.NB``, whatever
  ``rank``) on a CUDA float32 tensor, and ``cholesky.chol_plain`` at ``rank``
  columns a step on a CPU tensor.
- ``tri_inv_newton`` and ``tri_inv_dc``, L⁻¹ of a lower-triangular L by
  matmuls only, are plain torch, as they are plain jnp in the JAX package.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter

import torch

from .cholesky import NB, NBS, check_rank, chol_plain, launch_chol

MAX_N = 238  # the kernel's limit on an H100: A and L⁻¹ as row-padded triangles in 227 KB of shared memory
BLOCK_N = 128  # the blocked routine's diagonal-block size rule, the JAX package's
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
            ctypes.c_int,  # nb, columns a block step
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def kernel_max_n() -> int:
    """The largest n the kernel takes on the current CUDA device (238 on an
    H100): A and L⁻¹ of one matrix within its opt-in shared memory."""
    from . import _build

    fn = _build.load("chol_inv").zigp_chol_inv_max_n
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()


def chol_inv_plain(K: torch.Tensor, nb: int = 1):
    """(L, L⁻¹) of (..., n, n) SPD ``K`` in any float dtype, ``nb`` columns a
    step. A step on the columns [j0, j1) factors them as
    ``cholesky.chol_plain(K, rank=nb)`` does (each column absorbs the step's
    earlier columns, then takes its pivot), forward-substitutes rows j0..j1−1
    of L⁻¹ against that diagonal block, then updates the trailing block and
    the rows of L⁻¹ below it by the step's columns in order. nb = 1 is the
    column algorithm; nb = ``NB`` is the kernel's order of operations (the
    kernel multiplies by each pivot's reciprocal where this divides)."""
    if isinstance(nb, bool) or not isinstance(nb, int) or nb < 1:
        raise ValueError(f"chol_inv_plain: nb must be an int >= 1, got {nb!r}")
    n = K.shape[-1]
    A = K.clone()
    B = torch.eye(n, dtype=K.dtype, device=K.device).expand_as(K).clone()
    for j0 in range(0, n, nb):
        j1 = min(j0 + nb, n)
        for j in range(j0, j1):
            col = A[..., j:, j]
            for e in range(j0, j):
                col = col - A[..., j:, e] * A[..., j, e, None]
            piv = torch.sqrt(col[..., 0])
            A[..., j + 1 :, j] = col[..., 1:] / piv[..., None]
            A[..., j, j] = piv
        for j in range(j0, j1):
            row = B[..., j, : j + 1]
            for e in range(j0, j):
                row = row - A[..., j, e, None] * B[..., e, : j + 1]
            B[..., j, : j + 1] = row / A[..., j, j, None]
        for c in range(j0, j1):
            A[..., j1:, j1:] -= A[..., j1:, c, None] * A[..., None, j1:, c]
            B[..., j1:, :j1] -= A[..., j1:, c, None] * B[..., None, c, :j1]
    return torch.tril(A), torch.tril(B)


def launch_chol_inv(K: torch.Tensor, who: str = "chol_inv_cuda", nb: int = NB):
    """(L, L⁻¹) of (..., n, n) CUDA float32 ``K`` from ``csrc/chol_inv.cu`` at
    ``nb`` columns a block step, for any n the device takes
    (``kernel_max_n()``); raises on anything the kernel cannot take. The
    caller counts the launch."""
    if K.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {K.device}")
    if K.dtype != torch.float32:
        raise TypeError(f"{who}: the kernel takes float32, got {K.dtype}")
    if K.ndim < 2 or K.shape[-1] != K.shape[-2] or K.shape[-1] < 1:
        raise ValueError(f"{who}: expected (..., n, n) with n >= 1, got {tuple(K.shape)}")
    if not K.is_contiguous():
        raise ValueError(f"{who}: input must be contiguous")
    if nb not in NBS:
        raise ValueError(f"{who}: the kernel is built for nb in {NBS}, got {nb!r}")
    n = K.shape[-1]
    G = K.numel() // (n * n)
    L = torch.empty_like(K)
    Linv = torch.empty_like(K)
    if G == 0:
        return L, Linv
    fn = _kernel_fn()
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        err = fn(K.data_ptr(), L.data_ptr(), Linv.data_ptr(), n, G, nb, stream)
    if err != 0:
        raise RuntimeError(f"{who}: chol_inv kernel launch failed: cudaError {err} (n={n}, G={G}, nb={nb}; "
                           f"the device takes n <= {kernel_max_n()})")
    return L, Linv


def chol_inv_cuda(K: torch.Tensor):
    """(L, L⁻¹) of (..., n, n) SPD ``K``. A CUDA tensor goes to the kernel at
    ``NB`` columns a step (float32, contiguous, n ≤ ``MAX_N``; anything else
    raises, as does a device whose shared memory cannot hold n); a CPU tensor
    goes to ``chol_inv_plain``. Each kernel launch adds one to
    ``chol_inv_cuda.launches`` and to ``chol_inv_cuda.launches_by_n[n]``."""
    if K.device.type == "cpu":
        return chol_inv_plain(K)
    n = K.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"chol_inv_cuda: the kernel takes 1 <= n <= {MAX_N}, got n={n}")
    L, Linv = launch_chol_inv(K)
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
    nblk = -(-n // BLOCK_N)
    even = -(-n // nblk)
    nb = -(-even // 8) * 8
    return list(range(0, n, nb)) + [n]


def chol_inv_blocked(K: torch.Tensor):
    """Blocked (L, L⁻¹) of (..., n, n) SPD ``K``, for n ≤ 512: a
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


def chol_cuda(K: torch.Tensor, rank: int = 4) -> torch.Tensor:
    """L = chol(K) of (..., n, n) SPD ``K`` (any n >= 1; no identity-tail
    padding). A CUDA tensor goes to the kernel at its ``cholesky.NB`` columns
    a step, whatever ``rank`` (float32, contiguous; anything else raises); a
    CPU tensor to ``chol_plain`` at ``rank`` columns a step, as
    ``chol_pallas`` computes it. Each kernel launch adds one to
    ``chol_cuda.launches`` and to ``chol_cuda.launches_by_shape[(G, n,
    rank)]``."""
    rank = check_rank(rank)
    if K.device.type == "cpu":
        return chol_plain(K, rank)
    L = launch_chol(K, "chol_cuda")
    n = K.shape[-1]
    chol_cuda.launches += 1
    chol_cuda.launches_by_shape[(K.numel() // (n * n), n, rank)] += 1
    return L


chol_cuda.launches = 0
chol_cuda.launches_by_shape = Counter()


def tri_inv_newton(L: torch.Tensor) -> torch.Tensor:
    """L⁻¹ of (..., n, n) lower-triangular ``L`` by Newton's iteration
    X ← X(2I − LX) from X₀ = diag(L)⁻¹, as ``zigp_tpu``'s ``tri_inv_newton``:
    the first level is elementwise (2D⁻¹ − D⁻¹LD⁻¹), then ⌈log₂n⌉ − 1 matmul
    steps, exact in exact arithmetic. No safeguard: where the strictly lower
    part of D⁻¹L is large, the truncated-Neumann intermediates overflow
    float32 (the pptr 250-knot temporal factor does), as in the reference."""
    n = L.shape[-1]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    d = 1.0 / torch.diagonal(L, dim1=-2, dim2=-1)
    X = 2.0 * eye * d[..., :, None] - L * d[..., :, None] * d[..., None, :]
    I2 = 2.0 * eye
    for _ in range(max(0, math.ceil(math.log2(max(n, 2))) - 1)):
        X = X @ (I2 - L @ X)
    return X


def tri_inv_dc(L: torch.Tensor) -> torch.Tensor:
    """L⁻¹ of (..., n, n) lower-triangular ``L`` by divide-and-conquer block
    inversion, as ``zigp_tpu``'s ``tri_inv_dc``: pad to the next power of two
    m with an identity tail, invert the m/2 diagonal 2 × 2 blocks
    elementwise, then double the block size log₂m − 1 times with
    inv([[A, 0], [B, C]]) = [[A⁻¹, 0], [−C⁻¹ B A⁻¹, C⁻¹]], every level's
    blocks as one batched matmul pair. Every intermediate is a final
    sub-inverse, so nothing overflows where L⁻¹ does not."""
    n = L.shape[-1]
    batch = L.shape[:-2]
    m = 1 << max(0, (n - 1).bit_length())
    if m != n:
        P = torch.zeros(*batch, m, m, dtype=L.dtype, device=L.device)
        P[..., :n, :n] = L
        idx = torch.arange(n, m, device=L.device)
        P[..., idx, idx] = 1.0
        L = P
    if m == 1:
        return (1.0 / L)[..., :n, :n]

    def diag_blocks(s):  # (..., m/s, s, s): the diagonal s × s blocks of L
        Lb = L.reshape(*batch, m // s, s, m // s, s)
        return torch.diagonal(Lb, dim1=-4, dim2=-2).movedim(-1, -3)

    Ld = diag_blocks(2)
    a, b, c = Ld[..., 0:1, 0:1], Ld[..., 1:2, 0:1], Ld[..., 1:2, 1:2]
    zero = torch.zeros_like(a)
    X = torch.cat([torch.cat([1.0 / a, zero], -1), torch.cat([-b / (a * c), 1.0 / c], -1)], -2)
    s = 2
    while s < m:
        L21 = diag_blocks(2 * s)[..., s:, :s]
        X11, X22 = X[..., 0::2, :, :], X[..., 1::2, :, :]
        X21 = -(X22 @ (L21 @ X11))
        X = torch.cat([torch.cat([X11, torch.zeros_like(X21)], -1), torch.cat([X21, X22], -1)], -2)
        s *= 2
    return X[..., 0, :n, :n]
