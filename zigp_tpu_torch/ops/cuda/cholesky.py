"""L = chol(K) only, for small SPD matrices: the hand-written CUDA kernel and
its plain PyTorch version.

Counterpart of ``zigp_tpu/ops/pallas/cholesky.py``:

- ``small_cholesky_cuda`` (one (n, n) matrix) and
  ``batched_small_cholesky_cuda`` (a (B, n, n) batch) replace
  ``small_cholesky`` and ``batched_small_cholesky``. On a CUDA float32 tensor
  they launch ``csrc/chol.cu``: one CTA per matrix, the blocked
  register-tiled factorization of ``csrc/chol_tile.cuh`` at ``NB`` columns a
  step, the matrix as a row-padded triangle in shared memory up to
  ``shared_max_n()`` and in place in global memory above. On a CPU tensor
  they run ``chol_plain`` one column a step, as the Pallas kernels do. There
  is no fallback: a CUDA tensor the kernel cannot take raises.
- ``chol_plain`` is the algorithm in torch, in any dtype: a right-looking
  Cholesky, ``rank`` columns per step. Each column of a step first absorbs
  the updates of the step's earlier columns, then takes its pivot; the
  trailing block then takes the step's ``rank`` rank-1 updates. At rank =
  ``NB`` these are the kernel's operations in the kernel's order, except
  that the kernel multiplies by the pivot's reciprocal where this divides,
  so the two agree to rounding. No pivot clamp:
  a non-PSD input gives NaN from the failing pivot on.

``chol_inv.chol_cuda`` (the counterpart of ``chol_pallas``) launches the
same kernel, at ``NB`` whatever its ``rank``.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

NB = 8  # both tiled kernels' columns a block step, chosen on the card (chip_smoke.py's sweep)
NBS = (4, 8, 16)  # the widths the kernel is built for

_fns = {}


def _lib_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        from . import _build

        fn = getattr(_build.load("chol"), name)
        if name == "zigp_chol_f32":
            fn.argtypes = [
                ctypes.c_void_p,  # K
                ctypes.c_void_p,  # L
                ctypes.c_int,  # n
                ctypes.c_int,  # G
                ctypes.c_int,  # nb, columns a block step
                ctypes.c_void_p,  # cudaStream_t
            ]
        else:
            fn.argtypes = []
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def shared_max_n() -> int:
    """The largest n the kernel holds in shared memory on the current CUDA
    device (337 on an H100); above it, it works in place on L in global
    memory."""
    return _lib_fn("zigp_chol_shared_max_n")()


def check_rank(rank) -> int:
    if isinstance(rank, bool) or not isinstance(rank, int) or rank < 1:
        raise ValueError(f"chol: rank must be an int >= 1, got {rank!r}")
    return rank


def chol_plain(K: torch.Tensor, rank: int = 1) -> torch.Tensor:
    """Lower L = chol(K) of (..., n, n) SPD ``K`` in any float dtype, ``rank``
    columns per step, as the kernel computes it."""
    rank = check_rank(rank)
    n = K.shape[-1]
    A = K.clone()
    for j0 in range(0, n, rank):
        t = min(j0 + rank, n)
        for j in range(j0, t):
            col = A[..., j:, j]
            for e in range(j0, j):
                col = col - A[..., j:, e] * A[..., j, e, None]
            piv = torch.sqrt(col[..., 0])
            A[..., j + 1 :, j] = col[..., 1:] / piv[..., None]
            A[..., j, j] = piv
        for c in range(j0, t):
            A[..., t:, t:] -= A[..., t:, c, None] * A[..., None, t:, c]
    return torch.tril(A)


def launch_chol(K: torch.Tensor, who: str, nb: int = NB) -> torch.Tensor:
    """L of (..., n, n) CUDA float32 ``K`` from ``csrc/chol.cu`` at ``nb``
    columns a block step; raises on anything the kernel cannot take. The
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
    if G == 0:
        return L
    fn = _lib_fn("zigp_chol_f32")
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        err = fn(K.data_ptr(), L.data_ptr(), n, G, nb, stream)
    if err != 0:
        raise RuntimeError(f"{who}: chol kernel launch failed: cudaError {err} (n={n}, G={G}, nb={nb})")
    return L


def small_cholesky_cuda(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of one (n, n) SPD matrix. Each kernel launch adds one
    to ``.launches`` and to ``.launches_by_shape[n]``."""
    if K.ndim != 2:
        raise ValueError(f"small_cholesky_cuda: expected (n, n), got {tuple(K.shape)}")
    if K.device.type == "cpu":
        return chol_plain(K)
    L = launch_chol(K, "small_cholesky_cuda")
    small_cholesky_cuda.launches += 1
    small_cholesky_cuda.launches_by_shape[K.shape[-1]] += 1
    return L


small_cholesky_cuda.launches = 0
small_cholesky_cuda.launches_by_shape = Counter()


def batched_small_cholesky_cuda(Ks: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of a (B, n, n) batch of SPD matrices, one CTA per
    matrix. Each kernel launch adds one to ``.launches`` and to
    ``.launches_by_shape[(B, n)]``."""
    if Ks.ndim != 3:
        raise ValueError(f"batched_small_cholesky_cuda: expected (B, n, n), got {tuple(Ks.shape)}")
    if Ks.device.type == "cpu":
        return chol_plain(Ks)
    L = launch_chol(Ks, "batched_small_cholesky_cuda")
    batched_small_cholesky_cuda.launches += 1
    batched_small_cholesky_cuda.launches_by_shape[tuple(Ks.shape[:2])] += 1
    return L


batched_small_cholesky_cuda.launches = 0
batched_small_cholesky_cuda.launches_by_shape = Counter()
