"""(L, L⁻¹) of a batch of small SPD matrices: the hand-written CUDA kernels,
their plain PyTorch versions, and the two-level routine for the larger n on
the CPU.

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
- ``chol_inv_blocked`` replaces ``chol_inv_blocked``. On a CUDA float32
  tensor with ``MAX_N`` < n ≤ ``BLOCKED_MAX_N`` it launches
  ``csrc/chol_inv_cluster.cu`` once, one thread-block cluster per matrix, in
  one of two instances (``blocked_route``): "pair" while one CTA holds A
  beside its staging (n ≤ 320): rank 0 runs ``chol.cu``'s factorization
  and pushes each step's columns of L to rank 1, which computes L⁻¹ a step
  behind; "cluster" above: block rows of 8 dealt to ``plan(n)``'s C CTAs,
  each step's panel and block row of L⁻¹ copied into every CTA's shared
  memory. Both take ``chol_inv.cu``'s arithmetic, so the plain version is
  ``chol_inv_plain(K, NB)``. On a CPU tensor it runs
  ``chol_inv_blocked_plain``, the JAX package's two-level scheme in torch.
  There is no fallback: a CUDA tensor the kernel cannot take, or a cluster
  the device refuses, raises.
- ``chol_inv_blocked_plain``: ragged diagonal blocks of at most ``BLOCK_N``
  (the JAX package's rule) through ``chol_inv_cuda``; the panels, trailing
  Schur updates and the block forward substitution are float32 matmuls,
  exact because ``core.config`` turns TF32 off at import.
- ``chol_inv_cluster_plain`` walks the cluster instance's ``plan`` CTA by CTA: each
  CTA's rows, the panel gathered into every CTA's staging each step, the
  update of its own rows from the staging. It takes ``chol_inv_plain(K,
  NB)``'s operations in their order, so it equals it bit for bit; with
  ``cluster_tiles`` (the kernel's walk over its 4 × 4 tiles) it pins the
  kernel's plan on the CPU.

These are forward functions. Gradients go through ``ops.linalg.chol_inv``, a
``torch.autograd.Function`` that calls them on a detached input and whose
backward is the matmul-only rule of ``zigp_tpu/ops/linalg.py:177-211``.

``chol_inv_op`` (``zigp_tpu_torch::chol_inv``) and ``chol_inv_blocked_op``
(``zigp_tpu_torch::chol_inv_blocked``) are ``chol_inv_cuda`` and
``chol_inv_blocked`` registered as ``torch.library`` custom ops, with fake
implementations that give the output shapes: ``ops.linalg`` launches the
kernels through them, so ``torch.export`` records each launch as one op
call, and a program exported on the card calls the kernels when it runs
(``io.export``). Loading such a program needs this module imported.

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
import functools
import math
from collections import Counter
from dataclasses import dataclass

import numpy as np

import torch

from .cholesky import NB, NBS, check_rank, chol_plain, launch_chol

MAX_N = 238  # the kernel's limit on an H100: A and L⁻¹ as row-padded triangles in 227 KB of shared memory
BLOCK_N = 128  # the blocked routine's diagonal-block size rule, the JAX package's
BLOCKED_MAX_N = 512
CLUSTER_SIZES = (2, 4, 8)  # CTAs per cluster the cluster kernel's row instance is built for: portable sizes
CLUSTER_C = 8  # the row instance's cluster size: the fastest of CLUSTER_SIZES at every n measured on an H100
SMEM_BYTES = 232_448  # opt-in shared memory per CTA on an H100

_fn = None
_cluster_fn = None


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
    ``chol_inv_cuda.launches``, to ``chol_inv_cuda.launches_by_n[n]`` and to
    ``chol_inv_cuda.launches_by_batch[(G, n)]`` (G matrices in the launch)."""
    if K.device.type == "cpu":
        return chol_inv_plain(K)
    n = K.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"chol_inv_cuda: the kernel takes 1 <= n <= {MAX_N}, got n={n}")
    L, Linv = launch_chol_inv(K)
    chol_inv_cuda.launches += 1
    chol_inv_cuda.launches_by_n[n] += 1
    chol_inv_cuda.launches_by_batch[(K.numel() // (n * n), n)] += 1
    return L, Linv


chol_inv_cuda.launches = 0
chol_inv_cuda.launches_by_n = Counter()
chol_inv_cuda.launches_by_batch = Counter()


@torch.library.custom_op("zigp_tpu_torch::chol_inv", mutates_args=(), schema="(Tensor K) -> (Tensor, Tensor)")
def chol_inv_op(K):
    """``chol_inv_cuda`` as a registered op: the kernel on a CUDA tensor, the
    plain version on a CPU one."""
    return chol_inv_cuda(K)


@chol_inv_op.register_fake
def _chol_inv_fake(K):
    return torch.empty_like(K), torch.empty_like(K)


def block_offsets(n: int) -> list[int]:
    """Ragged adaptive diagonal blocks: n split evenly into ⌈n/128⌉ blocks,
    the size rounded up to a multiple of 8 (n=200 → 104 + 96), as
    ``zigp_tpu``'s ``chol_inv_blocked`` does. Returns the block offsets
    [0, ..., n]."""
    nblk = -(-n // BLOCK_N)
    even = -(-n // nblk)
    nb = -(-even // 8) * 8
    return list(range(0, n, nb)) + [n]


def chol_inv_blocked_plain(K: torch.Tensor):
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


def padded_row(i: int) -> int:
    """Offset of row i of ``chol_tile.cuh``'s row-padded, bank-skewed lower
    triangle (its ``padded_row``)."""
    t, s = i >> 2, i & 3
    return 4 * ((t + 1) * (2 * t + s) + t)


def _ceil4(x: int) -> int:
    return (x + 3) & ~3


@dataclass(frozen=True)
class ClusterPlan:
    """One launch of ``csrc/chol_inv_cluster.cu`` for n: C CTAs a matrix,
    block row b (rows NB·b …) on rank ``owners[b]`` = b mod C, and the
    shared memory of one CTA (the kernel's ``Layout``): A's and L⁻¹'s rows
    of the fullest rank (``region`` floats each); two of each staging area
    (even and odd steps): the panel (n rows of NB), the block row of L⁻¹
    (⌈n⌉₄ columns of NB), both with a float4 of skew per 4, and L_jj with its
    reciprocals; the lookahead's reciprocals, four mbarriers and the
    block-row table."""

    n: int
    C: int
    owners: tuple
    region: int
    bytes: int

    def rows(self, rank: int) -> list[int]:
        """The rows rank owns, block row by block row."""
        return [i for b, o in enumerate(self.owners) if o == rank for i in range(NB * b, min(NB * (b + 1), self.n))]


def _staged(r: int) -> int:
    """Offset of staged row (or column) r of the cluster kernel's staging:
    8 floats each, a float4 of skew per 4."""
    return NB * r + 4 * (r >> 2)


def _cluster_bytes(n: int, C: int) -> tuple[int, int]:
    nblk = -(-n // NB)
    block = lambda b: padded_row(min(NB * (b + 1), n)) - padded_row(NB * b)
    region = max(sum(block(b) for b in range(r, nblk, C)) for r in range(C))
    staging = 2 * (_ceil4(_staged(n)) + _ceil4(_staged(_ceil4(n))) + 72)  # two panels, block rows of B, L_jj
    floats = 2 * region + staging + 16 + 8 + _ceil4(nblk)  # + reciprocals, 4 mbarriers, the block-row table
    return region, 4 * floats


@functools.lru_cache(maxsize=None)
def plan(n: int, C: int | None = None) -> ClusterPlan:
    """The row instance's launch for n: ``CLUSTER_C`` CTAs a matrix (C = 8
    ran fastest at n = 250, 300, 337, 400 on an H100, PERF.md §6), or the C
    asked for; raises if its bytes per CTA exceed ``SMEM_BYTES``."""
    if isinstance(n, bool) or not isinstance(n, int) or n < 1:
        raise ValueError(f"chol_inv cluster: n must be an int >= 1, got {n!r}")
    C = CLUSTER_C if C is None else C
    if C not in CLUSTER_SIZES:
        raise ValueError(f"chol_inv cluster: C must be one of {CLUSTER_SIZES}, got {C!r}")
    region, nbytes = _cluster_bytes(n, C)
    if nbytes > SMEM_BYTES:
        raise ValueError(f"chol_inv cluster: n={n} does not fit {SMEM_BYTES} bytes a CTA at C={C}")
    return ClusterPlan(n, C, tuple(b % C for b in range(-(-n // NB))), region, nbytes)


def cluster_tiles(p: ClusterPlan, J: int, rank: int, warps: int = 16) -> tuple[list, list]:
    """The 4 × 4 tiles (i0, c0) rank updates in step J, as the kernel walks
    them: (the chain's three tiles of the next diagonal block, on warp 0 of
    its owner; the other tiles as (warp, i0, c0)). Row tile i0 = 8b + 4h of
    an own block row b > J takes columns c0 = 0, 4, …, i0 (L⁻¹'s rows left of
    the step for c0 < j1, the trailing A from j1) in runs of 32 tiles, the
    runs dealt to the warps in turn (warp 0 left out on the owner of the next
    block)."""
    n, C = p.n, p.C
    nblk = len(p.owners)
    j1 = min(NB * (J + 1), n)
    if j1 == n:
        return [], []
    own_blocks = (nblk - 1 - rank) // C + 1 if rank < nblk else 0
    q0 = (J - rank) // C + 1 if J >= rank else 0
    ahead = (J + 1) % C == rank
    look = [(j1, j1), (j1 + 4, j1), (j1 + 4, j1 + 4)] if ahead else []
    w0 = 1 if ahead else 0
    rest, g = [], 0
    for q in range(q0, own_blocks):
        b = rank + q * C
        for h in range(2):
            i0 = NB * b + 4 * h
            if i0 >= n:
                break
            ntiles = i0 // 4 + 1
            for k in range(-(-ntiles // 32)):
                warp = w0 + g % (warps - w0)
                rest += [(warp, i0, 4 * t) for t in range(32 * k, min(32 * k + 32, ntiles))
                         if not (ahead and b == J + 1 and 4 * t >= j1)]
                g += 1
    return look, rest


def chol_inv_cluster_plain(K: torch.Tensor, C: int | None = None):
    """(L, L⁻¹) of (..., n, n) SPD ``K`` computed as the cluster kernel
    distributes it over ``plan(n, C)``: each rank holds its rows of A and B
    = L⁻¹; per step the owner of the diagonal block factors it, each rank
    forward-substitutes its own panel rows and the owner block row j of B,
    every rank receives the panel and B's block row into its staging, and
    updates its own rows from the staging. Each entry takes the operations of
    ``chol_inv_plain(K, NB)`` in their order (dividing where the kernel
    multiplies by the reciprocal), so the two agree bit for bit."""
    n = K.shape[-1]
    p = plan(n, C)
    rows = [p.rows(r) for r in range(p.C)]
    rank_of = {i: r for r in range(p.C) for i in rows[r]}
    pos = {i: rows[r].index(i) for r in range(p.C) for i in rows[r]}
    eye = torch.eye(n, dtype=K.dtype, device=K.device).expand_as(K)
    A = [K[..., idx, :].clone() for idx in rows]  # rank r's rows, every column
    B = [eye[..., idx, :].clone() for idx in rows]
    at = lambda X, i: X[rank_of[i]][..., pos[i], :]  # row i of A or B, on its owner

    for j0 in range(0, n, NB):
        j1 = min(j0 + NB, n)
        o = rank_of[j0]
        diag = [pos[i] for i in range(j0, j1)]
        # the owner factors L_jj (the kernel's lookahead, or the first step)
        for j in range(j0, j1):
            Ao, sub = A[o], [pos[i] for i in range(j, j1)]
            col = Ao[..., sub, j]
            for e in range(j0, j):
                col = col - Ao[..., sub, e] * Ao[..., pos[j], e, None]
            piv = torch.sqrt(col[..., 0])
            Ao[..., sub[1:], j] = col[..., 1:] / piv[..., None]
            Ao[..., pos[j], j] = piv
        Ljj = A[o][..., diag, j0:j1].clone()  # staged in every rank
        # each rank's panel rows below the step, against the staged L_jj
        for r in range(p.C):
            mine = [pos[i] for i in rows[r] if i >= j1]
            for j in range(j0, j1):
                col = A[r][..., mine, j]
                for e in range(j0, j):
                    col = col - A[r][..., mine, e] * Ljj[..., j - j0, e - j0, None]
                A[r][..., mine, j] = col / Ljj[..., j - j0, j - j0, None]
        # the owner's block row j of B
        for j in range(j0, j1):
            row = at(B, j)[..., : j + 1]
            for e in range(j0, j):
                row = row - Ljj[..., j - j0, e - j0, None] * at(B, e)[..., : j + 1]
            B[o][..., pos[j], : j + 1] = row / Ljj[..., j - j0, j - j0, None]
        if j1 == n:
            break
        # staging: the panel rows j1.. and B's block row j, in every rank
        Ps = torch.stack([at(A, i)[..., j0:j1] for i in range(j1, n)], -2)
        Bs = B[o][..., diag, :j1].clone()
        for r in range(p.C):
            mine = [pos[i] for i in rows[r] if i >= j1]
            loc = [i - j1 for i in rows[r] if i >= j1]
            for c in range(NB):
                A[r][..., mine, j1:] -= Ps[..., loc, c, None] * Ps[..., None, :, c]
                B[r][..., mine, :j1] -= Ps[..., loc, c, None] * Bs[..., None, c, :]

    L = torch.empty_like(K)
    Linv = torch.empty_like(K)
    for r in range(p.C):
        L[..., rows[r], :] = A[r]
        Linv[..., rows[r], :] = B[r]
    return torch.tril(L), torch.tril(Linv)


def _cluster_kernel_fn():
    global _cluster_fn
    if _cluster_fn is None:
        from . import _build

        fn = _build.load("chol_inv_cluster").zigp_chol_inv_cluster_f32
        fn.argtypes = [
            ctypes.c_void_p,  # K
            ctypes.c_void_p,  # L
            ctypes.c_void_p,  # Linv
            ctypes.c_int,  # n
            ctypes.c_int,  # G
            ctypes.c_int,  # C, CTAs per cluster
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _cluster_fn = fn
    return _cluster_fn


def cluster_shared_bytes(n: int, C: int) -> int:
    """The cluster kernel's own count of its shared memory per CTA (``plan``
    must agree)."""
    from . import _build

    fn = _build.load("chol_inv_cluster").zigp_chol_inv_cluster_smem
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn(n, C)


def _check_cuda_f32(K: torch.Tensor, who: str) -> None:
    if K.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {K.device}")
    if K.dtype != torch.float32:
        raise TypeError(f"{who}: the kernel takes float32, got {K.dtype}")
    if K.ndim < 2 or K.shape[-1] != K.shape[-2] or K.shape[-1] < 1:
        raise ValueError(f"{who}: expected (..., n, n) with n >= 1, got {tuple(K.shape)}")
    if not K.is_contiguous():
        raise ValueError(f"{who}: input must be contiguous")


def launch_chol_inv_cluster(K: torch.Tensor, C: int | None = None, who: str = "chol_inv_blocked"):
    """(L, L⁻¹) of (..., n, n) CUDA float32 ``K`` from one launch of
    ``csrc/chol_inv_cluster.cu`` with ``plan(n, C)``'s clusters, for any n
    the plan fits; raises on anything the kernel cannot take and on a launch
    the device refuses. Each launch adds one to ``chol_inv_blocked.launches``,
    to ``chol_inv_blocked.launches_by_n[n]`` and to ``launches_by_batch[(G, n)]``."""
    _check_cuda_f32(K, who)
    n = K.shape[-1]
    p = plan(n, C)
    G = K.numel() // (n * n)
    L = torch.empty_like(K)
    Linv = torch.empty_like(K)
    if G == 0:
        return L, Linv
    fn = _cluster_kernel_fn()
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        err = fn(K.data_ptr(), L.data_ptr(), Linv.data_ptr(), n, G, p.C, stream)
    if err != 0:
        raise RuntimeError(f"{who}: chol_inv_cluster kernel launch failed: cudaError {err} (n={n}, G={G}, "
                           f"C={p.C}, {p.bytes} bytes a CTA)")
    chol_inv_blocked.launches += 1
    chol_inv_blocked.launches_by_n[n] += 1
    chol_inv_blocked.launches_by_batch[(G, n)] += 1
    return L, Linv


def pair_bytes(n: int) -> int:
    """Shared memory of one CTA of the cluster kernel's pair instance: A (or
    B) as a padded triangle, two staging areas of the step's 8 columns, the
    pivots' reciprocals and four mbarriers."""
    return 4 * (_ceil4(padded_row(n)) + 2 * _ceil4(_staged(n)) + 16 + 8)


def blocked_route(n: int) -> str:
    """How ``chol_inv_blocked`` factors n on the card, one launch of
    ``chol_inv_cluster.cu`` either way: "pair" (a cluster of 2, rank 0
    factoring and rank 1 inverting beside it) while ``pair_bytes(n)`` fits
    (n ≤ 320), else "cluster" (block rows dealt over ``plan(n)``'s C
    CTAs)."""
    return "pair" if pair_bytes(n) <= SMEM_BYTES else "cluster"


def launch_chol_inv_pair(K: torch.Tensor, who: str = "chol_inv_blocked"):
    """(L, L⁻¹) of (..., n, n) CUDA float32 ``K`` from one launch of the
    cluster kernel's pair instance (n ≤ 320 on an H100); raises on anything
    it cannot take. Each launch adds one to ``chol_inv_blocked.launches``, to
    ``launches_by_n[n]`` and to ``launches_by_batch[(G, n)]``."""
    _check_cuda_f32(K, who)
    n = K.shape[-1]
    if pair_bytes(n) > SMEM_BYTES:
        raise ValueError(f"{who}: the pair instance takes n with {pair_bytes(n)} > {SMEM_BYTES} bytes a CTA, n={n}")
    G = K.numel() // (n * n)
    L, Linv = torch.empty_like(K), torch.empty_like(K)
    if G == 0:
        return L, Linv
    from . import _build

    fn = _build.load("chol_inv_cluster").zigp_chol_inv_pair_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(K.device):
        err = fn(K.data_ptr(), L.data_ptr(), Linv.data_ptr(), n, G, torch.cuda.current_stream(K.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{who}: chol_inv_cluster pair launch failed: cudaError {err} (n={n}, G={G})")
    chol_inv_blocked.launches += 1
    chol_inv_blocked.launches_by_n[n] += 1
    chol_inv_blocked.launches_by_batch[(G, n)] += 1
    return L, Linv


def chol_inv_blocked(K: torch.Tensor):
    """(L, L⁻¹) of (..., n, n) SPD ``K`` for ``MAX_N`` < n ≤ ``BLOCKED_MAX_N``.
    A CUDA tensor goes to one launch of the cluster kernel in
    ``blocked_route(n)``'s instance, float32 and contiguous (anything else
    raises, as does a device that refuses the cluster); a CPU tensor to
    ``chol_inv_blocked_plain``."""
    if K.device.type == "cpu":
        return chol_inv_blocked_plain(K)
    n = K.shape[-1]
    if not MAX_N < n <= BLOCKED_MAX_N:
        raise ValueError(f"chol_inv_blocked: the card takes {MAX_N} < n <= {BLOCKED_MAX_N} here, got n={n}")
    return launch_chol_inv_pair(K) if blocked_route(n) == "pair" else launch_chol_inv_cluster(K)


chol_inv_blocked.launches = 0
chol_inv_blocked.launches_by_n = Counter()
chol_inv_blocked.launches_by_batch = Counter()


@torch.library.custom_op("zigp_tpu_torch::chol_inv_blocked", mutates_args=(),
                         schema="(Tensor K) -> (Tensor, Tensor)")
def chol_inv_blocked_op(K):
    """``chol_inv_blocked`` as a registered op: one launch of the cluster
    kernel (pair or row instance) on a CUDA tensor, the two-level plain
    routine on a CPU one."""
    return chol_inv_blocked(K)


@chol_inv_blocked_op.register_fake
def _chol_inv_blocked_fake(K):
    return torch.empty_like(K), torch.empty_like(K)


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
