"""The exact float32 product of the batch-reducing shapes with k split into
ranges, and ``matmul``, the product whose backward sends those shapes to it.

Counterpart of no Pallas kernel: of XLA's exact float32 dot at these shapes.
Under ``set_solve_precision("highest")`` the JAX package's ``bdot``
(``zigp_tpu/ops/linalg.py:56-118``) is a plain dot, and its transpose rule
contracts the conditionals' batch B in the backward: dL_p⁻¹ = dV·K_mn,pᵀ
((2, 250, B)·(B, 250) and (2, 105, B)·(B, 105), twice each a step) and the
factored contraction's dw = K_mn,s·dt ((2, 105, B)·(B, 250), for the mean and
for c2), at B = 8192 on the 105 × 250 grid. Given such a product whole,
cuBLAS runs SIMT float32 kernels of 32 × 32 tiles that each walk all of k: at
250 × 250, 128 CTAs of two warps, about 9 % of the card's FFMA peak.

- ``split_k_mm``: the first ``SPLITS``·ks of k as ``SPLITS`` ranges of ks
  (ks = K // ``SPLITS``), one batched ``torch.matmul`` of (..., S, M, ks)·
  (..., S, ks, N), which gives cuBLAS S times the CTAs, the S partials summed
  in the order of the ranges, and the rest of k (fewer than S) added last.
  Float32 operands, products and sums, as ``torch.matmul`` computes them
  with TF32 off; a chain of about K / S + S additions in place of K.
- ``matmul``: ``a @ b`` as ``torch.matmul`` computes it, whose backward
  computes dA = dC·Bᵀ and dB = Aᵀ·dC, each by ``split_k_mm`` where
  ``batch_reducing`` takes its shape (a long k and an output of few tiles,
  both sides at least ``MIN_SIDE``), else by ``torch.matmul``. Its ``vmap``
  rule folds the member dim into the batch. ``ops.linalg.bdot`` takes it
  under "highest" for float32 CUDA tensors that need a gradient, where
  ``backward_reduces`` finds such a product.
"""

from __future__ import annotations

import torch

SPLITS = 16  # k ranges: cuBLAS is given 16 times the CTAs (PERF.md §6: against 4 and 8)
LONG_K = 2048  # k a product needs to be batch-reducing
MIN_SIDE = 32  # M and N at least
MAX_TILES = 8  # an output of at most 8 tiles of 128 x 64 a batch member


def batch_reducing(M: int, N: int, K: int) -> bool:
    """Whether a product C (M, N) = A (M, K)·B (K, N) is split: k at least
    ``LONG_K``, both sides at least ``MIN_SIDE`` and at most ``MAX_TILES``
    tiles of 128 × 64 a batch member, the shapes where cuBLAS leaves k whole
    and the card idle. The shape alone decides."""
    return K >= LONG_K and min(M, N) >= MIN_SIDE and -(-M // 128) * -(-N // 64) <= MAX_TILES


def backward_reduces(M: int, K: int, N: int) -> bool:
    """Whether the backward of C (M, N) = A (M, K)·B (K, N) has a product to
    split: dA = dC·Bᵀ contracts N, dB = Aᵀ·dC contracts M. Where neither is
    batch-reducing, ``ops.linalg.bdot`` leaves the product to autograd's own
    backward, which reuses the operands the forward laid out (a batch of
    dots folds its strided operand by one copy there)."""
    return batch_reducing(M, K, N) or batch_reducing(K, N, M)


def split_k_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) of one batch shape, k in ``SPLITS``
    ranges of K // ``SPLITS`` summed in their order, then the rest of k.

    ``torch.matmul`` folds the (..., S) batch of the two views by a copy of
    each operand; a ``torch.bmm`` of each member's views in place, without
    the copies, measured the same device time a step (slower GEMMs on the
    strided operands) for more code (PERF.md §6)."""
    K = a.shape[-1]
    ks = K // SPLITS
    main = SPLITS * ks
    parts = a[..., :main].unflatten(-1, (SPLITS, ks)).movedim(-2, -3) @ b[..., :main, :].unflatten(-2, (SPLITS, ks))
    c = parts.sum(-3)
    if main < K:
        c = c + a[..., main:] @ b[..., main:, :]
    return c


def _product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ y for a product of the backward: by ``split_k_mm`` where the
    shape is batch-reducing and both are float32, the batch dims broadcast
    first, else by ``torch.matmul``."""
    M, K, N = x.shape[-2], x.shape[-1], y.shape[-1]
    if x.dtype == torch.float32 and y.dtype == torch.float32 and batch_reducing(M, N, K):
        batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
        return split_k_mm(x.expand(*batch, M, K), y.expand(*batch, K, N))
    return x @ y


class _SplitKMatmul(torch.autograd.Function):
    """a @ b of a (..., M, K) and b (..., K, N), both at least 2-D, with
    ``torch.matmul``'s broadcasting: the forward is ``a @ b`` itself, the
    backward routes each product by ``_product``."""

    @staticmethod
    def forward(a, b):
        return a @ b

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, gc):
        a, b = ctx.saved_tensors
        ga = _product(gc, b.mT).sum_to_size(a.shape) if ctx.needs_input_grad[0] else None
        gb = _product(a.mT, gc).sum_to_size(b.shape) if ctx.needs_input_grad[1] else None
        return ga, gb

    @staticmethod
    def vmap(info, in_dims, a, b):
        rank = max(x.dim() - (d is not None) for x, d in zip((a, b), in_dims))  # the larger logical rank

        def fold(x, d):
            # the member dim in front, then ones up to the larger logical rank, so that an unbatched operand
            # broadcasts against the stack as torch.matmul broadcasts it against each member
            if d is None:
                return x
            x = x.movedim(d, 0)
            return x.reshape(x.shape[0], *[1] * (rank + 1 - x.dim()), *x.shape[1:])

        return _SplitKMatmul.apply(fold(a, in_dims[0]), fold(b, in_dims[1])), 0


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (both at least 2-D), differentiable in both, whose backward
    splits k of the batch-reducing products (``batch_reducing``)."""
    if a.ndim < 2 or b.ndim < 2:
        raise ValueError(f"split_k.matmul: expected operands of at least 2 dims, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    return _SplitKMatmul.apply(a, b)
