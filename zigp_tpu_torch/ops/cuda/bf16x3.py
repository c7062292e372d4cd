"""The 3-pass bf16 product (the TPU's ``Precision.HIGH``): the hand-written
CUDA kernel, its plain PyTorch version, the registered op and the
differentiable ``bf16x3_mm``.

Counterpart of no Pallas kernel: of XLA's ``Precision.HIGH`` dot, which the
JAX package selects for its solve-replacing products under
``set_solve_precision("high" | "mixed")`` (``zigp_tpu/ops/linalg.py:56-118``;
``ops.linalg.hdot``/``bdot`` here). Each float32 operand is split into
hi = bf16(x) and lo = bf16(x − hi), and C = hi·hi + (hi·lo + lo·hi) with
float32 accumulation; lo·lo is dropped.

- ``bf16x3_mm_cuda``: on CUDA float32 tensors one call of
  ``csrc/bf16x3_mm.cu`` in the instance ``plan`` picks (``mma.sync`` bf16
  tensor-core tiles, with k split over CTAs and the partials added in a
  second, fixed-order pass where few tiles meet a long k; a warp a dot
  where M = N = 1; a thread an output for a short k with a thin side), the
  operands read through their strides (a transposed view is never copied;
  a batch that cannot be walked with two strides is made contiguous
  first); on CPU tensors ``bf16x3_mm_plain``. Anything else raises: there
  is no fallback.
- ``bf16x3_mm_plain``: the split by ``.to(torch.bfloat16).to(torch.float32)``
  and three float32 matmuls of the bf16-exact parts. Each product of two
  bf16 values is exact in float32, so it differs from the kernel only in
  the order of summation.
- ``bf16x3_mm_op`` (``zigp_tpu_torch::bf16x3_mm``): ``bf16x3_mm_cuda`` as a
  registered ``torch.library`` op with a fake implementation, so CUDA graphs
  and ``torch.export`` record the launch as one op call.
- ``bf16x3_mm``: the ``torch.autograd.Function`` around it, batched as
  ``torch.matmul`` (the batch dims broadcast). Its backward is the same
  product, dA = dC·op(B)ᵀ and dB = op(A)ᵀ·dC, as JAX's ``dot_general``
  transpose rule keeps the precision. Under ``torch.func.vmap`` (the member
  stack) its ``vmap`` rule folds the member dim into the batch: one launch a
  site for every member.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from dataclasses import dataclass

import torch

TILE = 64  # the tile instance's C tile
CHUNK = 32  # k a staged chunk
SMS = 132  # an H100's streaming multiprocessors
SPLIT_MIN_K = 256  # k a split takes at least
INSTANCES = {"tiles": 0, "dots": 1, "short_k": 2}

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        from . import _build

        fn = _build.load("bf16x3_mm").zigp_bf16x3_mm_f32
        fn.argtypes = [
            ctypes.c_void_p,  # A
            ctypes.c_void_p,  # B
            ctypes.c_void_p,  # C
            ctypes.c_void_p,  # scratch for the split partials, or null
            ctypes.c_int,  # G1, outer batch
            ctypes.c_int,  # G2, inner batch
            ctypes.c_int,  # M
            ctypes.c_int,  # N
            ctypes.c_int,  # K
            *[ctypes.c_longlong] * 8,  # A's batch, row, k strides; B's batch, k, column strides
            ctypes.c_int,  # instance
            ctypes.c_int,  # S, the k ranges
            ctypes.c_int,  # ks, k a range (a multiple of CHUNK)
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def split_bf16(x: torch.Tensor):
    """(hi, lo) of float32 ``x`` as float32 tensors: hi = bf16(x) and
    lo = bf16(x − hi), both exact in bf16."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi, (x - hi).to(torch.bfloat16).to(x.dtype)


def bf16x3_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """hi_a·hi_b + (hi_a·lo_b + lo_a·hi_b) by three float32 matmuls of the
    split parts, with ``torch.matmul``'s broadcasting."""
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    return ah @ bh + (ah @ bl + al @ bh)


@dataclass(frozen=True)
class Plan:
    """One call of the kernel: the instance, and for the tile instance the
    number of k ranges S and k a range (``ks``, a multiple of ``CHUNK``)."""

    instance: str
    splits: int = 1
    ks: int = CHUNK


def plan(G: int, M: int, N: int, K: int) -> Plan:
    """The instance for C (G, M, N) = A (G, M, K) B (G, K, N): "dots" for
    M = N = 1; "short_k" for K ≤ 16 with M or N below 16 (a tile would hold
    a sliver); else "tiles", with k split into S ranges of at least
    ``SPLIT_MIN_K`` where the G·⌈M/64⌉·⌈N/64⌉ tiles are fewer than two a
    streaming multiprocessor, S up to the count that makes them two."""
    if M == 1 and N == 1:
        return Plan("dots")
    if K <= 16 and min(M, N) < 16:
        return Plan("short_k")
    whole = max(CHUNK, -(-K // CHUNK) * CHUNK)
    tiles = G * -(-M // TILE) * -(-N // TILE)
    S = min(K // SPLIT_MIN_K, -(-2 * SMS // tiles))
    if S <= 1:
        return Plan("tiles", 1, whole)
    ks = -(-(-(-K // S)) // CHUNK) * CHUNK
    return Plan("tiles", -(-K // ks), ks)


def _batch_levels(a: torch.Tensor, b: torch.Tensor):
    """The batch of a (..., M, K) and b (..., K, N) of one batch shape as at
    most two levels (size, a's stride, b's stride), outer first: size-1
    dims dropped, neighbours merged where both operands step through them
    as one dim. None if more than two levels remain."""
    levels = []
    for n, sa, sb in zip(a.shape[:-2], a.stride()[:-2], b.stride()[:-2]):
        if n == 1:
            continue
        if levels and levels[-1][1] == sa * n and levels[-1][2] == sb * n:
            levels[-1] = (levels[-1][0] * n, sa, sb)
        else:
            levels.append((n, sa, sb))
    return levels if len(levels) <= 2 else None


def bf16x3_mm_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """op(A)·op(B) of a (..., M, K) and b (..., K, N) of one batch shape in
    the 3-pass product, a contiguous (..., M, N). CUDA float32 tensors go to
    one launch of the kernel (anything else on the card raises); CPU tensors
    to ``bf16x3_mm_plain``. Each call adds one to
    ``bf16x3_mm_cuda.launches`` and to ``launches_by_shape[(G, M, N, K)]``
    (a split call is two kernels, the products and the fixed-order sum of
    their partials, counted once)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return bf16x3_mm_plain(a, b)
    who = "bf16x3_mm_cuda"
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{who}: both operands on one CUDA device, got {a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"{who}: the kernel takes float32, got {a.dtype} and {b.dtype}")
    if a.ndim < 2 or b.ndim != a.ndim or a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"{who}: expected (..., M, K) and (..., K, N) of one batch shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    *batch, M, K = a.shape
    N = b.shape[-1]
    if max(M, N, K) >= 2**31:
        raise ValueError(f"{who}: M, N and K must be below 2**31, got {(M, N, K)}")
    c = torch.empty(*batch, M, N, dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    levels = _batch_levels(a, b)
    if levels is None:  # a batch no two strides walk: one copy of each operand
        a, b = a.contiguous(), b.contiguous()
        levels = _batch_levels(a, b)
    levels = [(1, 0, 0)] * (2 - len(levels)) + levels
    (G1, sa1, sb1), (G2, sa2, sb2) = levels
    if G1 * G2 >= 2**31:
        raise ValueError(f"{who}: a batch of {G1 * G2} is past the kernel's int")
    p = plan(G1 * G2, M, N, K)
    scratch = torch.empty(p.splits * c.numel(), dtype=c.dtype, device=c.device) if p.splits > 1 else None
    fn = _kernel_fn()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), None if scratch is None else scratch.data_ptr(), G1, G2, M,
                 N, K, sa1, sa2, a.stride(-2), a.stride(-1), sb1, sb2, b.stride(-2), b.stride(-1),
                 INSTANCES[p.instance], p.splits, p.ks, stream)
    if err != 0:
        raise RuntimeError(f"{who}: bf16x3_mm kernel launch failed: cudaError {err} (G={G1 * G2}, M={M}, N={N}, K={K}, "
                           f"{p})")
    bf16x3_mm_cuda.launches += 1
    bf16x3_mm_cuda.launches_by_shape[(G1 * G2, M, N, K)] += 1
    return c


bf16x3_mm_cuda.launches = 0
bf16x3_mm_cuda.launches_by_shape = Counter()


@torch.library.custom_op("zigp_tpu_torch::bf16x3_mm", mutates_args=(), schema="(Tensor a, Tensor b) -> Tensor")
def bf16x3_mm_op(a, b):
    """``bf16x3_mm_cuda`` as a registered op: the kernel on CUDA tensors, the
    plain version on CPU ones."""
    return bf16x3_mm_cuda(a, b)


@bf16x3_mm_op.register_fake
def _bf16x3_mm_fake(a, b):
    return a.new_empty((*a.shape[:-1], b.shape[-1]))


class _BF16x3MM(torch.autograd.Function):
    """The differentiable 3-pass product of a (..., M, K) and b (..., K, N)
    of one batch shape."""

    @staticmethod
    def forward(a, b):
        return bf16x3_mm_op(a.detach(), b.detach())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, gc):
        a, b = ctx.saved_tensors
        ga = _BF16x3MM.apply(gc, b.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        gb = _BF16x3MM.apply(a.transpose(-1, -2), gc) if ctx.needs_input_grad[1] else None
        return ga, gb

    @staticmethod
    def vmap(info, in_dims, a, b):
        from ..linalg import fold_member_dim

        a, b = (fold_member_dim(t, d, info.batch_size) for t, d in zip((a, b), in_dims))
        return _BF16x3MM.apply(a, b), 0


def bf16x3_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the 3-pass bf16 product, differentiable in both, with
    ``torch.matmul``'s batch broadcasting (both at least 2-D)."""
    if a.ndim < 2 or b.ndim < 2:
        raise ValueError(f"bf16x3_mm: expected operands of at least 2 dims, got {tuple(a.shape)} and {tuple(b.shape)}")
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.expand(*batch, *a.shape[-2:])
    b = b.expand(*batch, *b.shape[-2:])
    return _BF16x3MM.apply(a, b)
