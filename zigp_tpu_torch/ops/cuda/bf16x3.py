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
  ``csrc/bf16x3_mm.cu`` in the instance and copy routes ``plan_of`` picks:
  ``wgmma`` tiles of 128 × 128 (128 × 64 for the long-k products' few
  tiles) fed by a ring of asynchronously staged float32 chunks (TMA where
  the operand's rows are 16-byte aligned, cp.async elsewhere), split to bf16
  in shared memory, with a long k cut into the CTAs of one cluster and
  summed through distributed shared memory in a fixed order; a warp a dot
  where M = N = 1; for a short k with a thin side, CTAs of a few batch
  members by a span of the long side whose warps stream, the long operand
  read along its unit stride (the long side, or the batch through a
  transposing block a warp) and C written by rows. The
  operands are read through their strides (a transposed view is never
  copied; a batch that cannot be walked with two strides is made
  contiguous first); on CPU tensors ``bf16x3_mm_plain``. Anything else
  raises: there is no fallback.
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
import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

TILE = 128  # the tile instance's C tile: TILE rows (two warpgroups of 64) by TILE, or TILE / 2 where k is cut
CHUNK = 32  # k a staged chunk
STAGES = 4  # staged chunks in flight
SPLIT_BUFS = 3  # buffers of split chunks: two chunks' products in flight
THREADS = 256  # a tile CTA's threads: two warpgroups
MAX_CLUSTER = 8  # k ranges of a tile at most: the CTAs of one cluster
RANGE_MIN_K = 256  # k a range takes at least
MAX_GRID_Y = 65535  # the tiles' grid dim; past it a CTA walks tiles with that stride
NARROW_TILES = 4  # 128 x 64 tiles of a member at most for the narrow tiles
SMEM_LIMIT = 232_448  # shared memory a CTA may take on an H100
INSTANCES = {"tiles": 0, "dots": 1, "short_k": 2}
ROUTES = {0: "tma", 4: "cp.async16", 2: "cp.async8", 1: "cp.async4"}  # an operand's copy route by the C code
SK_THREADS = 256  # a short-k CTA's threads
SK_PITCH = 33  # floats a row of a short-k warp's staged block (batch-major), odd
SK_MEMBERS = (32, 16, 8, 4, 2, 1)  # batch members a short-k CTA may take, the most first (32 along the batch)
SK_MIN_CTAS = 4 * 132  # short-k CTAs wanted at most: four an SM of an H100 (fewer where C is small)
SK_MAX_K, SK_MAX_THIN = 16, 15  # the short-k instance's k and thin side at most

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
            ctypes.c_void_p,  # the 23 parameters, a host array of int64 (``Plan``'s and the operands')
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
    """One call of the kernel: the instance; the grid and each CTA's dynamic
    shared memory. For the tiles, the S k ranges of ``ks`` each (S CTAs a
    cluster, summed in the order of the ranges), the tile's columns
    (``tile_n``), the grid (S, tiles or ``MAX_GRID_Y``, 1), and each
    operand's copy route ("tma", "cp.async16", "cp.async8" or "cp.async4";
    "" where ``plan`` was given no operand). For a short k, the thin side
    ("m" or "n"), the long operand's layout ("n-major" or "m-major": unit
    stride along the long side; "batch-major": along the inner batch level,
    with a thin side of 1; "strided": neither), the batch members and the
    span of the long side a CTA (the grid (tiles, 1, 1), the span fastest),
    and the bytes of the stores that write C (16, or 4 where the rows are
    not 16-byte aligned)."""

    instance: str
    splits: int = 1
    ks: int = CHUNK
    grid: tuple = (1, 1, 1)
    smem: int = 0
    a_route: str = ""
    b_route: str = ""
    tile_n: int = TILE
    thin: str = ""
    layout: str = ""
    members: int = 0
    span: int = 0
    store: int = 0

    @property
    def sk_map(self) -> int:
        """The short-k kernel's mapping: 2 lanes along the batch (batch-major),
        1 lanes along the long side 16 bytes a lane, 0 4 bytes a lane."""
        return 2 if self.layout == "batch-major" else int(self.store == 16)

    @property
    def label(self) -> str:
        """The instance as counted: "dots", "short_k <layout> st<store>" or
        "tiles A:<route> B:<route>"."""
        if self.instance == "tiles":
            return f"tiles A:{self.a_route} B:{self.b_route}"
        return f"short_k {self.layout} st{self.store}" if self.instance == "short_k" else self.instance


def k_ranges(K: int) -> tuple[int, int]:
    """(S, ks): the tile instance's k cut into S ranges of ks (a multiple of
    ``CHUNK``; the last one shorter), by K alone, so that a batch member's
    result does not depend on the batch: S = clamp(K // ``RANGE_MIN_K``, 1,
    ``MAX_CLUSTER``), none of them empty."""
    S = max(1, min(MAX_CLUSTER, K // RANGE_MIN_K))
    ks = max(CHUNK, -(-(-(-K // S)) // CHUNK) * CHUNK)
    return max(1, -(-K // ks)), ks


def smem_bytes() -> int:
    """A tile CTA's dynamic shared memory, as ``csrc/bf16x3_mm.cu`` sizes
    it: the ring of float32 stages (A's 128 × 32 and B's 32 × 128 chunk),
    ``SPLIT_BUFS`` buffers of the split's bf16 hi and lo tiles, an mbarrier a
    stage and 1024 bytes to align the swizzles."""
    return STAGES * 2 * TILE * CHUNK * 4 + SPLIT_BUFS * 4 * TILE * CHUNK * 2 + STAGES * 8 + 1024


def short_k_plan(G: int, M: int, N: int, K: int, layout: str = "strided", aligned: bool = False) -> Plan:
    """The short-k instance for C (G, M, N) with the long operand in
    ``layout``: the thin side T = M where M ≤ N, else N. Batch-major, CTAs
    of 32 members (a lane each) by whole rows of the long side L. Else
    CTAs of the most members (``SK_MEMBERS``) by whole rows of L that
    still give the CTAs wanted: the fewer of ``SK_MIN_CTAS`` and the more
    of a thread's share of the outputs (4 where a lane takes 16 bytes, else
    1) and a warp's of the (member, t) pairs (so that few warps walk
    several); failing that, the span of L halved (multiples of a warp's
    width, 32 or 128 l's) until some do, else one member. 16-byte stores
    where C's rows start on 16 bytes: L % 4 == 0 for the batch-major
    layout; for the others where ``aligned`` (the long operand's rows on 16
    bytes with unit stride along L, L % 4 == 0, and a thin M or T = 1:
    ``plan_of`` reads it). Only the speed follows the tiling, never a bit
    of C."""
    thin = "m" if M <= N else "n"
    T, L = (M, N) if thin == "m" else (N, M)
    batch_major = layout == "batch-major"
    store = 16 if (L % 4 == 0 if batch_major else aligned) else 4
    width = 32 * (4 if store == 16 and not batch_major else 1)  # l's a warp covers
    outputs, pairs = -(-G * T * L // (SK_THREADS * width // 32)), -(-G * T // (SK_THREADS // 32))
    want = max(1, min(SK_MIN_CTAS, max(outputs, pairs)))
    members, span = (SK_MEMBERS[0], L) if batch_major else (None, L)
    while members is None:
        members = next((m for m in SK_MEMBERS if -(-G // m) * -(-L // span) >= want), None)
        if members is None and span <= width:
            members = SK_MEMBERS[-1]
        elif members is None:
            span = max(width, span // 2 // width * width)
    tiles = -(-G // members) * -(-L // span)
    smem = members * 8 * (1 + T * K) + (SK_THREADS // 32 * 32 * SK_PITCH * 4 if batch_major else 0)
    return Plan("short_k", grid=(min(max(tiles, 1), 2**31 - 1), 1, 1), smem=smem, thin=thin, layout=layout,
                members=members, span=span, store=store)


def plan(G: int, M: int, N: int, K: int, a_route: str = "", b_route: str = "", layout: str = "strided",
         aligned: bool = False) -> Plan:
    """The instance for C (G, M, N) = A (G, M, K) B (G, K, N): "dots" for
    M = N = 1; "short_k" for K ≤ 16 with M or N below 16 (a tile would hold
    a sliver), tiled by ``short_k_plan`` for the long operand's ``layout``
    and ``aligned``; else "tiles", with k cut by ``k_ranges`` (a cluster of
    S CTAs a tile) and the given copy routes, in C tiles of 128 × 128, or of
    128 × 64 where k is cut and a member has at most ``NARROW_TILES`` of
    them (the long-k products' few tiles: twice the streaming
    multiprocessors busy, and at most 16 clusters of 8 at the batch of 2,
    one wave on an H100). The instance and the k partition follow (M, N,
    K) alone, never the batch G; the short-k tiling follows G, but no bit
    of C does."""
    if M == 1 and N == 1:
        return Plan("dots")
    if K <= SK_MAX_K and min(M, N) <= SK_MAX_THIN:
        return short_k_plan(G, M, N, K, layout, aligned)
    S, ks = k_ranges(K)
    narrow = S > 1 and -(-M // TILE) * -(-N // (TILE // 2)) <= NARROW_TILES
    tile_n = TILE // 2 if narrow else TILE
    tiles = G * -(-M // TILE) * -(-N // tile_n)
    return Plan("tiles", S, ks, (S, min(tiles, MAX_GRID_Y), 1), smem_bytes(), a_route, b_route, tile_n)


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


def copy_width(ptr: int, rows: int, K: int, s_row: int, s_k: int, batch) -> int:
    """The copy route of one operand, ``rows`` (A's M or B's N) by K with
    those strides (elements) and ``batch`` [(size, stride), (size, stride)]
    (outer, inner), at byte address ``ptr``, as the C code reads it: 0 for
    TMA, else the floats of one cp.async copy (4, 2 or 1).

    The contiguous dim is k, unless the rows have unit stride and k does
    not. TMA where it can take the operand: unit stride along that dim, and
    the base and the byte stride of every other dim longer than 1 nonzero
    multiples of 16 (a (250, 250) factor's 1000-byte rows, a base one float
    off, a broadcast batch: cp.async). Else cp.async of as many floats as
    that alignment allows, along the contiguous dim (4 bytes a copy where
    neither dim has unit stride)."""
    mn = s_k != 1 and s_row == 1
    if (s_row if mn else s_k) != 1:
        return 1
    other = K if mn else rows
    s_other = s_k if mn else s_row
    (G1, s1), (G2, s2) = batch
    if rows >= 1 and K >= 1 and ptr % 16 == 0:
        # the C code's tensor map: a dim of size 1 takes a stride made up of the ones inside it
        st0 = 4 * s_other if other > 1 else 16
        st1 = 4 * s2 if G2 > 1 else st0 * other
        st2 = 4 * s1 if G1 > 1 else st1 * G2
        if all(0 < s < 2**40 and s % 16 == 0 for s in (st0, st1, st2)):
            return 0
    strides = [4 * s_other] + [4 * s for n, s in batch if n > 1]
    for w in (4, 2):
        if ptr % (4 * w) == 0 and all(s % (4 * w) == 0 for s in strides):
            return w
    return 1


def plan_of(a: torch.Tensor, b: torch.Tensor) -> Plan:
    """``plan`` for a (..., M, K) and b (..., K, N) of one batch shape as
    ``bf16x3_mm_cuda`` launches them: the batch as two levels (a batch that
    has more is launched on contiguous copies); for the tiles each operand's
    copy route by ``copy_width`` from its strides and address; for a short k
    the long operand's layout by its strides (unit stride along the long
    side, else along the inner batch level where the thin side is 1, else
    "strided") and whether its rows start on 16 bytes. The one place the
    instance, the routes and the layout are chosen."""
    *_, M, K = a.shape
    N = b.shape[-1]
    levels = _batch_levels(a, b)
    if levels is None:
        return plan_of(a.contiguous(), b.contiguous())
    levels = [(1, 0, 0)] * (2 - len(levels)) + levels
    G = levels[0][0] * levels[1][0]
    p = plan(G, M, N, K)
    if p.instance == "short_k":
        thin_m = p.thin == "m"
        y, s_l, s_k = (b, b.stride(-1), b.stride(-2)) if thin_m else (a, a.stride(-2), a.stride(-1))
        batch = [(n, sb if thin_m else sa) for n, sa, sb in levels]
        T, L = (M, N) if thin_m else (N, M)
        if s_l == 1:
            layout = "n-major" if thin_m else "m-major"
        else:
            layout = "batch-major" if T == 1 and batch[1][0] > 1 and batch[1][1] == 1 else "strided"
        aligned = (s_l == 1 and L % 4 == 0 and (thin_m or T == 1) and y.data_ptr() % 16 == 0
                   and all(s % 4 == 0 for n, s in batch if n > 1) and (K <= 1 or s_k % 4 == 0))
        return plan(G, M, N, K, layout=layout, aligned=aligned)
    if p.instance != "tiles":
        return p
    wa = copy_width(a.data_ptr(), M, K, a.stride(-2), a.stride(-1), [(n, sa) for n, sa, _ in levels])
    wb = copy_width(b.data_ptr(), N, K, b.stride(-1), b.stride(-2), [(n, sb) for n, _, sb in levels])
    return plan(G, M, N, K, ROUTES[wa], ROUTES[wb])


class Cta(NamedTuple):
    """One CTA of the tile instance's grid: its cluster's tile (batch g,
    rows m of C, columns n), its rank in the cluster and its k range, the C
    rows it writes, and the ranks whose partial sums it adds for them, in
    that order."""

    g: int
    m: range
    n: range
    rank: int
    k: range
    writes: range
    sums: tuple


def ctas(p: Plan, G: int, M: int, N: int, K: int):
    """The CTAs of ``p``'s grid for C (G, M, N), in the order the kernel
    derives them: blockIdx.y walks the tiles with a stride of the grid's y
    (m fastest, then n, then the batch), blockIdx.x is the rank, whose k
    range is [rank·ks, min(K, (rank + 1)·ks)); rank r writes rows
    [r·⌈128/S⌉, (r + 1)·⌈128/S⌉) of the tile, each the sum of the S ranks'
    partials in rank order."""
    S, ks, tn_ = p.splits, p.ks, p.tile_n
    tiles_m, tiles_n = -(-M // TILE), -(-N // tn_)
    tiles = G * tiles_m * tiles_n
    per = -(-TILE // S)
    for y in range(p.grid[1]):
        for tile in range(y, tiles, p.grid[1]):
            tm, rest = tile % tiles_m, tile // tiles_m
            tn, g = rest % tiles_n, rest // tiles_n
            m0, n0 = tm * TILE, tn * tn_
            for rank in range(p.grid[0]):
                rb, re = rank * per, min(TILE, rank * per + per)
                yield Cta(g, range(m0, min(M, m0 + TILE)), range(n0, min(N, n0 + tn_)), rank,
                          range(rank * ks, min(K, rank * ks + ks)), range(m0 + rb, min(M, m0 + re)),
                          tuple(range(S)))


class SkRun(NamedTuple):
    """A run of C a short-k CTA stores: ``n`` elements from element ``c``
    of C (contiguous) ``step`` apart, by stores of ``store`` bytes."""

    c: int
    n: int
    step: int
    store: int


class SkCta(NamedTuple):
    """One CTA of the short-k instance's grid: its batch members, its span
    of the long side and the runs of C it stores."""

    g: range
    l: range
    runs: tuple


def short_k_ctas(p: Plan, G: int, M: int, N: int):
    """The CTAs of the short-k plan ``p`` for C (G, M, N), in the kernel's
    order (tile = member group · spans + span), with the runs each stores:
    a (member, t) pair's outputs over the span (a thin M's row of C, or a
    thin N's column, T apart), or, batch-major, each member's row of a
    32-wide chunk of the span."""
    T, L = (M, N) if p.thin == "m" else (N, M)
    spans = -(-L // p.span)
    for tile in range(-(-G // p.members) * spans):
        group, sp = divmod(tile, spans)
        g0, l0 = group * p.members, sp * p.span
        gs, ls = range(g0, min(G, g0 + p.members)), range(l0, min(L, l0 + p.span))
        if p.sk_map == 2:
            runs = [SkRun(g * L + lc, min(32, ls.stop - lc), 1, p.store) for lc in range(l0, ls.stop, 32) for g in gs]
        elif p.thin == "m":
            runs = [SkRun((g * T + t) * L + l0, len(ls), 1, p.store) for g in gs for t in range(T)]
        else:
            runs = [SkRun((g * L + l0) * T + t, len(ls), T, p.store) for g in gs for t in range(T)]
        yield SkCta(gs, ls, tuple(runs))


class _Call:
    """What one (shapes, strides, alignments) signature needs at each call:
    the output's shape, the counted key and plan, the C code's parameters;
    or ``copy`` where the batch needs a contiguous copy first."""

    __slots__ = ("copy", "shape", "key", "plan", "params", "out")

    def __init__(self, a, b):
        *batch, M, K = a.shape
        N = b.shape[-1]
        self.out = (*batch, M, N)
        levels = _batch_levels(a, b)
        self.copy = levels is None
        self.params = None
        if self.copy or 0 in self.out:
            return
        levels = [(1, 0, 0)] * (2 - len(levels)) + levels
        (G1, sa1, sb1), (G2, sa2, sb2) = levels
        if G1 * G2 >= 2**31:
            raise ValueError(f"bf16x3_mm_cuda: a batch of {G1 * G2} is past the kernel's int")
        self.shape = (G1 * G2, M, N, K)
        widths = {v: k for k, v in ROUTES.items()}
        p = self.plan = plan_of(a, b)
        self.key = (*self.shape, p.label)
        self.params = (ctypes.c_longlong * 23)(G1, G2, M, N, K, sa1, sa2, a.stride(-2), a.stride(-1), sb1, sb2,
                                               b.stride(-2), b.stride(-1), INSTANCES[p.instance], p.splits, p.ks,
                                               widths.get(p.a_route, 1), widths.get(p.b_route, 1), p.tile_n,
                                               int(p.thin == "n"), p.sk_map, p.members, p.span)


_CALLS: dict = {}
_raw_stream = None


def _stream(index: int) -> int:
    global _raw_stream
    if _raw_stream is None:
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _raw_stream(index)


def bf16x3_mm_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """op(A)·op(B) of a (..., M, K) and b (..., K, N) of one batch shape in
    the 3-pass product, a contiguous (..., M, N). CUDA float32 tensors go to
    one launch of the kernel in ``plan_of``'s instance and copy routes
    (anything else on the card raises); CPU tensors to ``bf16x3_mm_plain``.
    Each call adds one to ``bf16x3_mm_cuda.launches``, to
    ``launches_by_shape[(G, M, N, K)]`` and to ``launches_by_instance[(G,
    M, N, K, label)]`` (``Plan.label``: the instance and, for the tiles,
    the operands' routes). What a call needs besides its pointers is worked
    out once for each signature of shapes, strides and alignments, so a
    call costs the host little more than the launch."""
    if not (a.is_cuda and b.is_cuda and a.dtype == torch.float32 and b.dtype == torch.float32
            and a.get_device() == b.get_device()):
        if a.device.type == "cpu" and b.device.type == "cpu":
            return bf16x3_mm_plain(a, b)
        who = "bf16x3_mm_cuda"
        if a.device.type != "cuda" or b.device != a.device:
            raise ValueError(f"{who}: both operands on one CUDA device, got {a.device} and {b.device}")
        raise TypeError(f"{who}: the kernel takes float32, got {a.dtype} and {b.dtype}")
    sig = (a.shape, b.shape, a.stride(), b.stride(), a.data_ptr() & 15, b.data_ptr() & 15)
    call = _CALLS.get(sig)
    if call is None:
        who = "bf16x3_mm_cuda"
        if a.ndim < 2 or b.ndim != a.ndim or a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
            raise ValueError(f"{who}: expected (..., M, K) and (..., K, N) of one batch shape, got "
                             f"{tuple(a.shape)} and {tuple(b.shape)}")
        if max(a.shape[-2], b.shape[-1], a.shape[-1]) >= 2**31:
            raise ValueError(f"{who}: M, N and K must be below 2**31, got {(a.shape[-2], b.shape[-1], a.shape[-1])}")
        if len(_CALLS) >= 4096:  # a bound on the signatures kept
            _CALLS.clear()
        call = _CALLS[sig] = _Call(a, b)
    if call.copy:  # a batch no two strides walk: one copy of each operand
        return bf16x3_mm_cuda(a.contiguous(), b.contiguous())
    c = a.new_empty(call.out)
    if call.params is None:  # an empty C
        return c
    index = a.get_device()
    fn = _fn or _kernel_fn()
    if index == torch.cuda.current_device():
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), ctypes.addressof(call.params), _stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), ctypes.addressof(call.params), _stream(index))
    if err != 0:
        raise RuntimeError(f"bf16x3_mm_cuda: kernel launch failed: cudaError {err} (shape {call.shape}, {call.plan})")
    bf16x3_mm_cuda.launches += 1
    bf16x3_mm_cuda.launches_by_shape[call.shape] += 1
    bf16x3_mm_cuda.launches_by_instance[call.key] += 1
    return c


bf16x3_mm_cuda.launches = 0
bf16x3_mm_cuda.launches_by_shape = Counter()
bf16x3_mm_cuda.launches_by_instance = Counter()


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
