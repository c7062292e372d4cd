"""y = (A ⊗ B) x for two square factors: the hand-written CUDA kernel, its
plain PyTorch version, and the kernel's tile plan.

Counterpart of ``zigp_tpu/ops/pallas/kron_matvec.py``:

- ``kron_mv_2_cuda`` replaces ``kron_mv_2``. On CUDA float32 tensors it
  launches ``csrc/kron_mv.cu``; on CPU tensors it runs ``kron_mv_2_plain``.
  There is no fallback: a CUDA tensor the kernel cannot take raises.
- ``kron_mv_2_plain`` is the same contraction in torch: X = x reshaped
  (Ma, Mb) row-major, T = X Bᵀ, Y = A T, y = vec(Y).
- ``plan`` is what one launch runs for (G, Ma, Mb): a CTA per TM × TN tile
  of Y, the ⌈Ma / TM⌉ CTAs of a column slab in one thread-block cluster that
  share the slab of T through distributed shared memory (the "cluster"
  instance, ⌈Ma / TM⌉ ≤ 8), or above that one CTA per column slab over every
  row tile, T in a global scratch of its own (the "global" instance). It is
  the one place the instance is chosen: the library launches the cluster
  instance for a null scratch (and refuses it past the cluster's reach), the
  global one for a scratch buffer. ``kron_mv_2_tiled_plain`` walks the plan
  CTA by CTA and chunk by chunk, with the cluster's exchange and the zero
  fills of the slab of T, so the plan is pinned on the CPU.

``transpose=True`` computes (Aᵀ ⊗ Bᵀ) x = vec(Aᵀ X B) from the same A and B
(the kernel reads them transposed), which the L⁻ᵀ pass of a Kronecker solve
needs.

Shapes: A (Ma, Ma), B (Mb, Mb) and x (Ma·Mb,) or (Ma·Mb, 1), as the JAX
function takes them; or a leading batch of G pairs, A (G, Ma, Ma), B
(G, Mb, Mb), x (G, Ma·Mb) or (G, Ma·Mb, 1), which is how the port stacks the
f/g pair. y has x's shape.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from dataclasses import dataclass

import torch

TM, TN = 16, 16  # the tile of Y per CTA, the one the library builds
CHUNK = 32  # k per staged chunk
SPLIT = 4  # k-groups per CTA, each taking CHUNK // SPLIT k of every chunk
MAX_CLUSTER = 8  # CTAs per cluster, the portable limit

_fn = None


def _lib():
    global _fn
    if _fn is None:
        from . import _build

        fn = _build.load("kron_mv").zigp_kron_mv_f32
        fn.argtypes = [
            ctypes.c_void_p,  # A
            ctypes.c_void_p,  # B
            ctypes.c_void_p,  # x
            ctypes.c_void_p,  # y
            ctypes.c_void_p,  # scratch: None for the cluster instance
            ctypes.c_int,  # Ma
            ctypes.c_int,  # Mb
            ctypes.c_int,  # G
            ctypes.c_int,  # transpose
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@dataclass(frozen=True)
class TilePlan:
    """One launch of ``csrc/kron_mv.cu``: the instance, the grid (x: the row
    tiles of a cluster, or 1; y: column slabs; z: G), CTAs per cluster along
    x, threads per CTA (one per output of the tile: SPLIT k-groups of 4-row
    micro-tiles), and floats of global scratch."""

    instance: str  # "cluster" or "global"
    grid: tuple[int, int, int]
    cluster: int
    threads: int
    scratch: int

    @property
    def name(self) -> str:
        return f"{self.instance} {TM}x{TN}"


@functools.lru_cache(maxsize=None)
def plan(G: int, Ma: int, Mb: int, instance: str | None = None) -> TilePlan:
    """The launch for G pairs of (Ma, Mb): the cluster instance within the
    cluster's reach (⌈Ma / TM⌉ ≤ MAX_CLUSTER), else the global one, or the
    ``instance`` asked for (the global instance takes any shape)."""
    rows, slabs = -(-Ma // TM), -(-Mb // TN)
    instance = instance or ("cluster" if rows <= MAX_CLUSTER else "global")
    if instance == "cluster":
        if rows > MAX_CLUSTER:
            raise ValueError(f"kron_mv_2: Ma = {Ma} is past the cluster's reach ({MAX_CLUSTER * TM} rows)")
        return TilePlan("cluster", (rows, slabs, G), rows, TM * TN, 0)
    if instance != "global":
        raise ValueError(f"kron_mv_2: no instance {instance!r} (cluster or global)")
    return TilePlan("global", (1, slabs, G), 1, TM * TN, G * slabs * Ma * TN)


def ctas(p: TilePlan, Ma: int, Mb: int):
    """Every CTA of the plan's grid, as (g, rank in its cluster, its row
    tiles [(i0, i1), ...], its columns (j0, j1)): in the cluster instance
    CTA x of grid x stores row tile x, in the global one the single CTA of
    grid x walks every row tile."""
    for g in range(p.grid[2]):
        for c in range(p.grid[1]):
            cols = (c * TN, min((c + 1) * TN, Mb))
            for x in range(p.grid[0]):
                starts = [x * TM] if p.instance == "cluster" else range(0, Ma, TM)
                yield g, x % p.cluster, [(i0, min(i0 + TM, Ma)) for i0 in starts], cols


def _shapes(A, B, x):
    """(G, Ma, Mb), with G = 0 for the unbatched form; raises on a mismatch."""
    if A.ndim != B.ndim or A.ndim not in (2, 3) or A.shape[-1] != A.shape[-2] or B.shape[-1] != B.shape[-2]:
        raise ValueError(f"kron_mv_2: expected square A and B, both with or both without a batch, got "
                         f"{tuple(A.shape)} and {tuple(B.shape)}")
    Ma, Mb = A.shape[-1], B.shape[-1]
    N = Ma * Mb
    if A.ndim == 2:
        if tuple(x.shape) not in ((N,), (N, 1)):
            raise ValueError(f"kron_mv_2: x must be ({N},) or ({N}, 1), got {tuple(x.shape)}")
        return 0, Ma, Mb
    G = A.shape[0]
    if B.shape[0] != G or tuple(x.shape) not in ((G, N), (G, N, 1)):
        raise ValueError(f"kron_mv_2: B must be ({G}, {Mb}, {Mb}) and x ({G}, {N}) or ({G}, {N}, 1), got "
                         f"{tuple(B.shape)} and {tuple(x.shape)}")
    return G, Ma, Mb


def _operands(A, B, x, transpose):
    """G ≥ 1, Ma, Mb, X (G, Ma, Mb), Aop and Bop (A and B, or their
    transposes), each with a leading batch."""
    G, Ma, Mb = _shapes(A, B, x)
    A3, B3 = (A, B) if G else (A[None], B[None])
    if transpose:
        A3, B3 = A3.transpose(-1, -2), B3.transpose(-1, -2)
    return max(G, 1), Ma, Mb, x.reshape(max(G, 1), Ma, Mb), A3, B3


def kron_mv_2_plain(A: torch.Tensor, B: torch.Tensor, x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """(A ⊗ B) x, or (Aᵀ ⊗ Bᵀ) x, in the inputs' dtype."""
    _, _, _, X, Aop, Bop = _operands(A, B, x, transpose)
    return (Aop @ (X @ Bop.transpose(-1, -2))).reshape(x.shape)


def _staged(M: torch.Tensor, r0: int, n: int, nk: int) -> torch.Tensor:
    """Rows r0 … r0 + n - 1 of M over k < nk, rounded up to whole chunks,
    zero past M's edges and past nk: what the kernel's Stager copies."""
    out = M.new_zeros(n, -(-nk // CHUNK) * CHUNK)
    blk = M[r0 : r0 + n, :nk]
    out[: blk.shape[0], : blk.shape[1]] = blk
    return out


def _chunked_product(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Σ_k P[i, k] Q[j, k] for staged P (rows, K) and Q (columns, K), K a
    multiple of CHUNK, grouped as the kernel groups it: k-group s sums its
    CHUNK // SPLIT k of every chunk, then the groups' sums are added in the
    order of s. The sum inside a group's share is torch's, not the kernel's
    chain of FMAs, so this pins the grouping, not the last bit."""
    Ps = P.reshape(P.shape[0], -1, SPLIT, CHUNK // SPLIT)
    Qs = Q.reshape(Q.shape[0], -1, SPLIT, CHUNK // SPLIT)
    part = torch.einsum("icsu,jcsu->sij", Ps, Qs)
    acc = part[0]
    for s in range(1, SPLIT):
        acc = acc + part[s]
    return acc


def kron_mv_2_tiled_plain(A: torch.Tensor, B: torch.Tensor, x: torch.Tensor, transpose: bool = False,
                          instance: str | None = None) -> torch.Tensor:
    """``kron_mv_2_plain`` computed as the plan's CTAs compute it, chunk by
    chunk. Cluster instance: each rank's rows of the slab of T (rows past Ma
    zero), written into every rank's copy of the slab through the exchange,
    the rows past the cluster's tiles that phase 3 reads zero-filled, then
    its tile of Y from its staged rows of Aop and the slab. Global instance:
    the slab of T through a scratch of Ma rows, then every tile of Y. What
    neither writes is NaN, so a read of it shows in y; y's entries that no
    CTA stores stay NaN."""
    G, Ma, Mb, X, Aop, Bop = _operands(A, B, x, transpose)
    p = plan(G, Ma, Mb, instance)
    nan = float("nan")
    Y = X.new_full((G, Ma, Mb), nan)
    ka = -(-Ma // CHUNK) * CHUNK  # k of phase 3, in whole chunks
    for g, c in ((g, c) for g in range(G) for c in range(p.grid[1])):
        j0, j1 = c * TN, min((c + 1) * TN, Mb)
        Q = _staged(Bop[g], j0, TN, Mb)
        if p.instance == "cluster":
            R = p.grid[0]
            own = []  # each rank's rows of T, rows past Ma zero
            for r in range(R):
                t = _chunked_product(_staged(X[g], r * TM, TM, Mb), Q)
                t[max(Ma - r * TM, 0) :] = 0
                own.append(t)
            for r in range(R):
                slab = X.new_full((-(-R * TM // CHUNK) * CHUNK, TN), nan)  # rank r's shared memory
                slab[R * TM : ka] = 0
                slab[r * TM : (r + 1) * TM] = own[r]
                for q in range(R):  # the peers' rows, read from their shared memory
                    if q != r:
                        slab[q * TM : (q + 1) * TM] = own[q]
                y = _chunked_product(_staged(Aop[g], r * TM, TM, Ma), slab[:ka].T)
                i1 = min((r + 1) * TM, Ma)
                Y[g, r * TM : i1, j0:j1] = y[: i1 - r * TM, : j1 - j0]
        else:
            T = X.new_full((Ma, TN), nan)  # the CTA's scratch
            for i0 in range(0, Ma, TM):
                i1 = min(i0 + TM, Ma)
                T[i0:i1] = _chunked_product(_staged(X[g], i0, TM, Mb), Q)[: i1 - i0]
            Tq = _staged(T.T, 0, TN, Ma)  # (column, k), k < Ma: the View of the scratch
            for i0 in range(0, Ma, TM):
                i1 = min(i0 + TM, Ma)
                Y[g, i0:i1, j0:j1] = _chunked_product(_staged(Aop[g], i0, TM, Ma), Tq)[: i1 - i0, : j1 - j0]
    return Y.reshape(x.shape)


def launch_kron_mv(A: torch.Tensor, B: torch.Tensor, x: torch.Tensor, transpose: bool = False,
                   instance: str | None = None) -> torch.Tensor:
    """y from ``csrc/kron_mv.cu`` on CUDA float32 tensors, in the plan's
    instance or the ``instance`` asked for; raises on anything the kernel
    cannot take. Each launch adds one to ``kron_mv_2_cuda.launches``, to
    ``kron_mv_2_cuda.launches_by_shape[(G, Ma, Mb, transpose)]`` (G = 1 for
    the unbatched form) and to
    ``kron_mv_2_cuda.launches_by_instance[(G, Ma, Mb, transpose, name)]``
    (the plan's name, e.g. "cluster 16x16", the instance the library ran)."""
    devices = {A.device.type, B.device.type, x.device.type}
    if devices != {"cuda"} or not (A.device == B.device == x.device):
        raise ValueError(f"kron_mv_2_cuda: A, B and x must be on one CUDA device, got {A.device}, {B.device}, "
                         f"{x.device}")
    if not (A.dtype == B.dtype == x.dtype == torch.float32):
        raise TypeError(f"kron_mv_2_cuda: the kernel takes float32, got {A.dtype}, {B.dtype}, {x.dtype}")
    G, Ma, Mb = _shapes(A, B, x)
    if not (A.is_contiguous() and B.is_contiguous() and x.is_contiguous()):
        raise ValueError("kron_mv_2_cuda: inputs must be contiguous")
    p = plan(max(G, 1), Ma, Mb, instance)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        scratch = torch.empty(p.scratch, dtype=x.dtype, device=x.device) if p.instance == "global" else None
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib()(
            A.data_ptr(), B.data_ptr(), x.data_ptr(), y.data_ptr(),
            None if scratch is None else scratch.data_ptr(), Ma, Mb, p.grid[2], int(transpose), stream,
        )
    if err != 0:
        raise RuntimeError(f"kron_mv_2 kernel launch failed: cudaError {err} (G={p.grid[2]}, Ma={Ma}, Mb={Mb}, "
                           f"{p.name})")
    shape = (p.grid[2], Ma, Mb, bool(transpose))
    kron_mv_2_cuda.launches += 1
    kron_mv_2_cuda.launches_by_shape[shape] += 1
    kron_mv_2_cuda.launches_by_instance[(*shape, p.name)] += 1
    return y


def kron_mv_2_cuda(A: torch.Tensor, B: torch.Tensor, x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """(A ⊗ B) x, or (Aᵀ ⊗ Bᵀ) x. CUDA tensors go to the kernel in the
    plan's instance (``launch_kron_mv``, which counts the launch: float32,
    contiguous, on one device; anything else raises); CPU tensors to
    ``kron_mv_2_plain``."""
    if {A.device.type, B.device.type, x.device.type} == {"cpu"}:
        return kron_mv_2_plain(A, B, x, transpose)
    return launch_kron_mv(A, B, x, transpose)


kron_mv_2_cuda.launches = 0
kron_mv_2_cuda.launches_by_shape = Counter()
kron_mv_2_cuda.launches_by_instance = Counter()
