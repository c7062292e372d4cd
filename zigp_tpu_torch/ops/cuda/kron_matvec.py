"""y = (A ⊗ B) x for two square factors: the hand-written CUDA kernel and its
plain PyTorch version.

Counterpart of ``zigp_tpu/ops/pallas/kron_matvec.py``:

- ``kron_mv_2_cuda`` replaces ``kron_mv_2``. On CUDA float32 tensors it
  launches ``csrc/kron_mv.cu`` (CTAs of 32 columns of the (Ma, Mb)
  intermediate T = X Bᵀ, each slab kept in shared memory); on CPU tensors it
  runs ``kron_mv_2_plain``. There is no fallback: a CUDA tensor the kernel
  cannot take raises.
- ``kron_mv_2_plain`` is the same contraction in torch: X = x reshaped
  (Ma, Mb) row-major, T = X Bᵀ, Y = A T, y = vec(Y).

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
from collections import Counter

import torch

_fns = {}
_shared_t = {}


def _lib_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        from . import _build

        fn = getattr(_build.load("kron_mv"), name)
        if name == "zigp_kron_mv_f32":
            fn.argtypes = [
                ctypes.c_void_p,  # A
                ctypes.c_void_p,  # B
                ctypes.c_void_p,  # x
                ctypes.c_void_p,  # y
                ctypes.c_void_p,  # scratch, or None
                ctypes.c_int,  # Ma
                ctypes.c_int,  # Mb
                ctypes.c_int,  # G
                ctypes.c_int,  # transpose
                ctypes.c_void_p,  # cudaStream_t
            ]
        else:
            fn.argtypes = [ctypes.c_int]  # Ma
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def shared_t(Ma: int) -> bool:
    """Whether the kernel keeps its slab of T (Ma rows) in shared memory on
    the current CUDA device; if not, it uses a global scratch buffer."""
    key = (torch.cuda.current_device(), Ma)
    if key not in _shared_t:
        _shared_t[key] = bool(_lib_fn("zigp_kron_mv_shared_t")(Ma))
    return _shared_t[key]


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


def kron_mv_2_plain(A: torch.Tensor, B: torch.Tensor, x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """(A ⊗ B) x, or (Aᵀ ⊗ Bᵀ) x, in the inputs' dtype."""
    G, Ma, Mb = _shapes(A, B, x)
    X = x.reshape(max(G, 1), Ma, Mb)
    A3, B3 = (A, B) if G else (A[None], B[None])
    if transpose:
        Y = A3.transpose(-1, -2) @ (X @ B3)
    else:
        Y = A3 @ (X @ B3.transpose(-1, -2))
    return Y.reshape(x.shape)


def kron_mv_2_cuda(A: torch.Tensor, B: torch.Tensor, x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """(A ⊗ B) x, or (Aᵀ ⊗ Bᵀ) x. CUDA tensors go to the kernel (float32,
    contiguous, on one device; anything else raises); CPU tensors to
    ``kron_mv_2_plain``. Each kernel launch adds one to
    ``kron_mv_2_cuda.launches`` and to
    ``kron_mv_2_cuda.launches_by_shape[(G, Ma, Mb, transpose)]`` (G = 1 for
    the unbatched form)."""
    devices = {A.device.type, B.device.type, x.device.type}
    if devices == {"cpu"}:
        return kron_mv_2_plain(A, B, x, transpose)
    if devices != {"cuda"} or not (A.device == B.device == x.device):
        raise ValueError(f"kron_mv_2_cuda: A, B and x must be on one CUDA device, got {A.device}, {B.device}, "
                         f"{x.device}")
    if not (A.dtype == B.dtype == x.dtype == torch.float32):
        raise TypeError(f"kron_mv_2_cuda: the kernel takes float32, got {A.dtype}, {B.dtype}, {x.dtype}")
    G, Ma, Mb = _shapes(A, B, x)
    if not (A.is_contiguous() and B.is_contiguous() and x.is_contiguous()):
        raise ValueError("kron_mv_2_cuda: inputs must be contiguous")
    G = max(G, 1)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        scratch = None if shared_t(Ma) else torch.empty(G * Ma * Mb, dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib_fn("zigp_kron_mv_f32")(
            A.data_ptr(), B.data_ptr(), x.data_ptr(), y.data_ptr(),
            None if scratch is None else scratch.data_ptr(), Ma, Mb, G, int(transpose), stream,
        )
    if err != 0:
        raise RuntimeError(f"kron_mv_2 kernel launch failed: cudaError {err} (G={G}, Ma={Ma}, Mb={Mb})")
    kron_mv_2_cuda.launches += 1
    kron_mv_2_cuda.launches_by_shape[(G, Ma, Mb, bool(transpose))] += 1
    return y


kron_mv_2_cuda.launches = 0
kron_mv_2_cuda.launches_by_shape = Counter()
