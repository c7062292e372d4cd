"""The ARD RBF cross-gram of a batch of kernels: the hand-written CUDA kernels
of its forward and its gradient, their plain PyTorch versions, and the
differentiable ``rbf_gram``.

Counterpart of ``zigp_tpu/ops/pallas/rbf_gram.py``:

- ``rbf_gram_cuda`` replaces the Pallas kernel ``rbf_gram``. On CUDA float32
  tensors it launches ``csrc/rbf_gram.cu`` (the difference form; 4 adjacent
  columns and one 16-byte store a thread where M % 4 == 0, D ≤ 3 and the
  gram fills the card, else one entry a thread, unrolled for D ≤ 3 and
  looped for any other D: the same bits either way); on CPU tensors it runs
  ``rbf_gram_plain``. There is no fallback:
  a CUDA tensor the kernel cannot take raises.
- ``rbf_gram_plain`` is the same arithmetic in torch, one input dimension at
  a time: acc += (x_d − z_d)² / ℓ_d², K = σ² exp(−acc / 2).
- ``rbf_gram_bwd_cuda`` replaces the JAX custom VJP's ``_bwd`` (which XLA
  fuses): one launch of ``csrc/rbf_gram.cu``'s backward kernel for the G
  grams (one a block of 8 input dimensions past D = 3), which recomputes K
  with the forward's arithmetic and reads gK alone; on CPU tensors
  ``rbf_gram_bwd_plain``. With W = gK ⊙ K, both compute every distance
  gradient in difference form:

      dℓ_d = Σ_ij W_ij (X_id − Z_jd)² / ℓ_d³
      dX_id = −Σ_j W_ij (X_id − Z_jd) / ℓ_d²,   dZ_jd = Σ_i W_ij (X_id − Z_jd) / ℓ_d²
      dσ² = Σ_ij W_ij / σ²

  The JAX VJP expands Σ W (x − z)² into Σ W x² − 2 x·(Wz) + Σ Wᵀ z² in
  float32; at the pptr time column (t ≈ 5, ℓ = 0.005) those terms are 10⁶
  times their difference and dℓ loses every digit. The difference form
  keeps float32's accuracy there (``tests/test_torch_rbf_gram.py``). The
  kernel's sums across its blocks are taken in a fixed order that depends
  on N and M alone: the same bits on every call, in a CUDA graph, and for a
  member folded into a stack's G.
- ``rbf_gram_op`` (``zigp_tpu_torch::rbf_gram``) is ``rbf_gram_cuda`` as a
  registered ``torch.library`` custom op, with a fake implementation that
  takes a symbolic N: the Function launches the kernel through it, so
  ``torch.export`` records the launch and an exported program calls the
  kernel (``io.export``; serving never differentiates).
- ``rbf_gram`` is the ``torch.autograd.Function`` around them. Its backward
  is ``rbf_gram_bwd_cuda`` (the kernel on CUDA float32, the plain version on
  CPU tensors).

Shapes: X (G, N, D) or (N, D), Z (G, M, D) or (M, D) — a 2-D input is shared
by the G kernels, with no copy, and its gradient is summed over them —
lengthscales (G, D) and variance (G,), or (D,) and () for a single kernel;
K is (G, N, M), or (N, M) for a single one.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        from . import _build

        fn = _build.load("rbf_gram").zigp_rbf_gram_f32
        fn.argtypes = [
            ctypes.c_void_p,  # X
            ctypes.c_void_p,  # Z
            ctypes.c_void_p,  # ell
            ctypes.c_void_p,  # var
            ctypes.c_void_p,  # K
            ctypes.c_int,  # G
            ctypes.c_int,  # N
            ctypes.c_int,  # M
            ctypes.c_int,  # D
            ctypes.c_longlong,  # X's stride between kernels, in elements
            ctypes.c_longlong,  # Z's stride between kernels
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


_bwd = None


def _bwd_kernel():
    """(the backward's launch, its scratch size), from the same library."""
    global _bwd
    if _bwd is None:
        from . import _build

        lib = _build.load("rbf_gram")
        scratch = lib.zigp_rbf_gram_bwd_scratch
        scratch.argtypes = [ctypes.c_int] * 6  # G, N, M, D, dims, flags
        scratch.restype = ctypes.c_longlong
        fn = lib.zigp_rbf_gram_bwd_f32
        fn.argtypes = [
            *[ctypes.c_void_p] * 10,  # X, Z, ell, var, gK, dX, dZ, dell, dvar, scratch
            *[ctypes.c_int] * 6,  # G, N, M, D, first dimension, dimensions
            ctypes.c_longlong,  # X's stride between kernels, in elements
            ctypes.c_longlong,  # Z's stride between kernels
            ctypes.c_int,  # flags
            ctypes.c_int,  # ticket slot
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _bwd = (fn, scratch)
    return _bwd


def rbf_gram_plain(X, Z, ell, var):
    """(G, N, M) gram of X (G or none, N, D) against Z (G or none, M, D) with
    ell (G, D) and var (G,), in the input's dtype: the kernel's arithmetic."""
    inv_ell2 = 1.0 / torch.square(ell)
    acc = None
    for d in range(X.shape[-1]):
        diff = X[..., :, None, d] - Z[..., None, :, d]
        t = torch.square(diff) * inv_ell2[:, d, None, None]
        acc = t if acc is None else acc + t
    return var[:, None, None] * torch.exp(-0.5 * acc)


def _g_stride(T: torch.Tensor, G: int, name: str, who: str) -> int:
    if T.ndim == 2:
        return 0
    if T.ndim != 3 or T.shape[0] != G:
        raise ValueError(f"{who}: {name} must be ({G}, n, D) or (n, D), got {tuple(T.shape)}")
    return T.stride(0)


def _check(X, Z, ell, var, who: str):
    """The kernels' common checks of the gram's inputs; returns (G, D, X's
    and Z's strides between kernels)."""
    tensors = (X, Z, ell, var)
    if any(t.device != X.device for t in tensors) or X.device.type != "cuda":
        raise ValueError(f"{who}: tensors on {[str(t.device) for t in tensors]}, expected one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{who}: the kernel takes float32, got {[t.dtype for t in tensors]}")
    D = X.shape[-1]
    if ell.ndim != 2 or D < 1 or Z.shape[-1] != D or ell.shape[1] != D:
        raise ValueError(
            f"{who}: expected D >= 1 and ell (G, D); got X {tuple(X.shape)}, "
            f"Z {tuple(Z.shape)}, ell {tuple(ell.shape)}"
        )
    G = ell.shape[0]
    if tuple(var.shape) != (G,):
        raise ValueError(f"{who}: var must be ({G},), got {tuple(var.shape)}")
    xg, zg = _g_stride(X, G, "X", who), _g_stride(Z, G, "Z", who)
    for name, T in (("X", X), ("Z", Z)):
        rows_ok = T.shape[-2] <= 1 or T.stride(-2) == D
        cols_ok = D == 1 or T.stride(-1) == 1
        if not (rows_ok and cols_ok):
            raise ValueError(f"{who}: each (n, D) block of {name} must be row-major, strides {T.stride()}")
    if not (ell.is_contiguous() and var.is_contiguous()):
        raise ValueError(f"{who}: ell and var must be contiguous")
    return G, D, xg, zg


def rbf_gram_cuda(X, Z, ell, var):
    """(G, N, M) gram (shapes as ``rbf_gram_plain``). CUDA tensors go to the
    kernel: float32, any D ≥ 1, each (n, D) block row-major, ell and var
    contiguous; anything else raises. CPU tensors go to ``rbf_gram_plain``.
    Each kernel launch adds one to ``rbf_gram_cuda.launches`` and to
    ``rbf_gram_cuda.launches_by_shape[(G, N, M, D)]``."""
    if all(t.device.type == "cpu" for t in (X, Z, ell, var)):
        return rbf_gram_plain(X, Z, ell, var)
    G, D, xg, zg = _check(X, Z, ell, var, "rbf_gram_cuda")
    N, M = X.shape[-2], Z.shape[-2]
    K = torch.empty((G, N, M), dtype=X.dtype, device=X.device)
    if G == 0 or N == 0 or M == 0:
        return K
    fn = _kernel_fn()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = fn(X.data_ptr(), Z.data_ptr(), ell.data_ptr(), var.data_ptr(), K.data_ptr(),
                 G, N, M, D, xg, zg, stream)
    if err != 0:
        raise RuntimeError(f"rbf_gram kernel launch failed: cudaError {err} (G={G}, N={N}, M={M}, D={D})")
    rbf_gram_cuda.launches += 1
    rbf_gram_cuda.launches_by_shape[(G, N, M, D)] += 1
    return K


rbf_gram_cuda.launches = 0
rbf_gram_cuda.launches_by_shape = Counter()


def rbf_gram_bwd_plain(X, Z, ell, var, K, gK, needs):
    """(dX, dZ, dℓ, dσ²) of sum(gK ⊙ K) for K = ``rbf_gram_plain(X, Z, ell,
    var)`` (its saved value), each None where ``needs`` (four bools, as
    ``ctx.needs_input_grad``) does not ask for it; a shared (2-D) X or Z
    gets its gradient summed over the G kernels."""
    need_X, need_Z, need_ell, need_var = needs
    W = gK * K
    dX = dZ = dell = dvar = None
    if need_X or need_Z or need_ell:
        inv_ell2 = 1.0 / torch.square(ell)
        dXs, dZs, dells = [], [], []
        for d in range(X.shape[-1]):
            diff = X[..., :, None, d] - Z[..., None, :, d]  # (G, N, M)
            Wd = W * diff
            if need_X:
                dXs.append(-Wd.sum(-1) * inv_ell2[:, d, None])
            if need_Z:
                dZs.append(Wd.sum(-2) * inv_ell2[:, d, None])
            if need_ell:
                dells.append((Wd * diff).sum((-2, -1)) / (ell[:, d] * ell[:, d] * ell[:, d]))
        if need_X:
            dX = torch.stack(dXs, -1)
            dX = dX if X.ndim == 3 else dX.sum(0)
        if need_Z:
            dZ = torch.stack(dZs, -1)
            dZ = dZ if Z.ndim == 3 else dZ.sum(0)
        if need_ell:
            dell = torch.stack(dells, -1)
    if need_var:
        dvar = W.sum((-2, -1)) / var
    return dX, dZ, dell, dvar


# csrc/rbf_gram.cu's backward flags
NEED_X, NEED_Z, NEED_ELL, NEED_VAR, SUM_X, SUM_Z, VEC_LOAD = 1, 2, 4, 8, 16, 32, 64
BWD_EXACT_D = 3  # D <= 3: one launch, every dimension in registers
BWD_MAX_DIMS = 8  # past that, one launch for each 8 input dimensions
_SLOTS = 256  # the kernel's tickets
_slots: dict = {}


def _slot(stream: int) -> int:
    """The backward's ticket for a stream: the last block of a launch is
    found by counting finished blocks on it, so two launches running at
    once (on two streams) must not share one. Launches on one stream, or
    in one graph, run one after the other."""
    return _slots.setdefault(stream, len(_slots) % _SLOTS)


def rbf_gram_bwd_cuda(X, Z, ell, var, K, gK, needs):
    """``rbf_gram_bwd_plain``'s (dX, dZ, dℓ, dσ²). CUDA tensors go to the
    backward kernel (the forward's checks, gK and K (G, N, M); a gK, an ell or
    a var that is not contiguous is copied to one that is); it recomputes K, so
    ``K`` is checked and not read. Anything else on the card raises; CPU
    tensors go to ``rbf_gram_bwd_plain``. Each kernel launch adds one to
    ``rbf_gram_bwd_cuda.launches`` and to ``launches_by_shape[(G, N, M,
    D)]``: one a call for D ≤ 3 or D ≤ 8, ⌈D / 8⌉ past that."""
    tensors = (X, Z, ell, var, K, gK)
    if all(t.device.type == "cpu" for t in tensors):
        return rbf_gram_bwd_plain(X, Z, ell, var, K, gK, needs)
    who = "rbf_gram_bwd_cuda"
    if any(t.device != X.device for t in tensors):
        raise ValueError(f"{who}: tensors on {[str(t.device) for t in tensors]}, expected one CUDA device")
    need_X, need_Z, need_ell, need_var = (bool(n) for n in needs)
    ell, var = ell.contiguous(), var.contiguous()  # the Function saves its inputs as given
    G, D, xg, zg = _check(X, Z, ell, var, who)
    N, M = X.shape[-2], Z.shape[-2]
    for name, T in (("gK", gK), ("K", K)):
        if T.dtype != torch.float32 or tuple(T.shape) != (G, N, M):
            raise ValueError(f"{who}: {name} must be float32 ({G}, {N}, {M}), got {T.dtype} {tuple(T.shape)}")
    gK = gK.contiguous()
    out = lambda need, *shape: torch.empty(shape, dtype=X.dtype, device=X.device) if need else None
    dX = out(need_X, *X.shape)
    dZ = out(need_Z, *Z.shape)
    dell, dvar = out(need_ell, G, D), out(need_var, G)
    if G == 0 or N == 0 or M == 0 or not (need_X or need_Z or need_ell or need_var):
        return tuple(None if t is None else t.zero_() for t in (dX, dZ, dell, dvar))
    flags = (NEED_X * need_X | NEED_Z * need_Z | NEED_ELL * need_ell | SUM_X * (X.ndim == 2)
             | SUM_Z * (Z.ndim == 2) | VEC_LOAD * (M % 4 == 0 and gK.data_ptr() % 16 == 0))
    dims = D if D <= BWD_EXACT_D else BWD_MAX_DIMS
    fn, scratch_floats = _bwd_kernel()
    scratch = torch.empty(scratch_floats(G, N, M, D, min(dims, D), flags), dtype=torch.float32, device=X.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        for d0 in range(0, D, dims):
            dc = min(dims, D - d0)
            f = flags | (NEED_VAR if need_var and d0 == 0 else 0)
            err = fn(X.data_ptr(), Z.data_ptr(), ell.data_ptr(), var.data_ptr(), gK.data_ptr(), ptr(dX), ptr(dZ),
                     ptr(dell), ptr(dvar), scratch.data_ptr(), G, N, M, D, d0, dc, xg, zg, f, _slot(stream), stream)
            if err != 0:
                raise RuntimeError(f"rbf_gram backward kernel launch failed: cudaError {err} "
                                   f"(G={G}, N={N}, M={M}, D={D}, dims {d0}..{d0 + dc})")
            rbf_gram_bwd_cuda.launches += 1
            rbf_gram_bwd_cuda.launches_by_shape[(G, N, M, D)] += 1
    return dX, dZ, dell, dvar


rbf_gram_bwd_cuda.launches = 0
rbf_gram_bwd_cuda.launches_by_shape = Counter()


@torch.library.custom_op("zigp_tpu_torch::rbf_gram", mutates_args=(),
                         schema="(Tensor X, Tensor Z, Tensor ell, Tensor var) -> Tensor")
def rbf_gram_op(X, Z, ell, var):
    """``rbf_gram_cuda`` as a registered op: the kernel on CUDA tensors, the
    plain version on CPU ones."""
    return rbf_gram_cuda(X, Z, ell, var)


@rbf_gram_op.register_fake
def _rbf_gram_fake(X, Z, ell, var):
    return X.new_empty((ell.shape[0], X.shape[-2], Z.shape[-2]))


class _RBFGram(torch.autograd.Function):
    """The differentiable gram. Under ``torch.func.vmap`` (the batched
    member stack) the ``vmap`` rule folds the member dim into the kernels'
    dim G, a member's X or Z shared by its G kernels expanded to each, and
    makes one call: one launch for every member's G grams, forward and
    backward."""

    @staticmethod
    def forward(X, Z, ell, var):
        return rbf_gram_op(X.detach(), Z.detach(), ell.detach().contiguous(), var.detach().contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def vmap(info, in_dims, X, Z, ell, var):
        from ..linalg import fold_member_dim

        F = info.batch_size
        X, Z, ell, var = (fold_member_dim(t, d, F) for t, d in zip((X, Z, ell, var), in_dims))
        G = ell.shape[1]

        def per_kernel(T):  # (F, G, n, D) from (F, G, n, D) or a shared (F, n, D)
            return T if T.ndim == 4 else T.unsqueeze(1).expand(F, G, *T.shape[1:])

        X, Z = (per_kernel(T).reshape(F * G, *T.shape[-2:]) for T in (X, Z))
        K = _RBFGram.apply(X, Z, ell.reshape(F * G, -1), var.reshape(F * G))
        return K.reshape(F, G, *K.shape[-2:]), 0

    @staticmethod
    def backward(ctx, gK):
        X, Z, ell, var, K = ctx.saved_tensors
        return rbf_gram_bwd_cuda(X, Z, ell, var, K, gK, ctx.needs_input_grad)


def rbf_gram(X, Z, lengthscales, variance):
    """σ² exp(−½ Σ_d (x_d − z_d)² / ℓ_d²) between the rows of X and Z,
    differentiable in all four (see the module docstring for shapes). A
    single lengthscale is shared by every input dimension."""
    single = lengthscales.ndim < 2
    ell = lengthscales.reshape(1, -1) if single else lengthscales
    var = variance.reshape(-1)
    ell = ell.expand(ell.shape[0], X.shape[-1])
    K = _RBFGram.apply(X, Z, ell, var)
    return K[0] if single else K
