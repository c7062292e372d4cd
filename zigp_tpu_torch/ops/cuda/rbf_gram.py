"""The ARD RBF cross-gram of a batch of kernels: the hand-written CUDA kernel,
its plain PyTorch version, and the differentiable ``rbf_gram``.

Counterpart of ``zigp_tpu/ops/pallas/rbf_gram.py``:

- ``rbf_gram_cuda`` replaces the Pallas kernel ``rbf_gram``. On CUDA float32
  tensors it launches ``csrc/rbf_gram.cu`` (one thread per entry, the
  difference form, unrolled for D ≤ 3 and looped for any other D); on CPU
  tensors it runs
  ``rbf_gram_plain``. There is no fallback: a CUDA tensor the kernel cannot
  take raises.
- ``rbf_gram_plain`` is the same arithmetic in torch, one input dimension at
  a time: acc += (x_d − z_d)² / ℓ_d², K = σ² exp(−acc / 2).
- ``rbf_gram_op`` (``zigp_tpu_torch::rbf_gram``) is ``rbf_gram_cuda`` as a
  registered ``torch.library`` custom op, with a fake implementation that
  takes a symbolic N: the Function launches the kernel through it, so
  ``torch.export`` records the launch and an exported program calls the
  kernel (``io.export``).
- ``rbf_gram`` is the ``torch.autograd.Function`` around them. Its backward
  reuses the saved K, as the JAX custom VJP does, but computes every
  distance gradient in difference form, with W = gK ⊙ K:

      dℓ_d = Σ_ij W_ij (X_id − Z_jd)² / ℓ_d³
      dX_id = −Σ_j W_ij (X_id − Z_jd) / ℓ_d²,   dZ_jd = Σ_i W_ij (X_id − Z_jd) / ℓ_d²
      dσ² = Σ_ij W_ij / σ²

  The JAX VJP expands Σ W (x − z)² into Σ W x² − 2 x·(Wz) + Σ Wᵀ z² in
  float32; at the pptr time column (t ≈ 5, ℓ = 0.005) those terms are 10⁶
  times their difference and dℓ loses every digit. The difference form
  keeps float32's accuracy there (``tests/test_torch_rbf_gram.py``).

Shapes: X (G, N, D) or (N, D), Z (G, M, D) or (M, D) — a 2-D input is shared
by the G kernels, with no copy — lengthscales (G, D) and variance (G,), or
(D,) and () for a single kernel; K is (G, N, M), or (N, M) for a single one.
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


def _g_stride(T: torch.Tensor, G: int, name: str) -> int:
    if T.ndim == 2:
        return 0
    if T.ndim != 3 or T.shape[0] != G:
        raise ValueError(f"rbf_gram_cuda: {name} must be ({G}, n, D) or (n, D), got {tuple(T.shape)}")
    return T.stride(0)


def rbf_gram_cuda(X, Z, ell, var):
    """(G, N, M) gram (shapes as ``rbf_gram_plain``). CUDA tensors go to the
    kernel: float32, any D ≥ 1, each (n, D) block row-major, ell and var
    contiguous; anything else raises. CPU tensors go to ``rbf_gram_plain``.
    Each kernel launch adds one to ``rbf_gram_cuda.launches`` and to
    ``rbf_gram_cuda.launches_by_shape[(G, N, M, D)]``."""
    tensors = (X, Z, ell, var)
    if all(t.device.type == "cpu" for t in tensors):
        return rbf_gram_plain(X, Z, ell, var)
    if any(t.device != X.device for t in tensors) or X.device.type != "cuda":
        raise ValueError(f"rbf_gram_cuda: tensors on {[str(t.device) for t in tensors]}, expected one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"rbf_gram_cuda: the kernel takes float32, got {[t.dtype for t in tensors]}")
    D = X.shape[-1]
    if ell.ndim != 2 or D < 1 or Z.shape[-1] != D or ell.shape[1] != D:
        raise ValueError(
            f"rbf_gram_cuda: expected D >= 1 and ell (G, D); got X {tuple(X.shape)}, "
            f"Z {tuple(Z.shape)}, ell {tuple(ell.shape)}"
        )
    G = ell.shape[0]
    if tuple(var.shape) != (G,):
        raise ValueError(f"rbf_gram_cuda: var must be ({G},), got {tuple(var.shape)}")
    xg, zg = _g_stride(X, G, "X"), _g_stride(Z, G, "Z")
    for name, T in (("X", X), ("Z", Z)):
        rows_ok = T.shape[-2] <= 1 or T.stride(-2) == D
        cols_ok = D == 1 or T.stride(-1) == 1
        if not (rows_ok and cols_ok):
            raise ValueError(f"rbf_gram_cuda: each (n, D) block of {name} must be row-major, strides {T.stride()}")
    if not (ell.is_contiguous() and var.is_contiguous()):
        raise ValueError("rbf_gram_cuda: ell and var must be contiguous")
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
    makes one call: one launch for every member's G grams."""

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
        need_X, need_Z, need_ell, need_var = ctx.needs_input_grad
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
