"""Dense and Kronecker-factored linear algebra for serving and training.

Counterpart of ``zigp_tpu/ops/linalg.py``: ``add_jitter``, the ``chol_inv``
dispatch with its matmul-only backward, the factored Kronecker products and
solves (against per-factor Cholesky factors or precomputed triangular
inverses), the diagonal and log-determinant pieces of the KL, and the
precision policy of the solve-replacing products (``set_solve_precision``,
``hdot``, ``bdot``, ``bulk_precision``). Every other float32 product is
exact float32: ``core.config`` turns TF32 off at import.

Every function takes leading batch dimensions, which is how the on/off model
runs its f and g GPs through one pass (the JAX package's ``vmap``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import split_k
from .cuda.bf16x3 import bf16x3_mm
from .cuda.chol_inv import BLOCKED_MAX_N, MAX_N, chol_inv_blocked_op, chol_inv_op

# The precision of the solve-replacing products (``zigp_tpu/ops/linalg.py:
# 56-118``), in two classes: the factor-space products (the chol_inv VJP,
# the Kronecker inverse solves, the KL trace, natgrad's S-products) go
# through ``hdot``; the batch-scaled projections and contractions of the
# conditionals ((M_p, M_p) @ (M_p, B) and the factored contractions, the
# products that grow with the batch) through ``bdot``. Each class is either
# exact float32 or the 3-pass bf16 product of ``ops.cuda.bf16x3`` (the TPU's
# Precision.HIGH).
_POLICIES = {"highest": (False, False), "high": (True, True), "mixed": (False, True)}
_POLICY = "highest"
_SOLVE_3PASS, _BULK_3PASS = _POLICIES[_POLICY]


def set_solve_precision(name: str) -> None:
    """Set the precision of every solve-replacing product: "highest" (the
    default: exact float32), "high" (the 3-pass bf16 product in both
    classes, about 1e-5 relative) or "mixed" (``hdot`` exact, ``bdot`` and
    the bulk contractions 3-pass).

    Only float32 changes: a float64 product is a plain matmul under every
    policy, as a float64 dot is exact on the TPU whatever its precision. On
    a CUDA tensor the 3-pass product is the kernel ``csrc/bf16x3_mm.cu``,
    on a CPU tensor its plain version.

    When it is read: the JAX package reads the policy when a step is traced,
    so a jitted step keeps what it traced. Here eager code reads it at each
    call, and a captured CUDA graph (a training block, a serving chunk
    graph) keeps the policy it captured: switch before building a model's
    steps, as the command line does before any model is built."""
    global _POLICY, _SOLVE_3PASS, _BULK_3PASS
    if name not in _POLICIES:
        raise ValueError(f"solve precision must be one of {sorted(_POLICIES)}, got {name!r}")
    _POLICY = name
    _SOLVE_3PASS, _BULK_3PASS = _POLICIES[name]


def solve_precision() -> str:
    """The policy in force ("highest", "high" or "mixed")."""
    return _POLICY


def _dot(a: torch.Tensor, b: torch.Tensor, three_pass: bool) -> torch.Tensor:
    if three_pass and a.dtype == torch.float32 and b.dtype == torch.float32:
        return bf16x3_mm(a, b)
    return a @ b


def hdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for a factor-space solve-replacing product: exact float32, or
    3-pass under "high"."""
    return _dot(a, b, _SOLVE_3PASS)


def bdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for a batch-scaled product of the conditionals: exact float32,
    or 3-pass under "high" and "mixed".

    Exact float32 on CUDA tensors that need a gradient, where the backward
    has a product that contracts the batch into a C of few tiles
    (``split_k.backward_reduces``), is ``a @ b`` itself whose backward
    computes those products with k split into ranges
    (``split_k.split_k_mm``); anything else (no gradient, no such product,
    the CPU, float64) is the plain ``a @ b``."""
    if _BULK_3PASS:
        return _dot(a, b, True)
    if (_on_card(a) and a.dtype == torch.float32 and b.dtype == torch.float32 and a.ndim >= 2 and b.ndim >= 2
            and (a.requires_grad or b.requires_grad) and torch.is_grad_enabled()
            and split_k.backward_reduces(a.shape[-2], a.shape[-1], b.shape[-1])):
        return split_k.matmul(a, b)
    return a @ b


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def bulk_precision() -> str:
    """The bulk class's precision in force, "highest" or "high" (the JAX
    package passes its ``jax.lax.Precision`` to its bulk einsums; the port's
    bulk contractions are products through ``bdot``)."""
    return "high" if _BULK_3PASS else "highest"


def add_jitter(K: torch.Tensor, jitter: float, *, relative_f32: float = 2.0e-4) -> torch.Tensor:
    """K + jitter·I, plus ``relative_f32 · mean(diag K)`` in float32 only.

    The absolute jitters are tuned for float64; an f32 gram with diag ≈ 20
    and near-duplicate rows carries rounding eigen-perturbations of order
    M·eps·σ², which the relative term (about 1600 f32 eps) absorbs. Float64
    grams get the absolute jitter alone, so the f64 parity path is the
    reference's."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    if K.dtype == torch.float32 and relative_f32:
        mean_diag = torch.diagonal(K, dim1=-2, dim2=-1).mean(-1)
        return K + (jitter + relative_f32 * mean_diag)[..., None, None] * eye
    return K + jitter * eye


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky factor of (..., n, n) ``K``
    (``zigp_tpu/ops/linalg.py:51-53``, XLA's library Cholesky there, the
    library's here). A matrix that is not positive definite gives a factor
    of NaN, as the JAX package's does: a ``torch.where`` on the device-side
    ``info``, with no host sync and no raise."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def tri_solve(L: torch.Tensor, b: torch.Tensor, *, lower: bool = True) -> torch.Tensor:
    """x with L x = b for triangular L (``zigp_tpu/ops/linalg.py:252``)."""
    return torch.linalg.solve_triangular(L, b, upper=not lower)


def chol_inv_route(n: int, dtype: torch.dtype, device_type: str) -> str:
    """Which implementation ``chol_inv`` takes (``zigp_tpu/ops/linalg.py:
    138-151``): float32 on the card goes to the CUDA kernel for n ≤ ``MAX_N``
    (238: one CTA holds the whole matrix, where the JAX package's kernel
    stops at 128) and to the thread-block-cluster kernel for n ≤ 512 (the JAX
    package's blocked routine); anything else, the CPU included, to the
    library Cholesky and triangular solve, where the JAX package leaves it
    to XLA."""
    if dtype == torch.float32 and device_type == "cuda":
        if n <= MAX_N:
            return "kernel"
        if n <= BLOCKED_MAX_N:
            return "cluster"
    return "library"


def chol_inv_forward(K: torch.Tensor):
    """(L, L⁻¹) of (..., n, n) ``K`` by the route of ``chol_inv_route``,
    forward only (no autograd). A matrix that is not positive definite
    gives NaN, as the JAX package's Cholesky does, and never raises or waits
    on the device: the kernels give NaN from the failing pivot on, the
    library route the whole matrix. The kernels are launched through their
    registered ops (``chol_inv_op``, ``chol_inv_blocked_op``), which is what
    ``torch.export`` records."""
    route = chol_inv_route(K.shape[-1], K.dtype, K.device.type)
    if route == "kernel":
        return chol_inv_op(K.contiguous())
    if route == "cluster":
        return chol_inv_blocked_op(K.contiguous())
    L = cholesky(K)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device).expand_as(K)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def _phi_half_diag(X: torch.Tensor) -> torch.Tensor:
    """The lower triangle of X with its diagonal halved."""
    return torch.tril(X) - 0.5 * torch.diag_embed(torch.diagonal(X, dim1=-2, dim2=-1))


def chol_vjp(L: torch.Tensor, Linv: torch.Tensor, dL: torch.Tensor, dot=torch.matmul) -> torch.Tensor:
    """The pullback of L = chol(K) (K read symmetrically, as the JAX
    package's Cholesky reads it) at cotangent ``dL``, by matmuls only with
    L⁻¹ in hand: K̄ = sym(L⁻ᵀ Φ(Lᵀ dL) L⁻¹), Φ the lower triangle with its
    diagonal halved (Murray 2016). ``dot`` takes the products: ``hdot`` in
    ``chol_inv``'s backward, exact float32 in natgrad's pullback (XLA's
    Cholesky VJP in the JAX package)."""
    mT = lambda A: A.transpose(-1, -2)
    P = _phi_half_diag(dot(mT(L), dL))
    return 0.5 * dot(dot(mT(Linv), P + mT(P)), Linv)


def fold_member_dim(x: torch.Tensor, in_dim, size: int) -> torch.Tensor:
    """The physical tensor of a ``torch.func.vmap`` input with its vmapped
    dim moved to the front, an unbatched one (``in_dim`` None) expanded to
    ``size`` there: the layout a Function's ``vmap`` rule folds into its
    leading batch."""
    return x.unsqueeze(0).expand(size, *x.shape) if in_dim is None else x.movedim(in_dim, 0)


class _CholInv(torch.autograd.Function):
    """(L, L⁻¹) = chol_inv(K) with the matmul-only backward of
    ``zigp_tpu/ops/linalg.py:177-211`` (reverse-mode Cholesky with L⁻¹ in
    hand), on every route: the forward's kernel, cluster kernel or library
    call sees a detached K, and the backward needs no solve. Its products
    are ``hdot``'s, read when the backward runs.

    Under ``torch.func.vmap`` (the batched member stack,
    ``training.batched``) the ``vmap`` rule folds the member dim into the
    leading batch and factors every member's matrices in one call, so a
    stack of F members launches the kernel as often as one member does."""

    @staticmethod
    def forward(K):
        return chol_inv_forward(K.detach())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*output)

    @staticmethod
    def backward(ctx, dL, dLinv):
        L, Linv = ctx.saved_tensors
        mT = lambda A: A.transpose(-1, -2)
        dL_tot = torch.zeros_like(L) if dL is None else dL
        if dLinv is not None:
            # pullback through L⁻¹ (lower-triangular dof only): −tril(L⁻ᵀ dLinv L⁻ᵀ)
            dL_tot = dL_tot - torch.tril(hdot(hdot(mT(Linv), dLinv), mT(Linv)))
        return chol_vjp(L, Linv, dL_tot, hdot)

    @staticmethod
    def vmap(info, in_dims, K):
        K = fold_member_dim(K, in_dims[0], info.batch_size)
        L, Linv = _CholInv.apply(K.reshape(-1, *K.shape[-2:]))
        return (L.reshape(K.shape), Linv.reshape(K.shape)), (0, 0)


def chol_inv(K: torch.Tensor):
    """(L, L⁻¹) with L = chol(K), batched over leading dims, differentiable
    in K on every route (``chol_inv_route``)."""
    return _CholInv.apply(K)


def chol_inv_stacked(Ks: Sequence[torch.Tensor]):
    """One ``chol_inv`` call for several grams of possibly different sizes
    (``zigp_tpu/ops/linalg.py:217-249``): each (..., n_p, n_p) is padded to
    n_max with an identity tail (chol and inverse of blockdiag(K, I) are
    blockdiag(chol K, I), so the tail never touches the real block), the
    padded grams are stacked on a new leading dim, factored at once and
    sliced back. Returns ``[(L_p, Linv_p), ...]``; differentiable through
    ``chol_inv``. The JAX package measured it slower than one call per
    factor and keeps it as that record."""
    if len(Ks) == 1:
        return [chol_inv(Ks[0])]
    ns = [K.shape[-1] for K in Ks]
    nmax = max(ns)
    padded = []
    for K, n in zip(Ks, ns):
        if n < nmax:
            tail = torch.zeros(nmax, dtype=K.dtype, device=K.device)
            tail[n:] = 1.0
            K = torch.nn.functional.pad(K, (0, nmax - n, 0, nmax - n)) + torch.diag(tail)
        padded.append(K)
    L, Linv = chol_inv(torch.stack(padded))
    return [(L[p, ..., :n, :n], Linv[p, ..., :n, :n]) for p, n in enumerate(ns)]


def _apply_factor_ops(ops, x: torch.Tensor) -> torch.Tensor:
    """(⊗_p A_p) x without forming the product, where ``ops[p] = (op, M_p)``
    and ``op(X)`` computes A_p X on X (..., K, M_p, N / M_p): x (..., N, K)
    with N = Π M_p. Each factor is applied to x reshaped to (M_p, N / M_p)
    per column, then its index is rotated to the back; after all factors
    the row-major order is restored (the reshape-shuffle matvec of
    ``zigp_tpu``'s ``_apply_factor_ops``)."""
    *batch, N, K = x.shape
    b = x.transpose(-1, -2)  # (..., K, N): columns are independent
    for op, s in ops:
        X = b.reshape(*batch, K, s, N // s)
        b = op(X).transpose(-1, -2).reshape(*batch, K, N)
    return b.transpose(-1, -2)


def _apply_factor_mats(mats: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(⊗_p mats[p]) x: mats[p] (..., M_p, M_p), x (..., N, K)."""
    return _apply_factor_ops([(lambda X, A=A: A.unsqueeze(-3) @ X, A.shape[-1]) for A in mats], x)


def _columns(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of an (N, K) x, for x given as (N,) or (N, K)."""
    return fn(x[:, None])[:, 0] if x.ndim == 1 else fn(x)


def _apply_factor_hdots(mats: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(⊗_p mats[p]) x with ``hdot`` products: mats[p] (..., M_p, M_p)."""
    return _apply_factor_ops([(lambda X, A=A: hdot(A.unsqueeze(-3), X), A.shape[-1]) for A in mats], x)


def kron_linv_lower(Linvs: Sequence[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    """x = (⊗_p L_p)⁻¹ b given the triangular inverses L_p⁻¹: ``hdot``
    products only."""
    return _apply_factor_hdots(Linvs, b)


def kron_linv_solve(Linvs: Sequence[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    """x = (⊗_p K_p)⁻¹ b = (⊗ L_p⁻ᵀ)(⊗ L_p⁻¹) b given the triangular inverses."""
    half = kron_linv_lower(Linvs, b)
    return _apply_factor_hdots([Li.transpose(-1, -2) for Li in Linvs], half)


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve K x = b given L = chol(K); b (N,) or (N, K)."""
    return _columns(lambda B: torch.cholesky_solve(B, L, upper=False), b)


# The JAX package's Kronecker algebra (``zigp_tpu/ops/linalg.py:256-358``) on
# (N,) or (N, K) right-hand sides, factored: the product is never formed.


def kron_dense(*mats: torch.Tensor) -> torch.Tensor:
    """Dense Kronecker product. Tests and debugging only: O(Π M_p²) memory
    (the reference's ``tf_kron``, onofftf/main.py:334-348)."""
    out = mats[0]
    for A in mats[1:]:
        out = torch.kron(out, A)
    return out


def kron_mv(mats: Sequence[torch.Tensor], x: torch.Tensor, *, precision=None) -> torch.Tensor:
    """y = (⊗_p mats[p]) x without materializing the Kronecker product.

    ``precision`` is accepted for the JAX signature: the JAX package's
    callers pass HIGHEST or leave the TPU's default, and the port's float32
    products are exact float32 in both cases (``core.config`` turns TF32 off
    at import; the ROADMAP's rule against reduced-precision products)."""
    return _columns(lambda X: _apply_factor_mats(mats, X), x)


def kron_solve_lower(Ls: Sequence[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    """x = (⊗_p L_p)⁻¹ b for lower-triangular factors L_p: (⊗ L_p)⁻¹ =
    ⊗ L_p⁻¹, so the factored matvec with a triangular solve a factor
    (replaces the reference's dense Cholesky-of-Kronecker,
    onofftf/main.py:355-358)."""
    ops = [(lambda X, L=L: torch.linalg.solve_triangular(L.unsqueeze(-3), X, upper=False), L.shape[-1])
           for L in Ls]
    return _columns(lambda B: _apply_factor_ops(ops, B), b)


def kron_chol_solve(Ls: Sequence[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    """x = (⊗_p K_p)⁻¹ b given the factors' Cholesky factors L_p = chol(K_p)."""
    ops = [(lambda X, L=L: torch.cholesky_solve(X, L.unsqueeze(-3), upper=False), L.shape[-1]) for L in Ls]
    return _columns(lambda B: _apply_factor_ops(ops, B), b)


# The KL's pieces (``zigp_tpu/ops/linalg.py:261-397``), batched over leading
# dims. The JAX package reads diagonals by a masked reduce to avoid a TPU
# relayout under vmap-of-jvp; ``torch.diagonal`` is a view and has no such
# cost, so the port reads them directly.


def masked_diag(A: torch.Tensor) -> torch.Tensor:
    """diag(A) over the last two dims."""
    return torch.diagonal(A, dim1=-2, dim2=-1)


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """log det K = 2 Σ log diag L."""
    return 2.0 * torch.sum(torch.log(masked_diag(L)), dim=-1)


def diag_of_inv_from_chol(L: torch.Tensor) -> torch.Tensor:
    """diag(K⁻¹) from L = chol(K), by one triangular solve against I."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    return diag_of_inv_from_linv(torch.linalg.solve_triangular(L, eye, upper=False))


def diag_of_inv_from_linv(Linv: torch.Tensor) -> torch.Tensor:
    """diag(K⁻¹) from L⁻¹: (K⁻¹)_ii = Σ_k (L⁻¹)_ki²."""
    return torch.sum(torch.square(Linv), dim=-2)


def kron_diag(diags: Sequence[torch.Tensor]) -> torch.Tensor:
    """diag(⊗_p D_p) for diagonal factors given as (..., M_p) vectors."""
    out = diags[0]
    for d in diags[1:]:
        out = (out[..., :, None] * d[..., None, :]).flatten(-2)
    return out


def kron_logdet_from_chols(Ls: Sequence[torch.Tensor]) -> torch.Tensor:
    """log det(⊗_p K_p) = Σ_p (M / M_p) · log det K_p, from the factors' L_p."""
    M = 1
    for L in Ls:
        M *= L.shape[-1]
    return sum((M // L.shape[-1]) * logdet_from_chol(L) for L in Ls)
