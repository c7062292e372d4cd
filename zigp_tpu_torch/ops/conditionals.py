"""Sparse-GP predictive conditionals q(f*) = ∫ p(f*|u) q(u) du: the dense
single-GP ``conditional`` and the Kronecker-structured ``kron_conditional``.

``conditional`` is the counterpart of ``zigp_tpu/ops/conditionals.py:30-93``
(the dense models' path: one M × M gram, the library Cholesky and triangular
solves, as XLA's there).

The Kronecker path is the counterpart of
``zigp_tpu/ops/conditionals.py:96-267`` (``kron_conditional``
with marginal variances or, ``full_cov=True``, the joint (B, B) covariance,
and ``_factored_contract`` and its pairwise ``_factored_contract_pair``). The
inducing grid is Z = ⊗_p Z_p; nothing of size (Π M_p)² is formed:

    V_p = L_p⁻¹ Kmn_p                         (matmul against chol_inv's L⁻¹)
    c1[b] = Π_p ‖V_p[:, b]‖²                  (= diag Kmnᵀ K⁻¹ Kmn, each factor ≥ 0)
    c2[b] = diag(Pᵀ S P)[b]                   (P = V whitened, K⁻¹Kmn otherwise)
    var   = Knn − c1 + c2,   mean = Kmnᵀ K⁻¹ q_mu  (or Vᵀ v whitened)

Every per-GP input carries one leading batch dimension G: the on/off model
stacks its f and g GPs there (G = 2), so each ``chol_inv`` call factors both
GPs' grams at once. ``Xnew`` (B, D) is shared by the batch.

The solve-replacing products are ``linalg.bdot``'s (the batch-scaled class
of the precision policy, ``linalg.set_solve_precision``), as the JAX
package's ``bdot`` and ``bulk_precision()`` einsums. The products it
leaves at the TPU's default precision (``Aᵀ A`` of the dense covariance,
the gram expansions) stay exact float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import linalg


class KronConditionalState(NamedTuple):
    """Precomputable per-step state shared by mean and variance
    (``zigp_tpu/ops/conditionals.py:89-93``)."""

    Ls: Tuple[torch.Tensor, ...]  # per-factor chol(Kmm_p)
    alpha: torch.Tensor  # (⊗K_p⁻¹) q_mu, shape (M, 1)


def conditional(
    Xnew: torch.Tensor,
    Z: torch.Tensor,
    kernel,
    f: torch.Tensor,
    *,
    full_cov: bool = False,
    q_sqrt: Optional[torch.Tensor] = None,
    whiten: bool = False,
    jitter: float = 1e-6,
):
    """Single-GP sparse conditional. Xnew (N, D), Z (M, D), ``kernel`` any
    kernel module of ``ops.kernels``, f (M, L) the inducing (whitened)
    means, q_sqrt None, (M, L) diagonal or (M, M, L) lower-triangular.
    Returns the mean (N, L) and the variance (N, L), or with ``full_cov``
    the covariance (N, N, L)."""
    Kmn = kernel.K(Z, Xnew)  # (M, N)
    Kmm = linalg.add_jitter(kernel.K(Z), jitter)
    Lm = linalg.cholesky(Kmm)
    A = linalg.tri_solve(Lm, Kmn, lower=True)  # (M, N)
    if full_cov:
        fvar = kernel.K(Xnew) - A.transpose(-1, -2) @ A  # (N, N)
    else:
        fvar = kernel.Kdiag(Xnew) - torch.sum(torch.square(A), dim=0)  # (N,)
    if not whiten:
        A = linalg.tri_solve(Lm.transpose(-1, -2), A, lower=False)
    fmean = linalg.bdot(A.transpose(-1, -2), f)  # (N, L)
    fvar = fvar[None].expand(f.shape[1], *fvar.shape)  # (L, N, N) or (L, N)
    if q_sqrt is not None:
        if q_sqrt.ndim == 2:
            LTA = A[None] * q_sqrt.transpose(0, 1)[:, :, None]  # (L, M, N)
        elif q_sqrt.ndim == 3:
            Lq = torch.tril(q_sqrt.permute(2, 0, 1))  # (L, M, M)
            LTA = linalg.bdot(Lq.transpose(-1, -2), A)  # Lqᵀ A per latent
        else:
            raise ValueError(f"Bad q_sqrt ndim: {q_sqrt.ndim}")
        if full_cov:
            fvar = fvar + linalg.bdot(LTA.transpose(-1, -2), LTA)
        else:
            fvar = fvar + torch.sum(torch.square(LTA), dim=1)
    fvar = fvar.permute(1, 2, 0) if full_cov else fvar.transpose(0, 1)
    return fmean, fvar


def kron_conditional(
    Xnew: torch.Tensor,
    kernels: Sequence,
    Zs: Sequence[torch.Tensor],
    q_mu: torch.Tensor,
    q_sqrt_diag: torch.Tensor,
    input_masks: Sequence,
    *,
    jitter: float = 1e-6,
    clip_variance: bool = True,
    whiten: bool = False,
    q_sqrt_factors: Optional[Sequence[torch.Tensor]] = None,
    factor_state=None,
    use_kernel: Sequence[bool] = (),
    full_cov: bool = False,
):
    """Marginal predictive mean and variance, each (G, B, 1), or with
    ``full_cov`` the mean and the joint covariance (G, B, B, 1).

    kernels[p]: a kernel's values (``ops.kernels``), each tensor with the
    leading G, e.g. ``RBFValues`` with lengthscales (G, d_p), variance (G,);
    Zs[p]: (G, M_p, d_p); q_mu, q_sqrt_diag: (G, M, 1) with M = Π M_p in
    row-major factor order; q_sqrt_factors[p]: (G, M_p, M_p) lower factors of
    S = ⊗ C_p C_pᵀ, or None for the diagonal family; input_masks[p]: the
    columns of Xnew for factor p (index tensor or sequence of ints);
    factor_state: precomputed (Ls, Linvs) of the jittered factor grams;
    use_kernel[p]: factor p's ``kernel_flags()`` (an RBF leaf's grams by
    ``ops.cuda.rbf_gram`` where its flag is on; all off when empty).
    ``whiten`` reads (q_mu, q_sqrt) as the whitened v with u = (⊗ L_p) v.

    ``full_cov``: every term is a Hadamard product of per-factor (B, B)
    grams (Kmnᵀ(⊗K⁻¹)Kmn = ⊙_p V_pᵀV_p, PᵀSP = ⊙_p (C_pᵀP_p)ᵀ(C_pᵀP_p) for
    the Kronecker family) or, for the diagonal family, the pairwise
    contraction ``_factored_contract_pair``; only (B, B) is formed, and the
    covariance is not clipped."""
    sizes = [Z.shape[-2] for Z in Zs]
    flags = list(use_kernel) or [False] * len(Zs)
    if factor_state is None:
        pairs = [
            linalg.chol_inv(linalg.add_jitter(k.K(Z, use_kernel=f), jitter))
            for k, Z, f in zip(kernels, Zs, flags)
        ]
        Linvs = [Li for _, Li in pairs]
    else:
        Linvs = list(factor_state[1])

    Knn = None
    Kmn_factors = []
    V_factors = []
    for k, Z, Li, mask, f in zip(kernels, Zs, Linvs, input_masks, flags):
        xp = Xnew.index_select(-1, torch.as_tensor(mask, device=Xnew.device))
        kd = k.K(xp, use_kernel=f) if full_cov else k.Kdiag(xp)  # (G, B, B) or (G, B)
        Knn = kd if Knn is None else Knn * kd
        Kmn_p = k.K(Z, xp, use_kernel=f)  # (G, M_p, B)
        Kmn_factors.append(Kmn_p)
        V_factors.append(linalg.bdot(Li, Kmn_p))

    if whiten:
        mu = _factored_contract(q_mu[..., 0], sizes, V_factors)
        proj = V_factors
    else:
        alpha = linalg.kron_linv_solve(Linvs, q_mu)  # (⊗K_p⁻¹) q_mu, (G, M, 1)
        proj = [linalg.bdot(Li.transpose(-1, -2), V_p) for Li, V_p in zip(Linvs, V_factors)]
        mu = _factored_contract(alpha[..., 0], sizes, Kmn_factors)

    if full_cov:
        if q_sqrt_factors is not None:
            c2 = None
            for C, P_p in zip(q_sqrt_factors, proj):
                CtP = linalg.bdot(torch.tril(C).transpose(-1, -2), P_p)  # (G, M_p, B)
                t = linalg.bdot(CtP.transpose(-1, -2), CtP)
                c2 = t if c2 is None else c2 * t
        else:
            c2 = _factored_contract_pair(torch.square(q_sqrt_diag[..., 0]), sizes, proj)
        c1 = None
        for V_p in V_factors:
            t = linalg.bdot(V_p.transpose(-1, -2), V_p)
            c1 = t if c1 is None else c1 * t
        return mu[..., None], (Knn - c1 + c2)[..., None]

    if q_sqrt_factors is not None:
        # S = ⊗ C_p C_pᵀ: diag(PᵀSP)[b] = Π_p ‖C_pᵀ P_p[:, b]‖²
        c2 = None
        for C, P_p in zip(q_sqrt_factors, proj):
            t = torch.sum(torch.square(linalg.bdot(torch.tril(C).transpose(-1, -2), P_p)), dim=-2)
            c2 = t if c2 is None else c2 * t
    else:
        # diagonal S: c2[b] = Σ_m S[m] (Π_p P_p[i_p, b])²
        S = torch.square(q_sqrt_diag[..., 0])
        c2 = _factored_contract(S, sizes, [torch.square(P_p) for P_p in proj])

    c1 = None
    for V_p in V_factors:
        t = torch.sum(torch.square(V_p), dim=-2)
        c1 = t if c1 is None else c1 * t

    var = Knn - c1 + c2
    if clip_variance:
        var = torch.clamp(var, min=0.0)
    return mu[..., None], var[..., None]


def _factored_contract(w: torch.Tensor, sizes: Sequence[int], factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """out[g, b] = Σ_{i₁..i_P} w[g, (i₁..i_P)] Π_p factors[p][g, i_p, b], one
    factor at a time, each a ``bdot``: w (G, M), factors[p] (G, M_p, B) ->
    (G, B). The first factor is one (B, M_1)·(M_1, M / M_1) product; each
    later one a product batched over b, (1, M_p)·(M_p, rest)."""
    G = w.shape[0]
    B = factors[0].shape[-1]
    rest = w.numel() // (G * sizes[0])
    t = linalg.bdot(factors[0].transpose(-1, -2), w.reshape(G, sizes[0], rest))  # (G, B, rest)
    for p in range(1, len(sizes)):
        rest //= sizes[p]
        F = factors[p].transpose(-1, -2).unsqueeze(-2)  # (G, B, 1, M_p)
        t = linalg.bdot(F, t.reshape(G, B, sizes[p], rest))  # (G, B, 1, rest)
    return t.reshape(G, B)


def _factored_contract_pair(w: torch.Tensor, sizes: Sequence[int], factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """out[g, b, c] = Σ_{i₁..i_P} w[g, (i₁..i_P)] Π_p factors[p][g, i_p, b]·factors[p][g, i_p, c],
    the pairwise analog of ``_factored_contract``, one factor at a time:
    w (G, M), factors[p] (G, M_p, B) -> (G, B, B); (G, B, B, M / M_1) at the
    peak. Each three-operand step is the elementwise outer product of the
    factor with itself, then one ``bdot`` over i_p."""
    G = w.shape[0]
    B = factors[0].shape[-1]
    rest = w.numel() // (G * sizes[0])
    outer = lambda F: F[..., :, None] * F[..., None, :]  # (G, M_p, B, B)
    FF = outer(factors[0]).reshape(G, sizes[0], B * B)
    t = linalg.bdot(FF.transpose(-1, -2), w.reshape(G, sizes[0], rest))  # (G, B·B, rest)
    for p in range(1, len(sizes)):
        rest //= sizes[p]
        FF = outer(factors[p]).reshape(G, sizes[p], B * B).transpose(-1, -2).unsqueeze(-2)  # (G, B·B, 1, M_p)
        t = linalg.bdot(FF, t.reshape(G, B * B, sizes[p], rest))  # (G, B·B, 1, rest)
    return t.reshape(G, B, B)
