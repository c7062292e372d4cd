"""KL(q(u) ‖ p(u)) between a Gaussian posterior and a Gaussian prior, dense
or Kronecker-structured.

Counterpart of ``zigp_tpu/ops/gauss_kl.py:31-179`` with the same formulas.
Every argument carries one leading batch dimension G (the on/off model's
stacked f/g pair) and every function returns the G KLs, shape (G,).

The Kronecker variants never form the (Π M_p)² prior: the Mahalanobis term
is a factored product against the L_p⁻¹ of ``chol_inv``, the trace term uses
diag((⊗K_p)⁻¹) = ⊗ diag(K_p⁻¹), and the prior log-determinant is a sum of
factor log-determinants. Jitter is the caller's, added once when building K.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import linalg


def gauss_kl(q_mu: torch.Tensor, q_sqrt: torch.Tensor, K: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL(N(q_mu, S) ‖ N(0, K)), K=None meaning a white (identity) prior.

    q_mu: (G, M, L). q_sqrt: (G, M, L) diagonal standard deviations, or
    (G, M, M, L) lower-triangular factors (upper triangle ignored). K: (G, M, M)."""
    white = K is None
    if white:
        alpha = q_mu
    else:
        Lp = linalg.cholesky(K)
        alpha = torch.linalg.solve_triangular(Lp, q_mu, upper=False)

    if q_sqrt.ndim == 3:
        diag = True
        num_latent = q_sqrt.shape[-1]
        Lq_diag = q_sqrt
    elif q_sqrt.ndim == 4:
        diag = False
        num_latent = q_sqrt.shape[-1]
        Lq = torch.tril(q_sqrt.permute(0, 3, 1, 2))  # (G, L, M, M)
        Lq_diag = linalg.masked_diag(Lq)
    else:
        raise ValueError(f"Bad q_sqrt ndim: {q_sqrt.ndim}")

    mahalanobis = torch.sum(torch.square(alpha), dim=(-2, -1))
    # the number of (inducing, latent) pairs, as the reference counts it
    NM = q_sqrt.shape[1] * num_latent
    logdet_qcov = torch.sum(torch.log(torch.square(Lq_diag)), dim=(-2, -1))

    if white:
        trace = torch.sum(torch.square(q_sqrt if diag else Lq), dim=tuple(range(1, q_sqrt.ndim)))
    elif diag:
        Kinv_diag = linalg.diag_of_inv_from_chol(Lp)  # (G, M)
        trace = torch.sum(Kinv_diag[..., None] * torch.square(q_sqrt), dim=(-2, -1))
    else:
        LpiLq = torch.linalg.solve_triangular(Lp[:, None], Lq, upper=False)
        trace = torch.sum(torch.square(LpiLq), dim=(-3, -2, -1))

    twoKL = mahalanobis - NM - logdet_qcov + trace
    if not white:
        twoKL = twoKL + num_latent * linalg.logdet_from_chol(Lp)
    return 0.5 * twoKL


def _factor_state(K_factors, factor_state):
    """(Ls, Linvs): the caller's precomputed chol_inv state, or computed here."""
    if factor_state is not None:
        return factor_state
    pairs = [linalg.chol_inv(Kp) for Kp in K_factors]
    return tuple(L for L, _ in pairs), tuple(Li for _, Li in pairs)


def gauss_kl_kron(
    q_mu: torch.Tensor,
    q_sqrt_diag: torch.Tensor,
    K_factors: Optional[Sequence[torch.Tensor]] = None,
    *,
    factor_state=None,
) -> torch.Tensor:
    """KL(N(q_mu, diag(q_sqrt²)) ‖ N(0, ⊗_p K_p)), fully factored.

    q_mu, q_sqrt_diag: (G, M, 1) with M = Π M_p; K_factors[p]: (G, M_p, M_p),
    jitter included; ``factor_state=(Ls, Linvs)`` shares one chol_inv per
    factor with the conditional."""
    Ls, Linvs = _factor_state(K_factors, factor_state)
    alpha = linalg.kron_linv_lower(Linvs, q_mu)
    mahalanobis = torch.sum(torch.square(alpha), dim=(-2, -1))
    constant = -float(q_sqrt_diag[0].numel())
    logdet_qcov = torch.sum(torch.log(torch.square(q_sqrt_diag)), dim=(-2, -1))
    Kinv_diag = linalg.kron_diag([linalg.diag_of_inv_from_linv(Li) for Li in Linvs])
    trace = torch.sum(Kinv_diag[..., None] * torch.square(q_sqrt_diag), dim=(-2, -1))
    prior_logdet = linalg.kron_logdet_from_chols(Ls)
    return 0.5 * (mahalanobis + constant - logdet_qcov + trace + prior_logdet)


def gauss_kl_kron_full(
    q_mu: torch.Tensor,
    C_factors: Sequence[torch.Tensor],
    K_factors: Optional[Sequence[torch.Tensor]] = None,
    *,
    factor_state=None,
) -> torch.Tensor:
    """KL(N(q_mu, ⊗_p C_p C_pᵀ) ‖ N(0, ⊗_p K_p)), fully factored:

        tr(K⁻¹S) = Π_p ‖L_p⁻¹ C_p‖²_F,   logdet S = Σ_p (M/M_p) · 2 Σ log|diag C_p|

    C_factors[p]: (G, M_p, M_p), only the lower triangle read. No K_factors
    and no factor_state means a white prior: tr(S) = Π_p ‖C_p‖²_F and the
    Mahalanobis term is ‖q_mu‖²."""
    M = 1
    for C in C_factors:
        M *= C.shape[-1]

    if K_factors is None and factor_state is None:
        mahalanobis = torch.sum(torch.square(q_mu), dim=(-2, -1))
        trace = 1.0
        for C in C_factors:
            trace = trace * torch.sum(torch.square(torch.tril(C)), dim=(-2, -1))
        prior_logdet = 0.0
    else:
        Ls, Linvs = _factor_state(K_factors, factor_state)
        alpha = linalg.kron_linv_lower(Linvs, q_mu)
        mahalanobis = torch.sum(torch.square(alpha), dim=(-2, -1))
        trace = 1.0
        for Li, C in zip(Linvs, C_factors):
            trace = trace * torch.sum(torch.square(linalg.hdot(Li, torch.tril(C))), dim=(-2, -1))
        prior_logdet = linalg.kron_logdet_from_chols(Ls)

    # A diagonal entry of an unconstrained C_p crossing zero would make
    # log|diag| = −inf; clamped at float32's tiny, the KL stays finite while
    # the trace and Mahalanobis terms still see the true factor.
    tiny = float(np.finfo(np.float32).tiny)
    logdet_qcov = 0.0
    for C in C_factors:
        logdet_qcov = logdet_qcov + (M // C.shape[-1]) * 2.0 * torch.sum(
            torch.log(torch.clamp(torch.abs(linalg.masked_diag(C)), min=tiny)), dim=-1
        )
    return 0.5 * (mahalanobis - M - logdet_qcov + trace + prior_logdet)
