"""The Kronecker-structured sparse predictive conditional q(f*) = ∫ p(f*|u) q(u) du.

Counterpart of ``zigp_tpu/ops/conditionals.py:96-249`` (``kron_conditional``
with marginal variances, and ``_factored_contract``). The inducing grid is
Z = ⊗_p Z_p; nothing of size (Π M_p)² is formed:

    V_p = L_p⁻¹ Kmn_p                         (matmul against chol_inv's L⁻¹)
    c1[b] = Π_p ‖V_p[:, b]‖²                  (= diag Kmnᵀ K⁻¹ Kmn, each factor ≥ 0)
    c2[b] = diag(Pᵀ S P)[b]                   (P = V whitened, K⁻¹Kmn otherwise)
    var   = Knn − c1 + c2,   mean = Kmnᵀ K⁻¹ q_mu  (or Vᵀ v whitened)

Every per-GP input carries one leading batch dimension G: the on/off model
stacks its f and g GPs there (G = 2), so each ``chol_inv`` call factors both
GPs' grams at once. ``Xnew`` (B, D) is shared by the batch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import linalg


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
):
    """Marginal predictive mean and variance, each (G, B, 1).

    kernels[p]: an ``RBFValues`` with lengthscales (G, d_p), variance (G,);
    Zs[p]: (G, M_p, d_p); q_mu, q_sqrt_diag: (G, M, 1) with M = Π M_p in
    row-major factor order; q_sqrt_factors[p]: (G, M_p, M_p) lower factors of
    S = ⊗ C_p C_pᵀ, or None for the diagonal family; input_masks[p]: the
    columns of Xnew for factor p (index tensor or sequence of ints);
    factor_state: precomputed (Ls, Linvs) of the jittered factor grams.
    ``whiten`` reads (q_mu, q_sqrt) as the whitened v with u = (⊗ L_p) v."""
    sizes = [Z.shape[-2] for Z in Zs]
    if factor_state is None:
        pairs = [linalg.chol_inv(linalg.add_jitter(k.K(Z), jitter)) for k, Z in zip(kernels, Zs)]
        Linvs = [Li for _, Li in pairs]
    else:
        Linvs = list(factor_state[1])

    Knn = None
    Kmn_factors = []
    V_factors = []
    for k, Z, Li, mask in zip(kernels, Zs, Linvs, input_masks):
        xp = Xnew.index_select(-1, torch.as_tensor(mask, device=Xnew.device))
        kd = k.Kdiag(xp)  # (G, B)
        Knn = kd if Knn is None else Knn * kd
        Kmn_p = k.K(Z, xp)  # (G, M_p, B)
        Kmn_factors.append(Kmn_p)
        V_factors.append(Li @ Kmn_p)

    if whiten:
        mu = _factored_contract(q_mu[..., 0], sizes, V_factors)
        proj = V_factors
    else:
        alpha = linalg.kron_linv_solve(Linvs, q_mu)  # (⊗K_p⁻¹) q_mu, (G, M, 1)
        proj = [Li.transpose(-1, -2) @ V_p for Li, V_p in zip(Linvs, V_factors)]
        mu = _factored_contract(alpha[..., 0], sizes, Kmn_factors)

    if q_sqrt_factors is not None:
        # S = ⊗ C_p C_pᵀ: diag(PᵀSP)[b] = Π_p ‖C_pᵀ P_p[:, b]‖²
        c2 = None
        for C, P_p in zip(q_sqrt_factors, proj):
            t = torch.sum(torch.square(torch.tril(C).transpose(-1, -2) @ P_p), dim=-2)
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
    factor at a time: w (G, M), factors[p] (G, M_p, B) -> (G, B)."""
    G = w.shape[0]
    B = factors[0].shape[-1]
    rest = w.numel() // (G * sizes[0])
    t = factors[0].transpose(-1, -2) @ w.reshape(G, sizes[0], rest)  # (G, B, rest)
    for p in range(1, len(sizes)):
        rest //= sizes[p]
        t = torch.einsum("gbir,gib->gbr", t.reshape(G, B, sizes[p], rest), factors[p])
    return t.reshape(G, B)
