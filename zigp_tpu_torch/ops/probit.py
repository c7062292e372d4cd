"""Probit-gate expectations E[Φ(g)], E[Φ²(g)], Var[Φ(g)] under q(g) = N(μ, σ²).

Counterpart of ``zigp_tpu/ops/probit.py`` with the same guards:

    z = μ/√(1+σ²),  a = 1/√(1+2σ²)
    E[Φ(g)]  = Φ̃(z),  E[Φ²(g)] = Φ̃(z) − 2T(z, a),  Var = E[Φ²] − E[Φ]²

with the clipped CDF Φ̃(x) = Φ(x)(1−2e−3) + 1e−3, Owen's T either as the
reference's closed-form lower bound or by 32-node Gauss–Legendre quadrature
(the exact option), and negative parts clipped by (x+|x|)/2.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


def normcdf_clipped(x: torch.Tensor) -> torch.Tensor:
    """Φ(x)·(1−2e−3) + 1e−3: probabilities kept in [1e−3, 1−1e−3]."""
    phi = 0.5 * (1.0 + torch.special.erf(x / np.sqrt(2.0)))
    return phi * (1.0 - 2.0e-3) + 1.0e-3


def owen_t_bound(h: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Closed-form lower bound (arctan a / 2π)·exp(−h²(a²+1)/2) on Owen's T."""
    h = torch.abs(h)
    return torch.arctan(a) / (2.0 * np.pi) * torch.exp(-0.5 * torch.square(h) * (torch.square(a) + 1.0))


@functools.lru_cache(maxsize=None)
def _legendre(order: int, dtype: torch.dtype, device: torch.device):
    """Gauss–Legendre nodes and weights from numpy, copied to ``device``
    once: a step then makes no host-to-device copy (a CUDA graph capture
    refuses one). Built outside any inference mode, so autograd may save
    them."""
    nodes, weights = np.polynomial.legendre.leggauss(order)
    with torch.inference_mode(False):
        return (torch.as_tensor(nodes, dtype=dtype, device=device),
                torch.as_tensor(weights, dtype=dtype, device=device))


def owen_t_exact(h: torch.Tensor, a: torch.Tensor, order: int = 32) -> torch.Tensor:
    """Owen's T(h, a) = ∫₀ᵃ e^{−h²(1+t²)/2} / (2π(1+t²)) dt by Gauss–Legendre
    quadrature on [0, a]."""
    nodes, weights = _legendre(order, h.dtype, h.device)
    t = 0.5 * a[..., None] * (nodes + 1.0)
    w = 0.5 * a[..., None] * weights
    h2 = torch.square(h)[..., None]
    t2 = 1.0 + torch.square(t)
    integrand = torch.exp(-0.5 * h2 * t2) / (2.0 * np.pi * t2)
    return torch.sum(w * integrand, dim=-1)


class ProbitExpectations(NamedTuple):
    e_phi: torch.Tensor  # E[Φ(g)]
    e_phi_sq: torch.Tensor  # E[Φ²(g)]
    var_phi: torch.Tensor  # Var[Φ(g)]


def probit_expectations(gmean: torch.Tensor, gvar: torch.Tensor, *, exact: bool = False) -> ProbitExpectations:
    z = gmean / torch.sqrt(1.0 + gvar)
    a = 1.0 / torch.sqrt(1.0 + 2.0 * gvar)
    cdfz = normcdf_clipped(z)
    tz = owen_t_exact(torch.abs(z), a) if exact else owen_t_bound(z, a)
    e_phi_sq = cdfz - 2.0 * tz
    var_phi = e_phi_sq - torch.square(cdfz)
    e_phi_sq = 0.5 * (e_phi_sq + torch.abs(e_phi_sq))
    var_phi = 0.5 * (var_phi + torch.abs(var_phi))
    return ProbitExpectations(cdfz, e_phi_sq, var_phi)


def probit(x: torch.Tensor) -> torch.Tensor:
    """Clipped probit link used by the classifier (scripts/classifier.py:216)."""
    return normcdf_clipped(x)
