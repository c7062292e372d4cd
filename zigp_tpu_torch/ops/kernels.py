"""The squared-exponential (RBF) kernel.

Counterpart of ``zigp_tpu/ops/kernels.py:34-96``. The gram uses the exact
pairwise-difference form below 16 input dimensions: the expansion form
computes O(1) distances as differences of O((x/ℓ)²) terms, and with the pptr
time column (t ≈ 5, ℓ ≈ 0.005, so (x/ℓ)² ≈ 10⁶) float32 cancellation makes
the factor gram indefinite.

``RBFValues`` holds constrained hyperparameters with any leading batch
dimensions, which is how the on/off model evaluates the f and g kernels of a
pair in one pass (a stacked leading dim of 2 in place of the JAX ``vmap``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..core.parameters import positive_param

_EXPANSION_MIN_DIM = 16


def square_dist(X, X2, lengthscales):
    """Scaled squared distances: X (..., N, D), X2 (..., N2, D) or None,
    lengthscales (..., D) -> (..., N, N2)."""
    ell = lengthscales[..., None, :]
    X = X / ell
    X2 = X if X2 is None else X2 / ell
    if X.shape[-1] < _EXPANSION_MIN_DIM:
        diff = X[..., :, None, :] - X2[..., None, :, :]
        return torch.sum(torch.square(diff), dim=-1)
    Xs = torch.sum(torch.square(X), dim=-1)
    X2s = torch.sum(torch.square(X2), dim=-1)
    return -2.0 * (X @ X2.transpose(-1, -2)) + Xs[..., :, None] + X2s[..., None, :]


class RBFValues(NamedTuple):
    """Constrained RBF hyperparameters: lengthscales (..., D), variance (...)."""

    lengthscales: torch.Tensor
    variance: torch.Tensor

    def K(self, X, X2: Optional[torch.Tensor] = None):
        d2 = square_dist(X, X2, self.lengthscales)
        return self.variance[..., None, None] * torch.exp(-0.5 * d2)

    def Kdiag(self, X):
        v = self.variance[..., None]
        return v.expand(*v.shape[:-1], X.shape[-2])


class SquaredExponential(nn.Module):
    """ARD squared-exponential kernel σ² exp(-½ Σ_d (x_d - x'_d)²/ℓ_d²)."""

    def __init__(self, lengthscales, variance):
        super().__init__()
        self.lengthscales = lengthscales
        self.variance = variance

    @classmethod
    def create(cls, lengthscales, variance, lr=None) -> "SquaredExponential":
        ell = np.atleast_1d(np.asarray(lengthscales, dtype=np.float64))
        return cls(positive_param(ell, lr=lr), positive_param(variance, lr=lr))

    def values(self) -> RBFValues:
        return RBFValues(self.lengthscales.value, self.variance.value)

    def K(self, X, X2=None):
        return self.values().K(X, X2)

    def Kdiag(self, X):
        return self.values().Kdiag(X)


RBF = SquaredExponential
