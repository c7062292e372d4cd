"""Bijectors between unconstrained raws and constrained parameter values.

Counterpart of ``zigp_tpu/core/bijectors.py`` with the same formulas, so a
parameter initialised at the same constrained value takes the same
unconstrained value in both packages. ``forward`` runs on tensors;
``inverse`` runs once at init on numpy float64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


class Bijector:
    name = "bijector"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def inverse(self, y) -> np.ndarray:
        raise NotImplementedError

    def inverse_tensor(self, y: torch.Tensor) -> torch.Tensor:
        """``inverse`` on a tensor, in its dtype and on its device: for an
        update that writes a constrained value back inside a step."""
        raise NotImplementedError(f"{self.name}: no tensor inverse")

    def __repr__(self):
        return self.name


class Identity(Bijector):
    name = "identity"

    def forward(self, x):
        return x

    def inverse(self, y):
        return np.asarray(y, dtype=np.float64)


class Softplus(Bijector):
    """y = log(1 + exp(x)) + lower (gpflow-0.4 ``transforms.positive``)."""

    name = "softplus"

    def __init__(self, lower: float = 1e-6):
        self.lower = lower

    def forward(self, x):
        return torch.logaddexp(x, torch.zeros_like(x)) + self.lower

    def inverse(self, y):
        ys = np.asarray(y, dtype=np.float64) - self.lower
        return ys + np.log(-np.expm1(-ys))

    def inverse_tensor(self, y):
        ys = y - self.lower
        return ys + torch.log(-torch.expm1(-ys))


class Exp(Bijector):
    name = "exp"

    def __init__(self, lower: float = 0.0):
        self.lower = lower

    def forward(self, x):
        return torch.exp(x) + self.lower

    def inverse(self, y):
        return np.log(np.asarray(y, dtype=np.float64) - self.lower)


class Sigmoid(Bijector):
    """Interval constraint y = lo + (hi - lo)·σ(x), scalar or per-entry bounds."""

    name = "sigmoid"

    def __init__(self, lo, hi):
        lo_a = np.ravel(np.asarray(lo, dtype=np.float64))
        hi_a = np.ravel(np.asarray(hi, dtype=np.float64))
        if not (hi_a > lo_a).all():
            raise ValueError(f"Sigmoid bounds need hi > lo, got {lo} .. {hi}")
        self.lo = float(lo_a[0]) if lo_a.size == 1 else tuple(map(float, lo_a))
        self.hi = float(hi_a[0]) if hi_a.size == 1 else tuple(map(float, hi_a))

    def forward(self, x):
        lo, hi = _bounds(self.lo, self.hi, x.dtype, x.device)
        # stable logistic via tanh
        return lo + (hi - lo) * 0.5 * (torch.tanh(0.5 * x) + 1.0)

    def inverse(self, y):
        y = np.asarray(y, dtype=np.float64)
        p = (y - np.asarray(self.lo)) / (np.asarray(self.hi) - np.asarray(self.lo))
        return np.log(p) - np.log1p(-p)


@functools.lru_cache(maxsize=None)
def _bounds(lo, hi, dtype: torch.dtype, device: torch.device):
    """The bounds as tensors on ``device``, copied there once: a step then
    makes no host-to-device copy (a CUDA graph capture refuses one). Built
    outside any inference mode, so autograd may save them."""
    with torch.inference_mode(False):
        return (torch.as_tensor(lo, dtype=dtype, device=device), torch.as_tensor(hi, dtype=dtype, device=device))


class FillLowerTriangular(Bijector):
    """Unconstrained (M, M) or (M, M, K) matrix -> its lower triangle."""

    name = "fill_tril"

    def forward(self, x):
        if x.ndim == 2:
            return torch.tril(x)
        return torch.tril(x.permute(2, 0, 1)).permute(1, 2, 0)

    def inverse(self, y):
        return np.asarray(y, dtype=np.float64)


identity = Identity()
positive = Softplus()
