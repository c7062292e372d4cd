"""Gauss–Hermite quadrature for likelihood expectations.

Counterpart of ``zigp_tpu/ops/quadrature.py``. The nodes and weights are
built with numpy in float64 and copied to the device once for each (n,
dtype, device), as ``ops.probit`` builds its Gauss–Legendre nodes: a step
that takes an expectation then makes no host-to-device copy, which a CUDA
graph capture refuses.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _hermite(n: int, dtype: torch.dtype, device: torch.device):
    x, w = np.polynomial.hermite.hermgauss(n)
    # built outside any inference mode, so autograd may save them
    with torch.inference_mode(False):
        return (torch.as_tensor(x * np.sqrt(2.0), dtype=dtype, device=device),
                torch.as_tensor(w / np.sqrt(np.pi), dtype=dtype, device=device))


def gauss_hermite_points(n: int, dtype: torch.dtype = torch.float64, device="cpu"):
    """Hermite nodes and weights normalised for E_{N(0,1)}[f] = Σ w_i f(x_i)."""
    return _hermite(n, dtype, torch.device(device))


def expectation(fun, mu: torch.Tensor, var: torch.Tensor, n: int = 20) -> torch.Tensor:
    """E_{g~N(mu, var)}[fun(g)], elementwise over mu and var, by n-point GH."""
    x, w = gauss_hermite_points(n, mu.dtype, mu.device)
    g = mu[..., None] + torch.sqrt(var)[..., None] * x
    return torch.sum(w * fun(g), dim=-1)
