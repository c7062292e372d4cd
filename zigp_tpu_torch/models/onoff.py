"""The on/off model's prediction record and its gated predictive sampler.

Counterpart of ``zigp_tpu/models/onoff.py:27-57``: the 9-tuple of the
reference's ``build_predict``, with the same field names and order, and
``gated_y_samples``. The sampler's draws come from a ``torch.Generator`` in
the JAX package's split order (f, then g, then the noise);
``gated_y_from`` is the pure map from given standard normals.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class OnOffPrediction(NamedTuple):
    gfmean: torch.Tensor  # E[Φ(g)]·E[f]
    gfvar: torch.Tensor  # E[Φ²(g)]·Var[f]
    gfmeanu: torch.Tensor  # Var[Φ(g)]·E[f]²
    fmean: torch.Tensor
    fvar: torch.Tensor
    gmean: torch.Tensor
    gvar: torch.Tensor
    pgmean: torch.Tensor  # E[Φ(g)]
    pgvar: torch.Tensor  # Var[Φ(g)]


def gated_y_from(pred: OnOffPrediction, noise_var, zf, zg, ze) -> torch.Tensor:
    """(S, B, 1) samples y* = Φ(g*)·f* + ε from the prediction's marginal
    moments and three sets of standard normals of shape (S, B, 1): f* from
    ``zf``, g* from ``zg``, ε ~ N(0, noise_var) from ``ze``."""
    f = pred.fmean[None] + torch.sqrt(torch.clamp(pred.fvar, min=0.0))[None] * zf
    g = pred.gmean[None] + torch.sqrt(torch.clamp(pred.gvar, min=0.0))[None] * zg
    return torch.special.ndtr(g) * f + torch.sqrt(torch.as_tensor(noise_var, dtype=f.dtype)) * ze


def gated_y_samples(pred: OnOffPrediction, noise_var, generator: torch.Generator, num_samples: int) -> torch.Tensor:
    """``gated_y_from`` on normals drawn from ``generator`` (on the
    prediction's device): zf, zg, ze in that order."""
    shape = (num_samples, *pred.fmean.shape)
    zf, zg, ze = (torch.randn(shape, generator=generator, dtype=pred.fmean.dtype, device=pred.fmean.device)
                  for _ in range(3))
    return gated_y_from(pred, noise_var, zf, zg, ze)
