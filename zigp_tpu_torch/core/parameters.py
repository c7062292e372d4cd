"""``Parameter``: an unconstrained tensor with its bijector and optimizer group.

Counterpart of ``zigp_tpu/core/parameters.py``. The module holds one
``nn.Parameter`` named ``raw`` (the unconstrained value), so the torch
parameter names of a model line up with the JAX pytree paths
(``f.kernels.0.lengthscales.raw`` <-> ``.f.kernels[0].lengthscales.raw``,
see ``io.convert``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from . import bijectors


class Parameter(nn.Module):
    def __init__(
        self,
        raw: torch.Tensor,
        bijector: bijectors.Bijector = bijectors.identity,
        *,
        trainable: bool = True,
        lr: Optional[float] = None,
    ):
        super().__init__()
        self.raw = nn.Parameter(raw, requires_grad=trainable)
        self.bijector = bijector
        self.trainable = trainable
        self.lr = lr

    @property
    def value(self) -> torch.Tensor:
        return self.bijector.forward(self.raw)

    @property
    def shape(self):
        return self.raw.shape

    def extra_repr(self) -> str:
        return f"shape={tuple(self.raw.shape)}, bijector={self.bijector}, lr={self.lr}"


def param(
    value,
    bijector: Optional[bijectors.Bijector] = None,
    *,
    trainable: bool = True,
    lr: Optional[float] = None,
    dtype: torch.dtype = torch.float64,
) -> Parameter:
    """A Parameter from a *constrained* value: the inverse runs in numpy
    float64, then the raw is cast to ``dtype`` (as the JAX ``param`` does)."""
    bijector = bijector or bijectors.identity
    raw = bijector.inverse(np.asarray(value, dtype=np.float64))
    return Parameter(
        torch.as_tensor(np.asarray(raw), dtype=dtype),
        bijector,
        trainable=trainable,
        lr=lr,
    )


def positive_param(value, **kw) -> Parameter:
    return param(value, bijectors.positive, **kw)
