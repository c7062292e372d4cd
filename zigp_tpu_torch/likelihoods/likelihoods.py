"""Gaussian likelihoods of the on/off model.

Counterpart of ``zigp_tpu/likelihoods/likelihoods.py:31-76``. ``OnOffGaussian``
is the Gaussian on the probit-gated signal: the gate's uncertainty enters its
expected log-density as Fmuvar = Var[Φ(g)]·Fmu², beside the usual Fvar term.
The serving path reads only the noise variance; the expected log-densities
are here for the training port.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.parameters import positive_param


class Gaussian(nn.Module):
    def __init__(self, variance):
        super().__init__()
        self.variance = variance

    @classmethod
    def create(cls, variance: float = 0.01, lr=None) -> "Gaussian":
        return cls(positive_param(variance, lr=lr))

    def variational_expectations(self, Fmu, Fvar, Y):
        v = self.variance.value
        return -0.5 * np.log(2.0 * np.pi) - 0.5 * torch.log(v) - 0.5 * (torch.square(Y - Fmu) + Fvar) / v


class OnOffGaussian(nn.Module):
    def __init__(self, variance):
        super().__init__()
        self.variance = variance

    @classmethod
    def create(cls, variance: float = 0.01, lr=None) -> "OnOffGaussian":
        return cls(positive_param(variance, lr=lr))

    def variational_expectations(self, Fmu, Fvar, Fmuvar, Y):
        v = self.variance.value
        return (
            -0.5 * np.log(2.0 * np.pi)
            - 0.5 * torch.log(v)
            - 0.5 * (torch.square(Y - Fmu) + Fvar + Fmuvar) / v
        )
