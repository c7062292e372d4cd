"""Likelihoods: the expected log-density terms of the ELBO.

Counterpart of ``zigp_tpu/likelihoods/likelihoods.py``:

- ``Gaussian``: SVGP regression; ``OnOffGaussian``: the Gaussian on the
  probit-gated signal, whose gate uncertainty enters its expected
  log-density as Fmuvar = Var[Φ(g)]·Fmu², beside the usual Fvar term;
- ``LogNormal`` and ``Gamma``: the positive-support heads of the hurdle's
  amount model y | y > 0, both with closed-form variational expectations
  under a Gaussian q(f);
- ``Bernoulli``: the probit classifier, ``num_gh = 0`` the reference's
  plug-in form log Φ̃(μ/√(1+v)), ``num_gh > 0`` Gauss–Hermite quadrature.

Every constant of a step is a Python float or a tensor cached on the
device (``ops.quadrature``), so the terms can be captured in a CUDA graph.

The regression heads' samplers (``zigp_tpu/likelihoods/likelihoods.py:50,
126, 194``) come in two parts: ``sample_draws(generator, F)`` draws the
standard variates (normals, or standard gammas for ``Gamma``) from a
``torch.Generator`` on F's device, and ``sample_y_from(F, draws)`` is the
pure map from them to y. ``sample_y(generator, F)`` is the two in turn.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.parameters import positive_param
from ..ops import quadrature
from ..ops.probit import normcdf_clipped


def _normals(generator, like: torch.Tensor) -> torch.Tensor:
    """Standard normals of ``like``'s shape, dtype and device."""
    return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)


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

    def predict_mean_and_var(self, Fmu, Fvar):
        return Fmu, Fvar + self.variance.value

    sample_draws = staticmethod(_normals)

    def sample_y_from(self, F, eps):
        """y = f + σ ε for standard normals ``eps`` (F's shape)."""
        return F + torch.sqrt(self.variance.value) * eps

    def sample_y(self, generator, F):
        """One observation draw y ~ N(f, σ²) per latent sample in ``F``."""
        return self.sample_y_from(F, self.sample_draws(generator, F))


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


class LogNormal(nn.Module):
    """log y | f ~ N(f, σ²), y > 0: a Gaussian SVGP on log y, whose
    predictive is exactly LogNormal(Fmu, Fvar + σ²). ``predict_mean_and_var``
    gives E[y] = exp(μ + s²/2), ``predict_median`` exp(μ)."""

    def __init__(self, variance):
        super().__init__()
        self.variance = variance

    @classmethod
    def create(cls, variance: float = 0.1, lr=None) -> "LogNormal":
        return cls(positive_param(variance, lr=lr))

    def variational_expectations(self, Fmu, Fvar, Y):
        v = self.variance.value
        logy = torch.log(Y)
        return -logy - 0.5 * np.log(2.0 * np.pi) - 0.5 * torch.log(v) - 0.5 * (torch.square(logy - Fmu) + Fvar) / v

    def predict_mean_and_var(self, Fmu, Fvar):
        s2 = Fvar + self.variance.value
        mean = torch.exp(Fmu + 0.5 * s2)
        var = (torch.exp(s2) - 1.0) * torch.exp(2.0 * Fmu + s2)
        return mean, var

    def predict_median(self, Fmu, Fvar):
        del Fvar
        return torch.exp(Fmu)

    def nlpd(self, Fmu, Fvar, Y):
        """Exact per-point −log p(y*) under LogNormal(μ, Fvar + σ²)."""
        s2 = Fvar + self.variance.value
        logy = torch.log(Y)
        return logy + 0.5 * torch.log(2.0 * np.pi * s2) + 0.5 * torch.square(logy - Fmu) / s2

    sample_draws = staticmethod(_normals)

    def sample_y_from(self, F, eps):
        """y = exp(f + σ ε) for standard normals ``eps`` (F's shape)."""
        return torch.exp(F + torch.sqrt(self.variance.value) * eps)

    def sample_y(self, generator, F):
        """One observation draw y ~ LogNormal(f, σ²) per latent sample."""
        return self.sample_y_from(F, self.sample_draws(generator, F))


class Gamma(nn.Module):
    """y | f ~ Gamma(shape α, mean exp(f)) (rate α e^{−f}). With
    E_q[e^{−f}] = exp(−μ + v/2):

        E_q[log p(y|f)] = α log α − lΓ(α) + (α−1) log y − α μ − α y exp(−μ + v/2).
    """

    def __init__(self, shape):
        super().__init__()
        self.shape = shape

    @classmethod
    def create(cls, shape: float = 1.0, lr=None) -> "Gamma":
        return cls(positive_param(shape, lr=lr))

    def variational_expectations(self, Fmu, Fvar, Y):
        a = self.shape.value
        return a * torch.log(a) - torch.lgamma(a) + (a - 1.0) * torch.log(Y) - a * Fmu - a * Y * torch.exp(
            -Fmu + 0.5 * Fvar)

    def predict_mean_and_var(self, Fmu, Fvar):
        a = self.shape.value
        mean = torch.exp(Fmu + 0.5 * Fvar)
        # Var[y] = E[Var[y|f]] + Var[E[y|f]] = E[e^{2f}]/α + Var[e^f]
        var = torch.exp(2.0 * Fmu + 2.0 * Fvar) / a + (torch.exp(Fvar) - 1.0) * torch.exp(2.0 * Fmu + Fvar)
        return mean, var

    def nlpd(self, Fmu, Fvar, Y, *, num_gh: int = 32):
        """−log E_{f~N(μ,v)}[Gamma(y; α, α e^{−f})] by GH quadrature with a
        log-sum-exp over the nodes."""
        a = self.shape.value
        x, w = quadrature.gauss_hermite_points(num_gh, Fmu.dtype, Fmu.device)
        f = Fmu[..., None] + torch.sqrt(torch.clamp(Fvar, min=0.0))[..., None] * x
        logp = (a * torch.log(a) - torch.lgamma(a) + (a - 1.0) * torch.log(Y)[..., None] - a * f
                - a * Y[..., None] * torch.exp(-f))
        return -torch.logsumexp(logp + torch.log(w), dim=-1)

    def sample_draws(self, generator, F):
        """Standard Gamma(α) variates of F's shape, dtype and device."""
        a = self.shape.value.detach().to(F.dtype).expand(F.shape)
        return torch._standard_gamma(a.contiguous(), generator=generator)

    def sample_y_from(self, F, g):
        """y = g e^f / α for standard Gamma(α) variates ``g``: a draw from
        Gamma(α, rate α e^{−f}), whose mean is e^f."""
        return g * torch.exp(F) / self.shape.value

    def sample_y(self, generator, F):
        """One draw y ~ Gamma(α, rate α e^{−f}) per latent sample."""
        return self.sample_y_from(F, self.sample_draws(generator, F))


class Bernoulli(nn.Module):
    """Probit-link Bernoulli. ``num_gh = 0`` is the reference's plug-in
    approximation; ``num_gh > 0`` Gauss–Hermite quadrature of E[log p(y|f)]."""

    def __init__(self, num_gh: int = 0):
        super().__init__()
        self.num_gh = int(num_gh)

    @classmethod
    def create(cls, num_gh: int = 0) -> "Bernoulli":
        return cls(num_gh)

    @staticmethod
    def predict_prob(Fmu, Fvar):
        """p(y=1|x) = Φ̃(μ/√(1+v))."""
        return normcdf_clipped(Fmu / torch.sqrt(1.0 + Fvar))

    def variational_expectations(self, Fmu, Fvar, Y):
        if self.num_gh > 0:
            def logp(f):
                p = normcdf_clipped(f)
                return torch.where(Y[..., None] == 1.0, torch.log(p), torch.log1p(-p))

            return quadrature.expectation(logp, Fmu, Fvar, n=self.num_gh)
        p = self.predict_prob(Fmu, Fvar)
        return torch.log(torch.where(Y == 1.0, p, 1.0 - p))
