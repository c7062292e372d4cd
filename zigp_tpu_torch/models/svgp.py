"""Dense-inducing-point sparse variational GP (SVGP).

Counterpart of ``zigp_tpu/models/svgp.py:23-127``: the single-GP building
block on one M × M inducing gram. A Gaussian likelihood gives the SVGP
regressor, Bernoulli the sparse GP classifier. ``predict_f_samples`` draws
from a ``torch.Generator`` on the model's device; ``predict_f_samples_from``
is the pure map from given standard normals.

Parameter names follow the JAX pytree paths (``kernel.lengthscales.raw``
here is ``.kernel.lengthscales.raw`` there), which is what ``io.convert``
relies on.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.bijectors import FillLowerTriangular
from ..core.config import jitter_pair, resolve_jitter
from ..core.parameters import param, positive_param
from ..ops import conditionals, gauss_kl, linalg


def inducing_q(M: int, num_latent: int, q_diag: bool, lr=None):
    """The initial q(u) scale: ones (M, L) on a positive bijector, or
    identity lower factors (M, M, L) for the full family."""
    if q_diag:
        return positive_param(np.ones((M, num_latent)), lr=lr)
    return param(np.stack([np.eye(M)] * num_latent, axis=2), FillLowerTriangular(), lr=lr)


def dense_kl(q_mu: torch.Tensor, q_sqrt: torch.Tensor, Kmm: Optional[torch.Tensor]) -> torch.Tensor:
    """``gauss_kl`` of one GP (its leading batch dim of 1 added and
    dropped); ``Kmm`` None is a white prior."""
    return gauss_kl.gauss_kl(q_mu[None], q_sqrt[None], None if Kmm is None else Kmm[None])[0]


def joint_samples(fmean: torch.Tensor, fcov: torch.Tensor, eps: torch.Tensor, jitter: float) -> torch.Tensor:
    """(S, N, L) joint draws from the means (N, L) and covariances (N, N, L)
    with standard normals ``eps`` (S, N, L), one Cholesky of each latent's
    jittered covariance (NaN where it is not positive definite)."""
    outs = []
    for k in range(fmean.shape[1]):
        Lc = linalg.cholesky(linalg.add_jitter(fcov[:, :, k], jitter))
        outs.append(fmean[:, k][None] + eps[:, :, k] @ Lc.transpose(-1, -2))
    return torch.stack(outs, dim=-1)


class SVGP(nn.Module):
    def __init__(self, kernel, likelihood, Z, q_mu, q_sqrt, mean_const, num_data, whiten, q_diag, jitter,
                 default_jitters):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.Z = Z
        self.q_mu = q_mu
        self.q_sqrt = q_sqrt
        self.mean_const = mean_const
        self.num_data = int(num_data)
        self.whiten = whiten
        self.q_diag = q_diag
        # None: the default pair frozen at creation, resolved by the dtype the
        # grams are built in (``jitter_for``)
        self.jitter = None if jitter is None else float(jitter)
        self.default_jitters = tuple(float(j) for j in default_jitters)

    @classmethod
    def create(
        cls,
        kernel,
        likelihood,
        Z: np.ndarray,
        *,
        num_data: int,
        num_latent: int = 1,
        whiten: bool = False,
        q_diag: bool = True,
        jitter: Optional[float] = None,
        mean_const: Optional[float] = None,
        q_mu_init: Optional[np.ndarray] = None,
        seed: int = 0,
        lr: Optional[float] = None,
    ) -> "SVGP":
        M = Z.shape[0]
        rng = np.random.RandomState(seed)
        q_mu = q_mu_init if q_mu_init is not None else rng.randn(M, num_latent) * 0.01
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            Z=param(Z, lr=lr),
            q_mu=param(q_mu, lr=lr),
            q_sqrt=inducing_q(M, num_latent, q_diag, lr),
            mean_const=None if mean_const is None else param(mean_const, lr=lr),
            num_data=num_data,
            whiten=whiten,
            q_diag=q_diag,
            jitter=jitter,
            default_jitters=jitter_pair(),
        )

    def jitter_for(self, dtype: torch.dtype) -> float:
        return self.jitter if self.jitter is not None else resolve_jitter(self.default_jitters, dtype)

    def prior_kl(self) -> torch.Tensor:
        if self.whiten:
            return dense_kl(self.q_mu.value, self.q_sqrt.value, None)
        Z = self.Z.value
        Kmm = linalg.add_jitter(self.kernel.K(Z), self.jitter_for(Z.dtype))
        return dense_kl(self.q_mu.value, self.q_sqrt.value, Kmm)

    def predict_f(self, Xnew: torch.Tensor, *, full_cov: bool = False):
        """(fmean, fvar), each (N, L), the prior mean constant added; with
        ``full_cov`` the covariance (N, N, L)."""
        Z = self.Z.value
        fmean, fvar = conditionals.conditional(
            Xnew, Z, self.kernel, self.q_mu.value, full_cov=full_cov, q_sqrt=self.q_sqrt.value,
            whiten=self.whiten, jitter=self.jitter_for(Z.dtype),
        )
        if self.mean_const is not None:
            fmean = fmean + self.mean_const.value
        return fmean, fvar

    def predict_f_samples_from(self, Xnew: torch.Tensor, eps: torch.Tensor, *, full_cov: bool = False):
        """(S, N, L) posterior samples from standard normals ``eps`` (S, N,
        L): jointly through the Cholesky of each latent's jittered
        covariance with ``full_cov``, else per-point marginals."""
        fmean, fvar = self.predict_f(Xnew, full_cov=full_cov)
        if full_cov:
            return joint_samples(fmean, fvar, eps, self.jitter_for(fmean.dtype))
        return fmean[None] + torch.sqrt(torch.clamp(fvar, min=0.0))[None] * eps

    def predict_f_samples(self, generator: torch.Generator, Xnew: torch.Tensor, num_samples: int = 1, *,
                          full_cov: bool = False):
        """``predict_f_samples_from`` on normals drawn from ``generator``."""
        raw = self.q_mu.raw
        eps = torch.randn((num_samples, Xnew.shape[0], raw.shape[1]), generator=generator, dtype=raw.dtype,
                          device=raw.device)
        return self.predict_f_samples_from(Xnew, eps, full_cov=full_cov)

    def elbo(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        kl = self.prior_kl()
        fmean, fvar = self.predict_f(X)
        var_exp = self.likelihood.variational_expectations(fmean, fvar, Y)
        return torch.sum(var_exp) * (self.num_data / X.shape[0]) - kl

    def loss(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return -self.elbo(X, Y)
