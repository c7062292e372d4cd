"""The dense-inducing on/off model, its prediction record and its gated
predictive sampler.

Counterpart of ``zigp_tpu/models/onoff.py``: the 9-tuple of the reference's
``build_predict``, with the same field names and order, ``gated_y_samples``
(:27-57), and ``OnOffSVGP`` (:61-187), the zero-inflated two-GP model on
dense inducing points: a signal GP f and a support GP g coupled through a
probit gate, y ≈ Φ(g)·f + ε. The sampler's draws come from a
``torch.Generator`` in the JAX package's split order (f, then g, then the
noise); ``gated_y_from`` is the pure map from given standard normals.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..core.config import jitter_pair, resolve_jitter
from ..core.parameters import param
from ..ops import conditionals, linalg
from ..ops.probit import probit_expectations
from .svgp import dense_kl, inducing_q


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


class OnOffSVGP(nn.Module):
    """The toy workflow's model: f and g each on its own dense inducing set
    (``Zf``, ``Zg``), the gate's expectations in closed form
    (``ops.probit``), the field names of the JAX model."""

    def __init__(self, kernf, kerng, likelihood, Zf, Zg, u_fm, u_gm, u_fs_sqrt, u_gs_sqrt, mean_const, num_data,
                 whiten, q_diag, jitter, default_jitters, exact_owen_t):
        super().__init__()
        self.kernf = kernf
        self.kerng = kerng
        self.likelihood = likelihood
        self.Zf = Zf
        self.Zg = Zg
        self.u_fm = u_fm
        self.u_gm = u_gm
        self.u_fs_sqrt = u_fs_sqrt
        self.u_gs_sqrt = u_gs_sqrt
        self.mean_const = mean_const
        self.num_data = int(num_data)
        self.whiten = whiten
        self.q_diag = q_diag
        # None: the default pair frozen at creation, resolved by the dtype the
        # grams are built in (``jitter_for``)
        self.jitter = None if jitter is None else float(jitter)
        self.default_jitters = tuple(float(j) for j in default_jitters)
        self.exact_owen_t = exact_owen_t

    @classmethod
    def create(
        cls,
        kernf,
        kerng,
        likelihood,
        Zf: np.ndarray,
        Zg: np.ndarray,
        *,
        num_data: int,
        num_latent: int = 1,
        whiten: bool = False,
        q_diag: bool = True,
        jitter: Optional[float] = None,
        mean_const: Optional[float] = None,
        exact_owen_t: bool = False,
        u_fm_init: Optional[np.ndarray] = None,
        u_gm_init: Optional[np.ndarray] = None,
        seed: int = 0,
    ) -> "OnOffSVGP":
        Mf, Mg = Zf.shape[0], Zg.shape[0]
        rng = np.random.RandomState(seed)
        u_fm = u_fm_init if u_fm_init is not None else rng.randn(Mf, num_latent) * 0.01
        u_gm = u_gm_init if u_gm_init is not None else rng.randn(Mg, num_latent) * 0.01
        return cls(
            kernf=kernf,
            kerng=kerng,
            likelihood=likelihood,
            Zf=param(Zf),
            Zg=param(Zg),
            u_fm=param(u_fm),
            u_gm=param(u_gm),
            u_fs_sqrt=inducing_q(Mf, num_latent, q_diag),
            u_gs_sqrt=inducing_q(Mg, num_latent, q_diag),
            mean_const=None if mean_const is None else param(mean_const),
            num_data=num_data,
            whiten=whiten,
            q_diag=q_diag,
            jitter=jitter,
            default_jitters=jitter_pair(),
            exact_owen_t=exact_owen_t,
        )

    def jitter_for(self, dtype: torch.dtype) -> float:
        return self.jitter if self.jitter is not None else resolve_jitter(self.default_jitters, dtype)

    def prior_kl(self) -> torch.Tensor:
        if self.whiten:
            return dense_kl(self.u_fm.value, self.u_fs_sqrt.value, None) + dense_kl(
                self.u_gm.value, self.u_gs_sqrt.value, None)
        Zf, Zg = self.Zf.value, self.Zg.value
        jitter = self.jitter_for(Zf.dtype)
        Kfmm = linalg.add_jitter(self.kernf.K(Zf), jitter)
        Kgmm = linalg.add_jitter(self.kerng.K(Zg), jitter)
        return dense_kl(self.u_fm.value, self.u_fs_sqrt.value, Kfmm) + dense_kl(
            self.u_gm.value, self.u_gs_sqrt.value, Kgmm)

    def predict(self, Xnew: torch.Tensor) -> OnOffPrediction:
        jitter = self.jitter_for(self.Zf.raw.dtype)
        fmean, fvar = conditionals.conditional(
            Xnew, self.Zf.value, self.kernf, self.u_fm.value, q_sqrt=self.u_fs_sqrt.value, whiten=self.whiten,
            jitter=jitter,
        )
        if self.mean_const is not None:
            fmean = fmean + self.mean_const.value
        gmean, gvar = conditionals.conditional(
            Xnew, self.Zg.value, self.kerng, self.u_gm.value, q_sqrt=self.u_gs_sqrt.value, whiten=self.whiten,
            jitter=jitter,
        )
        e_phi, e_phi_sq, var_phi = probit_expectations(gmean, gvar, exact=self.exact_owen_t)
        return OnOffPrediction(e_phi * fmean, e_phi_sq * fvar, var_phi * torch.square(fmean), fmean, fvar, gmean,
                               gvar, e_phi, var_phi)

    def predict_y_samples_from(self, Xnew: torch.Tensor, zf, zg, ze) -> torch.Tensor:
        """(S, B, 1) samples of y* = Φ(g*)·f* + ε (``gated_y_from``) from
        the marginals at ``Xnew`` and the given standard normals."""
        return gated_y_from(self.predict(Xnew), self.likelihood.variance.value, zf, zg, ze)

    def predict_y_samples(self, generator: torch.Generator, Xnew: torch.Tensor, num_samples: int = 1):
        """(S, B, 1) per-point samples of the gated predictive, drawn from
        ``generator`` (``gated_y_samples``; the reference returns moments
        only)."""
        return gated_y_samples(self.predict(Xnew), self.likelihood.variance.value, generator, num_samples)

    def elbo(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        kl = self.prior_kl()
        pred = self.predict(X)
        var_exp = self.likelihood.variational_expectations(pred.gfmean, pred.gfvar, pred.gfmeanu, Y)
        return torch.sum(var_exp) * (self.num_data / X.shape[0]) - kl

    def loss(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return -self.elbo(X, Y)
