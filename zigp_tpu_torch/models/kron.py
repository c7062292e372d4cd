"""Kronecker-structured sparse variational GPs: ``KronGP`` and the on/off pair.

Counterpart of ``zigp_tpu/models/kron.py`` (``KronGP`` :41-149 and
``KronOnOffSVGP`` :448-569), the serving half: ``create``, the factor grams
and their ``chol_inv`` state, ``predict_f`` and ``predict``. The KL and the
ELBO come with the training port.

The inducing grid is Z = Z_s × Z_t (e.g. 10 spatial kmeans centres × 100
temporal knots), never formed: the conditional works factor by factor
(``ops.conditionals``). Where the JAX package ``vmap``s the f/g pair over a
stacked pytree, the port stacks the pair's constrained values on a leading
dimension of 2 and runs one pass, so each ``chol_inv`` launch factors both
GPs' grams of one factor. The two GPs keep separate parameters.

Parameter names follow the JAX pytree paths (``f.kernels.0.lengthscales.raw``
here is ``.f.kernels[0].lengthscales.raw`` there), which is what
``io.convert`` relies on.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.bijectors import FillLowerTriangular
from ..core.config import default_jitter
from ..core.parameters import param, positive_param
from ..ops import conditionals, linalg
from ..ops.probit import probit_expectations
from .onoff import OnOffPrediction


def gen_input_masks(Zs: Sequence[np.ndarray]) -> Tuple[Tuple[int, ...], ...]:
    """Columns of X handled by each factor: consecutive column blocks."""
    masks = []
    start = 0
    for Z in Zs:
        d = Z.shape[1]
        masks.append(tuple(range(start, start + d)))
        start += d
    return tuple(masks)


class GPValues(NamedTuple):
    """One GP's constrained values (or a stack of several, leading dim G)."""

    kernels: tuple  # RBFValues per factor
    Zs: tuple
    q_mu: torch.Tensor
    q_sqrt: torch.Tensor
    q_sqrt_factors: Optional[tuple]


def _stack(items):
    """Stack matching trees of tensors (NamedTuples, tuples, None) on a new
    leading dimension."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    parts = [_stack(list(x)) for x in zip(*items)]
    return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)


class KronGP(nn.Module):
    """One GP on a Kronecker inducing grid. Posterior covariance: diagonal
    (``q_sqrt``, the reference's family) or Kronecker-factored full
    (S = ⊗_p C_p C_pᵀ, ``q_cov="kron"``)."""

    def __init__(self, kernels, Zs, q_mu, q_sqrt, input_masks, jitter, whiten=False, q_sqrt_factors=None):
        super().__init__()
        self.kernels = nn.ModuleList(kernels)
        self.Zs = nn.ModuleList(Zs)
        self.q_mu = q_mu
        self.q_sqrt = q_sqrt
        self.q_sqrt_factors = None if q_sqrt_factors is None else nn.ModuleList(q_sqrt_factors)
        self.input_masks = tuple(tuple(m) for m in input_masks)
        self.jitter = float(jitter)
        self.whiten = whiten
        # column picks as index tensors, moved to the device with the module
        for p, m in enumerate(self.input_masks):
            self.register_buffer(f"mask{p}", torch.tensor(m, dtype=torch.long), persistent=False)

    @classmethod
    def create(
        cls,
        kernels: Sequence,
        Zs: Sequence[np.ndarray],
        *,
        jitter: Optional[float] = None,
        q_mu_init: Optional[np.ndarray] = None,
        q_mu_scale: float = 0.1,
        lr: Optional[float] = None,
        seed: int = 0,
        whiten: bool = False,
        q_cov: str = "diag",
    ) -> "KronGP":
        M = int(np.prod([Z.shape[0] for Z in Zs]))
        rng = np.random.RandomState(seed)
        q_mu = q_mu_init if q_mu_init is not None else rng.randn(M, 1) * q_mu_scale
        factors = None
        if q_cov == "kron":
            factors = [param(np.eye(Z.shape[0]), FillLowerTriangular(), lr=lr) for Z in Zs]
        elif q_cov != "diag":
            raise ValueError(f"unknown q_cov family: {q_cov!r}")
        return cls(
            kernels=list(kernels),
            Zs=[param(Z, lr=lr) for Z in Zs],
            q_mu=param(q_mu, lr=lr),
            # frozen when the kron-factored covariance is active
            q_sqrt=positive_param(np.ones((M, 1)), lr=lr, trainable=factors is None),
            input_masks=gen_input_masks(Zs),
            jitter=jitter if jitter is not None else default_jitter(torch.float64),
            whiten=whiten,
            q_sqrt_factors=factors,
        )

    @property
    def factor_sizes(self) -> Tuple[int, ...]:
        return tuple(Z.shape[0] for Z in self.Zs)

    def masks(self):
        return [getattr(self, f"mask{p}") for p in range(len(self.input_masks))]

    def signature(self):
        """What must match for two GPs to run as one stacked pass."""
        shapes = tuple((n, tuple(p.shape)) for n, p in self.named_parameters())
        return shapes, self.input_masks, self.jitter, self.whiten

    def values(self) -> GPValues:
        return GPValues(
            tuple(k.values() for k in self.kernels),
            tuple(Z.value for Z in self.Zs),
            self.q_mu.value,
            self.q_sqrt.value,
            None if self.q_sqrt_factors is None else tuple(C.value for C in self.q_sqrt_factors),
        )

    # The methods below take values with a leading batch dim (see _stack).
    def _gram_factors(self, vals: GPValues):
        return [linalg.add_jitter(k.K(Z), self.jitter) for k, Z in zip(vals.kernels, vals.Zs)]

    def _factor_state(self, vals: GPValues):
        pairs = [linalg.chol_inv(Kp) for Kp in self._gram_factors(vals)]
        return tuple(L for L, _ in pairs), tuple(Li for _, Li in pairs)

    def _predict_f(self, vals: GPValues, Xnew, factor_state=None):
        return conditionals.kron_conditional(
            Xnew,
            vals.kernels,
            vals.Zs,
            vals.q_mu,
            vals.q_sqrt,
            self.masks(),
            jitter=self.jitter,
            whiten=self.whiten,
            q_sqrt_factors=vals.q_sqrt_factors,
            factor_state=factor_state if factor_state is not None else self._factor_state(vals),
        )

    def gram_factors(self):
        return [K[0] for K in self._gram_factors(_stack([self.values()]))]

    def factor_state(self):
        """(Ls, Linvs) = chol_inv of the jittered factor grams."""
        Ls, Linvs = self._factor_state(_stack([self.values()]))
        return tuple(L[0] for L in Ls), tuple(Li[0] for Li in Linvs)

    def predict_f(self, Xnew: torch.Tensor, factor_state=None):
        """Marginal predictive (mean, var), each (B, 1)."""
        if factor_state is not None:
            factor_state = _stack([factor_state])
        mu, var = self._predict_f(_stack([self.values()]), Xnew, factor_state)
        return mu[0], var[0]


class KronOnOffSVGP(nn.Module):
    """The two-GP zero-inflated on/off model on Kronecker inducing grids:
    a signal GP f and a support GP g coupled by a probit gate."""

    def __init__(self, f, g, likelihood, mean_const, g_mean_shift, num_data, exact_owen_t, pair_gps=True):
        super().__init__()
        self.f = f
        self.g = g
        self.likelihood = likelihood
        self.mean_const = mean_const
        self.g_mean_shift = float(g_mean_shift)
        self.num_data = int(num_data)
        self.exact_owen_t = exact_owen_t
        # Run f and g as one stacked pass when their shapes match: one
        # chol_inv launch per factor for the pair. Same math either way.
        self.pair_gps = pair_gps

    @classmethod
    def create(
        cls,
        fkernels,
        Zfs,
        gkernels,
        Zgs,
        likelihood,
        *,
        num_data,
        mean_const=None,
        g_mean_shift: float = 0.0,
        exact_owen_t: bool = False,
        jitter=None,
        seed: int = 0,
        lr: Optional[float] = None,
        q_mu_scale: float = 0.1,
        whiten: bool = False,
        q_cov: str = "diag",
    ) -> "KronOnOffSVGP":
        # Callers may pass the same kernel objects for f and g: copy, so the
        # two GPs never share (and silently tie) parameters.
        gkernels = copy.deepcopy(list(gkernels))
        kw = dict(jitter=jitter, lr=lr, q_mu_scale=q_mu_scale, whiten=whiten, q_cov=q_cov)
        return cls(
            f=KronGP.create(fkernels, Zfs, seed=seed, **kw),
            g=KronGP.create(gkernels, Zgs, seed=seed + 1, **kw),
            likelihood=likelihood,
            mean_const=None if mean_const is None else param(mean_const),
            g_mean_shift=g_mean_shift,
            num_data=num_data,
            exact_owen_t=exact_owen_t,
        )

    def _pairable(self) -> bool:
        return self.pair_gps and self.f.signature() == self.g.signature()

    def _predict_fg(self, Xnew: torch.Tensor):
        """(fmean, fvar), (gmean, gvar), each (B, 1)."""
        if self._pairable():
            mu, var = self.f._predict_f(_stack([self.f.values(), self.g.values()]), Xnew)
            return (mu[0], var[0]), (mu[1], var[1])
        return self.f.predict_f(Xnew), self.g.predict_f(Xnew)

    def predict(self, Xnew: torch.Tensor) -> OnOffPrediction:
        (fmean, fvar), (gmean, gvar) = self._predict_fg(Xnew)
        if self.mean_const is not None:
            fmean = fmean + self.mean_const.value
        # constant prior-mean shift on g (the reference's predict module uses
        # −1.0, its training 0; default 0)
        gmean = gmean + self.g_mean_shift
        e_phi, e_phi_sq, var_phi = probit_expectations(gmean, gvar, exact=self.exact_owen_t)
        return OnOffPrediction(
            e_phi * fmean,
            e_phi_sq * fvar,
            var_phi * torch.square(fmean),
            fmean,
            fvar,
            gmean,
            gvar,
            e_phi,
            var_phi,
        )

    def factor_state(self):
        """The pair's chol_inv factorizations: stacked (leading f/g dim) when
        paired, ((f state), (g state)) otherwise."""
        if self._pairable():
            return self.f._factor_state(_stack([self.f.values(), self.g.values()]))
        return self.f.factor_state(), self.g.factor_state()
