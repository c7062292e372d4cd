"""Kronecker-structured sparse variational GPs: ``KronGP``, the single-GP
``KronSVGP``, and the two-GP ``KronHurdleSVGP`` and ``KronOnOffSVGP``.

Counterpart of ``zigp_tpu/models/kron.py`` (``KronGP`` :41-149,
``KronSVGP`` :173-243, ``KronHurdleSVGP`` :246-445, ``KronOnOffSVGP``
:448-639): ``create``, the factor grams and their ``chol_inv`` state,
``prior_kl``, ``predict_f`` and ``predict``, ``elbo`` and ``loss``. The KL
and the conditional of a step share one ``chol_inv`` per factor, as in the
JAX package. The samplers (``KronGP.predict_f_samples`` with ``full_cov``,
``KronSVGP.predict_f_samples``, ``KronHurdleSVGP.predict_y_samples``,
``KronOnOffSVGP.predict_y_samples``) draw from a ``torch.Generator`` on the
model's device in the JAX package's split order; each is a thin shell around
a pure ``*_from`` core that takes the standard normals, uniforms or gammas.

The inducing grid is Z = Z_s × Z_t (e.g. 10 spatial kmeans centres × 100
temporal knots), never formed: the conditional works factor by factor
(``ops.conditionals``). Where the JAX package ``vmap``s the f/g pair over a
stacked pytree, the port stacks the pair's constrained values on a leading
dimension of 2 and runs one pass, so each ``chol_inv`` launch factors both
GPs' grams of one factor (``_KronPair``). The two GPs keep separate
parameters. A single GP runs the same pass with a leading dimension of 1.

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
from ..core.config import jitter_pair, resolve_jitter
from ..core.parameters import param, positive_param
from ..ops import conditionals, gauss_kl, linalg
from ..ops.probit import probit_expectations
from .onoff import OnOffPrediction, gated_y_from, gated_y_samples


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

    kernels: tuple  # per factor, the kernel's values (``ops.kernels``)
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
    if not isinstance(first, tuple):
        return first  # a static field (Matérn's nu2, an active dim), shared by the stack
    parts = [_stack(list(x)) for x in zip(*items)]
    return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)


class KronGP(nn.Module):
    """One GP on a Kronecker inducing grid. Posterior covariance: diagonal
    (``q_sqrt``, the reference's family) or Kronecker-factored full
    (S = ⊗_p C_p C_pᵀ, ``q_cov="kron"``)."""

    def __init__(self, kernels, Zs, q_mu, q_sqrt, input_masks, jitter, default_jitters, whiten=False,
                 q_sqrt_factors=None):
        super().__init__()
        self.kernels = nn.ModuleList(kernels)
        self.Zs = nn.ModuleList(Zs)
        self.q_mu = q_mu
        self.q_sqrt = q_sqrt
        self.q_sqrt_factors = None if q_sqrt_factors is None else nn.ModuleList(q_sqrt_factors)
        self.input_masks = tuple(tuple(m) for m in input_masks)
        # None: the default pair frozen at creation, resolved by the dtype the
        # grams are built in (``jitter_for``), as the JAX package takes its
        # default in the precision it runs.
        self.jitter = None if jitter is None else float(jitter)
        self.default_jitters = tuple(float(j) for j in default_jitters)
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
            jitter=jitter,
            default_jitters=jitter_pair(),
            whiten=whiten,
            q_sqrt_factors=factors,
        )

    @property
    def factor_sizes(self) -> Tuple[int, ...]:
        return tuple(Z.shape[0] for Z in self.Zs)

    def masks(self):
        return [getattr(self, f"mask{p}") for p in range(len(self.input_masks))]

    def kernel_flags(self) -> tuple:
        """Per factor, whether its grams come from ``ops.cuda.rbf_gram``: a
        bool for an RBF, a pair of flags for a composite (``ops.kernels``)."""
        return tuple(k.kernel_flags() for k in self.kernels)

    def signature(self):
        """What must match for two GPs to run as one stacked pass: the
        parameter shapes, and each factor kernel's family tree with its
        static fields (Matérn's ν, ``active_dims``, each RBF leaf's flag),
        which the JAX package's tree structures carry."""
        shapes = tuple((n, tuple(p.shape)) for n, p in self.named_parameters())
        kernels = tuple(k.signature() for k in self.kernels)
        jitters = tuple(self.jitter_for(dt) for dt in (torch.float64, torch.float32))
        return shapes, self.input_masks, jitters, self.whiten, kernels

    def jitter_for(self, dtype: torch.dtype) -> float:
        """The absolute jitter added to a gram of ``dtype``: the model's own,
        or the default pair frozen by ``create`` resolved by ``dtype`` (1e-6
        in float64 and 1e-5 in float32 unless ``jitter_level`` was in force)."""
        return self.jitter if self.jitter is not None else resolve_jitter(self.default_jitters, dtype)

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
        grams = [k.K(Z, use_kernel=f) for k, Z, f in zip(vals.kernels, vals.Zs, self.kernel_flags())]
        return [linalg.add_jitter(K, self.jitter_for(K.dtype)) for K in grams]

    def _factor_state(self, vals: GPValues):
        pairs = [linalg.chol_inv(Kp) for Kp in self._gram_factors(vals)]
        return tuple(L for L, _ in pairs), tuple(Li for _, Li in pairs)

    def _prior_kl(self, vals: GPValues, factor_state=None):
        """KL(q(u) ‖ p(u)) per stacked GP, (G,). The whitened prior needs no
        factor state; otherwise it is computed here unless given."""
        if self.whiten:
            if vals.q_sqrt_factors is not None:
                return gauss_kl.gauss_kl_kron_full(vals.q_mu, vals.q_sqrt_factors, None)
            return gauss_kl.gauss_kl(vals.q_mu, vals.q_sqrt, None)
        if factor_state is None:
            factor_state = self._factor_state(vals)
        if vals.q_sqrt_factors is not None:
            return gauss_kl.gauss_kl_kron_full(vals.q_mu, vals.q_sqrt_factors, factor_state=factor_state)
        return gauss_kl.gauss_kl_kron(vals.q_mu, vals.q_sqrt, factor_state=factor_state)

    def _predict_f(self, vals: GPValues, Xnew, factor_state=None, full_cov: bool = False):
        return conditionals.kron_conditional(
            Xnew,
            vals.kernels,
            vals.Zs,
            vals.q_mu,
            vals.q_sqrt,
            self.masks(),
            jitter=self.jitter_for(vals.q_mu.dtype),
            whiten=self.whiten,
            q_sqrt_factors=vals.q_sqrt_factors,
            factor_state=factor_state if factor_state is not None else self._factor_state(vals),
            use_kernel=self.kernel_flags(),
            full_cov=full_cov,
        )

    def gram_factors(self):
        return [K[0] for K in self._gram_factors(_stack([self.values()]))]

    def factor_state(self):
        """(Ls, Linvs) = chol_inv of the jittered factor grams."""
        Ls, Linvs = self._factor_state(_stack([self.values()]))
        return tuple(L[0] for L in Ls), tuple(Li[0] for Li in Linvs)

    def prior_kl(self, factor_state=None) -> torch.Tensor:
        if factor_state is not None:
            factor_state = _stack([factor_state])
        return self._prior_kl(_stack([self.values()]), factor_state)[0]

    def predict_f(self, Xnew: torch.Tensor, factor_state=None, *, full_cov: bool = False):
        """Marginal predictive (mean, var), each (B, 1); with ``full_cov``
        the mean and the joint covariance (B, B, 1)."""
        if factor_state is not None:
            factor_state = _stack([factor_state])
        mu, var = self._predict_f(_stack([self.values()]), Xnew, factor_state, full_cov)
        return mu[0], var[0]

    def predict_f_samples_from(self, Xnew: torch.Tensor, eps: torch.Tensor, *, full_cov: bool = False):
        """(S, B, 1) posterior samples from standard normals ``eps``: (S, B)
        drawn jointly through the Cholesky of the jittered (B, B) predictive
        covariance with ``full_cov``, else (S, B, 1) per-point marginals."""
        if full_cov:
            mu, cov = self.predict_f(Xnew, full_cov=True)
            Lc = linalg.cholesky(linalg.add_jitter(cov[:, :, 0], self.jitter_for(cov.dtype)))
            return (mu[:, 0][None] + eps @ Lc.transpose(-1, -2))[:, :, None]
        mu, var = self.predict_f(Xnew)
        return mu[None] + torch.sqrt(torch.clamp(var, min=0.0))[None] * eps

    def predict_f_samples(self, generator: torch.Generator, Xnew: torch.Tensor, num_samples: int = 1, *,
                          full_cov: bool = False):
        """``predict_f_samples_from`` on normals drawn from ``generator``."""
        shape = (num_samples, Xnew.shape[0]) + (() if full_cov else (1,))
        raw = self.q_mu.raw
        eps = torch.randn(shape, generator=generator, dtype=raw.dtype, device=raw.device)
        return self.predict_f_samples_from(Xnew, eps, full_cov=full_cov)


class LatentPrediction(NamedTuple):
    """A single GP's predictive latent moments, each (B, 1)."""

    fmean: torch.Tensor
    fvar: torch.Tensor


class ClassPrediction(NamedTuple):
    """The classifier head: p(y=1|x) and p − p², each (B, 1)."""

    pfmean: torch.Tensor
    pfvar: torch.Tensor


class KronSVGP(nn.Module):
    """Single-GP Kronecker SVGP: regression (Gaussian, LogNormal, Gamma) or
    the probit classifier (Bernoulli). One GP runs through ``KronGP``'s
    stacked pass with G = 1, so one ``chol_inv`` launch per factor serves
    the KL and the conditional of a step."""

    def __init__(self, gp, likelihood, mean_const, num_data):
        super().__init__()
        self.gp = gp
        self.likelihood = likelihood
        self.mean_const = mean_const
        self.num_data = int(num_data)

    @classmethod
    def create(cls, kernels, Zs, likelihood, *, num_data, mean_const=None, **kw) -> "KronSVGP":
        return cls(
            gp=KronGP.create(kernels, Zs, **kw),
            likelihood=likelihood,
            mean_const=None if mean_const is None else param(mean_const),
            num_data=num_data,
        )

    def _shift(self, fmean):
        return fmean if self.mean_const is None else fmean + self.mean_const.value

    def prior_kl(self) -> torch.Tensor:
        return self.gp.prior_kl()

    def predict_f(self, Xnew: torch.Tensor, *, full_cov: bool = False):
        """(fmean, fvar), each (B, 1), the prior mean constant added; with
        ``full_cov`` the joint covariance (B, B, 1)."""
        fmean, fvar = self.gp.predict_f(Xnew, full_cov=full_cov)
        return self._shift(fmean), fvar

    def predict_f_samples_from(self, Xnew: torch.Tensor, eps: torch.Tensor, *, full_cov: bool = False):
        """``KronGP.predict_f_samples_from`` with the mean constant added."""
        return self._shift(self.gp.predict_f_samples_from(Xnew, eps, full_cov=full_cov))

    def predict_f_samples(self, generator: torch.Generator, Xnew: torch.Tensor, num_samples: int = 1, *,
                          full_cov: bool = False):
        return self._shift(self.gp.predict_f_samples(generator, Xnew, num_samples, full_cov=full_cov))

    def predict_prob(self, Xnew: torch.Tensor):
        """The classifier head: p(y=1|x) = Φ̃(μ/√(1+v)) and p − p²."""
        fmean, fvar = self.predict_f(Xnew)
        p = self.likelihood.predict_prob(fmean, fvar)
        return p, p - torch.square(p)

    # ``predict_batched`` takes a bound method that returns named fields: it
    # keeps one chunk graph per model and method.
    def predict_latent(self, Xnew: torch.Tensor) -> LatentPrediction:
        return LatentPrediction(*self.predict_f(Xnew))

    def predict_class(self, Xnew: torch.Tensor) -> ClassPrediction:
        return ClassPrediction(*self.predict_prob(Xnew))

    def elbo(self, X: torch.Tensor, Y: torch.Tensor, *, num_data=None, factor_state=None) -> torch.Tensor:
        """(num_data / B) Σ E_q[log p(y | f)] − KL. ``num_data`` overrides
        the dataset size; ``factor_state`` injects ``self.factor_state()``.
        One factorization serves the KL and the conditional."""
        vals = _stack([self.gp.values()])
        st = self.gp._factor_state(vals) if factor_state is None else _stack([factor_state])
        kl = self.gp._prior_kl(vals, st)[0]
        mu, var = self.gp._predict_f(vals, X, st)
        var_exp = self.likelihood.variational_expectations(self._shift(mu[0]), var[0], Y)
        n = self.num_data if num_data is None else num_data
        return torch.sum(var_exp) * (n / X.shape[0]) - kl

    def loss(self, X, Y, *, num_data=None, factor_state=None):
        return -self.elbo(X, Y, num_data=num_data, factor_state=factor_state)

    def factor_state(self):
        return self.gp.factor_state()


class _KronPair(nn.Module):
    """Two GPs, f and g, run as one stacked pass when their signatures match
    (one chol_inv launch per factor for the pair), else one after the other.
    Same math either way. Subclasses set ``f``, ``g`` and ``pair_gps``."""

    def _pairable(self) -> bool:
        return self.pair_gps and self.f.signature() == self.g.signature()

    def _stacked(self) -> GPValues:
        return _stack([self.f.values(), self.g.values()])

    def _predict_fg(self, Xnew: torch.Tensor):
        """(fmean, fvar), (gmean, gvar), each (B, 1), without mean shifts."""
        if self._pairable():
            mu, var = self.f._predict_f(self._stacked(), Xnew)
            return (mu[0], var[0]), (mu[1], var[1])
        return self.f.predict_f(Xnew), self.g.predict_f(Xnew)

    def factor_state(self):
        """The pair's chol_inv factorizations: stacked (leading f/g dim) when
        paired, ((f state), (g state)) otherwise."""
        if self._pairable():
            return self.f._factor_state(self._stacked())
        return self.f.factor_state(), self.g.factor_state()

    def prior_kl(self) -> torch.Tensor:
        if self._pairable():
            return torch.sum(self.f._prior_kl(self._stacked()))
        return self.f.prior_kl() + self.g.prior_kl()

    def _kl_and_predict(self, X: torch.Tensor, factor_state=None):
        """KL_f + KL_g and ((fmean, fvar), (gmean, gvar)) at X, each GP
        factorizing its grams once (or taking ``factor_state``, the layout of
        ``self.factor_state()``) for its KL and its conditional."""

        def kl_and_predict(gp, vals, st):
            st = gp._factor_state(vals) if st is None else st
            return gp._prior_kl(vals, st), gp._predict_f(vals, X, st)

        if self._pairable():
            kls, (mu, var) = kl_and_predict(self.f, self._stacked(), factor_state)
            return torch.sum(kls), ((mu[0], var[0]), (mu[1], var[1]))
        stf, stg = (None, None) if factor_state is None else (_stack([s]) for s in factor_state)
        klf, (fm, fv) = kl_and_predict(self.f, _stack([self.f.values()]), stf)
        klg, (gm, gv) = kl_and_predict(self.g, _stack([self.g.values()]), stg)
        return klf[0] + klg[0], ((fm[0], fv[0]), (gm[0], gv[0]))


class HurdlePrediction(NamedTuple):
    """The joint hurdle's predictive moments: gate probability and amount latent."""

    p_on: torch.Tensor  # P(y > 0 | x) = Φ̃(gmean/√(1+gvar))
    fmean: torch.Tensor  # amount latent mean (log scale for LogNormal/Gamma)
    fvar: torch.Tensor
    gmean: torch.Tensor
    gvar: torch.Tensor


class KronHurdleSVGP(_KronPair):
    """The jointly trained hurdle: a Bernoulli gate GP g on 1[y>0] and a
    positive-support amount GP f on y | y>0, in one ELBO:

        ELBO = Σᵢ E_q(g)[log Bern(1[yᵢ>0] | Φ(gᵢ))]
             + Σ_{i: yᵢ>0} E_q(f)[log q(yᵢ | fᵢ)] − KL_f − KL_g.

    The amount term is masked, not subset, so a step's shapes are static."""

    def __init__(self, f, g, gate_likelihood, amount_likelihood, mean_const, num_data, pair_gps=True):
        super().__init__()
        self.f = f
        self.g = g
        self.gate_likelihood = gate_likelihood
        self.amount_likelihood = amount_likelihood
        self.mean_const = mean_const
        self.num_data = int(num_data)
        self.pair_gps = pair_gps

    @classmethod
    def create(
        cls,
        fkernels,
        Zfs,
        gkernels,
        Zgs,
        gate_likelihood,
        amount_likelihood,
        *,
        num_data,
        mean_const=None,
        jitter=None,
        seed: int = 0,
        lr: Optional[float] = None,
        q_mu_scale: float = 0.1,
        whiten: bool = False,
        q_cov: str = "diag",
    ) -> "KronHurdleSVGP":
        gkernels = copy.deepcopy(list(gkernels))  # never tie f's and g's parameters
        kw = dict(jitter=jitter, lr=lr, q_mu_scale=q_mu_scale, whiten=whiten, q_cov=q_cov)
        return cls(
            f=KronGP.create(fkernels, Zfs, seed=seed, **kw),
            g=KronGP.create(gkernels, Zgs, seed=seed + 1, **kw),
            gate_likelihood=gate_likelihood,
            amount_likelihood=amount_likelihood,
            mean_const=None if mean_const is None else param(mean_const),
            num_data=num_data,
        )

    def predict(self, Xnew: torch.Tensor) -> HurdlePrediction:
        (fmean, fvar), (gmean, gvar) = self._predict_fg(Xnew)
        if self.mean_const is not None:
            fmean = fmean + self.mean_const.value
        return HurdlePrediction(self.gate_likelihood.predict_prob(gmean, gvar), fmean, fvar, gmean, gvar)

    def predict_y_samples_from(self, Xnew: torch.Tensor, eps, amount_draws, u) -> torch.Tensor:
        """(S, B, 1) draws from the mixed predictive: f from the amount
        latent's marginal and standard normals ``eps``, pushed through the
        amount head's ``sample_y_from`` with its standard variates
        ``amount_draws``, kept where the uniforms ``u`` fall below p_on and 0
        elsewhere (zeros with probability 1 − p_on)."""
        pr = self.predict(Xnew)
        f = pr.fmean[None] + torch.sqrt(torch.clamp(pr.fvar, min=0.0))[None] * eps
        y = self.amount_likelihood.sample_y_from(f, amount_draws)
        return torch.where(u < pr.p_on[None], y, torch.zeros_like(y))

    def predict_y_samples(self, generator: torch.Generator, Xnew: torch.Tensor, num_samples: int = 1):
        """``predict_y_samples_from`` on variates drawn from ``generator``
        in the JAX package's order: the latent's normals, the amount head's
        draws, the gate's uniforms."""
        raw = self.f.q_mu.raw
        eps = torch.randn((num_samples, Xnew.shape[0], 1), generator=generator, dtype=raw.dtype, device=raw.device)
        amount = self.amount_likelihood.sample_draws(generator, eps)
        u = torch.rand(eps.shape, generator=generator, dtype=raw.dtype, device=raw.device)
        return self.predict_y_samples_from(Xnew, eps, amount, u)

    def elbo(self, X: torch.Tensor, Y: torch.Tensor, *, num_data=None, factor_state=None) -> torch.Tensor:
        """``Y`` carries the raw amounts, zeros included; the gate target
        and the amount mask come from it. ``num_data`` and ``factor_state``
        as in ``KronSVGP.elbo``."""
        kl, ((fmean, fvar), (gmean, gvar)) = self._kl_and_predict(X, factor_state)
        if self.mean_const is not None:
            fmean = fmean + self.mean_const.value
        on = (Y > 0).to(X.dtype)
        ve_gate = self.gate_likelihood.variational_expectations(gmean, gvar, on)
        # Y is 1 at the off rows, so the amount term stays finite there and
        # the mask zeroes it in the primal and the backward pass alike (a
        # log 0 would make 0·inf = NaN in the gradient, which Adam's
        # zero_nans would then hide)
        Ysafe = torch.where(on > 0, Y, torch.ones_like(Y))
        ve_amount = self.amount_likelihood.variational_expectations(fmean, fvar, Ysafe)
        var_exp = ve_gate + on * ve_amount
        n = self.num_data if num_data is None else num_data
        return torch.sum(var_exp) * (n / X.shape[0]) - kl

    def loss(self, X, Y, *, num_data=None, factor_state=None):
        return -self.elbo(X, Y, num_data=num_data, factor_state=factor_state)


class KronOnOffSVGP(_KronPair):
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

    def _gated(self, fmean, fvar, gmean, gvar):
        """The mean shifts, then the probit gate's expectations."""
        if self.mean_const is not None:
            fmean = fmean + self.mean_const.value
        # constant prior-mean shift on g (the reference's predict module uses
        # −1.0, its training 0; default 0)
        gmean = gmean + self.g_mean_shift
        return fmean, gmean, probit_expectations(gmean, gvar, exact=self.exact_owen_t)

    def predict(self, Xnew: torch.Tensor) -> OnOffPrediction:
        (fmean, fvar), (gmean, gvar) = self._predict_fg(Xnew)
        fmean, gmean, (e_phi, e_phi_sq, var_phi) = self._gated(fmean, fvar, gmean, gvar)
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

    def predict_y_samples_from(self, Xnew: torch.Tensor, zf, zg, ze) -> torch.Tensor:
        """(S, B, 1) samples of y* = Φ(g*)·f* + ε (``onoff.gated_y_from``)
        from the marginals at ``Xnew`` and the given standard normals."""
        return gated_y_from(self.predict(Xnew), self.likelihood.variance.value, zf, zg, ze)

    def predict_y_samples(self, generator: torch.Generator, Xnew: torch.Tensor, num_samples: int = 1):
        """(S, B, 1) per-point samples of the gated predictive, f* and g*
        from their posterior marginals, ε ~ N(0, likelihood.variance), drawn
        from ``generator`` (``onoff.gated_y_samples``)."""
        return gated_y_samples(self.predict(Xnew), self.likelihood.variance.value, generator, num_samples)

    def elbo(self, X: torch.Tensor, Y: torch.Tensor, *, num_data=None, factor_state=None) -> torch.Tensor:
        """The minibatch ELBO: (num_data / B) Σ E_q[log p(y | Φ(g) f)] − KL_f − KL_g.

        ``num_data`` overrides the model's dataset size; ``factor_state``
        injects a precomputed ``self.factor_state()`` (same layout). Each GP
        factorizes its grams once (chol_inv) for both its KL and its
        conditional; paired, f and g run as one stacked pass."""
        kl, ((fmean, fvar), (gmean, gvar)) = self._kl_and_predict(X, factor_state)
        fmean, gmean, (e_phi, e_phi_sq, var_phi) = self._gated(fmean, fvar, gmean, gvar)
        var_exp = self.likelihood.variational_expectations(
            e_phi * fmean, e_phi_sq * fvar, var_phi * torch.square(fmean), Y
        )
        n = self.num_data if num_data is None else num_data
        return torch.sum(var_exp) * (n / X.shape[0]) - kl

    def loss(self, X, Y, *, num_data=None, factor_state=None):
        return -self.elbo(X, Y, num_data=num_data, factor_state=factor_state)
