"""Model builders wiring configs to models for the pptr experiments.

Counterpart of ``zigp_tpu/experiments/builders.py``: the kernel zoo's
``make_kernel`` (a family name or an "a*b" / "a+b" spec), the on/off model,
the Kronecker SVGP regression (Gaussian, LogNormal and Gamma heads), the
probit classifier and the jointly trained hurdle. Each builder takes
``device`` (``None`` = the CUDA card), ``dtype`` and ``use_kernel``.
``use_kernel=True`` builds the grams of every RBF leaf, alone or inside a
composite, with the ``rbf_gram`` CUDA kernel (the JAX ``use_pallas``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import bijectors
from ..core.config import resolve_device
from ..core.parameters import param
from ..io.datasets import Split, kron_inducing_init
from ..likelihoods import Bernoulli, Gamma, Gaussian, LogNormal, OnOffGaussian
from ..models import KronHurdleSVGP, KronOnOffSVGP, KronSVGP
from ..ops import kernels as kz
from ..ops.kernels import RBF
from .configs import ClassifierPptrConfig, HurdleJointConfig, KernelInit, OnOffPptrConfig, SvgpPptrConfig


def _rbf(init, lr, use_kernel):
    return RBF.create(list(init.lengthscales), init.variance, lr=lr, use_kernel=use_kernel)


_FAMILIES = {
    "rbf": _rbf,
    "se": _rbf,
    "matern12": lambda init, lr, uk: kz.Matern.create(list(init.lengthscales), init.variance, nu="1/2", lr=lr),
    "matern32": lambda init, lr, uk: kz.Matern.create(list(init.lengthscales), init.variance, nu="3/2", lr=lr),
    "matern52": lambda init, lr, uk: kz.Matern.create(list(init.lengthscales), init.variance, nu="5/2", lr=lr),
    "periodic": lambda init, lr, uk: kz.Periodic.create(
        list(init.lengthscales), list(init.period) if init.period else [1.0] * len(init.lengthscales),
        init.variance, lr=lr),
    "rq": lambda init, lr, uk: kz.RationalQuadratic.create(
        list(init.lengthscales), init.variance, alpha=init.alpha, lr=lr),
    "linear": lambda init, lr, uk: kz.Linear.create([init.variance] * len(init.lengthscales), lr=lr),
}


def _bound_hypers(kernel, trust: float, *, lr=None):
    """Rebuild a kernel atom's lengthscales and period Parameters with a
    Sigmoid interval [init/trust, init·trust] (``KernelInit.trust``).
    Variances stay unbounded: they set scale, not gram conditioning, and
    the relative jitter absorbs them."""
    if trust <= 1.0:
        raise ValueError(f"trust must be > 1 (got {trust})")
    for f in ("lengthscales", "period"):
        p = getattr(kernel, f, None)
        if p is None:
            continue
        v = p.value.detach().numpy().astype(np.float64)
        setattr(kernel, f, param(v, bijectors.Sigmoid(v / trust, v * trust), lr=lr))
    return kernel


def make_kernel(init: KernelInit, *, lr=None, use_kernel: bool = False):
    """The kernel named by ``init.family``: a zoo name or a composite
    "a*b" / "a+b" spec (Product binds tighter than Sum; components share
    the lengthscale/variance init). ``use_kernel`` reaches every RBF atom."""
    spec = (init.family or "rbf").strip().lower()

    def atom(name):
        name = name.strip()
        if name not in _FAMILIES:
            raise ValueError(
                f"unknown kernel family {name!r}; choose from {sorted(_FAMILIES)} or join with '*' / '+'"
            )
        k = _FAMILIES[name](init, lr, use_kernel)
        if init.trust:
            k = _bound_hypers(k, float(init.trust), lr=lr)
        return k

    def product(term):
        parts = term.split("*")
        k = atom(parts[0])
        for p in parts[1:]:
            k = kz.Product.create(k, atom(p))
        return k

    terms = spec.split("+")
    k = product(terms[0])
    for t in terms[1:]:
        k = kz.Sum.create(k, product(t))
    return k


def _axis_spans(X):
    """(lat span, lon span) of the training inputs."""
    X = np.asarray(X)
    return float(X[:, 0].max() - X[:, 0].min()), float(X[:, 1].max() - X[:, 1].min())


def make_factor_kernels(
    spatial_init, temporal_init, spatial_factors, *, lr=None, axis_spans=None, use_kernel: bool = False
):
    """Per-factor kernels: one 2-D spatial kernel and the temporal kernel, or
    with ``spatial_factors`` one 1-D kernel per spatial axis, each axis's
    lengthscale init clamped to span/4 (a 2-D init of 8 on an axis of span
    about 10 makes the factor gram near rank 1)."""
    kw = dict(lr=lr, use_kernel=use_kernel)
    if spatial_factors is None:
        return [make_kernel(spatial_init, **kw), make_kernel(temporal_init, **kw)]

    def axis_init(d):
        ls = spatial_init.lengthscales
        ls_d = ls[min(d, len(ls) - 1)]
        if axis_spans is not None:
            ls_d = min(ls_d, float(axis_spans[d]) / 4.0)
        return dataclasses.replace(spatial_init, lengthscales=(ls_d,))

    return [
        make_kernel(axis_init(0), **kw),
        make_kernel(axis_init(1), **kw),
        make_kernel(temporal_init, **kw),
    ]


def _exog_kernels(X, *, lr=None, use_kernel: bool = False):
    """One RBF factor over the covariate columns when the inputs carry them
    (D > 3), with unit lengthscales and variance."""
    d = np.asarray(X).shape[1] - 3
    if d <= 0:
        return []
    return [RBF.create([1.0] * d, 1.0, lr=lr, use_kernel=use_kernel)]


def build_onoff_pptr(
    cfg: OnOffPptrConfig,
    split: Split,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
) -> KronOnOffSVGP:
    """The on/off model of ``cfg`` for ``split``, on ``device`` in ``dtype``.
    ``device=None`` is the CUDA card, and raises where there is none; pass
    ``device="cpu"`` for the CPU."""
    device = resolve_device(device)
    Zs = kron_inducing_init(
        split.Xtrain, cfg.grid.num_spatial, cfg.grid.num_temporal, seed=cfg.seed,
        spatial_factors=cfg.grid.spatial_factors, num_exog=cfg.grid.num_exog,
    )
    spans = _axis_spans(split.Xtrain)
    fkerns = make_factor_kernels(
        cfg.fk_spatial, cfg.fk_temporal, cfg.grid.spatial_factors,
        lr=cfg.kern_lr, axis_spans=spans, use_kernel=use_kernel,
    ) + _exog_kernels(split.Xtrain, lr=cfg.kern_lr, use_kernel=use_kernel)
    gkerns = make_factor_kernels(
        cfg.gk_spatial, cfg.gk_temporal, cfg.grid.spatial_factors,
        lr=cfg.kern_lr, axis_spans=spans, use_kernel=use_kernel,
    ) + _exog_kernels(split.Xtrain, lr=cfg.kern_lr, use_kernel=use_kernel)
    model = KronOnOffSVGP.create(
        fkerns,
        Zs,
        gkerns,
        [Z.copy() for Z in Zs],
        OnOffGaussian.create(cfg.noise_variance, lr=cfg.kern_lr),
        num_data=split.Xtrain.shape[0],
        jitter=cfg.jitter,
        seed=cfg.seed,
        lr=cfg.indp_lr,
        q_mu_scale=cfg.q_mu_scale,
        exact_owen_t=cfg.exact_owen_t,
        whiten=cfg.whiten,
        g_mean_shift=cfg.g_mean_shift,
        q_cov=cfg.q_cov,
    )
    return model.to(device=device, dtype=dtype)


def make_regression_likelihood(cfg, Y: np.ndarray):
    """(likelihood, mean_const) of the regression head named by
    ``cfg.likelihood``. The positive-support heads model the latent on a log
    scale, so they get a learned constant prior mean initialised from the
    (strictly positive) targets."""
    name = (cfg.likelihood or "gaussian").lower()
    if name == "gaussian":
        return Gaussian.create(cfg.noise_variance, lr=cfg.lr), None
    Y = np.asarray(Y, dtype=np.float64).reshape(-1)
    if (Y <= 0).any():
        raise ValueError(
            f"likelihood={name!r} requires strictly positive targets (got min {Y.min()}); use it as the "
            "hurdle's on-subset head or filter zeros first"
        )
    if name == "lognormal":
        return LogNormal.create(cfg.lognormal_variance, lr=cfg.lr), float(np.mean(np.log(Y)))
    if name == "gamma":
        return Gamma.create(cfg.gamma_shape, lr=cfg.lr), float(np.log(np.mean(Y)))
    raise ValueError(f"unknown regression likelihood {name!r}; choose gaussian | lognormal | gamma")


def _log_matched_kernel_inits(k_spatial, k_temporal, Y, n_factors: int):
    """Kernel inits with per-factor variance var(log y)^(1/F): the positive
    heads' latent lives on a log scale, where the Kronecker prior variance
    is the product over the factors (20 · 20 = 400 would put exp(200) in the
    predictive means)."""
    v_log = max(float(np.var(np.log(np.asarray(Y, dtype=np.float64).reshape(-1)))), 0.05)
    v_f = v_log ** (1.0 / n_factors)
    return dataclasses.replace(k_spatial, variance=v_f), dataclasses.replace(k_temporal, variance=v_f)


def _grid(cfg, X):
    return kron_inducing_init(
        X, cfg.grid.num_spatial, cfg.grid.num_temporal, seed=cfg.seed,
        spatial_factors=cfg.grid.spatial_factors, num_exog=cfg.grid.num_exog,
    )


def _kernels(k_spatial, k_temporal, cfg, X, use_kernel):
    return make_factor_kernels(
        k_spatial, k_temporal, cfg.grid.spatial_factors, lr=cfg.lr, axis_spans=_axis_spans(X), use_kernel=use_kernel,
    ) + _exog_kernels(X, lr=cfg.lr, use_kernel=use_kernel)


def _amount_inits(cfg, Y):
    """(likelihood, mean_const, k_spatial, k_temporal) of a regression or
    amount model on targets Y: the positive heads' kernels log-matched."""
    likelihood, mean_const = make_regression_likelihood(cfg, Y)
    k_spatial, k_temporal = cfg.k_spatial, cfg.k_temporal
    if mean_const is not None:
        n_factors = 2 if cfg.grid.spatial_factors is None else 3
        k_spatial, k_temporal = _log_matched_kernel_inits(k_spatial, k_temporal, Y, n_factors)
    return likelihood, mean_const, k_spatial, k_temporal


def build_svgp_pptr(
    cfg: SvgpPptrConfig,
    split: Split,
    *,
    subset_idx=None,
    device=None,
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
) -> KronSVGP:
    """The Kronecker SVGP regression of ``cfg`` on ``split``'s training rows,
    or on the rows ``subset_idx`` of them (its grid and inits from those)."""
    device = resolve_device(device)
    X = split.Xtrain if subset_idx is None else split.Xtrain[subset_idx]
    Y = split.Ytrain if subset_idx is None else split.Ytrain[subset_idx]
    likelihood, mean_const, k_spatial, k_temporal = _amount_inits(cfg, Y)
    model = KronSVGP.create(
        _kernels(k_spatial, k_temporal, cfg, X, use_kernel),
        _grid(cfg, X),
        likelihood,
        num_data=X.shape[0],
        mean_const=mean_const,
        jitter=cfg.jitter,
        seed=cfg.seed,
        lr=cfg.lr,
        q_mu_scale=cfg.q_mu_scale,
        whiten=cfg.whiten,
        q_cov=cfg.q_cov,
    )
    return model.to(device=device, dtype=dtype)


def build_classifier_pptr(
    cfg: ClassifierPptrConfig,
    split: Split,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
) -> KronSVGP:
    """The Kronecker probit classifier of ``cfg`` (train it on
    ``binarize_targets(split.Ytrain)``)."""
    device = resolve_device(device)
    X = split.Xtrain
    model = KronSVGP.create(
        _kernels(cfg.k_spatial, cfg.k_temporal, cfg, X, use_kernel),
        _grid(cfg, X),
        Bernoulli.create(num_gh=cfg.num_gh),
        num_data=X.shape[0],
        jitter=cfg.jitter,
        seed=cfg.seed,
        lr=cfg.lr,
        q_mu_scale=cfg.q_mu_scale,
        whiten=cfg.whiten,
        q_cov=cfg.q_cov,
    )
    return model.to(device=device, dtype=dtype)


def build_hurdle_joint_pptr(
    cfg: HurdleJointConfig,
    split: Split,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
) -> KronHurdleSVGP:
    """The jointly trained hurdle of ``cfg``: the amount head's likelihood,
    mean and kernel-variance inits from the strictly positive training
    targets, the gate's kernels from ``cfg.gk_*``."""
    device = resolve_device(device)
    X, Y = split.Xtrain, split.Ytrain
    Zs = _grid(cfg, X)
    Ypos = np.asarray(Y, dtype=np.float64).reshape(-1)
    Ypos = Ypos[Ypos > 0]
    amount_lik, mean_const, k_spatial, k_temporal = _amount_inits(cfg, Ypos)
    model = KronHurdleSVGP.create(
        _kernels(k_spatial, k_temporal, cfg, X, use_kernel),
        Zs,
        _kernels(cfg.gk_spatial, cfg.gk_temporal, cfg, X, use_kernel),
        [Z.copy() for Z in Zs],
        Bernoulli.create(num_gh=cfg.num_gh),
        amount_lik,
        num_data=X.shape[0],
        mean_const=mean_const,
        jitter=cfg.jitter,
        seed=cfg.seed,
        lr=cfg.lr,
        q_mu_scale=cfg.q_mu_scale,
        whiten=cfg.whiten,
        q_cov=cfg.q_cov,
    )
    return model.to(device=device, dtype=dtype)


def binarize_targets(Y: np.ndarray) -> np.ndarray:
    """y > 0 as float: the classifier's target transform."""
    return (np.asarray(Y) > 0).astype(np.float64)
