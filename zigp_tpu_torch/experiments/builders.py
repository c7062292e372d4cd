"""Model builders wiring configs to models for the pptr experiments.

Counterpart of ``zigp_tpu/experiments/builders.py:54-178`` for the on/off
model. The port has the RBF kernel only: any other family, or a composite
"a*b" / "a+b" spec, raises ``NotImplementedError``. ``use_kernel=True``
builds every factor's grams with the ``rbf_gram`` CUDA kernel (the JAX
``use_pallas``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import bijectors
from ..core.config import resolve_device
from ..core.parameters import param
from ..io.datasets import Split, kron_inducing_init
from ..likelihoods import OnOffGaussian
from ..models import KronOnOffSVGP
from ..ops.kernels import RBF
from .configs import KernelInit, OnOffPptrConfig

_RBF_NAMES = ("rbf", "se")


def make_kernel(init: KernelInit, *, lr=None, use_kernel: bool = False):
    """The kernel named by ``init.family``; ``init.trust`` > 0 rebuilds the
    lengthscales with a Sigmoid interval [init/trust, init·trust]."""
    spec = (init.family or "rbf").strip().lower()
    if spec not in _RBF_NAMES:
        raise NotImplementedError(
            f"kernel family {spec!r} is not ported yet; zigp_tpu_torch has {list(_RBF_NAMES)}"
        )
    k = RBF.create(list(init.lengthscales), init.variance, lr=lr, use_kernel=use_kernel)
    if init.trust:
        if init.trust <= 1.0:
            raise ValueError(f"trust must be > 1 (got {init.trust})")
        v = np.atleast_1d(np.asarray(init.lengthscales, dtype=np.float64))
        k.lengthscales = param(v, bijectors.Sigmoid(v / init.trust, v * init.trust), lr=lr)
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
