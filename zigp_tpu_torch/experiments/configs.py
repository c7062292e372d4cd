"""Typed experiment configs: plain copies of ``zigp_tpu/experiments/
configs.py`` (``KronGridConfig``, ``KernelInit``, ``OnOffPptrConfig``,
``best_onoff_config``) with the fields that build the on/off model; the
training fields (steps, batch, schedules, sampler) come with training."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class KronGridConfig:
    """Inducing-grid layout: ``num_spatial`` kmeans centres over (lat, lon) ⊗
    ``num_temporal`` time knots, or with ``spatial_factors=(n_lat, n_lon)``
    three factors lat ⊗ lon ⊗ time (``num_spatial`` then ignored)."""

    num_spatial: int = 10
    num_temporal: int = 100
    spatial_factors: Tuple[int, int] | None = None
    # knots of the exogenous factor when the inputs carry covariates (D > 3)
    num_exog: int = 8


@dataclass
class KernelInit:
    """Initial hyperparameters and family of one Kronecker kernel factor.
    The port has the "rbf" family; ``trust`` > 0 bounds the lengthscales to
    [init/trust, init·trust] by a Sigmoid bijector."""

    lengthscales: Tuple[float, ...]
    variance: float
    family: str = "rbf"
    trust: float = 0.0


@dataclass
class OnOffPptrConfig:
    """The reference's scripts/onoff.py defaults: 10 × 100 grid, diagonal q,
    unwhitened, bound Owen's T."""

    grid: KronGridConfig = field(default_factory=KronGridConfig)
    fk_spatial: KernelInit = field(default_factory=lambda: KernelInit((8.0, 8.0), 20.0))
    fk_temporal: KernelInit = field(default_factory=lambda: KernelInit((5.0 / 1000,), 20.0))
    gk_spatial: KernelInit = field(default_factory=lambda: KernelInit((8.0, 8.0), 10.0))
    gk_temporal: KernelInit = field(default_factory=lambda: KernelInit((5.0 / 1000,), 10.0))
    noise_variance: float = 0.01
    kern_lr: float = 1e-3
    indp_lr: float = 1e-3
    jitter: float = 1e-5
    q_mu_scale: float = 0.1
    seed: int = 0
    exact_owen_t: bool = False
    whiten: bool = False
    g_mean_shift: float = 0.0  # constant prior-mean shift on g at predict
    q_cov: str = "diag"  # "diag" | "kron" (factored full covariance)


def best_onoff_config() -> OnOffPptrConfig:
    """The champion on/off configuration: whitened, Kronecker-factored full
    covariance, 32 × 200 grid, exact Owen's T, learning rates 3e-3."""
    return OnOffPptrConfig(
        whiten=True,
        q_cov="kron",
        grid=KronGridConfig(num_spatial=32, num_temporal=200),
        fk_spatial=KernelInit((2.0, 2.0), 20.0),
        gk_spatial=KernelInit((2.0, 2.0), 10.0),
        exact_owen_t=True,
        indp_lr=3e-3,
        kern_lr=3e-3,
    )
