"""Typed experiment configs: plain copies of ``zigp_tpu/experiments/
configs.py`` (``KronGridConfig``, ``KernelInit``, the on/off, SVGP,
classifier and joint-hurdle configs, ``best_onoff_config``, the tuned
configs, ``ToyOnOffConfig`` and ``preset_configs``) with the JAX package's fields and defaults.
The mesh options the port does not have yet are kept so that a config that
sets them fails loudly in ``experiments.runners._fit_auto``."""

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

    ``family`` names a kernel of the zoo (``ops.kernels``): "rbf" (the
    reference's), "matern12"/"matern32"/"matern52", "periodic", "rq",
    "linear", or a composite joining those with "*" (Product) or "+" (Sum),
    e.g. "periodic*rbf". Components share the ``lengthscales``/``variance``
    init; "periodic" reads ``period``, "rq" reads ``alpha``. ``trust`` > 0
    bounds each component's lengthscales and periods to [init/trust,
    init·trust] by a Sigmoid bijector; 0 leaves them unbounded."""

    lengthscales: Tuple[float, ...]
    variance: float
    family: str = "rbf"
    period: Tuple[float, ...] = ()
    alpha: float = 1.0
    trust: float = 0.0


@dataclass
class OnOffPptrConfig:
    """The reference's scripts/onoff.py defaults: 10 × 100 grid, diagonal q,
    unwhitened, bound Owen's T, B = 1000."""

    num_iter: int = 50_000
    batch_size: int = 1000
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
    log_every: int = 200
    ckpt_every: int = 10_000  # checkpoint cadence of a run with a workdir
    hist_every: int = 0  # param/grad histogram cadence (the reference's 200 is costly)
    monitor_every: int = 10_000  # cadence of the runner's monitor callback
    exact_owen_t: bool = False
    whiten: bool = False
    scan_inner: int = 50  # optimizer steps per block of fit_scanned; 0 = the per-step fit
    lr_schedule: str = ""  # "" = constant; "cosine" = cosine decay over num_iter
    sampler: str = "host"  # "host" (shuffled epochs) | "device" (uniform, on the device)
    optimizer: str = "adam"  # "adam" | "natgrad" (natural step on q, Adam on the rest)
    # > 0: block-coordinate schedule (training.alternating): the hypers update
    # once per hyper_every steps, q-only steps between on one factorization
    # (sampler "device"; must divide scan_inner). 0 = joint training
    hyper_every: int = 0
    # post-hoc likelihood-variance recalibration by train-residual moment
    # matching (runners.recalibrate_noise); point metrics unchanged
    recalibrate_noise: bool = False
    natgrad_gamma: float = 0.1
    natgrad_warmup: int = 2000  # γ ramp length (steps)
    natgrad_adam_warmup: int = 1000  # all-raw Adam steps before the natural phase
    # q_cov="kron" only: the joint natural step on (mean, one Σ factor), the
    # factor alternating by step, instead of the mean step + Adam on factors
    natgrad_kron_joint: bool = False
    natgrad_kl_cap: float = 10.0  # per-step KL(q′‖q) budget (nats); 0 disables
    g_mean_shift: float = 0.0  # constant prior-mean shift on g at predict
    q_cov: str = "diag"  # "diag" | "kron" (factored full covariance)
    mesh_data: int = 0  # multi-device training, not ported
    mesh_model: int = 0


@dataclass
class SvgpPptrConfig:
    """The reference's scripts/svgp.py defaults. ``likelihood`` is the
    regression head: "gaussian" (the reference's), or the positive-support
    "lognormal" / "gamma" for the hurdle's amount model y | y > 0 (strictly
    positive training targets)."""

    num_iter: int = 50_000
    batch_size: int = 500
    grid: KronGridConfig = field(default_factory=KronGridConfig)
    k_spatial: KernelInit = field(default_factory=lambda: KernelInit((8.0, 8.0), 20.0))
    k_temporal: KernelInit = field(default_factory=lambda: KernelInit((5.0 / 1000,), 20.0))
    noise_variance: float = 0.01
    likelihood: str = "gaussian"
    lognormal_variance: float = 0.5  # init σ² of log y (lognormal head)
    gamma_shape: float = 1.0  # init α (gamma head; 1 = exponential)
    lr: float = 1e-3
    jitter: float = 1e-5
    q_mu_scale: float = 0.1
    seed: int = 0
    log_every: int = 200
    ckpt_every: int = 10_000
    hist_every: int = 0
    scan_inner: int = 50
    whiten: bool = False
    lr_schedule: str = ""
    q_cov: str = "diag"
    sampler: str = "host"
    hyper_every: int = 0  # block-coordinate cadence (see OnOffPptrConfig)
    recalibrate_noise: bool = False
    mesh_data: int = 0  # not ported
    mesh_model: int = 0
    optimizer: str = "adam"  # "adam" | "natgrad"
    natgrad_gamma: float = 0.1
    natgrad_warmup: int = 2000
    natgrad_adam_warmup: int = 1000
    natgrad_kron_joint: bool = False
    natgrad_kl_cap: float = 10.0


@dataclass
class ClassifierPptrConfig:
    """The reference's scripts/classifier.py defaults. ``num_gh`` 0 is its
    plug-in Bernoulli, > 0 Gauss–Hermite quadrature."""

    num_iter: int = 500
    batch_size: int = 1000
    grid: KronGridConfig = field(default_factory=KronGridConfig)
    k_spatial: KernelInit = field(default_factory=lambda: KernelInit((5.0, 5.0), 20.0))
    k_temporal: KernelInit = field(default_factory=lambda: KernelInit((5.0 / 1000,), 20.0))
    lr: float = 1e-3
    jitter: float = 1e-5
    q_mu_scale: float = 0.01
    num_gh: int = 0
    seed: int = 0
    log_every: int = 100
    ckpt_every: int = 10_000
    hist_every: int = 0
    scan_inner: int = 50
    whiten: bool = False
    lr_schedule: str = ""
    q_cov: str = "diag"
    sampler: str = "host"
    hyper_every: int = 0
    mesh_data: int = 0
    mesh_model: int = 0
    optimizer: str = "adam"
    natgrad_gamma: float = 0.1
    natgrad_warmup: int = 2000
    natgrad_adam_warmup: int = 1000
    natgrad_kron_joint: bool = False
    natgrad_kl_cap: float = 10.0


@dataclass
class HurdleJointConfig:
    """The jointly trained hurdle (``models.KronHurdleSVGP``): gate and
    amount GP in one ELBO. The gate's kernel inits follow the classifier's;
    the builder matches the amount kernels' variance to var(log y⁺) for the
    positive heads."""

    num_iter: int = 50_000
    batch_size: int = 1000
    grid: KronGridConfig = field(default_factory=KronGridConfig)
    # amount GP (f)
    k_spatial: KernelInit = field(default_factory=lambda: KernelInit((8.0, 8.0), 20.0))
    k_temporal: KernelInit = field(default_factory=lambda: KernelInit((5.0 / 1000,), 20.0))
    # gate GP (g)
    gk_spatial: KernelInit = field(default_factory=lambda: KernelInit((5.0, 5.0), 20.0))
    gk_temporal: KernelInit = field(default_factory=lambda: KernelInit((5.0 / 1000,), 20.0))
    likelihood: str = "lognormal"  # amount head: lognormal | gamma | gaussian
    lognormal_variance: float = 0.5
    gamma_shape: float = 1.0
    noise_variance: float = 0.01  # gaussian amount head only
    num_gh: int = 0  # gate Bernoulli: 0 = plug-in, > 0 = GH
    lr: float = 1e-3
    jitter: float = 1e-5
    q_mu_scale: float = 0.1
    seed: int = 0
    log_every: int = 200
    ckpt_every: int = 10_000
    hist_every: int = 0
    scan_inner: int = 50
    whiten: bool = False
    lr_schedule: str = ""
    q_cov: str = "diag"
    sampler: str = "host"
    hyper_every: int = 0
    mesh_data: int = 0
    mesh_model: int = 0
    optimizer: str = "adam"
    natgrad_gamma: float = 0.1
    natgrad_warmup: int = 2000
    natgrad_adam_warmup: int = 1000
    natgrad_kron_joint: bool = False
    natgrad_kl_cap: float = 10.0


def best_onoff_config() -> OnOffPptrConfig:
    """The champion on/off configuration: whitened, Kronecker-factored full
    covariance, 32 × 200 grid, exact Owen's T, cosine learning rates 3e-3,
    B = 4000, 150k steps, the device sampler."""
    return OnOffPptrConfig(
        num_iter=150_000,
        whiten=True,
        q_cov="kron",
        grid=KronGridConfig(num_spatial=32, num_temporal=200),
        fk_spatial=KernelInit((2.0, 2.0), 20.0),
        gk_spatial=KernelInit((2.0, 2.0), 10.0),
        exact_owen_t=True,
        lr_schedule="cosine",
        indp_lr=3e-3,
        kern_lr=3e-3,
        batch_size=4000,
        sampler="device",
    )


def tuned_svgp_config() -> SvgpPptrConfig:
    """The whitened 32 × 200 SVGP."""
    return SvgpPptrConfig(
        whiten=True,
        grid=KronGridConfig(num_spatial=32, num_temporal=200),
        k_spatial=KernelInit((2.0, 2.0), 20.0),
    )


def tuned_classifier_config() -> ClassifierPptrConfig:
    """The whitened 32 × 200 classifier, 5000 steps."""
    return ClassifierPptrConfig(
        whiten=True,
        num_iter=5000,
        grid=KronGridConfig(num_spatial=32, num_temporal=200),
        k_spatial=KernelInit((2.0, 2.0), 20.0),
    )


@dataclass
class ToyOnOffConfig:
    """The notebook's toy config (cells 7-10): RBF ℓ = 2, σ²f = 1, σ²g = 5,
    noise 0.01, M = 10, scipy L-BFGS-B with a history of 100 (scipy's
    default 10 tracks this objective's curvature poorly)."""

    num_inducing: int = 10
    f_lengthscale: float = 2.0
    f_variance: float = 1.0
    g_lengthscale: float = 2.0
    g_variance: float = 5.0
    noise_variance: float = 0.01
    jitter: float = 1e-6
    optimizer: str = "lbfgs"  # "lbfgs" (the reference's, through gpflow) | "adam"
    maxiter: int = 8000
    lbfgs_maxcor: int = 100
    seed: int = 0


def preset_configs(preset: str) -> dict:
    """The base config of each model family for a preset: "reference" (the
    reference's configs, unwhitened), "reference-stable" (the same with
    ``whiten=True`` only) or "best" (the champion and tuned configs)."""
    import dataclasses

    if preset == "best":
        return {
            "onoff": best_onoff_config(),
            "svgp": tuned_svgp_config(),
            "classifier": tuned_classifier_config(),
            "hurdlej": HurdleJointConfig(),
        }
    base = {
        "onoff": OnOffPptrConfig(),
        "svgp": SvgpPptrConfig(),
        "classifier": ClassifierPptrConfig(),
        "hurdlej": HurdleJointConfig(),
    }
    if preset == "reference-stable":
        return {k: dataclasses.replace(v, whiten=True) for k, v in base.items()}
    if preset != "reference":
        raise ValueError(f"unknown preset: {preset!r}")
    return base


REFERENCE_PRESET_WARNING = (
    "warning: --preset reference runs the reference's unwhitened "
    "parameterization — fold 3 of the svgp/hurdle protocol is known to "
    "diverge under it (RESULTS.md footnote). --preset reference-stable is "
    "the same config with whiten=True only."
)
