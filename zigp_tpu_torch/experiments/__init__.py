from . import builders, configs, cv, runners, toy
from .cv import run_cv
from .configs import (
    ClassifierPptrConfig,
    KronGridConfig,
    HurdleJointConfig,
    OnOffPptrConfig,
    SvgpPptrConfig,
    ToyOnOffConfig,
)
from .runners import (
    run_classifier,
    run_hurdle,
    run_hurdle_joint,
    run_onoff,
    run_predict,
    run_svgp,
    run_zero_inflated,
)
from .toy import REFERENCE_TOY_ELBO, build_toy_model, run_toy

__all__ = [
    "builders",
    "configs",
    "runners",
    "toy",
    "OnOffPptrConfig",
    "SvgpPptrConfig",
    "ClassifierPptrConfig",
    "KronGridConfig",
    "ToyOnOffConfig",
    "HurdleJointConfig",
    "run_onoff",
    "run_predict",
    "run_svgp",
    "run_classifier",
    "run_hurdle",
    "run_hurdle_joint",
    "run_zero_inflated",
    "run_toy",
    "build_toy_model",
    "REFERENCE_TOY_ELBO",
]
