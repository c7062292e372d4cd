from . import bijectors, config, parameters  # config: the TF32-off precision pin runs at import
from .parameters import Parameter, param, positive_param

__all__ = ["bijectors", "config", "parameters", "Parameter", "param", "positive_param"]
