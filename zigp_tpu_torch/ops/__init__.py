from . import conditionals, gauss_kl, kernels, linalg, probit, quadrature
from .kernels import (
    RBF,
    Constant,
    Linear,
    Matern,
    Periodic,
    Product,
    RationalQuadratic,
    SquaredExponential,
    Sum,
    White,
)

__all__ = [
    "conditionals",
    "gauss_kl",
    "kernels",
    "linalg",
    "probit",
    "quadrature",
    "RBF",
    "SquaredExponential",
    "Matern",
    "White",
    "Constant",
    "Sum",
    "Product",
    "Periodic",
    "RationalQuadratic",
    "Linear",
]
