"""The kernel zoo: the squared-exponential (RBF), Matérn (ν = 1/2, 3/2, 5/2),
white noise, constant, periodic, rational quadratic and linear kernels, and
their ``Sum`` and ``Product``.

Counterpart of ``zigp_tpu/ops/kernels.py``, with the same formulas and field
names. The RBF gram uses the exact pairwise-difference form below 16 input
dimensions: the expansion form computes O(1) distances as differences of
O((x/ℓ)²) terms, and with the pptr time column (t ≈ 5, ℓ ≈ 0.005, so
(x/ℓ)² ≈ 10⁶) float32 cancellation makes the factor gram indefinite. Matérn
and the rational quadratic always take the difference form, as in the JAX
package.

Each family is an ``nn.Module`` whose ``values()`` returns a ``NamedTuple``
of its constrained hyperparameters with any leading batch dimensions, and
of its static fields (``active_dims``, Matérn's ``nu2``), which are not
stacked. Its ``K``/``Kdiag`` work over the leading dims, which is how the
on/off model evaluates the f and g kernels of a pair in one pass (a stacked
leading dim of 2 in place of the JAX ``vmap``). A composite's values are the
``NamedTuple`` of its children's values. Inputs are (..., N, D); a 2-D input
is shared by the batch.

``SquaredExponential.use_kernel`` is the counterpart of the JAX
``use_pallas`` (default off): the gram then comes from ``ops.cuda.rbf_gram``
— the CUDA kernel for float32 on the card, its plain version on the CPU —
while float64 on the card keeps the gram below, as the JAX package keeps
XLA's for anything but float32. The flag is not one of the values: the model
passes it to ``K`` as ``kernel_flags()`` gives it, a bool for an RBF leaf, a
pair of flags for a composite and False for the other families. The other
families are plain torch, as they are plain jnp in the JAX package: no
Pallas kernel computes them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.parameters import positive_param
from . import linalg
from .cuda.rbf_gram import rbf_gram

_EXPANSION_MIN_DIM = 16


def _pick(X: torch.Tensor, dims: Optional[Tuple[int, ...]]) -> torch.Tensor:
    """The columns ``dims`` of X (..., N, D), without building an index
    tensor from host data (a copy a captured step cannot make): a slice for
    a run of consecutive columns, else a stack of single columns."""
    if dims is None:
        return X
    if dims == tuple(range(dims[0], dims[0] + len(dims))):
        return X[..., dims[0]:dims[0] + len(dims)]
    return torch.stack([X[..., d] for d in dims], -1)


def _diff_square_dist(X, X2):
    """Σ_d (x_d − x2_d)² of already-scaled X (..., N, D) and X2 (..., N2, D)."""
    return torch.sum(torch.square(X[..., :, None, :] - X2[..., None, :, :]), dim=-1)


def square_dist(X, X2, lengthscales):
    """Scaled squared distances: X (..., N, D), X2 (..., N2, D) or None,
    lengthscales (..., D) -> (..., N, N2)."""
    ell = lengthscales[..., None, :]
    X = X / ell
    X2 = X if X2 is None else X2 / ell
    if X.shape[-1] < _EXPANSION_MIN_DIM:
        return _diff_square_dist(X, X2)
    Xs = torch.sum(torch.square(X), dim=-1)
    X2s = torch.sum(torch.square(X2), dim=-1)
    return -2.0 * (X @ X2.transpose(-1, -2)) + Xs[..., :, None] + X2s[..., None, :]


def _const_diag(v: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """The (..., N) diagonal σ², σ² (...) expanded with no host value (a
    ``torch.full`` from a tensor would read it on the host)."""
    v = v[..., None]
    return v.expand(*v.shape[:-1], X.shape[-2])


def _flag_pair(use_kernel) -> tuple:
    return use_kernel if isinstance(use_kernel, tuple) else (use_kernel, use_kernel)


class RBFValues(NamedTuple):
    """Constrained RBF hyperparameters: lengthscales (..., D), variance (...)."""

    lengthscales: torch.Tensor
    variance: torch.Tensor
    active_dims: Optional[Tuple[int, ...]] = None

    def K(self, X, X2: Optional[torch.Tensor] = None, *, use_kernel: bool = False):
        X = _pick(X, self.active_dims)
        X2 = None if X2 is None else _pick(X2, self.active_dims)
        if use_kernel and (X.device.type == "cpu" or X.dtype == torch.float32):
            X = X.contiguous()
            return rbf_gram(X, X if X2 is None else X2.contiguous(), self.lengthscales, self.variance)
        d2 = square_dist(X, X2, self.lengthscales)
        return self.variance[..., None, None] * torch.exp(-0.5 * d2)

    def Kdiag(self, X):
        return _const_diag(self.variance, X)


class MaternValues(NamedTuple):
    """Constrained Matérn hyperparameters; ``nu2`` is 2ν (1, 3 or 5)."""

    lengthscales: torch.Tensor
    variance: torch.Tensor
    nu2: int = 3
    active_dims: Optional[Tuple[int, ...]] = None

    def K(self, X, X2: Optional[torch.Tensor] = None, *, use_kernel=False):
        ell = self.lengthscales[..., None, :]
        X = _pick(X, self.active_dims) / ell
        X2 = X if X2 is None else _pick(X2, self.active_dims) / ell
        # safe sqrt: value exact, gradient finite at r = 0
        r = torch.sqrt(torch.clamp(_diff_square_dist(X, X2), min=1e-36))
        v = self.variance[..., None, None]
        if self.nu2 == 1:
            return v * torch.exp(-r)
        if self.nu2 == 3:
            s = math.sqrt(3.0) * r
            return v * (1.0 + s) * torch.exp(-s)
        s = math.sqrt(5.0) * r
        return v * (1.0 + s + torch.square(s) / 3.0) * torch.exp(-s)

    def Kdiag(self, X):
        return _const_diag(self.variance, X)


class WhiteValues(NamedTuple):
    """σ²·I on matching inputs (X2 None), 0 cross-covariance."""

    variance: torch.Tensor

    def K(self, X, X2: Optional[torch.Tensor] = None, *, use_kernel=False):
        if X2 is None:
            eye = torch.eye(X.shape[-2], dtype=X.dtype, device=X.device)
            return self.variance[..., None, None] * eye
        batch = torch.broadcast_shapes(self.variance.shape, X.shape[:-2], X2.shape[:-2])
        return torch.zeros((*batch, X.shape[-2], X2.shape[-2]), dtype=X.dtype, device=X.device)

    def Kdiag(self, X):
        return _const_diag(self.variance, X)


class ConstantValues(NamedTuple):
    """σ² everywhere."""

    variance: torch.Tensor

    def K(self, X, X2: Optional[torch.Tensor] = None, *, use_kernel=False):
        v = self.variance[..., None, None]
        n2 = X.shape[-2] if X2 is None else X2.shape[-2]
        return v.expand(*v.shape[:-2], X.shape[-2], n2)

    def Kdiag(self, X):
        return _const_diag(self.variance, X)


class PeriodicValues(NamedTuple):
    """Constrained periodic hyperparameters: lengthscales and period (..., D),
    variance (...)."""

    lengthscales: torch.Tensor
    period: torch.Tensor
    variance: torch.Tensor
    active_dims: Optional[Tuple[int, ...]] = None

    def K(self, X, X2: Optional[torch.Tensor] = None, *, use_kernel=False):
        X = _pick(X, self.active_dims)
        X2 = X if X2 is None else _pick(X2, self.active_dims)
        diff = X[..., :, None, :] - X2[..., None, :, :]
        per = self.period[..., None, None, :]
        s = torch.sin(math.pi * diff / per) / self.lengthscales[..., None, None, :]
        return self.variance[..., None, None] * torch.exp(-2.0 * torch.sum(torch.square(s), dim=-1))

    def Kdiag(self, X):
        return _const_diag(self.variance, X)


class RationalQuadraticValues(NamedTuple):
    """Constrained rational-quadratic hyperparameters: lengthscales (..., D),
    variance and the mixture weight alpha (...)."""

    lengthscales: torch.Tensor
    variance: torch.Tensor
    alpha: torch.Tensor
    active_dims: Optional[Tuple[int, ...]] = None

    def K(self, X, X2: Optional[torch.Tensor] = None, *, use_kernel=False):
        ell = self.lengthscales[..., None, :]
        X = _pick(X, self.active_dims) / ell
        X2 = X if X2 is None else _pick(X2, self.active_dims) / ell
        d2 = _diff_square_dist(X, X2)
        a = self.alpha[..., None, None]
        return self.variance[..., None, None] * torch.pow(1.0 + d2 / (2.0 * a), -a)

    def Kdiag(self, X):
        return _const_diag(self.variance, X)


class LinearValues(NamedTuple):
    """Per-dimension variances (..., D) of σ²·⟨x, x'⟩."""

    variances: torch.Tensor
    active_dims: Optional[Tuple[int, ...]] = None

    def K(self, X, X2: Optional[torch.Tensor] = None, *, use_kernel=False):
        X = _pick(X, self.active_dims)
        X2 = X if X2 is None else _pick(X2, self.active_dims)
        return linalg.bdot(X * self.variances[..., None, :], X2.transpose(-1, -2))

    def Kdiag(self, X):
        X = _pick(X, self.active_dims)
        return torch.sum(X * self.variances[..., None, :] * X, dim=-1)


class SumValues(NamedTuple):
    k1: tuple
    k2: tuple

    def K(self, X, X2: Optional[torch.Tensor] = None, *, use_kernel=False):
        f1, f2 = _flag_pair(use_kernel)
        return self.k1.K(X, X2, use_kernel=f1) + self.k2.K(X, X2, use_kernel=f2)

    def Kdiag(self, X):
        return self.k1.Kdiag(X) + self.k2.Kdiag(X)


class ProductValues(NamedTuple):
    k1: tuple
    k2: tuple

    def K(self, X, X2: Optional[torch.Tensor] = None, *, use_kernel=False):
        f1, f2 = _flag_pair(use_kernel)
        return self.k1.K(X, X2, use_kernel=f1) * self.k2.K(X, X2, use_kernel=f2)

    def Kdiag(self, X):
        return self.k1.Kdiag(X) * self.k2.Kdiag(X)


def _dims(active_dims) -> Optional[Tuple[int, ...]]:
    return tuple(int(d) for d in active_dims) if active_dims is not None else None


def _vec(x) -> np.ndarray:
    return np.atleast_1d(np.asarray(x, dtype=np.float64))


class Kernel(nn.Module):
    """What every family shares: ``K``/``Kdiag`` through ``values()``, the
    gram-kernel flags (none but an RBF leaf's), and ``signature()``: the
    family tree and its static fields, which two GPs must share to run as
    one stacked pass (the JAX package compares tree structures)."""

    def kernel_flags(self):
        return False

    def _static(self) -> tuple:
        return (getattr(self, "active_dims", None),)

    def signature(self) -> tuple:
        return (type(self).__name__, *self._static())

    def K(self, X, X2=None):
        return self.values().K(X, X2, use_kernel=self.kernel_flags())

    def Kdiag(self, X):
        return self.values().Kdiag(X)


class SquaredExponential(Kernel):
    """ARD squared-exponential kernel σ² exp(-½ Σ_d (x_d - x'_d)²/ℓ_d²)."""

    def __init__(self, lengthscales, variance, use_kernel: bool = False, active_dims=None):
        super().__init__()
        self.lengthscales = lengthscales
        self.variance = variance
        self.use_kernel = use_kernel
        self.active_dims = _dims(active_dims)

    @classmethod
    def create(cls, lengthscales, variance, active_dims=None, lr=None,
               use_kernel: bool = False) -> "SquaredExponential":
        return cls(positive_param(_vec(lengthscales), lr=lr), positive_param(variance, lr=lr), use_kernel,
                   active_dims)

    def kernel_flags(self) -> bool:
        return self.use_kernel

    def _static(self) -> tuple:
        return self.active_dims, self.use_kernel

    def values(self) -> RBFValues:
        return RBFValues(self.lengthscales.value, self.variance.value, self.active_dims)


RBF = SquaredExponential

_NU2 = {"1/2": 1, "3/2": 3, "5/2": 5}


class Matern(Kernel):
    """Matérn kernel (ν ∈ {1/2, 3/2, 5/2}) with ARD lengthscales."""

    def __init__(self, lengthscales, variance, nu2: int = 3, active_dims=None):
        super().__init__()
        self.lengthscales = lengthscales
        self.variance = variance
        self.nu2 = int(nu2)
        self.active_dims = _dims(active_dims)

    @classmethod
    def create(cls, lengthscales, variance, nu: str = "3/2", active_dims=None, lr=None) -> "Matern":
        return cls(positive_param(_vec(lengthscales), lr=lr), positive_param(variance, lr=lr), _NU2[nu],
                   active_dims)

    def _static(self) -> tuple:
        return self.nu2, self.active_dims

    def values(self) -> MaternValues:
        return MaternValues(self.lengthscales.value, self.variance.value, self.nu2, self.active_dims)


class White(Kernel):
    """White-noise kernel: σ²·I on matching inputs, 0 cross-covariance."""

    def __init__(self, variance):
        super().__init__()
        self.variance = variance

    @classmethod
    def create(cls, variance: float = 1.0, lr=None) -> "White":
        return cls(positive_param(variance, lr=lr))

    def values(self) -> WhiteValues:
        return WhiteValues(self.variance.value)


class Constant(Kernel):
    """Constant (bias) kernel: σ² everywhere."""

    def __init__(self, variance):
        super().__init__()
        self.variance = variance

    @classmethod
    def create(cls, variance: float = 1.0, lr=None) -> "Constant":
        return cls(positive_param(variance, lr=lr))

    def values(self) -> ConstantValues:
        return ConstantValues(self.variance.value)


class Periodic(Kernel):
    """Exact periodic (MacKay) kernel σ²·exp(−2 Σ_d sin²(π(x−x')_d/p_d)/ℓ_d²),
    ARD lengthscales and periods."""

    def __init__(self, lengthscales, period, variance, active_dims=None):
        super().__init__()
        self.lengthscales = lengthscales
        self.period = period
        self.variance = variance
        self.active_dims = _dims(active_dims)

    @classmethod
    def create(cls, lengthscales, period, variance, active_dims=None, lr=None) -> "Periodic":
        return cls(positive_param(_vec(lengthscales), lr=lr), positive_param(_vec(period), lr=lr),
                   positive_param(variance, lr=lr), active_dims)

    def values(self) -> PeriodicValues:
        return PeriodicValues(self.lengthscales.value, self.period.value, self.variance.value, self.active_dims)


class RationalQuadratic(Kernel):
    """σ²·(1 + r²/(2α))^−α with ARD lengthscales and a trainable α."""

    def __init__(self, lengthscales, variance, alpha, active_dims=None):
        super().__init__()
        self.lengthscales = lengthscales
        self.variance = variance
        self.alpha = alpha
        self.active_dims = _dims(active_dims)

    @classmethod
    def create(cls, lengthscales, variance, alpha: float = 1.0, active_dims=None,
               lr=None) -> "RationalQuadratic":
        return cls(positive_param(_vec(lengthscales), lr=lr), positive_param(variance, lr=lr),
                   positive_param(alpha, lr=lr), active_dims)

    def values(self) -> RationalQuadraticValues:
        return RationalQuadraticValues(self.lengthscales.value, self.variance.value, self.alpha.value,
                                       self.active_dims)


class Linear(Kernel):
    """σ²·⟨x, x'⟩ (dot-product kernel) with ARD per-dimension variances."""

    def __init__(self, variances, active_dims=None):
        super().__init__()
        self.variances = variances
        self.active_dims = _dims(active_dims)

    @classmethod
    def create(cls, variances, active_dims=None, lr=None) -> "Linear":
        return cls(positive_param(_vec(variances), lr=lr), active_dims)

    def values(self) -> LinearValues:
        return LinearValues(self.variances.value, self.active_dims)


class _Composite(Kernel):
    """Two kernels over the same inputs (``active_dims`` on the children for
    separable combinations over input blocks); per-group learning rates ride
    on the children's Parameters."""

    _values = None  # the composite's NamedTuple of its children's values

    def __init__(self, k1, k2):
        super().__init__()
        self.k1 = k1
        self.k2 = k2

    @classmethod
    def create(cls, k1, k2):
        return cls(k1, k2)

    def kernel_flags(self) -> tuple:
        return self.k1.kernel_flags(), self.k2.kernel_flags()

    def signature(self) -> tuple:
        return type(self).__name__, self.k1.signature(), self.k2.signature()

    def values(self):
        return self._values(self.k1.values(), self.k2.values())


class Sum(_Composite):
    """k₁ + k₂."""

    _values = SumValues


class Product(_Composite):
    """k₁ · k₂."""

    _values = ProductValues


def flag_leaves(flags) -> list:
    """The leaves of a ``kernel_flags()`` tree, in order: one bool per RBF
    leaf and per other leaf (False)."""
    if isinstance(flags, tuple):
        return [leaf for f in flags for leaf in flag_leaves(f)]
    return [bool(flags)]
