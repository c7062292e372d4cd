"""``Parameter``: an unconstrained tensor with its bijector and optimizer group.

Counterpart of ``zigp_tpu/core/parameters.py``. The module holds one
``nn.Parameter`` named ``raw`` (the unconstrained value), so the torch
parameter names of a model line up with the JAX pytree paths
(``f.kernels.0.lengthscales.raw`` <-> ``.f.kernels[0].lengthscales.raw``,
see ``io.convert``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from . import bijectors


class Parameter(nn.Module):
    def __init__(
        self,
        raw: torch.Tensor,
        bijector: bijectors.Bijector = bijectors.identity,
        *,
        trainable: bool = True,
        lr: Optional[float] = None,
    ):
        super().__init__()
        self.raw = nn.Parameter(raw, requires_grad=trainable)
        self.bijector = bijector
        self.trainable = trainable
        self.lr = lr

    @property
    def value(self) -> torch.Tensor:
        return self.bijector.forward(self.raw)

    @property
    def shape(self):
        return self.raw.shape

    def assign_(self, value) -> None:
        """Set the constrained value in place: its raw (the bijector's
        inverse, in numpy float64) is copied into the storage that exists, so
        a CUDA graph captured over it stays valid. The JAX ``replace_value``."""
        raw = self.bijector.inverse(np.asarray(value, dtype=np.float64))
        with torch.no_grad():
            self.raw.copy_(torch.as_tensor(np.asarray(raw), dtype=self.raw.dtype))

    def extra_repr(self) -> str:
        return f"shape={tuple(self.raw.shape)}, bijector={self.bijector}, lr={self.lr}"


def param(
    value,
    bijector: Optional[bijectors.Bijector] = None,
    *,
    trainable: bool = True,
    lr: Optional[float] = None,
    dtype: torch.dtype = torch.float64,
) -> Parameter:
    """A Parameter from a *constrained* value: the inverse runs in numpy
    float64, then the raw is cast to ``dtype`` (as the JAX ``param`` does)."""
    bijector = bijector or bijectors.identity
    raw = bijector.inverse(np.asarray(value, dtype=np.float64))
    return Parameter(
        torch.as_tensor(np.asarray(raw), dtype=dtype),
        bijector,
        trainable=trainable,
        lr=lr,
    )


def positive_param(value, **kw) -> Parameter:
    return param(value, bijectors.positive, **kw)


def is_parameter(x) -> bool:
    return isinstance(x, Parameter)


def constrained(module: nn.Module) -> dict[str, torch.Tensor]:
    """{raw's parameter name: constrained value} of every raw of ``module``:
    a Parameter's raw maps to its ``.value``, any other tensor passes
    through as it is (the JAX ``constrained(tree)``). The names are those of
    ``lr_labels`` and ``io.convert`` (``f.kernels.0.lengthscales.raw``, the
    JAX leaf ``.f.kernels[0].lengthscales``)."""
    out = {}
    for name, p in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        m = module.get_submodule(owner) if owner else module
        out[name] = m.value if is_parameter(m) and leaf == "raw" else p
    return out


def _label(p: Parameter, default_label: str) -> str:
    if not p.trainable:
        return "frozen"
    return default_label if p.lr is None else f"lr:{p.lr:g}"


def lr_labels(model: nn.Module, default_label: str = "default") -> dict[str, str]:
    """{raw's parameter name: optimizer label}, as ``zigp_tpu``'s ``lr_labels``
    labels the pytree: "frozen" for a non-trainable Parameter, "lr:<value>"
    for one with its own lr, ``default_label`` otherwise."""
    return {
        f"{name}.raw" if name else "raw": _label(m, default_label)
        for name, m in model.named_modules()
        if isinstance(m, Parameter)
    }


def collect_lrs(model: nn.Module, default_lr: float) -> dict[str, float]:
    """{label: lr} of the trainable groups present in ``model``, always with
    "default"; the "frozen" label has no lr and is left out."""
    groups = {"default": default_lr}
    for m in model.modules():
        if isinstance(m, Parameter) and m.trainable and m.lr is not None:
            groups[_label(m, "default")] = m.lr
    return groups


def hyperparam_summary(model: nn.Module, *, max_size: int = 8) -> dict[str, np.ndarray]:
    """{JAX-style path: constrained value} of every trainable Parameter of
    at most ``max_size`` entries: the learned kernel hyperparameters and
    likelihood noise, not the variational or inducing arrays (the JAX
    ``hyperparam_summary``; the runners log one line each)."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, Parameter) and m.trainable and m.raw.numel() <= max_size:
            key = "".join(f"[{p}]" if p.isdigit() else f".{p}" for p in name.split(".")).strip(".")
            out[key] = m.value.detach().cpu().numpy()
    return out
