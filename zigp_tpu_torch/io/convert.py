"""Carry a JAX model's parameters into the port, and back.

The keys are the JAX model's pytree paths as ``jax.tree_util.keystr`` prints
them (``.f.kernels[0].lengthscales.raw``); the values are the unconstrained
raws as numpy arrays. The port's parameter names are the same paths in
PyTorch's dotted form (``f.kernels.0.lengthscales.raw``), so the mapping is a
rewrite of the string and needs no JAX. A JAX model's jitter is a static
float, resolved when it was created; it crosses as an explicit jitter.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn


def jax_key(torch_name: str) -> str:
    """``f.kernels.0.lengthscales.raw`` -> ``.f.kernels[0].lengthscales.raw``."""
    return "".join(f"[{p}]" if p.isdigit() else f".{p}" for p in torch_name.split("."))


def torch_name(jax_path: str) -> str:
    """``.f.kernels[0].lengthscales.raw`` -> ``f.kernels.0.lengthscales.raw``."""
    return re.sub(r"\[(\d+)\]", r".\1", jax_path).lstrip(".")


def dump_arrays(model: nn.Module) -> Dict[str, np.ndarray]:
    """Every parameter's raw value as numpy, keyed by its JAX path."""
    return {jax_key(n): p.detach().cpu().numpy().copy() for n, p in model.named_parameters()}


def set_jitter(model: nn.Module, jitter: float) -> None:
    """Give every GP of ``model`` (each submodule with ``jitter_for``) the
    explicit ``jitter``: the float a JAX model stores (``KronGP.jitter``,
    resolved when it was created)."""
    for m in model.modules():
        if hasattr(m, "jitter_for"):
            m.jitter = float(jitter)


def load_jax_arrays(model: nn.Module, arrays: Dict[str, np.ndarray], *, jitter: Optional[float] = None) -> None:
    """Copy raws keyed by JAX path into ``model``'s parameters, in place, cast
    to each parameter's dtype and device. Raises on a missing key, an unknown
    key or a shape mismatch, before anything is written. ``jitter``: the JAX
    model's stored jitter, carried across as the port model's explicit one
    (``set_jitter``)."""
    params = dict(model.named_parameters())
    expected = {jax_key(n): n for n in params}
    missing = sorted(set(expected) - set(arrays))
    unknown = sorted(set(arrays) - set(expected))
    if missing or unknown:
        raise KeyError(f"load_jax_arrays: missing keys {missing}, unknown keys {unknown}")
    for key, name in expected.items():
        shape = tuple(np.shape(arrays[key]))
        if shape != tuple(params[name].shape):
            raise ValueError(
                f"load_jax_arrays: {key} has shape {shape}, the model expects "
                f"{tuple(params[name].shape)}"
            )
    with torch.no_grad():
        for key, name in expected.items():
            p = params[name]
            p.copy_(torch.as_tensor(np.asarray(arrays[key]), dtype=p.dtype))
    if jitter is not None:
        set_jitter(model, jitter)


def stack_size(stack: nn.Module) -> int:
    """The member count of a member stack (``training.batched.stack_models``);
    raises for anything else."""
    size = getattr(stack, "stack_size", None)
    if size is None:
        raise TypeError(f"{type(stack).__name__} is not a member stack (training.batched.stack_models)")
    return size


def dump_stack(stack: nn.Module) -> Dict[str, np.ndarray]:
    """A member stack's raws (``training.batched.stack_models``) as numpy,
    keyed by JAX path, each with the leading member axis F: the layout of
    the JAX package's stacked pytree (``stack_pytrees``)."""
    stack_size(stack)
    return dump_arrays(stack)


def load_jax_stack(stack: nn.Module, arrays: Dict[str, np.ndarray]) -> None:
    """Copy the JAX package's stacked pytree (a leading F on every leaf, as
    numpy, keyed by JAX path) into ``stack``'s raws, in place. Raises on a
    missing or unknown key, or a shape mismatch (the member count
    included), before anything is written."""
    stack_size(stack)
    load_jax_arrays(stack, arrays)
