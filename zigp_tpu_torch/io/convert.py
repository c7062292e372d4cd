"""Carry a JAX model's parameters into the port, and back.

The keys are the JAX model's pytree paths as ``jax.tree_util.keystr`` prints
them (``.f.kernels[0].lengthscales.raw``); the values are the unconstrained
raws as numpy arrays. The port's parameter names are the same paths in
PyTorch's dotted form (``f.kernels.0.lengthscales.raw``), so the mapping is a
rewrite of the string and needs no JAX.
"""

from __future__ import annotations

import re
from typing import Dict

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


def load_jax_arrays(model: nn.Module, arrays: Dict[str, np.ndarray]) -> None:
    """Copy raws keyed by JAX path into ``model``'s parameters, in place, cast
    to each parameter's dtype and device. Raises on a missing key, an unknown
    key or a shape mismatch, before anything is written."""
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
