"""Numerics policy: float dtype, jitter, device resolution and the matmul precision pin.

Counterpart of ``zigp_tpu/core/config.py``. The JAX package pins every
solve-replacing contraction to exact f32 (``Precision.HIGHEST``) because the
TPU's default bf16 products moved the unwhitened predictive mean by 100x.
On Hopper the reduced-precision default to guard against is TF32: this module
turns it off for matmuls and cuDNN when it is imported, so every float32
product in the port (the blocked ``chol_inv`` panels, the conditional's
projections and factored contractions) runs in full float32.

The jitter is the JAX package's one config point: ``settings()``, read by
``default_jitter`` and overridden for a block of code by ``jitter_level``.
A model reads it once, when it is created (``KronGP.create`` freezes the
pair in force), as the JAX models store ``float(default_jitter())``; after
that no model reads a global, so a CUDA graph captured over a model stays
valid whatever the settings do later.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass
class Settings:
    # Jitter added to the diagonal of inducing-point gram matrices before
    # Cholesky. The gpflow-0.4 default (used by the toy OnOffSVGP path,
    # onoffgpf/OnOffSVGP.py:96) is 1e-6; the pptr scripts use 1e-5.
    jitter: float = 1e-6
    # float32 jitter floor: single-precision Cholesky needs more regularisation.
    jitter_f32: float = 1e-5


_settings = Settings()


def settings() -> Settings:
    return _settings


def default_float() -> torch.dtype:
    """The dtype tensors are made in by default (``torch.get_default_dtype``)."""
    return torch.get_default_dtype()


def jitter_pair() -> tuple[float, float]:
    """The (float64 jitter, float32 floor) in force now: what a model
    created now freezes."""
    return (_settings.jitter, _settings.jitter_f32)


def resolve_jitter(pair: tuple[float, float], dtype: torch.dtype) -> float:
    """The absolute jitter of ``pair`` for a gram of ``dtype``: the float64
    value, or in any other precision the larger of it and the float32 floor
    (the JAX ``default_jitter`` rule)."""
    jitter, jitter_f32 = pair
    return jitter if dtype == torch.float64 else max(jitter, jitter_f32)


def default_jitter(dtype: torch.dtype | None = None) -> float:
    return resolve_jitter(jitter_pair(), dtype or default_float())


@contextmanager
def jitter_level(value: float):
    """Temporarily override the global jitter (both precisions); both values
    are restored on exit, also when the block raises."""
    old = jitter_pair()
    _settings.jitter = value
    _settings.jitter_f32 = value
    try:
        yield
    finally:
        _settings.jitter, _settings.jitter_f32 = old


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA card. There is no quiet CPU fallback: asking
    for the card on a machine without one raises; the CPU is used only when
    the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
