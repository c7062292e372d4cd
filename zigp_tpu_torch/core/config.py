"""Numerics policy: default jitter, device resolution and the matmul precision pin.

Counterpart of ``zigp_tpu/core/config.py``. The JAX package pins every
solve-replacing contraction to exact f32 (``Precision.HIGHEST``) because the
TPU's default bf16 products moved the unwhitened predictive mean by 100x.
On Hopper the reduced-precision default to guard against is TF32: this module
turns it off for matmuls and cuDNN when it is imported, so every float32
product in the port (the blocked ``chol_inv`` panels, the conditional's
projections and factored contractions) runs in full float32.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


# Jitter added to the diagonal of inducing-point grams when a model gives
# none: the float64 default, and the float32 floor (single-precision
# Cholesky needs more regularisation).
JITTER = 1e-6
JITTER_F32 = 1e-5


def default_jitter(dtype: torch.dtype | None = None) -> float:
    dtype = dtype or torch.get_default_dtype()
    return JITTER if dtype == torch.float64 else max(JITTER, JITTER_F32)


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
