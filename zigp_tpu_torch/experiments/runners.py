"""Runners: batched prediction over a large input set, and the on/off
model's training.

Counterpart of ``zigp_tpu/experiments/runners.py``: ``predict_batched``
(:55-80) and the training half of ``run_onoff`` / ``_fit_auto`` (:83-275) as
``train_onoff_pptr``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..core.config import resolve_device
from ..io.datasets import Split
from ..training import DataSet, FitResult, cosine_adam, fit_scanned, make_optimizer
from .builders import build_onoff_pptr
from .configs import OnOffPptrConfig


def train_onoff_pptr(
    cfg: OnOffPptrConfig,
    split: Split,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
    model=None,
    log_fn: Callable[[str], None] = print,
) -> FitResult:
    """Build the on/off model of ``cfg`` for ``split`` (or take ``model``)
    and train it for ``cfg.num_iter`` steps in blocks of ``cfg.scan_inner``
    at ``cfg.batch_size``, by ``cfg.sampler``, with per-lr-group Adam (cosine
    decay over ``cfg.num_iter`` when ``cfg.lr_schedule == "cosine"``), as the
    JAX package's scanned path does. ``device=None`` is the CUDA card;
    ``use_kernel`` builds the factor grams with the ``rbf_gram`` kernel.

    What the port does not have raises ``NotImplementedError``: natural
    gradients, the block-coordinate schedule (``hyper_every``), meshes, and
    the per-step loop that the JAX package takes when ``scan_inner`` is 0 or
    longer than the run."""
    unported = [
        what
        for what, on in (
            ("optimizer='natgrad'", cfg.optimizer == "natgrad"),
            ("hyper_every > 0", cfg.hyper_every > 0),
            ("mesh_data/mesh_model", bool(cfg.mesh_data or cfg.mesh_model)),
            ("the per-step fit (scan_inner 0 or > num_iter)", not 0 < cfg.scan_inner <= cfg.num_iter),
        )
        if on
    ]
    if unported:
        raise NotImplementedError(f"train_onoff_pptr: {unported} not ported to zigp_tpu_torch yet")
    if cfg.optimizer != "adam":
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if model is None:
        model = build_onoff_pptr(cfg, split, device=device, dtype=dtype, use_kernel=use_kernel)
    schedule = cosine_adam(cfg.num_iter) if cfg.lr_schedule == "cosine" else None
    optimizer = make_optimizer(model, default_lr=cfg.indp_lr, schedule=schedule)
    return fit_scanned(
        model,
        DataSet(split.Xtrain, split.Ytrain),
        num_iter=cfg.num_iter,
        batch_size=cfg.batch_size,
        num_inner=cfg.scan_inner,
        optimizer=optimizer,
        log_every_blocks=max(1, cfg.log_every // cfg.scan_inner) if cfg.log_every else 0,
        log_fn=log_fn,
        sampler=cfg.sampler,
        sampler_seed=cfg.seed,
    )


def predict_batched(
    predict_fn: Callable,
    X: np.ndarray,
    batch: int = 4096,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, np.ndarray]:
    """Run ``predict_fn`` over X in fixed-shape chunks of ``batch`` rows.

    ``predict_fn(X_chunk)`` returns a NamedTuple or dict of (batch, k)
    tensors. X goes to ``device`` (``None`` = the CUDA card) in one copy; the
    last chunk is padded to ``batch`` rows by repeating its last row. Every
    chunk is launched before the one copy of all results to the host at the
    end, so the host never waits on the card between chunks. Runs under
    ``torch.inference_mode()``."""
    device = resolve_device(device)
    N = X.shape[0]
    with torch.inference_mode():
        Xd = torch.as_tensor(np.asarray(X), dtype=dtype).to(device)
        names = None
        widths = None
        pending = []
        for start in range(0, N, batch):
            chunk = Xd[start : start + batch]
            pad = batch - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk[-1:].expand(pad, -1)], dim=0)
            res = predict_fn(chunk)
            d = res._asdict() if hasattr(res, "_asdict") else dict(res)
            if names is None:
                names = list(d)
                widths = [d[k].shape[-1] for k in names]
            pending.append(torch.cat([d[k] for k in names], dim=-1)[: batch - pad])
        if not pending:
            return {}
        host = torch.cat(pending, dim=0).cpu().numpy()
    cols = np.cumsum([0] + widths)
    return {k: host[:, cols[i] : cols[i + 1]] for i, k in enumerate(names)}
