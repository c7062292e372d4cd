"""Serving runner: batched prediction over a large input set.

Counterpart of ``zigp_tpu/experiments/runners.py:55-80`` (``predict_batched``).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..core.config import resolve_device


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
