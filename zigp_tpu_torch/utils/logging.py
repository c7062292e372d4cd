"""Training observability: scalar and histogram metric logging to JSONL.

A copy of ``zigp_tpu/utils/logging.py`` (the JAX package's module is numpy
only apart from its pytree walk; the port keeps its own): one JSON object per
log call, ``{"step", "wall", <scalars>, "hist/<name>": <percentile
summary>}``, the records the JAX logger writes, so the same tools read both.
On a mesh (``parallel``) rank 0 alone writes and prints.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..io.convert import jax_key
from ..parallel.mesh import is_main_process


def _summarize_array(a: np.ndarray) -> Dict[str, float]:
    a = np.asarray(a, dtype=np.float64).ravel()
    if a.size == 0:
        return {}
    pct = np.percentile(a, [0, 5, 25, 50, 75, 95, 100])
    return {
        "n": int(a.size),
        "mean": float(a.mean()),
        "std": float(a.std()),
        "p0": float(pct[0]),
        "p5": float(pct[1]),
        "p25": float(pct[2]),
        "p50": float(pct[3]),
        "p75": float(pct[4]),
        "p95": float(pct[5]),
        "p100": float(pct[6]),
    }


def _parameter_key(raw_name: str) -> str:
    """``f.kernels.0.lengthscales.raw`` -> ``.f.kernels[0].lengthscales``:
    the JAX path of the Parameter that holds the raw."""
    key = jax_key(raw_name)
    return key[: -len(".raw")] if key.endswith(".raw") else key


class MetricLogger:
    def __init__(self, path: Optional[str] = None, *, also_print: bool = False):
        self.path = path
        self.also_print = also_print
        self._fh = None
        self.writer = is_main_process()
        self.also_print = also_print and self.writer
        if path and self.writer:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, scalars: Optional[Dict[str, Any]] = None,
            histograms: Optional[Dict[str, Any]] = None):
        record: Dict[str, Any] = {"step": int(step), "wall": round(time.time() - self._t0, 3)}
        for k, v in (scalars or {}).items():
            record[k] = float(v)
        for k, v in (histograms or {}).items():
            record[f"hist/{k}"] = _summarize_array(np.asarray(v))
        line = json.dumps(record)
        if self._fh:
            self._fh.write(line + "\n")
        if self.also_print:
            print(line)
        return record

    def log_param_tree(self, step: int, tree, prefix: str = "param"):
        """Histogram-summarize every raw of ``tree``: a model (each
        ``Parameter``'s raw) or ``{raw name: tensor}`` (its gradients), keyed
        by the JAX path of the Parameter, as the JAX logger keys them."""
        items = tree.named_parameters() if isinstance(tree, nn.Module) else tree.items()
        hists = {f"{prefix}{_parameter_key(n)}": _host(t) for n, t in items}
        return self.log(step, histograms=hists)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

