"""Ahead-of-time export of a trained model's predict function for serving.

Counterpart of ``zigp_tpu/io/export.py``. The JAX package lowers the predict
function once to StableHLO with the parameters baked in; here it is
``torch.export.export`` of a small module around ``model.predict`` (the
model's own predict, not ``predict_batched`` and its chunk graph), with the
parameters carried in the program and the batch dimension a
``torch.export.Dim`` unless ``batch_size`` pins it.

Artifact layout: one file, a JSON metadata line (its own magic, the kind,
the input width, the batch, the device type and dtype the program was traced
for, the torch version, the output names), ``\\n``, then the bytes of
``torch.export.save``. Each package's loader refuses the other's artifact by
its magic.

What loading needs: torch, and the port's op registrations
(``zigp_tpu_torch.ops.cuda``, which ``load_predictor`` imports). Not the
model code, not the checkpoint. A program traced on the card calls the
hand-written kernels through those registered ops (``zigp_tpu_torch::
chol_inv``, ``chol_inv_blocked``, ``rbf_gram``, wherever the model's
factorizations and grams take them) and serves on the card; one traced on
the CPU takes the CPU path (the library factorization, and the plain gram
where the model's gram kernel flag is on) and serves on the CPU.

The parameters are constants of the program: export again after more
training.
"""

from __future__ import annotations

import io
import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

_MAGIC = "zigp-torch-export-v1"
_JAX_MAGIC = "zigp-export-v1"  # the JAX package's artifacts


def _predict_dict_fn(model, kind: str) -> Callable:
    """A predict function returning a plain dict of tensors (the JAX
    package's fields: the classifier's ``p`` is the pair (p, p − p²))."""
    if kind in ("onoff", "hurdlej"):
        return lambda X: dict(model.predict(X)._asdict())
    if kind == "svgp":

        def fn(X):
            mean, var = model.predict_f(X)
            return {"fmean": mean, "fvar": var}

        return fn
    if kind == "classifier":

        def fn(X):  # ``model.predict_prob`` on the one conditional: one factorization a call
            mean, var = model.predict_f(X)
            p = model.likelihood.predict_prob(mean, var)
            return {"fmean": mean, "fvar": var, "p": (p, p - torch.square(p))}

        return fn
    raise ValueError(f"unknown export kind {kind!r} (onoff|svgp|classifier|hurdlej)")


class _Predictor(torch.nn.Module):
    """The module ``torch.export`` traces: the model and its predict dict."""

    def __init__(self, model, kind: str):
        super().__init__()
        self.model = model
        self.fn = _predict_dict_fn(model, kind)

    def forward(self, X):
        return self.fn(X)


def export_predictor(model, kind: str, d_in: int, path: str, *, batch_size: Optional[int] = None) -> str:
    """Write ``model``'s predict function to the artifact ``path``.

    The program is traced on the model's device in its dtype. ``batch_size``
    None (the default) exports a symbolic batch, so the loaded predictor
    takes any number of rows; an int pins it. The model is run once on two
    rows first (which also fills its cached device constants, such as the
    quadrature nodes, with real tensors). Returns ``path``."""
    fn = _predict_dict_fn(model, kind)
    p = next(model.parameters())
    device, dtype = p.device, p.dtype
    rows = 2 if batch_size is None else int(batch_size)
    example = torch.zeros((rows, int(d_in)), dtype=dtype, device=device)
    dynamic = {"X": {0: torch.export.Dim("batch", min=1)}} if batch_size is None else None
    with torch.no_grad():
        outputs = sorted(fn(example))
        program = torch.export.export(_Predictor(model, kind).eval(), (example,), dynamic_shapes=dynamic,
                                      strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    meta = {
        "magic": _MAGIC,
        "kind": kind,
        "d_in": int(d_in),
        "batch_size": None if batch_size is None else int(batch_size),
        "device": device.type,
        "dtype": str(dtype).removeprefix("torch."),
        "torch_version": torch.__version__,
        "outputs": outputs,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(json.dumps(meta).encode("utf-8"))
        f.write(b"\n")
        f.write(buf.getvalue())
    return path


def _to_numpy(v):
    if isinstance(v, (tuple, list)):
        return np.stack([_to_numpy(t) for t in v])
    return v.detach().cpu().numpy()


class ServedPredictor:
    """A loaded artifact: ``pred(X) -> dict[str, np.ndarray]``."""

    def __init__(self, program, meta: Dict):
        self._program = program
        self._module = program.module()
        self.meta = meta
        self.device = torch.device(meta["device"])
        self.dtype = getattr(torch, meta["dtype"])

    def __call__(self, X, *, as_numpy: bool = True):
        """Serve one request of (n, d_in) rows. ``as_numpy=False`` returns
        the program's tensors on its device without waiting for them."""
        X = torch.as_tensor(np.asarray(X) if not isinstance(X, torch.Tensor) else X)
        if X.ndim != 2 or X.shape[1] != self.meta["d_in"]:
            raise ValueError(f"expected (n, {self.meta['d_in']}) input, got {tuple(X.shape)}")
        b = self.meta.get("batch_size")
        if b is not None and X.shape[0] != b:
            raise ValueError(
                f"artifact was exported with fixed batch {b}, got {X.shape[0]} "
                "rows (re-export with batch_size=None for a symbolic batch)"
            )
        with torch.no_grad():
            out = self._module(X.to(device=self.device, dtype=self.dtype))
        if not as_numpy:
            return out
        return {k: _to_numpy(v) for k, v in out.items()}


def load_predictor(path: str) -> ServedPredictor:
    """Load an artifact written by :func:`export_predictor`. Imports
    ``zigp_tpu_torch.ops.cuda`` first, which registers the ops a program
    traced on the card calls."""
    from ..ops import cuda  # noqa: F401  (registers zigp_tpu_torch::chol_inv, ::chol_inv_blocked, ::rbf_gram)

    with open(path, "rb") as f:
        raw = f.read()
    head, _, blob = raw.partition(b"\n")
    try:
        meta = json.loads(head.decode("utf-8"))
    except Exception as e:  # noqa: BLE001 — one error for every unreadable header
        raise ValueError(f"{path} is not a zigp_tpu_torch export artifact: {e}") from None
    magic = meta.get("magic") if isinstance(meta, dict) else None
    if magic == _JAX_MAGIC:
        raise ValueError(f"{path} is a zigp_tpu (JAX) export artifact, not a zigp_tpu_torch one: "
                         "load it with zigp_tpu.io.export.load_predictor")
    if magic != _MAGIC:
        raise ValueError(f"{path} is not a zigp_tpu_torch export artifact")
    return ServedPredictor(torch.export.load(io.BytesIO(blob)), meta)
