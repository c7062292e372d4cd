"""Scipy L-BFGS-B over a model's parameters, with torch gradients.

Counterpart of ``zigp_tpu/training/scipy_opt.py:33-78`` (gpflow-0.4's
``Model.optimize()``, notebook cell 10): every parameter's raw, in the
model's order (the JAX pytree's), is flattened into one float64 numpy
vector; each scipy evaluation copies it into the raws, takes one loss and
its gradient by autograd on the model's device, and returns both to the
host in one copy. A frozen parameter (``requires_grad`` off, a JAX
Parameter with ``trainable=False``) gets a zero gradient, so L-BFGS never
moves it. scipy's host round trip per evaluation is inherent, as it is in
the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def scipy_optimize(
    model,
    loss_fn: Optional[Callable] = None,
    *,
    args: Tuple = (),
    maxiter: int = 1000,
    maxfun: Optional[int] = None,
    method: str = "L-BFGS-B",
    callback=None,
    options: Optional[dict] = None,
):
    """Minimize ``loss_fn(model, *args)`` (default: ``model.loss(*args)``)
    over the trainable parameters. The model is updated in place to the
    result; returns (model, scipy result)."""
    from scipy.optimize import minimize

    raws = [p for _, p in model.named_parameters()]
    trainable = [p for p in raws if p.requires_grad]
    sizes = [p.numel() for p in raws]
    p0 = raws[0]

    def _loss():
        return loss_fn(model, *args) if loss_fn is not None else model.loss(*args)

    def assign(x: np.ndarray) -> None:
        flat = torch.from_numpy(np.asarray(x, dtype=np.float64)).to(device=p0.device, dtype=p0.dtype)
        with torch.no_grad():
            for p, part in zip(raws, torch.split(flat, sizes)):
                p.copy_(part.reshape(p.shape))

    def fun(x):
        assign(x)
        loss = _loss()
        grads = torch.autograd.grad(loss, trainable)
        by_raw = iter(grads)
        parts = [next(by_raw).reshape(-1) if p.requires_grad else torch.zeros_like(p).reshape(-1) for p in raws]
        out = torch.cat([loss.detach().reshape(1), *parts]).to(device="cpu", dtype=torch.float64).numpy()
        return float(out[0]), out[1:]

    x0 = torch.cat([p.detach().reshape(-1) for p in raws]).to(device="cpu", dtype=torch.float64).numpy()
    result = minimize(
        fun,
        x0,
        jac=True,
        method=method,
        options={"maxiter": maxiter, **({"maxfun": maxfun} if maxfun else {}), **(options or {})},
        callback=callback,
    )
    assign(result.x)
    return model, result
