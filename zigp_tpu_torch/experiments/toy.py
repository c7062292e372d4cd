"""The toy 1-D on/off GP: the reference notebook's workflow
(zero-inflated-gpflow.ipynb cells 3-12) as a function.

Counterpart of ``zigp_tpu/experiments/toy.py:23-86``: the dense
``OnOffSVGP`` on ``toydata.mat`` (read from ``ZIGP_DATA_DIR``) with the
notebook's config (M = 10 inducing points per GP on a linspace over the x
range, RBF ℓ = 2, σ²f = 1, σ²g = 5, noise 0.01), optimized by scipy's
L-BFGS-B over torch gradients, as gpflow's ``Model.optimize()`` does, or by
Adam through ``training.fit``. The reference's ELBO after its 8000
iterations is ``REFERENCE_TOY_ELBO`` (cell 10's output).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.config import resolve_device
from ..io.datasets import load_toydata
from ..likelihoods import OnOffGaussian
from ..models import OnOffSVGP
from ..ops.kernels import RBF
from .configs import ToyOnOffConfig

REFERENCE_TOY_ELBO = 488.7130771963765


def build_toy_model(
    cfg: Optional[ToyOnOffConfig] = None,
    x: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[OnOffSVGP, np.ndarray, np.ndarray]:
    """(model, x, y): the notebook's model of ``cfg`` on (x, y), or on
    ``toydata.mat`` when they are not given, on ``device`` (``None`` is the
    CUDA card) in ``dtype``."""
    cfg = cfg or ToyOnOffConfig()
    device = resolve_device(device)
    if x is None or y is None:
        x, y, _ = load_toydata()
    # Notebook cell 7: linspace with endpoint=False and the first point
    # dropped, 9 interior knots for num_inducing=10.
    Z = np.delete(np.linspace(x.min(), x.max(), cfg.num_inducing, endpoint=False), 0).reshape(-1, 1)
    model = OnOffSVGP.create(
        RBF.create([cfg.f_lengthscale], cfg.f_variance),
        RBF.create([cfg.g_lengthscale], cfg.g_variance),
        OnOffGaussian.create(cfg.noise_variance),
        Z,
        Z.copy(),
        num_data=x.shape[0],
        jitter=cfg.jitter,
        seed=cfg.seed,
    )
    return model.to(device=device, dtype=dtype), x, y


def run_toy(cfg: Optional[ToyOnOffConfig] = None, *, log_fn=print, device=None,
            dtype: torch.dtype = torch.float32) -> dict:
    """Build the toy model, log its initial ELBO, optimize it with
    ``cfg.optimizer`` ("lbfgs": scipy L-BFGS-B with ``cfg.lbfgs_maxcor``
    pairs; otherwise Adam at lr 1e-2 on the full batch) for ``cfg.maxiter``
    iterations, and log the final ELBO beside the reference's."""
    cfg = cfg or ToyOnOffConfig()
    model, x, y = build_toy_model(cfg, device=device, dtype=dtype)
    p0 = next(model.parameters())
    X, Y = (torch.as_tensor(a, dtype=dtype, device=p0.device) for a in (x, y))

    with torch.no_grad():
        elbo0 = float(model.elbo(X, Y))
    log_fn(f"initial ELBO: {elbo0:.4f}")

    t0 = time.perf_counter()
    result = None
    if cfg.optimizer == "lbfgs":
        from ..training.scipy_opt import scipy_optimize

        model, result = scipy_optimize(model, lambda m: m.loss(X, Y), maxiter=cfg.maxiter,
                                       options={"maxcor": cfg.lbfgs_maxcor})
        log_fn(f"L-BFGS-B: {result.nit} iterations, {result.nfev} evaluations: {result.message}")
    else:
        from ..training import DataSet, fit

        model = fit(model, DataSet(x, y), num_iter=cfg.maxiter, batch_size=x.shape[0], learning_rate=1e-2,
                    log_every=0).model
    seconds = time.perf_counter() - t0

    with torch.no_grad():
        elbo = float(model.elbo(X, Y))
        pred = model.predict(X)
    log_fn(f"final ELBO: {elbo:.10f}  (reference: {REFERENCE_TOY_ELBO:.10f}); optimizer {seconds:.2f} s")
    return {
        "model": model,
        "elbo": elbo,
        "initial_elbo": elbo0,
        "prediction": pred,
        "x": x,
        "y": y,
        "result": result,
        "seconds": seconds,
    }
