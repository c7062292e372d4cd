"""Diagnostic plots, in two halves: the panels and the drawing.

Counterpart of ``zigp_tpu/utils/plotting.py``:

- ``plot_onoff_1d``: the toy diagnostic (onoffgpf/PlotOnOff1D.py:8-157):
  data and the gated prediction with its band, the signal GP f, the gate
  probability Φ(g), the support GP g, and for the dense ``OnOffSVGP`` the
  column of kernel-matrix heat maps over the training inputs: Φ(g)Φ(g)ᵀ∘K_f,
  K_f, Φ(g)Φ(g)ᵀ and K_g;
- ``plot_inducing_monitor``: the training-time monitor of the Kronecker
  on/off model (scripts/onoff.py:394-423): the mean target per time index
  and the temporal slices of u_fm and u_gm.

Each is split in two: ``onoff_1d_panels`` / ``inducing_monitor_panels``
return every array a panel draws, as numpy, computed on the model's device
(predictions and grams under ``torch.no_grad``); ``draw_onoff_1d`` /
``draw_inducing_monitor`` draw them with matplotlib, imported there, so a
machine without it (the card's) still computes the panels. The monitor's
grouping is numpy's, not pandas'. ``require_matplotlib`` lets a caller stop
before any work when the drawing would fail after it.
"""

from __future__ import annotations

import importlib.util
from typing import Optional

import numpy as np
import torch

MONITOR_SLICES = 128  # the monitor's cap on plotted slices: an exogenous grid multiplies the site count


def require_matplotlib(what: str) -> None:
    """Stop with a message naming matplotlib when it is not installed."""
    if importlib.util.find_spec("matplotlib") is None:
        raise SystemExit(f"error: {what} needs matplotlib, which is not installed; the panels "
                         "(zigp_tpu_torch.utils.plotting.*_panels) need no matplotlib")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def onoff_1d_panels(model, x: np.ndarray, y: np.ndarray, heatmaps: bool = True) -> dict:
    """Every array ``plot_onoff_1d`` draws, over the inputs sorted by x:
    ``xs``, ``ys``; the gated prediction ``gf`` and its band ``band``
    (±1.5·(√fvar·Φ̄ + √pgvar·(1−Φ̄) + √σ²), PlotOnOff1D.py:56-58); ``fm``,
    ``fs`` (f's mean and sd), ``pg`` (E[Φ(g)]), ``gm``, ``gs``; ``Zf`` and
    ``Zg`` when the model has them; with ``heatmaps`` and a dense model
    (``kernf``, ``kerng``) ``heat``: the four kernel matrices by title."""
    p = next(model.parameters())
    order = np.argsort(x[:, 0])
    with torch.no_grad():
        pred = model.predict(torch.as_tensor(np.asarray(x), dtype=p.dtype, device=p.device))
        col = lambda a: _np(a)[order, 0]
        sd = lambda a: np.sqrt(np.maximum(col(a), 0.0))
        y_col = y if y.ndim > 1 else y[:, None]
        out = {"xs": x[order, 0], "ys": np.asarray(y_col)[order, 0], "gf": col(pred.gfmean), "fm": col(pred.fmean),
               "fs": sd(pred.fvar), "pg": col(pred.pgmean), "gm": col(pred.gmean), "gs": sd(pred.gvar)}
        lik = getattr(model, "likelihood", None)
        noise_sd = float(np.sqrt(_np(lik.variance.value))) if lik is not None and hasattr(lik, "variance") else 0.0
        out["band"] = 1.5 * (out["fs"] * out["pg"] + sd(pred.pgvar) * (1.0 - out["pg"]) + noise_sd)
        for name in ("Zf", "Zg"):
            if hasattr(model, name):
                out[name] = _np(getattr(model, name).value)[:, 0]
        if heatmaps and hasattr(model, "kernf") and hasattr(model, "kerng"):
            Xs = torch.as_tensor(np.asarray(x)[order], dtype=p.dtype, device=p.device)
            Kf, Kg = _np(model.kernf.K(Xs)), _np(model.kerng.K(Xs))
            Kpg = out["pg"][:, None] * out["pg"][None, :]
            out["heat"] = {"sparse kernel  Φ(g)Φ(g)ᵀ∘K_f": Kpg * Kf, "latent kernel  K_f": Kf,
                           "probit kernel  Φ(g)Φ(g)ᵀ": Kpg, "latent kernel  K_g": Kg}
    return out


def draw_onoff_1d(panels: dict, save_path: Optional[str] = None):
    """Draw ``onoff_1d_panels``'s arrays; the path written, or the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.gridspec as gridspec
    import matplotlib.pyplot as plt

    xs = panels["xs"]
    heat = panels.get("heat")
    if heat:
        fig = plt.figure(figsize=(13, 12))
        grid = gridspec.GridSpec(4, 4)
        axes = [plt.subplot(grid[i, 0:-1]) for i in range(4)]
        heat_axes = [plt.subplot(grid[i, -1]) for i in range(4)]
    else:
        fig, axes = plt.subplots(4, 1, figsize=(10, 12), sharex=True)

    ax = axes[0]
    ax.plot(xs, panels["ys"], "k.", ms=3, label="y")
    gf, band = panels["gf"], panels["band"]
    ax.plot(xs, gf, "b-", label="E[Φ(g)·f]")
    ax.fill_between(xs, gf - band, gf + band, alpha=0.2)
    ax.set_title("data and gated prediction")
    ax.legend(loc="best", fontsize=8)

    for ax, (m, s, Z, style, label, title) in zip(
        (axes[1], axes[3]),
        (("fm", "fs", "Zf", "g", "E[f]", "signal GP f"), ("gm", "gs", "Zg", "m", "E[g]", "support GP g")),
    ):
        mean, sd = panels[m], panels[s]
        ax.plot(xs, mean, f"{style}-", label=label)
        ax.fill_between(xs, mean - 2 * sd, mean + 2 * sd, alpha=0.2, color=style)
        if Z in panels:
            ax.plot(panels[Z], np.full_like(panels[Z], mean.min()), "k^", ms=6)
        ax.set_title(title)

    ax = axes[2]
    ax.plot(xs, panels["pg"], "r-", label="E[Φ(g)]")
    ax.set_ylim(-0.05, 1.05)
    ax.set_title("gate probability Φ(g)")

    if heat:
        for ax, (title, K) in zip(heat_axes, heat.items()):
            im = ax.imshow(K, cmap="viridis")
            fig.colorbar(im, ax=ax, fraction=0.046, pad=0.03)
            ax.set_title(title, fontsize=9)
            ax.set_xticks([])
            ax.set_yticks([])
    return _finish(fig, plt, save_path)


def plot_onoff_1d(model, x: np.ndarray, y: np.ndarray, save_path: Optional[str] = None, heatmaps: bool = True):
    """The toy diagnostic of a 1-D on/off model (dense or Kronecker): 4
    time-series panels, and with ``heatmaps`` (a dense model) the 4 kernel
    matrices beside them."""
    return draw_onoff_1d(onoff_1d_panels(model, x, y, heatmaps=heatmaps), save_path)


def _temporal_factor(gp) -> int:
    """The factor consuming input column 2 (its mask is (2,)): the last in
    the reference's layout, but an appended exogenous factor (forecast
    covariates) comes after it."""
    for i, mask in enumerate(getattr(gp, "input_masks", ()) or ()):
        if tuple(mask) == (2,):
            return i
    return len(gp.factor_sizes) - 1


def inducing_monitor_panels(model, Xtrain: np.ndarray, Ytrain: np.ndarray, time_scale: float = 1000.0) -> dict:
    """Every array ``plot_inducing_monitor`` draws: ``t`` (each time index,
    ascending) and ``mean_y`` (the mean target there); for "u_fm" (f) and
    "u_gm" (g): ``zt`` (the temporal inducing inputs, sorted, × time_scale,
    rounded to 4 places), ``slices`` (q_mu's temporal slice of each of the
    first ``MONITOR_SLICES`` sites, in ``zt``'s order) and ``floor``
    (q_mu's least value, where the knots are marked). q_mu is row-major
    over the factors; the temporal axis is moved last before slicing."""
    t = np.asarray(Xtrain)[:, 2].ravel() * time_scale
    keys, inverse = np.unique(t, return_inverse=True)
    sums = np.bincount(inverse, weights=np.asarray(Ytrain, np.float64).ravel(), minlength=keys.size)
    out = {"t": keys, "mean_y": sums / np.bincount(inverse, minlength=keys.size)}
    with torch.no_grad():
        for gp, name in ((model.f, "u_fm"), (model.g, "u_gm")):
            sizes = tuple(gp.factor_sizes)
            t_idx = _temporal_factor(gp)
            U = np.moveaxis(_np(gp.q_mu.value).ravel().reshape(sizes), t_idx, -1).reshape(-1, sizes[t_idx])
            zt = _np(gp.Zs[t_idx].value).ravel()
            srt = np.argsort(zt)
            out[name] = {"zt": np.round(zt[srt] * time_scale, 4), "slices": U[:MONITOR_SLICES][:, srt],
                         "floor": float(U.min())}
    return out


def draw_inducing_monitor(panels: dict, save_path: Optional[str] = None):
    """Draw ``inducing_monitor_panels``'s arrays; the path written, or the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2, ax3) = plt.subplots(3, 1, figsize=(16, 8), sharex=True)
    ax1.bar(panels["t"], panels["mean_y"], align="center")
    ax1.set_title("mean target per time index")
    for ax, name in ((ax2, "u_fm"), (ax3, "u_gm")):
        p = panels[name]
        for row in p["slices"]:
            ax.plot(p["zt"], row, alpha=0.7)
        ax.scatter(p["zt"], np.full(p["zt"].shape, p["floor"]), color="#514A30", s=8)
        ax.set_title(f"{name} temporal slices per station")
    return _finish(fig, plt, save_path)


def plot_inducing_monitor(model, Xtrain: np.ndarray, Ytrain: np.ndarray, save_path: Optional[str] = None,
                          time_scale: float = 1000.0):
    """The Kronecker on/off training monitor: the mean target over time and
    the temporal slices of both GPs' inducing means."""
    return draw_inducing_monitor(inducing_monitor_panels(model, Xtrain, Ytrain, time_scale), save_path)


def _finish(fig, plt, save_path):
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110)
        plt.close(fig)
        return save_path
    return fig
