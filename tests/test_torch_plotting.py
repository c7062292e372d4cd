"""The port's plots (``utils/plotting.py``) and TensorBoard export
(``utils/tb_export.py``) against the JAX package's, on the CPU in float64.

- ``onoff_1d_panels`` of the dense toy model, its raws moved off the init
  and carried to the JAX model (``io.convert``): every array of every panel
  (the sorted data, the gated prediction and its band, f, Φ(g), g and their
  bands, the inducing inputs, the four kernel matrices) within rtol 1e-10
  (and 1e-10 of each array's largest magnitude, for entries near zero) of
  the same arrays computed from the JAX model, as
  ``zigp_tpu.utils.plotting.plot_onoff_1d`` computes them;
- ``inducing_monitor_panels`` on 2-factor, 3-factor and exogenous-factor
  grids, each against what the JAX package's ``plot_inducing_monitor``
  draws (read back from its figure: the bars, every slice line, the knot
  markers), the same tolerance; the JAX monitor groups with pandas, the
  port with numpy;
- the monitor's PNG written (the toy plot's is ``tests/test_torch_cli.py``'s
  ``toy --plot`` case);
- the same JSONL exported by both packages' ``export_jsonl`` reads back,
  through TensorBoard's own event reader, to the same scalars and the same
  histograms (every field, exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.experiments import builders as jbuilders
from zigp_tpu.experiments import configs as jconfigs
from zigp_tpu.experiments import toy as jtoy
from zigp_tpu.utils import plotting as jplotting
from zigp_tpu.utils import tb_export as jtb
from zigp_tpu.utils.logging import MetricLogger
from zigp_tpu_torch.experiments import builders as tbuilders
from zigp_tpu_torch.experiments import configs as tconfigs
from zigp_tpu_torch.experiments import toy as ttoy
from zigp_tpu_torch.experiments.configs import ToyOnOffConfig
from zigp_tpu_torch.io.convert import load_jax_arrays
from zigp_tpu_torch.io.datasets import synthetic_pptr, synthetic_toydata
from zigp_tpu_torch.utils import plotting
from zigp_tpu_torch.utils import tb_export

from .test_torch_runners import _jsplit
from .test_torch_train import _jraws, _with_raws

RTOL = 1e-10
PNG = b"\x89PNG"


@pytest.fixture(scope="module")
def toy_pair():
    """The toy models of both packages on 120 synthetic rows, every raw
    moved off the init by seeded noise, the same values in both."""
    x, y, _ = synthetic_toydata(120, seed=0)
    jm, _, _ = jtoy.build_toy_model(jtoy.ToyOnOffConfig(), x, y)
    rng = np.random.RandomState(4)
    arrays = {k: v + 0.05 * rng.randn(*np.shape(v)) for k, v in _jraws(jm).items()}
    jm = _with_raws(jm, arrays)
    tm, _, _ = ttoy.build_toy_model(ToyOnOffConfig(), x, y, device="cpu", dtype=torch.float64)
    load_jax_arrays(tm, arrays)
    return jm, tm, x, y


def _jax_onoff_panels(jm, x, y):
    """What ``zigp_tpu.utils.plotting.plot_onoff_1d`` draws, from the JAX model."""
    pred = jax.jit(lambda m, X: m.predict(X))(jm, jnp.asarray(x))
    order = np.argsort(x[:, 0])
    col = lambda a: np.asarray(a)[order, 0]
    sd = lambda a: np.sqrt(np.maximum(col(a), 0.0))
    pg = col(pred.pgmean)
    noise_sd = float(np.sqrt(np.asarray(jm.likelihood.variance.value)))
    Xs = jnp.asarray(x[order])
    Kf, Kg = (np.asarray(K) for K in jax.jit(lambda m, X: (m.kernf.K(X), m.kerng.K(X)))(jm, Xs))
    Kpg = pg[:, None] * pg[None, :]
    return {
        "xs": x[order, 0], "ys": y[order, 0], "gf": col(pred.gfmean), "fm": col(pred.fmean), "fs": sd(pred.fvar),
        "pg": pg, "gm": col(pred.gmean), "gs": sd(pred.gvar),
        "band": 1.5 * (sd(pred.fvar) * pg + sd(pred.pgvar) * (1.0 - pg) + noise_sd),
        "Zf": np.asarray(jm.Zf.value)[:, 0], "Zg": np.asarray(jm.Zg.value)[:, 0],
        "heat": {"sparse kernel  Φ(g)Φ(g)ᵀ∘K_f": Kpg * Kf, "latent kernel  K_f": Kf, "probit kernel  Φ(g)Φ(g)ᵀ": Kpg,
                 "latent kernel  K_g": Kg},
    }


def _close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    else:
        want = np.asarray(want)
        np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=RTOL * np.abs(want).max(initial=0.0),
                                   err_msg=path)


def test_onoff_1d_panels_match_jax(toy_pair):
    jm, tm, x, y = toy_pair
    got = plotting.onoff_1d_panels(tm, x, y)
    _close(got, _jax_onoff_panels(jm, x, y))
    assert got["band"].min() > 0 and got["heat"]["latent kernel  K_f"].shape == (120, 120)
    assert "heat" not in plotting.onoff_1d_panels(tm, x, y, heatmaps=False)


def _split(case):
    split = synthetic_pptr(10, 48, seed=1)
    if case == "exog":  # two covariate columns: an exogenous factor after the temporal one
        rng = np.random.RandomState(2)
        cov = lambda X: np.concatenate([X, rng.rand(X.shape[0], 2)], axis=1)
        split = type(split)(cov(split.Xtrain), split.Ytrain, cov(split.Xtest), split.Ytest)
    return split


GRIDS = {"2-factor": dict(num_spatial=3, num_temporal=5), "3-factor": dict(spatial_factors=(2, 3), num_temporal=5),
         "exog": dict(num_spatial=3, num_temporal=5, num_exog=3)}


def _jax_monitor(jm, X, Y):
    """What the JAX monitor draws, read back from its figure."""
    import matplotlib.pyplot as plt

    fig = jplotting.plot_inducing_monitor(jm, X, Y)
    ax1, ax2, ax3 = fig.axes
    out = {"t": np.array([p.get_x() + p.get_width() / 2 for p in ax1.patches]),
           "mean_y": np.array([p.get_height() for p in ax1.patches])}
    for ax, name in ((ax2, "u_fm"), (ax3, "u_gm")):
        offsets = np.asarray(ax.collections[0].get_offsets())
        out[name] = {"zt": offsets[:, 0], "slices": np.stack([ln.get_ydata() for ln in ax.lines]),
                     "floor": offsets[0, 1], "line_x": [ln.get_xdata() for ln in ax.lines]}
    plt.close(fig)
    return out


@pytest.mark.parametrize("case", list(GRIDS))
def test_inducing_monitor_panels_match_jax(case):
    split = _split(case)
    cfg = lambda pkg: pkg.OnOffPptrConfig(grid=pkg.KronGridConfig(**GRIDS[case]))
    jm = jbuilders.build_onoff_pptr(cfg(jconfigs), _jsplit(split))
    tm = tbuilders.build_onoff_pptr(cfg(tconfigs), split, device="cpu", dtype=torch.float64)
    got = plotting.inducing_monitor_panels(tm, split.Xtrain, split.Ytrain)
    want = _jax_monitor(jm, split.Xtrain, split.Ytrain)
    assert len(tm.f.Zs) == (2 if case == "2-factor" else 3)
    _close(got["t"], want["t"], "t")
    _close(got["mean_y"], want["mean_y"], "mean_y")
    for name in ("u_fm", "u_gm"):
        for x in want[name].pop("line_x"):
            _close(x, got[name]["zt"], f"{name} line x")
        _close(got[name], want[name], name)
    assert got["u_fm"]["slices"].shape[1] == 5


def test_monitor_writes_a_png(tmp_path):
    split = _split("2-factor")
    tm = tbuilders.build_onoff_pptr(tconfigs.OnOffPptrConfig(grid=tconfigs.KronGridConfig(**GRIDS["2-factor"])),
                                    split, device="cpu", dtype=torch.float64)
    path = plotting.plot_inducing_monitor(tm, split.Xtrain, split.Ytrain, save_path=str(tmp_path / "m.png"))
    assert open(path, "rb").read(4) == PNG


def test_require_matplotlib_names_it(monkeypatch):
    import importlib.util

    plotting.require_matplotlib("toy --plot")
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    with pytest.raises(SystemExit, match="toy --plot needs matplotlib"):
        plotting.require_matplotlib("toy --plot")


def _read_events(logdir):
    """({tag: [(step, value)]}, {tag: [(step, histogram fields)]}) of the
    event file in ``logdir``, read record by record (TFRecord framing: a
    length, its CRC, the serialized ``Event``, its CRC) with the event proto
    the writer uses; TensorBoard's own reader imports TensorFlow, which takes
    seconds, and ``tests/test_tb_export.py`` already holds the JAX export
    against it."""
    import glob
    import os
    import struct

    from tensorboardX.proto.event_pb2 import Event

    (path,) = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    data = open(path, "rb").read()
    scalars, hists, pos = {}, {}, 0
    while pos < len(data):
        (n,) = struct.unpack("<Q", data[pos : pos + 8])
        event = Event.FromString(data[pos + 12 : pos + 12 + n])
        pos += 12 + n + 4
        for v in event.summary.value:
            if v.HasField("histo"):
                h = v.histo
                hists.setdefault(v.tag, []).append((event.step, h.num, h.min, h.max, h.sum, h.sum_squares,
                                                    list(h.bucket_limit), list(h.bucket)))
            else:
                scalars.setdefault(v.tag, []).append((event.step, v.simple_value))
    return scalars, hists


def test_tb_export_reads_back_as_the_jax_export(tmp_path):
    rng = np.random.RandomState(0)
    path = str(tmp_path / "metrics.jsonl")
    logger = MetricLogger(path)
    for step in (100, 200, 300):
        logger.log(step, scalars={"loss": 1.0 / step, "elbo": -1.0 / step},
                   histograms={"param.q_mu": rng.randn(50) * step, "grad.ls": np.full(20, 0.5)})
    logger.close()

    got = _read_events(tb_export.export_jsonl(path, str(tmp_path / "port")))
    want = _read_events(jtb.export_jsonl(path, str(tmp_path / "jax")))
    assert got == want
    assert set(got[0]) == {"loss", "elbo"} and set(got[1]) == {"param.q_mu", "grad.ls"}
    assert [s for s, _ in got[0]["loss"]] == [100, 200, 300]
    assert [h[1] for h in got[1]["param.q_mu"]] == [50.0] * 3
