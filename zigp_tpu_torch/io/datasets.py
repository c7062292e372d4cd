"""Dataset plumbing for the pptr experiments (numpy and scipy only).

Counterpart of ``zigp_tpu/io/datasets.py:22-286``: the ``Split`` record,
``load_toydata``, ``load_pptr``, the 5-fold ``make_cv_splits`` (a numpy KFold: the same folds
as scikit-learn's ``KFold(shuffle=True)``, which the card's machine does not
have), the rolling-origin ``make_forecast_splits`` with its exogenous
covariates ``augment_forecast_covariates`` (copies, array for array), the
inducing-grid init ``kron_inducing_init``, which returns the JAX package's
centres exactly for the same seed (scipy ``kmeans`` under
``np.random.seed``), and the reference's pptr preprocessing
(``onofftf/utils_pptr.py``: time filter, min-max scaling, heuristic kernel
init) as ``Preprocessing``, a copy of the JAX package's.

``synthetic_pptr`` is the port's own: a set shaped like the real one (105
stations over Finland, hourly points, about 90 % exact zeros) made from a
seed, for runs where ``pptr.pickle`` is not at hand; ``save_pptr`` writes a
split in ``load_pptr``'s format, so the command line can read it
(``--data``). ``synthetic_toydata`` and ``save_toydata`` do the same for
``toydata.mat``, which the toy reads from ``ZIGP_DATA_DIR``.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

DEFAULT_DATA_DIR = os.environ.get("ZIGP_DATA_DIR", "data")

# The real set's shape: station box, ndatehour range, share of dry hours.
PPTR_LAT = (59.8, 70.1)
PPTR_LON = (20.0, 31.0)
PPTR_HOURS = (4368, 5447)
PPTR_ZERO_FRAC = 0.898


@dataclass
class Split:
    Xtrain: np.ndarray
    Ytrain: np.ndarray
    Xtest: np.ndarray
    Ytest: np.ndarray


def load_toydata(path: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x, y, f) each (450, 1) float64 from the toy 1-D on/off dataset,
    ``toydata.mat`` under ``ZIGP_DATA_DIR`` unless ``path`` is given."""
    from scipy.io import loadmat

    path = path or os.path.join(DEFAULT_DATA_DIR, "toydata.mat")
    m = loadmat(path)
    return m["x"], m["y"], m["f"]


def load_pptr(path: Optional[str] = None) -> Split:
    """Finnish precipitation: Xtrain (105280, 3) = [lat, lon, ndatehour]."""
    path = path or os.path.join(DEFAULT_DATA_DIR, "pptr.pickle")
    with open(path, "rb") as f:
        d = pickle.load(f)
    return Split(d["Xtrain"], d["Ytrain"], d["Xtest"], d["Ytest"])


def save_pptr(split: Split, path: str, *, time_scale: float = 1000.0) -> str:
    """Write ``split`` as ``load_pptr`` reads it, the time column multiplied
    by ``time_scale`` back to raw ndatehour (``synthetic_pptr`` gives it ÷1000,
    as the CV splits do, and ``make_cv_splits`` divides again). Returns
    ``path``."""
    raw = []
    for X in (split.Xtrain, split.Xtest):
        X = np.array(X, dtype=np.float64)
        X[:, 2] *= time_scale
        raw.append(X)
    with open(path, "wb") as f:
        pickle.dump({"Xtrain": raw[0], "Ytrain": np.asarray(split.Ytrain), "Xtest": raw[1],
                     "Ytest": np.asarray(split.Ytest)}, f)
    return path


def kfold_indices(n: int, n_splits: int, seed: int) -> List[tuple]:
    """[(train_index, test_index)] of scikit-learn's ``KFold(n_splits,
    shuffle=True, random_state=seed)`` on n rows: the rows shuffled by
    ``RandomState(seed)``, cut into consecutive folds of n // k rows, the
    first n % k folds one row longer; both index sets in ascending order."""
    if not 2 <= n_splits <= n:
        raise ValueError(f"kfold_indices: n_splits must be in 2..{n}, got {n_splits}")
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits)
    sizes[: n % n_splits] += 1
    out, start = [], 0
    for size in sizes:
        test = np.zeros(n, dtype=bool)
        test[order[start : start + size]] = True
        out.append((np.flatnonzero(~test), np.flatnonzero(test)))
        start += size
    return out


def make_cv_splits(data: Split, n_splits: int = 5, seed: int = 1234, time_scale: float = 1000.0) -> List[Split]:
    """5-fold CV over the concatenated train and test rows with the time
    column divided by ``time_scale`` (the reference's create_cvsplits)."""
    Xraw = np.concatenate([data.Xtrain, data.Xtest])
    Yraw = np.concatenate([data.Ytrain, data.Ytest])
    Xraw = Xraw.copy()
    Xraw[:, 2] = Xraw[:, 2] / time_scale
    return [Split(Xraw[tr], Yraw[tr], Xraw[te], Yraw[te]) for tr, te in kfold_indices(Xraw.shape[0], n_splits, seed)]


def make_forecast_splits(
    data: Split,
    n_origins: int = 5,
    *,
    horizon_frac: float = 0.1,
    start_frac: float = 0.5,
    time_scale: float = 1000.0,
    covariates: bool = False,
) -> List[Split]:
    """Rolling-origin temporal-extrapolation splits: fold k trains on every
    point strictly before its origin time and tests on the following window
    of ``horizon_frac`` of the time range (past to future, where the KFold
    protocol interpolates between observed times). With the defaults the 5
    origins sit at 50/60/70/80/90 % of the time range and the windows tile
    its second half; the last window takes the range's end. Time is divided
    by ``time_scale`` as in ``make_cv_splits``. ``covariates=True`` appends
    ``augment_forecast_covariates``' five columns (D 3 → 8) with each fold's
    origin as the test rows' information cutoff."""
    Xraw = np.concatenate([data.Xtrain, data.Xtest]).copy()
    Yraw = np.concatenate([data.Ytrain, data.Ytest])
    Xraw[:, 2] = Xraw[:, 2] / time_scale
    t = Xraw[:, 2]
    lo, hi = float(t.min()), float(t.max())
    span = hi - lo
    splits = []
    for k in range(n_origins):
        t0 = lo + (start_frac + k * horizon_frac) * span
        t1 = t0 + horizon_frac * span
        train = t < t0
        test = (t >= t0) & ((t < t1) if k < n_origins - 1 else (t <= hi))
        if not train.any() or not test.any():
            raise ValueError(
                f"forecast origin {k}: empty train ({train.sum()}) or test "
                f"({test.sum()}) window — check start_frac/horizon_frac"
            )
        Xtr, Ytr = Xraw[train], Yraw[train]
        Xte, Yte = Xraw[test], Yraw[test]
        if covariates:
            Xtr, Xte = augment_forecast_covariates(Xtr, Ytr, Xte, t0, time_scale=time_scale)
        splits.append(Split(Xtr, Ytr, Xte, Yte))
    return splits


def augment_forecast_covariates(
    Xtrain: np.ndarray,
    Ytrain: np.ndarray,
    Xtest: np.ndarray,
    cutoff: float,
    *,
    time_scale: float = 1000.0,
    wet_window: int = 72,
) -> Tuple[np.ndarray, np.ndarray]:
    """Append five forecast-computable covariates to the input rows (D 3 → 8):

    0. ``lag24``: the station's latest observation at the same hour of day
       strictly before the information cutoff (log1p amount scale);
    1. ``wet_frac``: the share of wet hours in the station's last
       ``wet_window`` hours before the cutoff;
    2. ``wet_amount``: log1p of the mean rain over that window;
    3, 4. sin and cos of the diurnal phase 2π·hour/24.

    The (station, hour) table comes from ``(Xtrain, Ytrain)`` only. Train
    rows are cut off strictly before their own hour, test rows at ``cutoff``
    (the forecast origin, in the split's ÷``time_scale`` units). The three
    history columns are z-scored by the train rows' statistics."""
    Xtr = np.asarray(Xtrain, dtype=np.float64)
    Ytr = np.asarray(Ytrain, dtype=np.float64).reshape(-1)
    Xte = np.asarray(Xtest, dtype=np.float64)

    # (station, hour) table from the train rows only
    coords = np.round(Xtr[:, :2], 6)
    uniq, sid_tr = np.unique(coords, axis=0, return_inverse=True)
    S = uniq.shape[0]
    hr_tr = np.round(Xtr[:, 2] * time_scale).astype(np.int64)
    h0, h1 = int(hr_tr.min()), int(hr_tr.max())
    H = h1 - h0 + 1
    ytab = np.full((S, H), np.nan)
    ytab[sid_tr, hr_tr - h0] = Ytr
    obs = np.isfinite(ytab)
    yz = np.where(obs, ytab, 0.0)
    cum_n = np.concatenate([np.zeros((S, 1)), np.cumsum(obs, axis=1)], axis=1)
    cum_wet = np.concatenate([np.zeros((S, 1)), np.cumsum(yz > 0, axis=1)], axis=1)
    cum_amt = np.concatenate([np.zeros((S, 1)), np.cumsum(yz, axis=1)], axis=1)
    station_wet_mean = np.where(cum_n[:, -1] > 0, cum_wet[:, -1] / np.maximum(cum_n[:, -1], 1), 0.0)
    station_amt_mean = np.where(cum_n[:, -1] > 0, cum_amt[:, -1] / np.maximum(cum_n[:, -1], 1), 0.0)

    def features(X, cut_hours):
        n = X.shape[0]
        c2 = np.round(np.asarray(X[:, :2], dtype=np.float64), 6)
        # stations unseen in train get the station-mean fallbacks
        key = {tuple(u): i for i, u in enumerate(uniq)}
        sid = np.array([key.get(tuple(r), -1) for r in c2], dtype=np.int64)
        hrs = np.round(X[:, 2] * time_scale).astype(np.int64)
        cut = np.asarray(cut_hours, dtype=np.int64)
        known = sid >= 0
        sid_s = np.where(known, sid, 0)

        # lag24: h' = h − 24k with h' ≤ cut − 1, k ≥ 1; up to 4 backoffs
        lag = np.full(n, np.nan)
        k0 = np.maximum(np.ceil((hrs - (cut - 1)) / 24.0), 1.0).astype(np.int64)
        for extra in range(4):
            hp = hrs - 24 * (k0 + extra)
            valid = known & np.isnan(lag) & (hp >= h0) & (hp <= h1)
            idx = np.clip(hp - h0, 0, H - 1)
            got = valid & obs[sid_s, idx]
            lag[got] = ytab[sid_s[got], idx[got]]
        lag = np.where(np.isnan(lag), station_amt_mean[sid_s], lag)
        lag = np.log1p(np.maximum(lag, 0.0))

        # recent-window wetness and amount over [cut − W, cut)
        hi = np.clip(cut - h0, 0, H)
        lo = np.clip(cut - wet_window - h0, 0, H)
        n_obs = cum_n[sid_s, hi] - cum_n[sid_s, lo]
        wet = cum_wet[sid_s, hi] - cum_wet[sid_s, lo]
        amt = cum_amt[sid_s, hi] - cum_amt[sid_s, lo]
        wet_frac = np.where(n_obs > 0, wet / np.maximum(n_obs, 1), station_wet_mean[sid_s])
        wet_amt = np.log1p(np.where(n_obs > 0, amt / np.maximum(n_obs, 1), station_amt_mean[sid_s]))

        phase = 2.0 * np.pi * (hrs % 24) / 24.0
        return np.stack([lag, wet_frac, wet_amt, np.sin(phase), np.cos(phase)], 1)

    cut_hour = int(np.floor(cutoff * time_scale))
    f_tr = features(Xtr, hr_tr)  # per-row cutoff: strictly before
    f_te = features(Xte, np.full(Xte.shape[0], cut_hour))

    # z-score the history columns by the train statistics (sin and cos stay raw)
    mu = f_tr[:, :3].mean(axis=0)
    sd = np.maximum(f_tr[:, :3].std(axis=0), 1e-6)
    f_tr[:, :3] = (f_tr[:, :3] - mu) / sd
    f_te[:, :3] = (f_te[:, :3] - mu) / sd
    return np.concatenate([Xtr, f_tr], axis=1), np.concatenate([Xte, f_te], axis=1)


def synthetic_pptr(n_stations: int = 105, n_hours: int = 1080, *, seed: int = 0) -> Split:
    """A pptr-shaped split made from ``seed``: ``n_stations`` uniform in the
    real station box, ``n_hours`` consecutive hours from ndatehour 4368
    (rescaled ÷1000 as the CV splits do), targets 0 with the real set's dry
    share and exponential amounts otherwise; rows shuffled 80/20 into train
    and test."""
    rng = np.random.RandomState(seed)
    lat = rng.uniform(*PPTR_LAT, n_stations)
    lon = rng.uniform(*PPTR_LON, n_stations)
    hours = PPTR_HOURS[0] + np.arange(n_hours, dtype=np.float64)
    s, h = np.meshgrid(np.arange(n_stations), hours, indexing="ij")
    X = np.stack([lat[s.ravel()], lon[s.ravel()], h.ravel() / 1000.0], axis=1)
    wet = rng.rand(X.shape[0]) >= PPTR_ZERO_FRAC
    Y = np.where(wet, rng.exponential(1.0, X.shape[0]), 0.0)[:, None]
    perm = rng.permutation(X.shape[0])
    n_test = int(round(0.2 * X.shape[0]))
    te, tr = perm[:n_test], perm[n_test:]
    return Split(X[tr], Y[tr], X[te], Y[te])


def synthetic_toydata(n: int = 450, *, seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x, y, f), each (n, 1) float64, shaped like ``toydata.mat`` and made
    from ``seed``: x sorted uniform on [0, 10], a smooth signal f, and y =
    f + N(0, 0.1²) where a smooth support function is positive, exactly 0
    elsewhere (about half the points)."""
    rng = np.random.RandomState(seed)
    x = np.sort(rng.uniform(0.0, 10.0, n))[:, None]
    f = 2.0 * np.sin(1.3 * x) + 0.5 * x / 10.0
    on = np.sin(0.7 * x + 0.4) + 0.3 * np.cos(2.1 * x) > 0.0
    y = np.where(on, f + 0.1 * rng.randn(n, 1), 0.0)
    return x, y, f


def save_toydata(x: np.ndarray, y: np.ndarray, f: np.ndarray, path: str) -> str:
    """Write (x, y, f) as ``load_toydata`` reads it (a MATLAB file with
    variables x, y, f). Returns ``path``."""
    from scipy.io import savemat

    savemat(path, {"x": x, "y": y, "f": f})
    return path


def kron_inducing_init(
    Xtrain: np.ndarray,
    num_spatial: int = 10,
    num_temporal: int = 100,
    *,
    seed: int = 0,
    spatial_factors: tuple | None = None,
    num_exog: int = 8,
) -> List[np.ndarray]:
    """Inducing grid: kmeans centres over (lat, lon) and a linspace over the
    time column. ``spatial_factors=(n_lat, n_lon)`` gives three one-column
    factors lat ⊗ lon ⊗ time instead; inputs with more than 3 columns append
    an exogenous factor of ``num_exog`` kmeans centres over the extra
    columns."""
    from scipy.cluster.vq import kmeans

    np.random.seed(seed)

    def _kmeans_knots(cols, k):
        Z = kmeans(np.asarray(cols, dtype=np.float64), k)[0]
        if Z.shape[0] < k:
            # scipy kmeans drops empty clusters: top up with random rows
            extra = cols[np.random.choice(cols.shape[0], k - Z.shape[0], replace=False)]
            Z = np.concatenate([Z, np.asarray(extra, dtype=np.float64)], axis=0)
        return Z

    exog = [_kmeans_knots(Xtrain[:, 3:], num_exog)] if Xtrain.shape[1] > 3 else []
    if spatial_factors is not None:
        n_lat, n_lon = spatial_factors
        Z_t = np.linspace(Xtrain[:, 2].min(), Xtrain[:, 2].max(), num_temporal)
        return [
            np.linspace(Xtrain[:, 0].min(), Xtrain[:, 0].max(), n_lat)[:, None],
            np.linspace(Xtrain[:, 1].min(), Xtrain[:, 1].max(), n_lon)[:, None],
            Z_t[:, None],
        ] + exog
    Z_s = _kmeans_knots(Xtrain[:, 0:2], num_spatial)
    Z_t = np.linspace(Xtrain[:, 2].min(), Xtrain[:, 2].max(), num_temporal)[:, None]
    return [Z_s, Z_t] + exog


@dataclass
class ScaleParams:
    mins: Dict[str, float] = field(default_factory=dict)
    ranges: Dict[str, float] = field(default_factory=dict)


class Preprocessing:
    """pptr preprocessing pipeline (onofftf/utils_pptr.py:4-123): time-window
    filter on the ndatehour column, min-max scaling of lat/lon/time with
    recorded scale params, heuristic kernel initialisation."""

    COLS = ("lat", "lon", "ndatehour")

    def __init__(self, split: Split):
        self.split = Split(
            split.Xtrain.copy(), split.Ytrain.copy(), split.Xtest.copy(), split.Ytest.copy()
        )
        self.scale_params = ScaleParams()
        self._scaled_loc = False
        self._scaled_time = False

    def filter_time(self, min_idx: float = 0.0, max_idx: float = np.inf) -> "Preprocessing":
        s = self.split
        tr = (s.Xtrain[:, 2] >= min_idx) & (s.Xtrain[:, 2] <= max_idx)
        te = (s.Xtest[:, 2] >= min_idx) & (s.Xtest[:, 2] <= max_idx)
        self.split = Split(s.Xtrain[tr], s.Ytrain[tr], s.Xtest[te], s.Ytest[te])
        return self

    def scale(self, scale_loc: bool = True, scale_time: bool = True) -> "Preprocessing":
        s = self.split
        allX = np.concatenate([s.Xtrain, s.Xtest])
        cols = []
        if scale_loc:
            cols += [0, 1]
            self._scaled_loc = True
        if scale_time:
            cols += [2]
            self._scaled_time = True
        for c in cols:
            name = self.COLS[c]
            lo, hi = allX[:, c].min(), allX[:, c].max()
            self.scale_params.mins[name] = float(lo)
            self.scale_params.ranges[name] = float(hi - lo)
            s.Xtrain[:, c] = (s.Xtrain[:, c] - lo) / (hi - lo)
            s.Xtest[:, c] = (s.Xtest[:, c] - lo) / (hi - lo)
        return self

    @property
    def model_data(self) -> Split:
        return self.split

    @property
    def kernel_params(self) -> Tuple[float, List[float]]:
        """Heuristic init (utils_pptr.py:104-123): variance = max(Y);
        lengthscale 3/range per scaled dim, 3.0 otherwise."""
        variance = float(np.max(self.split.Ytrain))
        ells = []
        for name in ("lat", "lon"):
            if self._scaled_loc:
                ells.append(round(3.0 / self.scale_params.ranges[name], 4))
            else:
                ells.append(3.0)
        if self._scaled_time:
            ells.append(round(3.0 / self.scale_params.ranges["ndatehour"], 4))
        else:
            ells.append(3.0)
        return variance, ells
