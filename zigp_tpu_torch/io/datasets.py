"""Dataset plumbing for the pptr experiments (numpy and scipy only).

Counterpart of ``zigp_tpu/io/datasets.py:22-65, 236-286``: the ``Split``
record, ``load_pptr``, the 5-fold ``make_cv_splits`` (a numpy KFold: the
same folds as scikit-learn's ``KFold(shuffle=True)``, which the card's
machine does not have) and the inducing-grid init ``kron_inducing_init``,
which returns the JAX package's centres exactly for the same seed (scipy
``kmeans`` under ``np.random.seed``).

``synthetic_pptr`` is the port's own: a set shaped like the real one (105
stations over Finland, hourly points, about 90 % exact zeros) made from a
seed, for runs where ``pptr.pickle`` is not at hand.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import List, Optional

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


def load_pptr(path: Optional[str] = None) -> Split:
    """Finnish precipitation: Xtrain (105280, 3) = [lat, lon, ndatehour]."""
    path = path or os.path.join(DEFAULT_DATA_DIR, "pptr.pickle")
    with open(path, "rb") as f:
        d = pickle.load(f)
    return Split(d["Xtrain"], d["Ytrain"], d["Xtest"], d["Ytest"])


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
