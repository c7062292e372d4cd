"""The benchmark's inputs, made from ``--seed``: the pptr-shaped data, the
inducing grid's factors and the parameters both sides start from.

The data follows the recipe of the program's ``io.datasets.synthetic_pptr``
(frozen here): ``n_stations`` uniform in the real station box, ``n_hours``
consecutive hours from ndatehour 4368 rescaled ÷1000, targets 0 with the
real set's dry share and exponential amounts otherwise, rows shuffled 80/20
into train and test. Every value is made float32-representable, so the
float32 program and the float64 reference read the same numbers.

Every stream is a ``numpy.random.Generator`` on ``SeedSequence([seed,
stream])``, so any whole seed works, 64-bit ones included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

# streams of one seed
DATA, GRID, INIT, SERVE_STATE, SERVE_ROWS, SAMPLE, ORDER, SAMPLER = range(8)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream]))


def derived_seed(seed: int, stream: int) -> int:
    """A 31-bit seed for the program's own generators (its device sampler)."""
    return int(rng(seed, stream).integers(0, 2**31 - 1))


def f32(a) -> np.ndarray:
    """``a`` rounded to float32 and held in float64."""
    return np.asarray(a, dtype=np.float32).astype(np.float64)


@dataclass
class Data:
    stations: np.ndarray  # (S, 2) lat, lon
    hours: np.ndarray  # (H,) time column (ndatehour / 1000)
    Xtrain: np.ndarray  # (N, 3)
    Ytrain: np.ndarray  # (N, 1)
    Xtest: np.ndarray
    Ytest: np.ndarray


def pptr(spec: dict, seed: int) -> Data:
    """The pptr-shaped split of ``spec`` (the configuration's ``data``)."""
    r = rng(seed, DATA)
    S, H = int(spec["n_stations"]), int(spec["n_hours"])
    lat = r.uniform(*spec["lat"], S)
    lon = r.uniform(*spec["lon"], S)
    hours = f32((spec["hour0"] + np.arange(H, dtype=np.float64)) / 1000.0)
    stations = f32(np.stack([lat, lon], axis=1))
    s, h = np.meshgrid(np.arange(S), np.arange(H), indexing="ij")
    X = np.concatenate([stations[s.ravel()], hours[h.ravel()][:, None]], axis=1)
    wet = r.random(X.shape[0]) >= spec["zero_frac"]
    Y = f32(np.where(wet, r.exponential(1.0, X.shape[0]), 0.0)[:, None])
    perm = r.permutation(X.shape[0])
    n_test = int(round(spec["test_frac"] * X.shape[0]))
    te, tr = perm[:n_test], perm[n_test:]
    return Data(stations, hours, X[tr], Y[tr], X[te], Y[te])


def kmeans(points: np.ndarray, k: int, r: np.random.Generator, iters: int = 25) -> np.ndarray:
    """Lloyd's k-means from ``k`` distinct points drawn by ``r``."""
    C = points[r.choice(points.shape[0], k, replace=False)].copy()
    for _ in range(iters):
        d = ((points[:, None, :] - C[None]) ** 2).sum(-1)
        lab = d.argmin(1)
        for j in range(k):
            if (lab == j).any():
                C[j] = points[lab == j].mean(0)
    return C


def grid_factors(cfg: dict, data: Data, seed: int) -> List[np.ndarray]:
    """[Z_s (Ms, 2), Z_t (Mt, 1)]: every station, or ``num_spatial``
    k-means centres over the stations; ``num_temporal`` knots over the
    training rows' time span."""
    g = cfg["grid"]
    if g["spatial"] == "stations":
        Zs = data.stations.copy()
        if Zs.shape[0] != g["num_spatial"]:
            raise ValueError(f"grid: {Zs.shape[0]} stations, num_spatial {g['num_spatial']}")
    elif g["spatial"] == "kmeans":
        Zs = kmeans(data.stations, int(g["num_spatial"]), rng(seed, GRID))
    else:
        raise ValueError(f"grid: unknown spatial layout {g['spatial']!r}")
    t = data.Xtrain[:, 2]
    Zt = np.linspace(t.min(), t.max(), int(g["num_temporal"]))[:, None]
    return [f32(Zs), f32(Zt)]


def rbf(Z1: np.ndarray, Z2: np.ndarray, ell, var) -> np.ndarray:
    d2 = (((Z1[:, None, :] - Z2[None, :, :]) / np.asarray(ell, dtype=np.float64)) ** 2).sum(-1)
    return var * np.exp(-0.5 * d2)


def jittered(K: np.ndarray, cfg: dict) -> np.ndarray:
    """K + (jitter + relative · mean diag K)·I: the configuration's float32 rule."""
    j = cfg["jitter"] + cfg["jitter_relative"] * float(np.mean(np.diag(K)))
    return K + j * np.eye(K.shape[0])


def train_state(cfg: dict, Zs: List[np.ndarray], seed: int) -> Dict[str, dict]:
    """The constrained values a training run starts from: the configuration's
    kernel inits, q_mu = q_mu_scale·N(0, 1) per GP, q_sqrt = 1."""
    r = rng(seed, INIT)
    M = int(np.prod([Z.shape[0] for Z in Zs]))
    out = {}
    for gp in ("f", "g"):
        out[gp] = dict(
            kernels=[dict(cfg[f"{gp}k_spatial"]), dict(cfg[f"{gp}k_temporal"])],
            Zs=[Z.copy() for Z in Zs],
            q_mu=f32(cfg["q_mu_scale"] * r.standard_normal((M, 1))),
            q_sqrt=np.ones((M, 1)),
        )
    out["noise_variance"] = float(cfg["noise_variance"])
    return out


def serve_state(cfg: dict, Zs: List[np.ndarray], seed: int) -> Dict[str, dict]:
    """A served model's values: the configuration's kernel inits, q_mu a
    draw from each GP's prior scaled to the latent's scale (``serve_scale``:
    f about the amounts' scale, g the gate's), q_sqrt uniform in
    ``serve_q_sqrt``, as a trained posterior has them."""
    r = rng(seed, SERVE_STATE)
    state = train_state(cfg, Zs, seed)
    lo, hi = cfg["serve_q_sqrt"]
    for gp in ("f", "g"):
        ks, kt = state[gp]["kernels"]
        Ls = np.linalg.cholesky(jittered(rbf(Zs[0], Zs[0], ks["lengthscales"], ks["variance"]), cfg))
        Lt = np.linalg.cholesky(jittered(rbf(Zs[1], Zs[1], kt["lengthscales"], kt["variance"]), cfg))
        V = r.standard_normal((Zs[0].shape[0], Zs[1].shape[0]))
        U = Ls @ V @ Lt.T * (cfg["serve_scale"][gp] / np.sqrt(ks["variance"] * kt["variance"]))
        state[gp]["q_mu"] = f32(U.reshape(-1, 1))
        state[gp]["q_sqrt"] = f32(r.uniform(lo, hi, (U.size, 1)))
    return state
