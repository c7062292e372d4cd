"""The general traffic generator: what a mix's data file asks for, made
from the seed.

Training mixes (``"kind": "train"``) are read by ``harness.train``: the
sampler, the block length, the log cadence, the solve precision, the traced
stretch.

Serving mixes (``"kind": "serve"``) describe a closed loop of one client
calling in cycles of fixed call sizes. Each entry of ``cycle`` gives a
call's ``shape``, its row count and how many calls of it a cycle holds:

- ``stations_hours``: every station over ``hours`` consecutive hours from a
  seeded start (a day, a week at every station);
- ``random_rows``: ``rows`` (station, hour) pairs drawn uniformly (a CV
  test fold, a batch scoring job);
- ``raster``: an ``nx`` × ``ny`` raster over the stations' box over
  ``hours`` consecutive hours (hourly maps).

The sizes are fixed by the file; the seed makes the rows and shuffles the
order of the calls within each cycle. ``variants`` sets of rows are made
for each entry in set-up and the cycles take them in turn, so the window
makes no rows.
"""

from __future__ import annotations

from typing import List

import numpy as np

from . import data as D


def call_rows(entry: dict, d: D.Data, r: np.random.Generator) -> np.ndarray:
    """One call's (rows, 3) float64 inputs (float32-representable)."""
    shape, H, S = entry["shape"], d.hours.shape[0], d.stations.shape[0]
    if shape == "stations_hours":
        h = int(entry["hours"])
        t0 = int(r.integers(0, H - h + 1))
        s, t = np.meshgrid(np.arange(S), np.arange(t0, t0 + h), indexing="ij")
        X = np.concatenate([d.stations[s.ravel()], d.hours[t.ravel()][:, None]], axis=1)
    elif shape == "random_rows":
        n = int(entry["rows"])
        X = np.concatenate([d.stations[r.integers(0, S, n)], d.hours[r.integers(0, H, n)][:, None]], axis=1)
    elif shape == "raster":
        nx, ny, h = int(entry["nx"]), int(entry["ny"]), int(entry["hours"])
        lat = np.linspace(d.stations[:, 0].min(), d.stations[:, 0].max(), nx)
        lon = np.linspace(d.stations[:, 1].min(), d.stations[:, 1].max(), ny)
        t0 = int(r.integers(0, H - h + 1))
        a, b, t = np.meshgrid(lat, lon, d.hours[t0 : t0 + h], indexing="ij")
        X = np.stack([a.ravel(), b.ravel(), t.ravel()], axis=1)
    else:
        raise ValueError(f"traffic: unknown call shape {shape!r}")
    if X.shape[0] != int(entry["rows"]):
        raise ValueError(f"traffic: a {shape} call makes {X.shape[0]} rows, the mix says {entry['rows']}")
    return D.f32(X)


class ServeCalls:
    """The calls of a serving mix: ``variants[e][v]`` the rows of entry e's
    variant v, and ``cycle(c)`` the (entry, variant) of each call of cycle c
    in its shuffled order."""

    def __init__(self, traffic: dict, d: D.Data, seed: int):
        r = D.rng(seed, D.SERVE_ROWS)
        self.entries = traffic["cycle"]
        self.nvar = int(traffic["variants"])
        self.variants: List[List[np.ndarray]] = [[call_rows(e, d, r) for _ in range(self.nvar)]
                                                 for e in self.entries]
        self.slots = [i for i, e in enumerate(self.entries) for _ in range(int(e["count"]))]
        self.order = D.rng(seed, D.ORDER)

    @property
    def calls_per_cycle(self) -> int:
        return len(self.slots)

    @property
    def rows_per_cycle(self) -> int:
        return sum(int(e["rows"]) * int(e["count"]) for e in self.entries)

    def cycle(self, c: int) -> List[tuple]:
        perm = self.order.permutation(len(self.slots))
        return [(self.slots[i], c % self.nvar) for i in perm]

    def rows(self, entry: int, variant: int) -> np.ndarray:
        return self.variants[entry][variant]
