"""Epoch-shuffled minibatch pipeline.

A copy of ``zigp_tpu/training/data.py:17-77`` (the JAX package's module is
numpy only; the port keeps its own). Shuffle at each epoch boundary and wrap
the last partial batch into the next epoch's head, so every batch has
exactly ``batch_size`` rows: the same batches as the JAX ``DataSet`` for the
same seed.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class DataSet:
    def __init__(self, x: np.ndarray, y: np.ndarray, *, seed: int = 121):
        if x.shape[0] != y.shape[0]:
            raise ValueError(f"DataSet: {x.shape[0]} inputs but {y.shape[0]} targets")
        self._x = np.asarray(x)
        self._y = np.asarray(y)
        self._num_examples = x.shape[0]
        self._epochs_completed = 0
        self._index_in_epoch = 0
        self._rng = np.random.RandomState(seed)

    @property
    def num_examples(self) -> int:
        return self._num_examples

    @property
    def epochs_completed(self) -> int:
        return self._epochs_completed

    @property
    def arrays(self):
        """(X, Y) backing arrays, for device-resident sampling (uniform
        sampling does not care that they may be epoch-shuffled in place)."""
        return self._x, self._y

    def next_batch(self, batch_size: int, shuffle: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        start = self._index_in_epoch

        if self._epochs_completed == 0 and start == 0 and shuffle:
            perm0 = self._rng.permutation(self._num_examples)
            self._x = self._x[perm0]
            self._y = self._y[perm0]

        if start + batch_size > self._num_examples:
            self._epochs_completed += 1
            rest = self._num_examples - start
            x_rest, y_rest = self._x[start:], self._y[start:]
            if shuffle:
                perm = self._rng.permutation(self._num_examples)
                self._x = self._x[perm]
                self._y = self._y[perm]
            start = 0
            self._index_in_epoch = batch_size - rest
            end = self._index_in_epoch
            return (
                np.concatenate([x_rest, self._x[start:end]], axis=0),
                np.concatenate([y_rest, self._y[start:end]], axis=0),
            )
        self._index_in_epoch += batch_size
        end = self._index_in_epoch
        return self._x[start:end], self._y[start:end]

    def batches(self, batch_size: int, num_batches: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for _ in range(num_batches):
            yield self.next_batch(batch_size)

    def skip(self, batch_size: int, k: int):
        """Fast-forward past k batches by drawing and discarding them, so a
        resumed run sees the batches the original run would have."""
        for _ in range(k):
            self.next_batch(batch_size)
