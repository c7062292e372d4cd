"""Composite zero-inflated predictors built from a classifier and a regressor.

A copy of ``zigp_tpu/models/composites.py`` (numpy only; the port keeps its
own). Both are post-hoc combiners over the predictions of the Kronecker
classifier and regressor (the reference's scripts/hurdle.py and
scripts/zero_inflated.py):

- ``zero_inflated_combine``: the elementwise product of the classifier's
  probability (or its hard > 0.5 indicator) with the regression mean;
- ``hurdle_combine``: hard classifier labels, overwritten with the
  regression mean at the indices called "on". The hurdle's regressor is a
  ``KronSVGP`` trained on the "on" subset.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ZeroInflatedPrediction(NamedTuple):
    pred_prob: np.ndarray  # p_clf · μ_reg
    pred_indicator: np.ndarray  # 1[p_clf > 0.5] · μ_reg


def zero_inflated_combine(clf_prob: np.ndarray, reg_mean: np.ndarray) -> ZeroInflatedPrediction:
    clf_prob = np.asarray(clf_prob)
    reg_mean = np.asarray(reg_mean)
    indc = (clf_prob > 0.5) * 1.0
    return ZeroInflatedPrediction(clf_prob * reg_mean, indc * reg_mean)


def hurdle_on_indices(clf_prob: np.ndarray) -> np.ndarray:
    """Indices the classifier calls 'on' (p > 0.5) — the hurdle regression
    subset (scripts/hurdle.py:49-54)."""
    return np.where(np.asarray(clf_prob).reshape(-1) > 0.5)[0]


def hurdle_combine(
    clf_prob: np.ndarray, reg_mean_on: np.ndarray, on_idx: np.ndarray
) -> np.ndarray:
    """Combined hurdle prediction: classifier hard label everywhere, replaced
    by the regression mean at 'on' indices (scripts/hurdle.py:360-366)."""
    clf_prob = np.asarray(clf_prob)
    combined = (clf_prob > 0.5) * 1.0
    combined = combined.astype(np.float64).reshape(clf_prob.shape)
    flat = combined.reshape(-1, combined.shape[-1] if combined.ndim > 1 else 1)
    reg = np.asarray(reg_mean_on).reshape(len(on_idx), -1)
    flat[on_idx] = reg
    return flat.reshape(combined.shape)
