"""The on/off model's prediction record.

Counterpart of ``zigp_tpu/models/onoff.py:46-57``: the 9-tuple of the
reference's ``build_predict``, with the same field names and order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class OnOffPrediction(NamedTuple):
    gfmean: torch.Tensor  # E[Φ(g)]·E[f]
    gfvar: torch.Tensor  # E[Φ²(g)]·Var[f]
    gfmeanu: torch.Tensor  # Var[Φ(g)]·E[f]²
    fmean: torch.Tensor
    fvar: torch.Tensor
    gmean: torch.Tensor
    gvar: torch.Tensor
    pgmean: torch.Tensor  # E[Φ(g)]
    pgvar: torch.Tensor  # Var[Φ(g)]
