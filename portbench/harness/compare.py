"""The numbers that decide ``correct``, each held to a limit from the cell's
workload file.

Training, at the start (the first three steps of the window's own call
and feed, from the benchmark's inputs):

- ``loss_gap``: the largest |L_prog − L_ref| / |L_ref| over the steps;
- ``grad_gap``: the first gradient as the optimizer got it (its first
  moment after one step ÷ (1 − β₁)), by the worst leaf: the gap between the
  program's norm and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf;
- ``step_gap``: the parameters' change after the three steps, by the worst
  leaf in the same measure, leaving out the leaves whose reference gradient
  is under a thousandth of the median leaf's (Adam moves those by
  round-off alone);
- ``data_grad_gap``: the first gradient in the same measure, by the worst
  of the leaves that the KL does not reach (the reference's ∂KL/∂leaf is
  0: the likelihood's), whose gradient is the data term's alone;
- ``data_gap``: the first step's data term, the loss less the KL at the
  same parameters (the program's own ``prior_kl``), |D_prog − D_ref| /
  |D_ref|: what a fault in the batch changes, apart from the KL.

And over the first replayed block, the window's graph, which the reference
follows from the program's state at the block's start:

- ``replay_loss_gap``: as ``loss_gap``, over the block's first three steps;
- ``replay_data_gap``: as ``data_gap``, at the block's first step;
- ``replay_step_gap``: as ``step_gap``, the change over the whole block.

A cell whose worst leaf is rounding by the model's own conditioning (its
workload file's ``numbers``: ``{"losses": "first", "leaves": "median"}``;
PERF.md gives the look) compares the steadier first loss of each stretch
(``loss1_gap``, ``replay_loss1_gap``) and the median leaf's gap
(``grad_gap_median``, ``step_gap_median``, ``replay_step_gap_median``) in
their place. ``replay_losses``, ``step_leaves`` and ``replay_step_leaves``
set the replay's losses, the start's change and the replay's apart from the
rest: Adam moves an element by up to its learning rate a step whichever the
size of its gradient, so an element whose gradient is nought to rounding
moves on the sign of its round-off, and the start's later losses and a
worst leaf's change follow that sign (PERF.md gives the look at the
flagship cells).

Serving: ``field_gap``, the largest |prog − ref| over the sampled rows of
every call of the window, by the worst of the 9 fields, over the root mean
square of the reference's field on those rows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit

    def line(self) -> str:
        return f"check {self.name} {self.value!r} limit {self.limit!r} {'ok' if self.ok else 'FAILED'}"


def _norms(d: Dict[str, np.ndarray]) -> Dict[str, float]:
    return {n: float(np.linalg.norm(np.asarray(v, dtype=np.float64))) for n, v in d.items()}


def norm_gap(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray], leaves: List[str],
             over: str = "worst") -> float:
    """|‖prog‖ − ‖ref‖| / max(‖ref‖, median leaf's ‖ref‖) of each of
    ``leaves``: the largest (``over`` "worst") or the median ("median")."""
    pn, rn = _norms({n: prog[n] for n in leaves}), _norms({n: ref[n] for n in leaves})
    med = float(np.median([rn[n] for n in leaves]))
    gaps = [abs(pn[n] - rn[n]) / max(rn[n], med, 1e-300) for n in leaves]
    if not all(map(math.isfinite, gaps)):
        return math.inf
    return max(gaps) if over == "worst" else float(np.median(gaps))


def moved_leaves(grad_ref: Dict[str, np.ndarray], share: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's (the others move under Adam by round-off alone)."""
    rn = _norms(grad_ref)
    med = float(np.median(list(rn.values())))
    return [n for n, v in rn.items() if v >= share * med]


def _loss_gap(prog: list, ref: list, n: int) -> float:
    lp = np.asarray(prog[:n], dtype=np.float64)
    lr = np.asarray(ref[:n], dtype=np.float64)
    if lp.shape != lr.shape or not np.all(np.isfinite(lp)):
        return math.inf
    return float(np.max(np.abs(lp - lr) / np.abs(lr)))


def _rel(p: float, r: float) -> float:
    return abs(p - r) / abs(r) if math.isfinite(p) else math.inf


def _losses(losses: str):
    """(the count of steps compared, the number's name) for ``losses``."""
    return (1, "loss1_gap") if losses == "first" else (3, "loss_gap")


def _suffix(leaves: str) -> str:
    return "_median" if leaves == "median" else ""


def train_numbers(prog: dict, ref: dict, losses: str = "each", leaves: str = "worst",
                  replay_losses: Optional[str] = None, step_leaves: Optional[str] = None,
                  replay_step_leaves: Optional[str] = None) -> Dict[str, float]:
    """``prog`` and ``ref``: {"start": {"losses": [3], "data", "grad":
    {leaf: array}, "delta": {leaf: array}}, "replay": {"losses": [3],
    "data", "delta"}}, by the same leaf names; ``losses`` "each" or "first",
    ``leaves`` "worst" or "median"; ``replay_losses`` (as ``losses`` by
    default) the replay's, ``step_leaves`` and ``replay_step_leaves`` (as
    ``leaves`` by default) the start's change and the replay's (see the
    module docstring)."""
    ps, rs = prog["start"], ref["start"]
    if set(ps["grad"]) != set(rs["grad"]):
        raise ValueError(f"leaves differ: {sorted(set(ps['grad']) ^ set(rs['grad']))}")
    n, lname = _losses(losses)
    step_leaves = step_leaves or leaves
    suffix = _suffix(leaves)
    names = sorted(rs["grad"])
    moved = moved_leaves(rs["grad"])
    out = {
        lname: _loss_gap(ps["losses"], rs["losses"], n),
        "grad_gap" + suffix: norm_gap(ps["grad"], rs["grad"], names, leaves),
        "step_gap" + _suffix(step_leaves): norm_gap(ps["delta"], rs["delta"], moved, step_leaves),
    }
    if rs.get("data_leaves"):
        rn = _norms(rs["grad"])
        pn = _norms({k: ps["grad"][k] for k in rs["data_leaves"]})
        gaps = [abs(pn[k] - rn[k]) / max(rn[k], 1e-300) for k in rs["data_leaves"]]
        out["data_grad_gap"] = max(gaps) if all(map(math.isfinite, gaps)) else math.inf
    out["data_gap"] = _rel(ps["data"], rs["data"])
    if "replay" in ref:
        pr, rr = prog["replay"], ref["replay"]
        rn, rname = _losses(replay_losses or losses)
        out["replay_" + rname] = _loss_gap(pr["losses"], rr["losses"], rn)
        out["replay_data_gap"] = _rel(pr["data"], rr["data"])
        replay_step_leaves = replay_step_leaves or leaves
        out["replay_step_gap" + _suffix(replay_step_leaves)] = norm_gap(pr["delta"], rr["delta"], moved,
                                                                       replay_step_leaves)
    return out


def serve_numbers(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    worst = 0.0
    for k, r in ref.items():
        r = np.asarray(r, dtype=np.float64)
        p = np.asarray(prog[k], dtype=np.float64)
        if not np.all(np.isfinite(p)):
            return {"field_gap": math.inf}
        scale = max(float(np.sqrt(np.mean(np.square(r)))), 1e-300)
        worst = max(worst, float(np.max(np.abs(p - r))) / scale)
    return {"field_gap": worst}


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    missing = set(numbers) - set(limits)
    if missing:
        raise ValueError(f"no limit for {sorted(missing)}")
    return [Check(n, float(numbers[n]), float(limits[n])) for n in numbers]
