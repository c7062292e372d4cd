"""Adam with per-parameter learning-rate groups.

Counterpart of ``zigp_tpu/training/optim.py:20-61``. The JAX package labels
each raw by its ``Parameter.lr`` (``core.parameters.lr_labels``) and runs one
optax Adam per label under ``multi_transform``; Adam is elementwise, so that
is one ``torch.optim.Adam`` with a param group per label. Its update is
optax's: eps 1e-8 outside the square root, bias-corrected moments. A
non-trainable Parameter ("frozen") holds no gradient and joins no group.

``zero_nans`` zeroes NaN gradient entries before the update, as
``optax.zero_nans`` does (``where(isnan(g), 0, g)``); ±inf passes through.
A schedule is a ``LambdaLR`` stepped after each update, so the first update
uses the schedule's value at step 0, as optax's counter does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from ..core.parameters import collect_lrs, lr_labels


class GroupedAdam:
    """``torch.optim.Adam`` over the per-lr groups, with the optional NaN
    zeroing and learning-rate schedule. ``step()`` applies one update from
    the gradients in ``.grad``; ``zero_grad()`` clears them."""

    def __init__(self, adam: torch.optim.Adam, schedule: Optional[Callable[[int], float]], zero_nans: bool):
        self.adam = adam
        self.scheduler = None if schedule is None else torch.optim.lr_scheduler.LambdaLR(adam, schedule)
        self.zero_nans = zero_nans
        self.params = [p for g in adam.param_groups for p in g["params"]]

    def step(self) -> None:
        if self.zero_nans:
            with torch.no_grad():
                for p in self.params:
                    if p.grad is not None:
                        p.grad.masked_fill_(torch.isnan(p.grad), 0.0)
        self.adam.step()
        if self.scheduler is not None:
            self.scheduler.step()

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)


def cosine_scale(step: int, total_steps: int, *, warmup: int = 0, final_scale: float = 0.01) -> float:
    """The learning-rate multiplier at ``step`` of optax's
    ``cosine_decay_schedule(1, total_steps, alpha=final_scale)``, or with
    ``warmup`` of ``warmup_cosine_decay_schedule(0, 1, warmup, total_steps,
    end_value=final_scale)``: a linear ramp from 0, then the cosine from 1 to
    ``final_scale`` over the remaining steps, held there after the end."""
    if warmup:
        if step < warmup:
            return step / warmup
        step, total_steps = step - warmup, total_steps - warmup
    t = min(step, total_steps)
    return (1.0 - final_scale) * 0.5 * (1.0 + math.cos(math.pi * t / total_steps)) + final_scale


def cosine_adam(total_steps: int, *, warmup: int = 0, final_scale: float = 0.01) -> Callable[[int], float]:
    """A schedule for ``make_optimizer``: Adam with (optional warmup +) cosine
    decay to final_scale·lr over total_steps, for every group."""

    def schedule(step: int) -> float:
        return cosine_scale(step, total_steps, warmup=warmup, final_scale=final_scale)

    return schedule


def make_optimizer(
    model: nn.Module,
    *,
    default_lr: float = 1e-3,
    schedule: Optional[Callable[[int], float]] = None,
    zero_nans: bool = True,
) -> GroupedAdam:
    """Adam over ``model``'s trainable raws, one param group per lr label
    ("default" at ``default_lr``, "lr:<value>" at that value), each group's
    learning rate multiplied by ``schedule(step)`` when one is given."""
    lrs = collect_lrs(model, default_lr)
    labels = lr_labels(model)
    members: dict[str, list] = {label: [] for label in lrs}
    for name, raw in model.named_parameters():
        if labels[name] != "frozen":
            members[labels[name]].append(raw)
    groups = [{"params": ps, "lr": lrs[label], "label": label} for label, ps in members.items() if ps]
    return GroupedAdam(torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8), schedule, zero_nans)


def adam_per_group(model: nn.Module, default_lr: float = 1e-3) -> GroupedAdam:
    return make_optimizer(model, default_lr=default_lr)
