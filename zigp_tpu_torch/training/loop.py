"""One training step: loss, gradients and the optimizer's update.

Counterpart of ``make_train_step`` in ``zigp_tpu/training/loop.py:25-44``.
The JAX step is a jitted pure function of (model, opt_state, X, Y); here the
model's parameters and the optimizer's moments are updated in place, so the
step takes the model and the batch and returns the loss. ``fit`` (the
per-step loop with checkpoints and NaN restore) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import torch


def make_train_step(optimizer, loss_fn: Optional[Callable] = None):
    """A step ``(model, X, Y) -> loss``: one value-and-grad of the loss
    (default ``model.loss``) and one update of ``optimizer``
    (``training.optim.make_optimizer``). The returned loss is detached and
    stays on the device."""

    def step(model, X, Y) -> torch.Tensor:
        optimizer.zero_grad()
        loss = loss_fn(model, X, Y) if loss_fn is not None else model.loss(X, Y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


@dataclass
class FitResult:
    model: Any
    optimizer: Any
    losses: List[float] = field(default_factory=list)  # at the log points
    steps_per_sec: float = 0.0  # host clock, after the first block
    final_loss: float = float("nan")
    # every step's loss of the run, in order, copied to the host once at the end
    step_losses: Optional[torch.Tensor] = None
