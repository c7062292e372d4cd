"""One training step, and the per-step fit loop.

Counterpart of ``zigp_tpu/training/loop.py``. The JAX step is a jitted pure
function of (model, opt_state, X, Y); here the model's parameters and the
optimizer's moments are updated in place, so the step takes the model and
the batch and returns the loss. ``fit`` is the per-step loop with its
finiteness cadence, checkpoints, NaN restore and callback; on the card each
of its steps is one replay of a captured block of one step
(``training.scan.BlockRunner``), the mechanism ``fit_scanned`` uses.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch


def make_train_step(optimizer, loss_fn: Optional[Callable] = None):
    """A step ``(model, X, Y) -> loss``: one value-and-grad of the loss
    (default ``model.loss``) and one update of ``optimizer``
    (``training.optim.make_optimizer``). The gradients accumulate into the
    optimizer's zeroed buffers, so the step allocates no lasting storage and
    can be captured in a CUDA graph. The returned loss is detached and stays
    on the device."""

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
    optimizer: Any  # holds the end state: the counterpart of the JAX opt_state
    losses: List[float] = field(default_factory=list)  # at the log points
    steps_per_sec: float = 0.0  # host clock, after the first block (and the capture)
    # True when training stopped early on Ctrl-C (after checkpointing for
    # resume): callers that run several fits must abort, not treat the
    # partial run as trained.
    interrupted: bool = False
    # the loss of the last trained step or block; NaN = unknown (no step, an
    # interrupted run, or a last block restored from a checkpoint)
    final_loss: float = float("nan")
    # every step's loss of the run, in order, copied to the host once at the end
    step_losses: Optional[torch.Tensor] = None


def block_for_interrupt(model, log_fn, interrupt: BaseException, *, mid_step: bool = False) -> None:
    """After a KeyboardInterrupt in a training loop, wait for the card so the
    state is safe to checkpoint. If the interrupt landed inside a step or
    block (``mid_step``), the state is between steps, with nothing to
    checkpoint: re-raise, and ``resume`` picks up from the last periodic
    checkpoint (the JAX package's case of donated buffers)."""
    p = next(model.parameters(), None)
    if p is not None and p.is_cuda:
        torch.cuda.synchronize(p.device)
    if mid_step:
        log_fn("interrupted inside a step — no state between steps to checkpoint; resume from the last periodic "
               "checkpoint")
        raise interrupt


def save_final(ckpt_manager, steps_done: int, restored_this_block: bool, model, optimizer, log_fn,
               mesh=None) -> None:
    """The save at completion (the reference saves after its loop whatever
    the cadence), so restore-and-predict sees the trained state. Not after a
    last-block NaN restore: re-stamping the restored (older) state at
    ``steps_done`` would present a half-trained model as trained. On a
    ``mesh`` whose ranks share the directory, rank 0's reading of it decides
    for every rank: a rank that read it after rank 0 had written this save
    would skip the save's barrier."""
    if restored_this_block:
        log_fn(
            f"run ended in a NaN-restored state — final checkpoint stays at step "
            f"{ckpt_manager.latest_step() if ckpt_manager else '?'}, not {steps_done}"
        )
    elif ckpt_manager is not None:
        stale = ckpt_manager.latest_step() != steps_done
        if stale if mesh is None else mesh.agree(stale):
            ckpt_manager.save_at(steps_done, model, optimizer)


def fit(
    model,
    data,
    *,
    num_iter: int,
    batch_size: int,
    optimizer=None,
    learning_rate: float = 1e-3,
    log_every: int = 200,
    log_fn: Callable[[str], None] = print,
    callback: Optional[Callable[[int, Any, torch.Tensor], None]] = None,
    loss_fn: Optional[Callable] = None,
    ckpt_manager=None,
    recover_on_nan: bool = True,
    start_step: int = 0,
) -> FitResult:
    """The per-step Adam loop of ``zigp_tpu/training/loop.py:fit``:
    ``num_iter`` steps on ``data``'s next batches of ``batch_size``, a log
    every ``log_every`` steps, ``callback(i, model, loss)`` after each step.

    With a ``ckpt_manager`` a checkpoint is written at its cadence and, with
    ``recover_on_nan``, the loss is checked at min(log_every, the cadence)
    steps: a non-finite one restores the model and optimizer from the latest
    checkpoint, in place. ``i`` counts from 0 in this call, as in the JAX
    package; ``start_step`` (a resumed run's) offsets the checkpoint names
    and nothing else (0 in the JAX package, which names a resumed run's
    checkpoints from 0)."""
    from .optim import make_optimizer
    from .scan import BlockRunner, StagedBlocks, make_scan_train_step

    if optimizer is None:
        optimizer = make_optimizer(model, default_lr=learning_rate)
    p0 = next(model.parameters())
    batches = StagedBlocks(data, "host", batch_size, 1, device=p0.device, dtype=p0.dtype)
    body = make_scan_train_step(optimizer, loss_fn)
    runner = BlockRunner(lambda: body(model, batches.Xs, batches.Ys), batches.Xs)

    check_every = log_every or 0
    if ckpt_manager is not None and recover_on_nan:
        cadence = getattr(ckpt_manager, "every", 0) or 200
        check_every = min(check_every or cadence, cadence)
    losses: List[float] = []
    all_losses = []
    t_start = time.perf_counter()
    timed_steps = 0
    for i in range(num_iter):
        batches.fill(0)
        loss = runner()[0]
        all_losses.append(loss)
        capture = runner.wants_capture and i + 1 < num_iter  # only for steps to come
        if i == 0 or capture:
            float(loss)  # waits: the first step and the capture are not timed
            if capture:
                log_fn(f"iter {i:>8d}  step graph: {runner.capture().graph.describe()}")
            t_start = time.perf_counter()
            timed_steps = 0
        else:
            timed_steps += 1
        if check_every and i % check_every == 0:
            loss_val = float(loss)
            if not np.isfinite(loss_val):
                log_fn(f"iter {i:>8d}  NON-FINITE loss")
                if ckpt_manager is not None and recover_on_nan:
                    restored = ckpt_manager.restore_latest(model, optimizer)
                    if restored is not None:
                        log_fn(f"restored from checkpoint at step {restored[2]}")
                        continue
            if log_every and i % log_every == 0:
                losses.append(loss_val)
                log_fn(f"iter {i:>8d}  loss {loss_val:.6f}")
        if ckpt_manager is not None and i > 0:
            ckpt_manager.maybe_save(start_step + i, model, optimizer)
        if callback is not None:
            callback(i, model, loss)
    step_losses = torch.stack(all_losses).cpu() if all_losses else None  # waits for the device
    elapsed = max(time.perf_counter() - t_start, 1e-12)
    # the final save, gated as every other save site: never unverified state
    end = start_step + num_iter
    if (
        ckpt_manager is not None
        and num_iter > 0
        and ckpt_manager.latest_step() != end
        and np.isfinite(float(step_losses[-1]))
    ):
        ckpt_manager.save_at(end, model, optimizer)
    return FitResult(
        model=model,
        optimizer=optimizer,
        losses=losses,
        steps_per_sec=timed_steps / elapsed if timed_steps else 0.0,
        final_loss=float(step_losses[-1]) if num_iter > 0 else float("nan"),
        step_losses=step_losses,
    )
