"""Blocks of K training steps, and the scanned fit loop.

Counterpart of ``zigp_tpu/training/scan.py``. The JAX package runs K steps
per dispatch with ``lax.scan`` over a staged (K, B, D) block; here a block is
a Python loop of K steps over the same staged block, with no host sync
inside it: the losses stay on the device until the caller reads them.

Two sources of minibatches, as in the JAX package:

- "host": shuffled epochs from a ``DataSet``, staged as one (K, B, D) block
  per K steps and copied to the device (``stage_batches``);
- "device": the training set lives on the device, and each block draws its
  K·B row indices with ONE ``torch.randint`` on a seeded device
  ``torch.Generator`` and gathers them ONCE (the JAX package's one
  ``jax.random.randint`` and one gather per block). Sampling is iid uniform
  with replacement; the indices of block b are a function of the sampler
  seed and b alone. They differ from the JAX package's, whose generator is
  another.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from .loop import FitResult, make_train_step


def make_scan_train_step(optimizer, loss_fn: Optional[Callable] = None):
    """A block step ``(model, Xs, Ys) -> losses``: K sequential optimizer
    steps over Xs (K, B, D), Ys (K, B, L); losses (K,) on the device."""
    step = make_train_step(optimizer, loss_fn)

    def scan_step(model, Xs, Ys) -> torch.Tensor:
        return torch.stack([step(model, Xs[k], Ys[k]) for k in range(Xs.shape[0])])

    return scan_step


def block_seed(sampler_seed: int, block: int) -> int:
    """The generator seed of block ``block``: the pair (seed, block) as one
    64-bit integer, as the JAX package builds its block key from the pair."""
    return ((sampler_seed & 0xFFFFFFFF) << 32) | (block & 0xFFFFFFFF)


def make_device_sampling_scan_step(
    optimizer,
    Xtrain: torch.Tensor,
    Ytrain: torch.Tensor,
    batch_size: int,
    loss_fn: Optional[Callable] = None,
):
    """A block step ``(model, seed, num_inner) -> losses`` on device-resident
    data: ``torch.randint`` of num_inner·batch_size indices on a generator of
    ``Xtrain``'s device seeded with ``seed``, one gather of X and Y, then
    num_inner optimizer steps."""
    N = Xtrain.shape[0]
    generator = torch.Generator(device=Xtrain.device)
    scan_step = make_scan_train_step(optimizer, loss_fn)

    def step(model, seed: int, num_inner: int) -> torch.Tensor:
        generator.manual_seed(seed)
        idx = torch.randint(0, N, (num_inner * batch_size,), generator=generator, device=Xtrain.device)
        Xs = Xtrain[idx].reshape(num_inner, batch_size, *Xtrain.shape[1:])
        Ys = Ytrain[idx].reshape(num_inner, batch_size, *Ytrain.shape[1:])
        return scan_step(model, Xs, Ys)

    return step


def stage_batches(data, batch_size: int, num_inner: int, *, device, dtype):
    """Pull num_inner minibatches from a DataSet into one (K, B, ...) block
    of each of X and Y, on ``device`` in ``dtype``."""
    xs, ys = [], []
    for _ in range(num_inner):
        bx, by = data.next_batch(batch_size)
        xs.append(bx)
        ys.append(by)
    to = lambda a: torch.as_tensor(np.stack(a), dtype=dtype).to(device)
    return to(xs), to(ys)


_NOT_PORTED = ("ckpt_manager", "metric_logger", "mesh", "alternating", "callback")


def fit_scanned(
    model,
    data,
    *,
    num_iter: int,
    batch_size: int,
    num_inner: int = 50,
    optimizer=None,
    learning_rate: float = 1e-3,
    log_every_blocks: int = 1,
    log_fn: Callable[[str], None] = print,
    loss_fn: Optional[Callable] = None,
    start_step: int = 0,
    sampler: str = "host",
    sampler_seed: int = 0,
    ckpt_manager=None,
    metric_logger=None,
    mesh=None,
    alternating: int = 0,
    callback=None,
) -> FitResult:
    """Train ``model`` in place for ``num_iter`` steps, rounded up to whole
    blocks of ``num_inner``, on minibatches of ``batch_size`` from ``data``
    (a ``DataSet``) by ``sampler`` ("host" or "device"; see the module
    docstring). The model's device and dtype are the data's on the device.

    At every ``log_every_blocks``-th block the last loss of the block is read
    (one host sync) and logged. The run's step rate excludes the first
    block, as the JAX package's does. A non-finite loss at the end raises
    ``FloatingPointError``.

    Checkpoints (``ckpt_manager``), metric logs (``metric_logger``), meshes,
    the block-coordinate schedule (``alternating``) and callbacks are not
    ported yet: setting any of them raises ``NotImplementedError``."""
    given = {"ckpt_manager": ckpt_manager, "metric_logger": metric_logger, "mesh": mesh,
             "alternating": alternating, "callback": callback}
    unported = [name for name in _NOT_PORTED if given[name]]
    if unported:
        raise NotImplementedError(f"fit_scanned: {unported} not ported to zigp_tpu_torch yet")
    if sampler not in ("host", "device"):
        raise ValueError(f"fit_scanned: unknown sampler {sampler!r}")
    if optimizer is None:
        from .optim import make_optimizer

        optimizer = make_optimizer(model, default_lr=learning_rate)

    p0 = next(model.parameters())
    device, dtype = p0.device, p0.dtype
    if sampler == "device":
        X, Y = data.arrays
        step = make_device_sampling_scan_step(
            optimizer,
            torch.as_tensor(np.asarray(X), dtype=dtype).to(device),
            torch.as_tensor(np.asarray(Y), dtype=dtype).to(device),
            batch_size,
            loss_fn,
        )
    else:
        step = make_scan_train_step(optimizer, loss_fn)

    num_blocks = max(1, -(-num_iter // num_inner))
    all_losses = []
    losses = []
    t_start = time.perf_counter()
    timed_steps = 0
    steps_done = start_step
    for b in range(num_blocks):
        if sampler == "device":
            block_losses = step(model, block_seed(sampler_seed, start_step // num_inner + b), num_inner)
        else:
            block_losses = step(model, *stage_batches(data, batch_size, num_inner, device=device, dtype=dtype))
        all_losses.append(block_losses)
        steps_done += num_inner
        if b == 0:
            float(block_losses[-1])  # waits for the first block: warm-up is not timed
            t_start = time.perf_counter()
        else:
            timed_steps += num_inner
        if log_every_blocks and b % log_every_blocks == 0:
            last = float(block_losses[-1])
            losses.append(last)
            log_fn(f"step {steps_done:>8d}  loss {last:.6f}")
    step_losses = torch.cat(all_losses).cpu()  # waits for the device
    elapsed = max(time.perf_counter() - t_start, 1e-12)
    final_loss = float(step_losses[-1])
    if not np.isfinite(final_loss):
        raise FloatingPointError(
            f"fit_scanned finished at step {steps_done} with a non-finite loss ({final_loss})"
        )
    return FitResult(
        model=model,
        optimizer=optimizer,
        losses=losses,
        steps_per_sec=timed_steps / elapsed if timed_steps else 0.0,
        final_loss=final_loss,
        step_losses=step_losses,
    )
