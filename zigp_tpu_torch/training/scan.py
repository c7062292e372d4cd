"""Blocks of K training steps, one dispatch each on the card, and the
production fit loop.

Counterpart of ``zigp_tpu/training/scan.py``. The JAX package runs K steps
per dispatch with ``lax.scan`` over a staged (K, B, D) block. Here the block
is a Python loop of K steps (``make_scan_train_step``), which is what runs on
the CPU; on the card that loop is captured once in a CUDA graph
(``make_graphed_scan_step``) and each later block is one replay, the
counterpart of ``lax.scan``'s one dispatch. Parameters, gradients and the
optimizer's state live in storage allocated before the capture
(``training.optim``), and each block's minibatches are copied into one static
(K, B, ·) pair, so a replay reads what an eager block would. The losses stay
on the device until the caller reads them. ``BlockRunner`` takes the block
body as a callable, so the joint block, the block-coordinate schedule's
(``training.alternating``) and the natural-gradient trainer's
(``training.natgrad``) share one capture path.

Two sources of minibatches, as in the JAX package:

- "host": shuffled epochs from a ``DataSet``, staged as one (K, B, D) block
  per K steps and copied to the device;
- "device": the training set lives on the device, and each block draws its
  K·B row indices with ONE ``torch.randint`` on a seeded device
  ``torch.Generator`` and gathers them ONCE (the JAX package's one
  ``jax.random.randint`` and one gather per block), outside the graph, into
  the static block. Sampling is iid uniform with replacement; the indices of
  block b are a function of the sampler seed and b alone. They differ from
  the JAX package's, whose generator is another.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.profiling import span
from .loop import FitResult, block_for_interrupt, make_train_step, save_final

# Eager steps before a capture (real steps of the run): at least one block.
WARMUP_STEPS = 3


def make_scan_train_step(optimizer, loss_fn: Optional[Callable] = None):
    """A block step ``(model, Xs, Ys) -> losses``: K sequential optimizer
    steps over Xs (K, B, D), Ys (K, B, L); losses (K,) on the device."""
    step = make_train_step(optimizer, loss_fn)

    def scan_step(model, Xs, Ys) -> torch.Tensor:
        return torch.stack([step(model, Xs[k], Ys[k]) for k in range(Xs.shape[0])])

    return scan_step


def capture_block(body: Callable[[], torch.Tensor]):
    """Capture ``body()`` (a block of steps on static CUDA tensors that
    returns its (K,) losses) in one CUDA graph: the counterpart of the JAX
    package's jitted ``lax.scan`` block. Returns ``step() -> losses``: one
    replay on whatever the caller has copied into the block's static inputs,
    the losses copied out of the graph's pool (the next replay overwrites
    it); ``step.graph`` is the ``ops.cuda.graphs.CountedGraph`` (capture
    and instantiate times, pool size, launches a replay). An eager run of
    ``body`` must have come first, on a side stream
    (``ops.cuda.graphs.on_side_stream``): it builds and loads the kernels.
    A capture that fails raises. ``step.body`` keeps ``body``, and with it
    the model and optimizer storage the graph reads and writes, alive as
    long as the graph: a graph replayed after its caller let them go would
    write into freed memory."""
    from ..ops.cuda.graphs import CountedGraph

    graph = CountedGraph()
    with graph.capture():
        losses = body()

    def step() -> torch.Tensor:
        graph.replay()
        return losses.clone()

    step.graph = graph
    step.body = body
    return step


def make_graphed_scan_step(optimizer, model, Xs, Ys, loss_fn: Optional[Callable] = None):
    """``capture_block`` of K optimizer steps over the static CUDA blocks
    Xs (K, B, D), Ys (K, B, L)."""
    body = make_scan_train_step(optimizer, loss_fn)
    return capture_block(lambda: body(model, Xs, Ys))


class BlockRunner:
    """The blocks of a run: ``body()`` runs one block of K steps on static
    tensors (``Xs``, (K, B, ·), tells the device and K) and returns its
    losses. The joint, alternating and natural-gradient blocks all run
    through it. On the CPU each call runs ``body``. On the card the first
    ⌈WARMUP_STEPS / K⌉ calls run it on a side stream, as a capture's warm-up
    (real steps of the run); then ``capture()`` (when ``wants_capture``) and
    every later call is one replay. ``capture=False`` runs every block
    eagerly: a block with gloo collectives, which a graph cannot hold."""

    def __init__(self, body: Callable[[], torch.Tensor], Xs: torch.Tensor, *, capture: bool = True):
        self.body = body
        self.cuda = Xs.device.type == "cuda" and capture
        self.warm = math.ceil(WARMUP_STEPS / Xs.shape[0]) if self.cuda else 0
        self.graphed = None

    @property
    def wants_capture(self) -> bool:
        return self.cuda and self.warm == 0 and self.graphed is None

    def capture(self):
        self.graphed = capture_block(self.body)
        return self.graphed

    def __call__(self) -> torch.Tensor:
        if not self.cuda:
            return self.body()
        if self.graphed is None:
            if self.warm == 0:
                self.capture()
            else:
                self.warm -= 1
                from ..ops.cuda.graphs import on_side_stream

                return on_side_stream(self.body)
        return self.graphed()


def block_seed(sampler_seed: int, block: int) -> int:
    """The generator seed of block ``block``: the pair (seed, block) as one
    64-bit integer, as the JAX package builds its block key from the pair."""
    return ((sampler_seed & 0xFFFFFFFF) << 32) | (block & 0xFFFFFFFF)


def _draw(generator: torch.Generator, seed: int, N: int, count: int) -> torch.Tensor:
    """``count`` row indices in [0, N), uniform with replacement, from
    ``generator`` seeded with ``seed``: one ``randint`` on its device."""
    generator.manual_seed(seed)
    return torch.randint(0, N, (count,), generator=generator, device=generator.device)


def _next_batches(data, batch_size: int, num_inner: int):
    """The next ``num_inner`` batches of a DataSet, stacked: (K, B, ...) numpy.
    A data set with ``next_block`` (``io.native.NativeDataSet``) stages them
    in one call, as the JAX package's ``stage_batches`` does."""
    if hasattr(data, "next_block"):
        return data.next_block(batch_size, num_inner)
    xs, ys = zip(*(data.next_batch(batch_size) for _ in range(num_inner)))
    return np.stack(xs), np.stack(ys)


def stage_batches(data, batch_size: int, num_inner: int, *, device, dtype):
    """Pull num_inner minibatches from a DataSet into one (K, B, ...) block
    of each of X and Y, on ``device`` in ``dtype``."""
    return tuple(torch.as_tensor(a, dtype=dtype).to(device) for a in _next_batches(data, batch_size, num_inner))


class StagedBlocks:
    """One static (K, B, ·) pair ``Xs``, ``Ys`` on ``device``, refilled for
    each block by ``fill(block)``: from ``data`` (a ``DataSet``) by
    ``sampler`` "host" (the next K batches of its epochs) or "device" (the
    training set on the device, ``block_seed(sampler_seed, block)``'s
    indices gathered once). ``rows``: a data-parallel rank's block of each
    batch's B rows (``parallel.mesh.row_block``); the pair is then
    (K, rows, ·), and the batches are the whole run's, of which it keeps its
    rows."""

    def __init__(self, data, sampler: str, batch_size: int, num_inner: int, *, device, dtype, sampler_seed: int = 0,
                 rows: Optional[slice] = None):
        if sampler not in ("host", "device"):
            raise ValueError(f"unknown sampler {sampler!r}")
        X, Y = (np.asarray(a) for a in data.arrays)
        self.data, self.sampler, self.batch_size, self.seed = data, sampler, batch_size, sampler_seed
        self.rows = rows if rows is not None else slice(0, batch_size)
        b = len(range(batch_size)[self.rows])
        self.Xs = torch.empty((num_inner, b, *X.shape[1:]), dtype=dtype, device=device)
        self.Ys = torch.empty((num_inner, b, *Y.shape[1:]), dtype=dtype, device=device)
        if sampler == "device":
            self.Xtrain = torch.as_tensor(X, dtype=dtype).to(device)
            self.Ytrain = torch.as_tensor(Y, dtype=dtype).to(device)
            self.generator = torch.Generator(device=device)

    def fill(self, block: int) -> None:
        if self.sampler == "device":
            self.fill_seed(block_seed(self.seed, block))
        else:
            xs, ys = _next_batches(self.data, self.batch_size, self.Xs.shape[0])
            self.Xs.copy_(torch.from_numpy(np.ascontiguousarray(xs[:, self.rows])))
            self.Ys.copy_(torch.from_numpy(np.ascontiguousarray(ys[:, self.rows])))

    def fill_seed(self, seed: int) -> None:
        """The device sampler's block of generator seed ``seed``: all K·B
        indices drawn, this block's rows of each step gathered."""
        K, b = self.Xs.shape[:2]
        idx = _draw(self.generator, seed, self.Xtrain.shape[0], K * self.batch_size)
        if b != self.batch_size:
            idx = idx.view(K, self.batch_size)[:, self.rows].reshape(-1)
        torch.index_select(self.Xtrain, 0, idx, out=self.Xs.view(K * b, *self.Xs.shape[2:]))
        torch.index_select(self.Ytrain, 0, idx, out=self.Ys.view(K * b, *self.Ys.shape[2:]))


def mesh_blocks(mesh, data, sampler: str, batch_size: int, num_inner: int, like: torch.Tensor, sampler_seed: int,
                log_fn) -> tuple:
    """(``StagedBlocks`` of this rank's rows of every batch, on ``like``'s
    device and dtype; whether its blocks may be captured): on a mesh the
    rank's block of rows, and no capture under gloo, whose collectives a
    CUDA graph cannot hold (logged once)."""
    rows = None
    if mesh is not None:
        from ..parallel.mesh import row_block

        rows = row_block(mesh, batch_size)
    blocks = StagedBlocks(data, sampler, batch_size, num_inner, device=like.device, dtype=like.dtype,
                          sampler_seed=sampler_seed, rows=rows)
    capture = mesh is None or mesh.backend != "gloo"
    if not capture and like.is_cuda:
        log_fn("gloo collectives cannot be captured: the blocks run eagerly")
    return blocks, capture


def _agree(mesh, value):
    """``value`` as rank 0 sees it, on every rank of ``mesh`` (a branch the
    ranks must take together); ``value`` itself without a mesh."""
    return value if mesh is None else mesh.agree(value)


def _loss_of(loss_fn):
    return (lambda m, X, Y: loss_fn(m, X, Y)) if loss_fn is not None else (lambda m, X, Y: m.loss(X, Y))


def _all_grads(model, loss, X, Y) -> dict:
    """{raw name: gradient of the loss on (X, Y)} for every raw, frozen ones
    included (zero where the loss does not reach it), as ``jax.grad`` of
    the model gives: computed eagerly, leaving ``.grad`` untouched."""
    named = list(model.named_parameters())
    frozen = [p for _, p in named if not p.requires_grad]
    for p in frozen:
        p.requires_grad_(True)
    try:
        grads = torch.autograd.grad(loss(model, X, Y), [p for _, p in named], allow_unused=True)
    finally:
        for p in frozen:
            p.requires_grad_(False)
    return {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named, grads)}


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
    ckpt_manager=None,
    recover_on_nan: bool = True,
    metric_logger=None,
    hist_every: int = 0,
    callback: Optional[Callable] = None,
    callback_every: int = 0,
    sampler: str = "host",
    sampler_seed: int = 0,
    mesh=None,
    mesh_tp: bool = False,
    alternating: int = 0,
    alt_opt_factories=None,
) -> FitResult:
    """Train ``model`` in place for ``num_iter`` steps in this call, rounded
    up to whole blocks of ``num_inner``, on minibatches of ``batch_size``
    from ``data`` (a ``DataSet``) by ``sampler`` ("host" or "device"; see the
    module docstring). The model's device and dtype are the data's on the
    device. On the card every block after the warm-up is one replay of the
    captured block (``BlockRunner``); a capture that fails raises.

    ``optimizer`` (``make_optimizer``; by default Adam at ``learning_rate``)
    carries the start state, the counterpart of the JAX ``opt_state``: a
    resumed run passes the one ``CheckpointManager.restore_latest`` wrote
    into. ``start_step`` offsets the step count of the logs and checkpoint
    names, and the device sampler's block index.

    As the JAX package's production loop:

    - ``ckpt_manager`` (``io.checkpoint.CheckpointManager``): a checkpoint
      at ``start_step`` when its directory is empty, so NaN recovery always
      has a target, one whenever a block crosses its cadence, and one at the
      end (``save_final``);
    - ``recover_on_nan``: a non-finite block loss restores the model and the
      optimizer from the latest checkpoint, in place; poisoned state is
      never checkpointed (the loss is checked first);
    - ``metric_logger`` (``utils.logging.MetricLogger``): scalars loss,
      elbo, kl and var_exp at the log cadence, and with ``hist_every`` > 0
      parameter and gradient histograms at that step cadence (the gradients
      computed eagerly, outside the graph);
    - ``callback(step, model)`` every ``callback_every`` steps;
    - Ctrl-C between blocks checkpoints the state and returns with
      ``interrupted``; one inside a block re-raises (``block_for_interrupt``).

    ``alternating`` > 0: the block-coordinate schedule
    (``training.alternating``): the hyperparameters update once per that
    many steps by their own Adam, and the q-only steps between take the
    factorization computed once after it. It needs ``sampler="device"``, the
    model's own loss, and ``alternating`` dividing ``num_inner``;
    ``optimizer`` is then the pair of ``init_alt_optimizers`` (by default
    made here, with ``alt_opt_factories``: the (q, h) schedules), and the
    checkpoints hold both.

    The host reads a loss only at the log points and checkpoint boundaries
    (and once at the end). The run's step rate counts the blocks after the
    first and, on the card, after the capture. A non-finite loss at the end
    raises ``FloatingPointError``, unless the last block was restored.
    ``mesh`` (``parallel.make_mesh``; this process is one of its ranks):
    data-parallel training, each rank on its B / n_data rows of every batch
    (both samplers draw the single-rank batches), its gradient summed over
    the data group every step (``parallel.step``); the model is first
    broadcast from rank 0. ``mesh_tp``: the M-row variational raws and their
    Adam moments row-sharded over the model axis too (``parallel.tp_place``;
    the result's ``optimizer`` is the placed one), joint Adam only. The
    losses every rank reads are summed over the data group, so every rank
    takes the same branches; rank 0 alone writes the checkpoints and the
    metrics. Under gloo the blocks run eagerly (its collectives cannot be
    captured); under NCCL a block is one replay, its all-reduces inside.

    Under a recording ``torch.profiler`` each block is the span
    ``zigp.train.block`` and its parts are spans of their own
    (``utils.profiling``); none is opened inside a captured body."""
    if sampler not in ("host", "device"):
        raise ValueError(f"fit_scanned: unknown sampler {sampler!r}")
    if mesh is None and mesh_tp:
        raise ValueError("fit_scanned: mesh_tp needs a mesh")
    if mesh is not None and batch_size % mesh.shape["data"]:
        raise ValueError(f"batch size {batch_size} not divisible by data axis {mesh.shape['data']}")
    if alternating:
        from .alternating import init_alt_optimizers, make_alternating_block

        if sampler != "device" or loss_fn is not None:
            raise ValueError(
                "alternating training requires sampler='device' and the model's own loss (loss_fn=None)")
        if mesh_tp:
            raise ValueError("alternating training supports data-parallel meshes only (mesh_tp=False)")
        if num_inner % alternating:
            raise ValueError(f"scan_inner ({num_inner}) must divide by hyper_every ({alternating})")
        if mesh is not None:
            from ..parallel.mesh import replicate

            replicate(mesh, model)
        if optimizer is None:
            optimizer = init_alt_optimizers(model, learning_rate=learning_rate, opt_factories=alt_opt_factories)
        step = make_alternating_block(model, optimizer, alternating, mesh=mesh)
    else:
        if optimizer is None:
            from .optim import make_optimizer

            optimizer = make_optimizer(model, default_lr=learning_rate)
        if mesh is not None:
            from ..parallel.mesh import replicate
            from ..parallel.step import make_local_block
            from ..parallel.tp import tp_place

            if mesh_tp:
                optimizer = tp_place(mesh, model, optimizer)
            else:
                replicate(mesh, model)
            train = make_local_block(optimizer, mesh, loss_fn)
        else:
            train = make_scan_train_step(optimizer, loss_fn)
        step = lambda Xs, Ys: train(model, Xs, Ys)

    p0 = next(model.parameters())
    loss = _loss_of(loss_fn)
    if mesh is not None:
        from ..parallel.step import sharded_loss

        loss = sharded_loss(loss_fn, mesh)
    blocks, capture = mesh_blocks(mesh, data, sampler, batch_size, num_inner, p0, sampler_seed, log_fn)
    runner = BlockRunner(lambda: step(blocks.Xs, blocks.Ys), blocks.Xs, capture=capture)
    kl_fn = model.prior_kl if hasattr(model, "prior_kl") else None
    hist = metric_logger is not None and hist_every

    if ckpt_manager is not None and _agree(mesh, ckpt_manager.latest_step() is None):
        with span("train.checkpoint"):
            ckpt_manager.save_at(start_step, model, optimizer)

    # ceil: never train fewer steps than asked (the JAX package's rule)
    num_blocks = max(1, -(-num_iter // num_inner))
    all_losses, losses = [], []
    t_start = time.perf_counter()
    timed_steps = 0
    steps_done = start_step
    restored_this_block = False
    in_block = False
    block_losses = None
    try:
        for b in range(num_blocks):
            with span("train.block"):
                restored_this_block = False
                in_block = True
                with span("train.fill"):
                    blocks.fill(start_step // num_inner + b)
                with span("train.replay" if runner.graphed is not None else "train.eager"):
                    block_losses = runner()
                all_losses.append(block_losses)
                prev_steps = steps_done
                steps_done += num_inner
                in_block = False
                capture = runner.wants_capture and b + 1 < num_blocks  # only for blocks to come
                if b == 0 or capture:
                    with span("train.sync"):
                        float(block_losses[-1])  # waits: the first block and the capture are not timed
                    if capture:
                        with span("train.capture"):
                            described = runner.capture().graph.describe()
                        log_fn(f"step {steps_done:>8d}  block graph of {num_inner} steps: {described}")
                    t_start = time.perf_counter()
                    timed_steps = 0
                else:
                    timed_steps += num_inner

                is_log = log_every_blocks and b % log_every_blocks == 0
                ckpt_due = ckpt_manager is not None and ckpt_manager.crossed(prev_steps, steps_done)
                # The host waits on the card only where it needs the value: at
                # log points and checkpoint boundaries (never checkpoint
                # unverified state). NaN recovery rides on those syncs.
                if is_log or ckpt_due:
                    with span("train.sync"):
                        last = float(block_losses[-1])
                    if not np.isfinite(last):
                        log_fn(f"step {steps_done:>8d}  NON-FINITE loss")
                        if ckpt_manager is not None and recover_on_nan:
                            with span("train.checkpoint"):
                                restored = ckpt_manager.restore_latest(model, optimizer)
                            if restored is not None:
                                restored_this_block = True
                                log_fn(f"restored from checkpoint at step {restored[2]}")
                        continue
                    if ckpt_due:
                        with span("train.checkpoint"):
                            ckpt_manager.save_at(steps_done, model, optimizer)
                    if is_log:
                        with span("train.log"):
                            losses.append(last)
                            log_fn(f"step {steps_done:>8d}  loss {last:.6f}")
                            if metric_logger is not None:
                                scalars = {"loss": last, "elbo": -last}
                                if kl_fn is not None:
                                    with torch.no_grad():
                                        kl = float(kl_fn())
                                    scalars["kl"] = kl
                                    scalars["var_exp"] = kl - last  # elbo = var_exp - kl
                                metric_logger.log(steps_done, scalars=scalars)
                if hist and (prev_steps // hist_every) != (steps_done // hist_every):
                    with span("train.log"):
                        if sampler == "device":
                            bx, by = data.next_batch(batch_size)
                            hX = torch.as_tensor(bx[blocks.rows], dtype=p0.dtype).to(p0.device)
                            hY = torch.as_tensor(by[blocks.rows], dtype=p0.dtype).to(p0.device)
                        else:
                            hX, hY = blocks.Xs[-1], blocks.Ys[-1]
                        grads = _all_grads(model, loss, hX, hY)
                        if mesh is not None:  # this rank's share, summed over the data group
                            for g in grads.values():
                                mesh.all_reduce_data(g)
                        metric_logger.log_param_tree(steps_done, model, prefix="param")
                        metric_logger.log_param_tree(steps_done, grads, prefix="grad")
                if callback is not None and callback_every and (prev_steps // callback_every) != (steps_done // callback_every):
                    with span("train.callback"):
                        callback(steps_done, model)
    except KeyboardInterrupt as ki:
        # The reference's Ctrl-C breaks the loop and saves, so a manual stop
        # is resumable; the result says so, so multi-run callers abort.
        block_for_interrupt(model, log_fn, ki, mid_step=in_block)
        log_fn(f"interrupted at step {steps_done} — checkpointing for resume")
        if ckpt_manager is not None:
            with span("train.sync"):
                last = float(block_losses[-1]) if steps_done > start_step else 0.0
            if np.isfinite(last):
                with span("train.checkpoint"):
                    ckpt_manager.save_at(steps_done, model, optimizer)
            else:
                log_fn("interrupt state is non-finite — not checkpointed")
        elapsed = max(time.perf_counter() - t_start, 1e-12)
        with span("train.sync"):
            step_losses = torch.cat(all_losses).cpu() if all_losses else None
        return FitResult(
            model=model,
            optimizer=optimizer,
            losses=losses,
            steps_per_sec=timed_steps / elapsed if timed_steps else 0.0,
            interrupted=True,
            step_losses=step_losses,
        )
    with span("train.sync"):
        step_losses = torch.cat(all_losses).cpu()  # waits for the device
    elapsed = max(time.perf_counter() - t_start, 1e-12)
    # One final check closes the silent-NaN window: with no log points and
    # no checkpoints nothing above read a loss.
    final_loss = float(step_losses[-1])
    if not np.isfinite(final_loss) and not restored_this_block:
        raise FloatingPointError(
            f"fit_scanned finished at step {steps_done} with a non-finite loss ({final_loss}); the trained "
            "state is unusable. Enable checkpointing (ckpt_manager) to get NaN recovery mid-run."
        )
    with span("train.checkpoint"):
        save_final(ckpt_manager, steps_done, restored_this_block, model, optimizer, log_fn, mesh=mesh)
    return FitResult(
        model=model,
        optimizer=optimizer,
        losses=losses,
        steps_per_sec=timed_steps / elapsed if timed_steps else 0.0,
        final_loss=final_loss if not restored_this_block else float("nan"),
        step_losses=step_losses,
    )
