"""Data-parallel training steps over the mesh.

Counterpart of ``zigp_tpu/parallel/step.py``. The JAX package jits the
ELBO, its gradient and the Adam update with the minibatch sharded over the
``data`` axis and lets XLA insert the all-reduce. Here each rank runs its
share by hand:

- it takes its contiguous B / n_data rows of the step's batch;
- its loss is its share of the minibatch loss,
  −((N/B) Σ_own rows E[log p(y | f)] − KL / n_data), which is the model's
  own loss on its rows (scaled by N / (B / n_data)) over n_data: summed over
  the data group it is the single-rank loss, up to the order of the sum;
- it runs backward into the optimizer's flat gradient buffer
  (``training.optim.GradBuffer``) and sums that buffer over the data group
  with ONE ``all_reduce``; Adam then runs identically on every rank. Under
  tensor parallelism the buffer holds this rank's rows of the row-sharded
  raws (``parallel.tp.RowShardedAdam.collect_grads``) and the update ends
  with their gather.

The block of K steps (``make_scan_sharded_train_step``) all-reduces its (K,)
losses once, so every rank reads the same losses and takes the same
branches (NaN restore, checkpoints, logs). On the card under NCCL the block,
its all-reduces included, is one CUDA-graph replay (``training.scan.
BlockRunner``); gloo's collectives cannot be captured, so under gloo the
blocks run eagerly.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .mesh import Mesh, row_block, shard_batch


def sharded_loss(loss_fn: Optional[Callable], mesh: Mesh) -> Callable:
    """This rank's share of the loss: the loss on its rows over n_data."""
    n = mesh.shape["data"]
    if loss_fn is None:
        return lambda m, X, Y, **kw: m.loss(X, Y, **kw) / n
    return lambda m, X, Y, **kw: loss_fn(m, X, Y, **kw) / n


def reduce_gradients(optimizer, mesh: Mesh) -> None:
    """Sum the optimizer's flat gradient over the data group, in place:
    after a row-sharded optimizer has taken its rows of the full gradient."""
    collect = getattr(optimizer, "collect_grads", None)
    if collect is not None:
        collect()
    mesh.all_reduce_data(optimizer.grads.flat)


def make_local_step(optimizer, mesh: Mesh, loss_fn: Optional[Callable] = None):
    """A step ``(model, X, Y) -> loss`` on this rank's rows X (B / n_data,
    D): its share of the loss, the gradient summed over the data group, one
    update. The returned loss is this rank's share, on the device."""
    loss = sharded_loss(loss_fn, mesh)

    def step(model, X, Y) -> torch.Tensor:
        optimizer.zero_grad()
        value = loss(model, X, Y)
        value.backward()
        reduce_gradients(optimizer, mesh)
        optimizer.step()
        return value.detach()

    return step


def make_local_block(optimizer, mesh: Mesh, loss_fn: Optional[Callable] = None):
    """A block ``(model, Xs, Ys) -> losses`` of K steps on this rank's rows
    Xs (K, B / n_data, D); the (K,) losses summed over the data group (the
    single-rank losses) with one all-reduce, on the device."""
    step = make_local_step(optimizer, mesh, loss_fn)

    def block(model, Xs, Ys) -> torch.Tensor:
        losses = torch.stack([step(model, Xs[k], Ys[k]) for k in range(Xs.shape[0])])
        return mesh.all_reduce_data(losses)

    return block


def make_sharded_train_step(optimizer, mesh: Mesh, loss_fn: Optional[Callable] = None):
    """A step ``(model, X, Y) -> loss``: X, Y the whole batch (every rank
    the same), each rank training on its row block; the loss returned is
    the whole batch's, on every rank."""
    step = make_local_step(optimizer, mesh, loss_fn)

    def sharded(model, X, Y) -> torch.Tensor:
        X, Y = shard_batch(mesh, X, Y)
        return mesh.all_reduce_data(step(model, X, Y).clone())

    return sharded


def _check_placement(optimizer, tp: bool) -> None:
    from .tp import RowShardedAdam

    if tp and not isinstance(optimizer, RowShardedAdam):
        raise ValueError("tp=True needs an optimizer placed by parallel.tp_place")


def make_scan_sharded_train_step(optimizer, mesh: Mesh, loss_fn: Optional[Callable] = None, *, tp: bool = False):
    """A block step ``(model, Xs, Ys) -> losses`` of K = Xs.shape[0]
    optimizer steps, each step's (B, D) minibatch (every rank's Xs the same)
    split over the data axis; losses (K,) the single-rank ones, on every
    rank. With ``tp`` the optimizer is ``tp_place``'s, and the variational
    rows and their moments stay row-sharded over the model axis for the
    whole block. B must divide by the data axis."""
    _check_placement(optimizer, tp)
    block = make_local_block(optimizer, mesh, loss_fn)

    def step(model, Xs, Ys) -> torch.Tensor:
        rows = row_block(mesh, Xs.shape[1])
        return block(model, Xs[:, rows], Ys[:, rows])

    return step


class _Arrays:
    def __init__(self, X, Y):
        self.arrays = (np.asarray(X), np.asarray(Y))


def make_device_sampling_sharded_scan_step(optimizer, mesh: Mesh, Xtrain, Ytrain, batch_size: int,
                                           loss_fn: Optional[Callable] = None, *, tp: bool = False):
    """The device sampler on the mesh: every rank holds the training set on
    its device and draws the whole block's K·B indices from the same seed
    (``training.scan.block_seed``), then gathers its own B / n_data rows of
    each step. The index sequence is the single-rank sampler's, so the
    trajectory is the single-rank one. Returns ``step(model, seed,
    num_inner) -> losses`` (K,), ``seed`` the block's generator seed."""
    from ..training.scan import StagedBlocks

    _check_placement(optimizer, tp)
    if batch_size % mesh.shape["data"]:
        raise ValueError(f"batch size {batch_size} not divisible by data axis {mesh.shape['data']}")
    block = make_local_block(optimizer, mesh, loss_fn)
    data = _Arrays(Xtrain, Ytrain)
    staged = {}

    def step(model, seed: int, num_inner: int) -> torch.Tensor:
        if num_inner not in staged:
            p0 = next(model.parameters())
            staged[num_inner] = StagedBlocks(data, "device", batch_size, num_inner, device=p0.device,
                                             dtype=p0.dtype, rows=row_block(mesh, batch_size))
        blocks = staged[num_inner]
        blocks.fill_seed(seed)
        return block(model, blocks.Xs, blocks.Ys)

    return step
