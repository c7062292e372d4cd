"""The (data, model) mesh: one process per rank, explicit collectives.

Counterpart of ``zigp_tpu/parallel/mesh.py``. The JAX package runs one
process over many devices and lets XLA insert the collectives over a
``jax.sharding.Mesh``. PyTorch runs one process per rank (``torchrun``), so
here the mesh is the set of ranks of the default process group, laid out as
the JAX mesh lays out its devices: ``reshape(n_data, n_model)``, rank
``d · n_model + m`` at coordinates (d, m), the model axis contiguous.

- ``data`` shards each step's minibatch: rank (d, ·) takes the d-th block of
  B / n_data rows (``shard_batch``); its gradient is summed over the data
  group (``parallel.step``).
- ``model`` row-shards the M-row variational leaves and their Adam moments
  (``parallel.tp``): the ranks of one model group hold disjoint row blocks.

The collectives are ``all_reduce`` and ``broadcast`` on tensors only, which
gloo runs on CUDA tensors too, so two ranks can share one card over gloo; host
values go through the ``*_object`` collectives. A single process with no
process group is a world of one, whose collectives are no-ops. A one-rank
process group (``torchrun --nproc-per-node 1``) runs them, so a CUDA graph of
a training block holds its ``all_reduce`` even at one rank.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "model")


def _launch_hint(n: int) -> str:
    return (f"launch one process per rank: torchrun --nproc-per-node {n} -m zigp_tpu_torch.experiments ... "
            f"(or python -m torch.distributed.run --nproc-per-node {n} ...)")


class MeshLaunchError(ValueError):
    """A mesh that is not the launch's world: the message says how to launch."""


def is_main_process() -> bool:
    """True on rank 0 of the default process group, or with none: the rank
    that alone writes checkpoints, metric logs and results."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the default process group, if there is one."""
    if dist.is_initialized():
        dist.barrier()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class Mesh:
    """The ranks of the default process group as an (n_data, n_model)
    grid. ``shape`` is {"data": n_data, "model": n_model}, ``coords`` this
    rank's (d, m), ``device`` its device, ``backend`` the process group's
    ("nccl", "gloo", or None for a world of one with no group); ``data_group``
    holds the ranks of this rank's column (same m), ``model_group`` those of
    its row (same d)."""

    def __init__(self, n_data: int, n_model: int, device: torch.device):
        self.shape = {"data": int(n_data), "model": int(n_model)}
        self.device = torch.device(device)
        self.distributed = dist.is_initialized()
        self.backend = dist.get_backend() if self.distributed else None
        self.rank = dist.get_rank() if self.distributed else 0
        self.coords = divmod(self.rank, n_model)
        self.data_group = self.model_group = None
        if self.distributed:
            world = dist.get_world_size()
            # every rank creates every group, in the same order
            for m in range(n_model):
                ranks = [d * n_model + m for d in range(n_data)]
                g = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
                if m == self.coords[1]:
                    self.data_group = g
            for d in range(n_data):
                ranks = [d * n_model + m for m in range(n_model)]
                g = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
                if d == self.coords[0]:
                    self.model_group = g

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device}, backend={self.backend})")

    # ---- collectives (no-ops in a world of one with no process group) ----

    def all_reduce_data(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data group, in place; returns ``t``."""
        if self.distributed:
            dist.all_reduce(t, group=self.data_group)
        return t

    def all_reduce_model(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the model group, in place; returns ``t``."""
        if self.distributed:
            dist.all_reduce(t, group=self.model_group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
        if self.distributed:
            dist.broadcast(t, src)
        return t

    def gather_object(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        if not self.distributed:
            return [obj]
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj)
        return out

    def agree(self, obj):
        """Rank 0's ``obj`` on every rank: a branch every rank must take
        together is decided once."""
        if not self.distributed:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, 0)
        return box[0]


def _default_device(backend: Optional[str]) -> torch.device:
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % max(1, torch.cuda.device_count())))
        return torch.device("cuda", local)
    return torch.device("cpu")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, *, devices: Optional[Sequence] = None) -> Mesh:
    """The (n_data, n_model) mesh over every rank of the default process
    group (a single process with none is a world of one). ``n_data`` None
    takes the world size over ``n_model``. Raises, as the JAX package does
    when the devices are too few, unless n_data · n_model is the world size;
    the message says how to launch. ``devices``: each rank's device, indexed
    by rank (e.g. ``["cuda:0", "cuda:0"]`` for two gloo ranks on one card;
    ``"cuda"`` without an index is the current card, which the mesh stores
    by its index); by default ``cuda:LOCAL_RANK`` under NCCL and the CPU otherwise. An NCCL
    mesh that puts two ranks on one GPU raises (NCCL refuses it)."""
    world = world_size()
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1 (got {n_model})")
    if n_data is None:
        n_data = max(1, world // n_model)
    if n_data * n_model != world:
        raise MeshLaunchError(f"mesh needs {n_data}×{n_model} = {n_data * n_model} processes but this run has "
                              f"{world}; " + _launch_hint(n_data * n_model))
    backend = dist.get_backend() if dist.is_initialized() else None
    rank = dist.get_rank() if dist.is_initialized() else 0
    if devices is not None:
        devices = list(devices)
        if len(devices) < world:
            raise ValueError(f"make_mesh: {len(devices)} devices for {world} ranks")
        device = torch.device(devices[rank])
    else:
        device = _default_device(backend)
    if device.type == "cuda":
        if device.index is None:  # "cuda": the current card, named by its index
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device.index)
    mesh = Mesh(n_data, n_model, device)
    if backend == "nccl":
        # asked over gloo: an NCCL collective between two ranks on one GPU
        # fails inside NCCL before it could say so
        seen = [None] * world
        dist.all_gather_object(seen, (socket.gethostname(), device.index), group=dist.new_group(backend="gloo"))
        refuse_shared_gpus(seen)
    return mesh


def refuse_shared_gpus(seen: Sequence) -> None:
    """Raise unless every rank's (host, GPU index) in ``seen`` is its own:
    NCCL refuses two ranks on one GPU."""
    if len(set(seen)) != len(seen):
        raise ValueError(f"NCCL refuses two ranks on one GPU (ranks' (host, device): {list(seen)}); give each rank "
                         "its own card, or use backend='gloo'")


def replicated(mesh: Mesh) -> tuple:
    """The placement of a replicated tensor: every rank holds all of it
    (the JAX ``PartitionSpec()``; torch has no ``NamedSharding``)."""
    return ()


def batch_sharding(mesh: Mesh) -> tuple:
    """The placement of an (N, D) batch: rows split over the data axis (the
    JAX ``PartitionSpec("data", None)``)."""
    return ("data", None)


def row_block(mesh: Mesh, n: int, axis: str = "data") -> slice:
    """This rank's contiguous block of ``n`` rows along ``axis``."""
    parts = mesh.shape[axis]
    if n % parts:
        raise ValueError(f"{n} rows not divisible by the {axis} axis ({parts})")
    i = mesh.coords[AXES.index(axis)]
    b = n // parts
    return slice(i * b, (i + 1) * b)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's row block of each array (leading dim split over data)."""
    out = tuple(a[row_block(mesh, a.shape[0])] for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, model):
    """Every raw of ``model`` (a module, or a tensor) broadcast from rank 0,
    in place; returns it."""
    tensors = [model] if isinstance(model, torch.Tensor) else [p for p in model.parameters()]
    with torch.no_grad():
        for t in tensors:
            mesh.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t)
    return model
