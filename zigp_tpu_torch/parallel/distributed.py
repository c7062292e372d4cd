"""The multi-process bootstrap and the multi-host mesh.

Counterpart of ``zigp_tpu/parallel/distributed.py``. The JAX package runs one
process per host and bootstraps ``jax.distributed``; PyTorch runs one process
per rank, so here ``initialize`` is ``torch.distributed.init_process_group``
from explicit arguments or the launcher's environment (``torchrun``'s
``MASTER_ADDR``/``RANK``/``WORLD_SIZE``, or SLURM's), and a no-op without
either.

The layout follows the JAX package's recipe: the **data** axis across hosts
(pure data parallelism needs one gradient all-reduce per step, the only
collective that then crosses hosts) and the **model** axis inside a host (its
collectives run every step, on the host's own links). ``torchrun`` numbers
ranks host-major (``node_rank · LOCAL_WORLD_SIZE + local_rank``), so a mesh
whose model axis divides the ranks per host keeps each model group on one
host.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, world_size

# A rank that dies, or takes a branch the others do not, ends the run with an
# error after this long instead of hanging it.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def _slurm_env() -> Optional[tuple]:
    """(rank, world size, local rank) from SLURM, when it launched us."""
    if "SLURM_PROCID" not in os.environ or "SLURM_NTASKS" not in os.environ:
        return None
    return int(os.environ["SLURM_PROCID"]), int(os.environ["SLURM_NTASKS"]), int(os.environ.get("SLURM_LOCALID", 0))


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Initialize the default process group when running multi-process; a
    no-op in a single process. Returns True iff it is initialized.

    ``coordinator_address``: the rendezvous, ``host:port``,
    ``tcp://host:port`` or ``file:///path`` (a ``FileStore``), with
    ``num_processes`` and ``process_id``. Omitted, the launcher's environment
    is read: ``torchrun`` (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``) or
    SLURM (``SLURM_PROCID``, ``SLURM_NTASKS``, with ``MASTER_ADDR`` and
    ``MASTER_PORT``). ``backend`` defaults to NCCL when the card is there,
    gloo otherwise; under NCCL the rank's current device becomes
    ``cuda:LOCAL_RANK``. ``timeout`` bounds every collective. Calling again
    is a no-op."""
    if dist.is_initialized():
        return True
    explicit = coordinator_address is not None or num_processes not in (None, 1)
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ
    slurm = _slurm_env() if not torchrun else None
    if not (explicit or torchrun or (slurm and "MASTER_ADDR" in os.environ)):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("initialize: a coordinator_address needs num_processes and process_id")
        init = coordinator_address
        if "://" not in init:
            init = f"tcp://{init}"
        kw = dict(init_method=init, world_size=int(num_processes), rank=int(process_id))
        local_rank = int(process_id) % max(1, torch.cuda.device_count()) if backend == "nccl" else 0
    elif torchrun:
        kw = dict(init_method="env://")
    else:
        rank, world, local_rank = slurm
        kw = dict(init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}",
                  world_size=world, rank=rank)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend=backend, timeout=timeout, **kw)
    return True


def shutdown() -> None:
    """Destroy the default process group (and its subgroups), if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_multihost_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (data, model) mesh of a multi-host run, laid out so that the model
    axis never crosses a host (``LOCAL_WORLD_SIZE``, the ranks per host, must
    divide by ``n_model``) and the data axis is host-major. Falls back to
    ``make_mesh`` in a single process."""
    world = world_size()
    if world == 1:
        return make_mesh(n_data, n_model)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local % n_model:
        raise ValueError(
            f"n_model={n_model} must divide the per-host device count {local} "
            "(the model axis cannot cross a DCN boundary)"
        )
    nproc = max(1, world // local)  # hosts
    ici_data = local // n_model
    total_data = ici_data * nproc
    if n_data is not None and n_data != total_data:
        raise ValueError(
            f"n_data={n_data} inconsistent with {nproc} processes × "
            f"{ici_data} per-host data shards = {total_data}"
        )
    return make_mesh(total_data, n_model)
