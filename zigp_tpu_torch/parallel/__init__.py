"""The parallel layer: the (data, model) mesh over ranks, data-parallel and
tensor-parallel training steps, and the multi-process bootstrap.

Counterpart of ``zigp_tpu/parallel``, with its names. One process per rank
(``torchrun --nproc-per-node N``), explicit collectives; see ``mesh``.
"""

from .distributed import initialize as initialize_distributed, make_multihost_mesh
from .mesh import batch_sharding, make_mesh, replicate, replicated, shard_batch
from .step import (
    make_device_sampling_sharded_scan_step,
    make_scan_sharded_train_step,
    make_sharded_train_step,
)
from .tp import make_tp_train_step, tp_place, tp_shardings_tree

__all__ = [
    "initialize_distributed",
    "make_multihost_mesh",
    "make_mesh",
    "replicated",
    "batch_sharding",
    "shard_batch",
    "replicate",
    "make_sharded_train_step",
    "make_scan_sharded_train_step",
    "make_device_sampling_sharded_scan_step",
    "make_tp_train_step",
    "tp_place",
    "tp_shardings_tree",
]
