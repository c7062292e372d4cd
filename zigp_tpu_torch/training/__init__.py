from .alternating import AdamPair, init_alt_optimizers, make_alternating_block, partition_model
from .data import DataSet
from .loop import FitResult, fit, make_train_step
from .natgrad import (
    NaturalGradientTrainer,
    fit_natgrad_scanned,
    gamma_schedule,
    natgrad_update_block_kron,
    natgrad_update_diag,
    natgrad_update_mean_kron,
)
from .optim import adam_per_group, cosine_adam, make_optimizer
from .scan import (
    BlockRunner,
    StagedBlocks,
    capture_block,
    fit_scanned,
    make_graphed_scan_step,
    make_scan_train_step,
    stage_batches,
)

__all__ = [
    "AdamPair",
    "BlockRunner",
    "DataSet",
    "FitResult",
    "NaturalGradientTrainer",
    "StagedBlocks",
    "adam_per_group",
    "capture_block",
    "cosine_adam",
    "fit",
    "fit_natgrad_scanned",
    "fit_scanned",
    "gamma_schedule",
    "init_alt_optimizers",
    "make_alternating_block",
    "make_graphed_scan_step",
    "make_optimizer",
    "make_scan_train_step",
    "make_train_step",
    "natgrad_update_block_kron",
    "natgrad_update_diag",
    "natgrad_update_mean_kron",
    "partition_model",
    "stage_batches",
]
