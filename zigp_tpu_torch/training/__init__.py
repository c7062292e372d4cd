from .alternating import (
    AdamPair,
    init_alt_optimizers,
    make_alternating_block,
    make_batched_alternating_step,
    partition_model,
)
from .batched import (
    StackedBlocks,
    StackedNaturalGradientTrainer,
    fit_batched_scanned,
    fit_natgrad_batched,
    make_batched_block,
    over_members,
    predict_batched_stacked,
    stack_models,
    stack_size,
    unstack_model,
)
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
from .scipy_opt import scipy_optimize

__all__ = [
    "AdamPair",
    "BlockRunner",
    "DataSet",
    "FitResult",
    "NaturalGradientTrainer",
    "StackedBlocks",
    "StackedNaturalGradientTrainer",
    "StagedBlocks",
    "adam_per_group",
    "capture_block",
    "cosine_adam",
    "fit",
    "fit_batched_scanned",
    "fit_natgrad_batched",
    "fit_natgrad_scanned",
    "fit_scanned",
    "gamma_schedule",
    "init_alt_optimizers",
    "make_alternating_block",
    "make_batched_alternating_step",
    "make_batched_block",
    "make_graphed_scan_step",
    "make_optimizer",
    "make_scan_train_step",
    "make_train_step",
    "natgrad_update_block_kron",
    "natgrad_update_diag",
    "natgrad_update_mean_kron",
    "over_members",
    "partition_model",
    "predict_batched_stacked",
    "scipy_optimize",
    "stack_models",
    "stack_size",
    "stage_batches",
    "unstack_model",
]
