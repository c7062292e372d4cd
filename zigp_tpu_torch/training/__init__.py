from .data import DataSet
from .loop import FitResult, fit, make_train_step
from .optim import adam_per_group, cosine_adam, make_optimizer
from .scan import StagedBlocks, fit_scanned, make_graphed_scan_step, make_scan_train_step, stage_batches

__all__ = [
    "DataSet",
    "FitResult",
    "StagedBlocks",
    "adam_per_group",
    "cosine_adam",
    "fit",
    "fit_scanned",
    "make_graphed_scan_step",
    "make_optimizer",
    "make_scan_train_step",
    "make_train_step",
    "stage_batches",
]
