from .data import DataSet
from .loop import FitResult, make_train_step
from .optim import adam_per_group, cosine_adam, make_optimizer
from .scan import fit_scanned, make_device_sampling_scan_step, make_scan_train_step, stage_batches

__all__ = [
    "DataSet",
    "FitResult",
    "adam_per_group",
    "cosine_adam",
    "fit_scanned",
    "make_device_sampling_scan_step",
    "make_optimizer",
    "make_scan_train_step",
    "make_train_step",
    "stage_batches",
]
