from . import checkpoint, datasets, export
from .datasets import Preprocessing, Split, kron_inducing_init, load_pptr, load_toydata, make_cv_splits

__all__ = [
    "checkpoint",
    "datasets",
    "export",
    "Split",
    "load_toydata",
    "load_pptr",
    "make_cv_splits",
    "kron_inducing_init",
    "Preprocessing",
]
