from . import config  # noqa: F401  (the TF32-off precision pin runs at import)
