"""zigp_tpu_torch: the PyTorch/CUDA port of zigp_tpu for NVIDIA Hopper (H100).

The module tree mirrors ``zigp_tpu``'s so each counterpart is easy to find.
The package imports torch, numpy and scipy only; the JAX package stays the
reference the port is tested against (``tests/test_torch_*.py``).

Importing the package pins float32 matmuls to full precision (TF32 off,
see ``core.config``). Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.
"""

from . import core  # noqa: F401  (sets the precision pin at import)
