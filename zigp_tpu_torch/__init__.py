"""zigp_tpu_torch: the PyTorch/CUDA port of zigp_tpu for NVIDIA Hopper (H100).

The module tree mirrors ``zigp_tpu``'s so each counterpart is easy to find,
and each subpackage re-exports its JAX counterpart's public names. The
package imports torch, numpy and scipy only; the JAX package stays the
reference the port is tested against (``tests/test_torch_*.py``).

Importing the package pins float32 matmuls to full precision (TF32 off,
see ``core.config``). It builds no kernel and starts no CUDA context: the
kernels are compiled at their first launch. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""

from . import core, io, likelihoods, models, ops, parallel, training, utils
from .core import bijectors, config
from .core.parameters import Parameter, param, positive_param

__version__ = "0.1.0"
