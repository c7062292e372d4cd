"""Hand-written CUDA kernels for Hopper (sm_90a), built from ``csrc/`` at
first use (``_build``) and bound with ctypes."""
