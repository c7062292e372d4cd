"""Kernel families of a trace, a frozen copy of the program's
``utils.xprof.op_category`` with the 3-pass product's kernels named as a
family of their own: the port's kernels by name, ``gemm`` (cuBLAS, CUTLASS
and the ``sm90_``/``ampere_`` kernels), ``elementwise``, ``reduction``,
``memcpy``, ``memset``, else ``other``. The families of a trace's device
events sum to its device time."""

from __future__ import annotations

PORT_KERNELS = ("chol_inv_cluster_kernel", "chol_inv_pair_kernel", "chol_inv_kernel", "chol_kernel",
                "kron_mv_cluster", "kron_mv_global", "rbf_gram_bwd_kernel", "rbf_gram_kernel",
                "bf16x3_tile_kernel", "bf16x3_dot_kernel", "bf16x3_short_k_kernel")
_GEMM_MARKS = ("gemm", "cutlass", "sm90_", "sm80_", "ampere_", "gemv")


def family(name: str) -> str:
    for k in PORT_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    if any(m in low for m in _GEMM_MARKS):
        return "gemm"
    if "elementwise" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduction"
    return "other"
