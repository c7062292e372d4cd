"""Device time of the ``gemm`` family (cuBLAS and CUTLASS products; ``harness.families``) in the
traced blocks, a step."""


def read(r):
    us = r.view.family_us().get("gemm")
    return us / r.steps if us and r.steps else None
