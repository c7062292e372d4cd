"""Each kernel's logical operations and bytes against hand counts at one
shape, and the frozen model-FLOP counts against the program's."""

import pytest

from portbench.harness import counts
from portbench.harness.manifest import load_module

F = 4  # bytes of a float32


@pytest.mark.parametrize("kernel, key, ops, nbytes", [
    # K (2, 250, 8192), D = 1: 3D + 3 flops an entry; X, Z and the hypers read once, K written once
    ("rbf_gram", (2, 250, 8192, 1), 2 * 250 * 8192 * 6, F * (250 + 8192 + 2 * 2 + 2 * 250 * 8192)),
    ("rbf_gram_bwd", (2, 105, 8192, 2), 2 * 105 * 8192 * 19, F * (2 * 105 * 8192 + 2 * (105 * 2 + 8192 * 2 + 2 * 3))),
    ("chol_inv", (2, 10), 2 * 2 * 1000 / 3, F * 3 * 2 * 100),
    ("chol_inv_cluster", (2, 250), 2 * 2 * 250**3 / 3, F * 3 * 2 * 250 * 250),
    ("bf16x3_mm", (2, 250, 8192, 250), 3 * 2 * 2 * 250 * 8192 * 250, F * 2 * (250 * 250 + 250 * 8192 + 250 * 8192)),
])
def test_roofline_counts(kernel, key, ops, nbytes):
    mod = load_module("rooflines", kernel)
    assert mod.ops_bytes(key) == (pytest.approx(ops), pytest.approx(nbytes))


def test_the_grid_gram_bound_is_the_kernel_tables():
    # PERF.md's kernel table: (2,250,8192) bound 4.9e-3 ms by bytes
    _, nbytes = load_module("rooflines", "rbf_gram").ops_bytes((2, 250, 8192, 1))
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(4.9e-3, rel=0.01)


@pytest.mark.parametrize("B, Ms, Mt", [(1000, 10, 100), (8192, 105, 250), (4000, 32, 200)])
def test_step_flops_are_the_programs(B, Ms, Mt):
    from zigp_tpu_torch.experiments.measure import analytic_matmul_flops

    assert counts.train_step_flops(B, Ms, Mt) == analytic_matmul_flops(B, Ms, Mt)
    assert counts.serve_row_flops(Ms, Mt) * B * 3 == pytest.approx(analytic_matmul_flops(B, Ms, Mt))
