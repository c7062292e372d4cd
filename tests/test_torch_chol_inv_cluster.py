"""The thread-block-cluster chol_inv (``csrc/chol_inv_cluster.cu``, 238 < n <=
512) pinned on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against its plain version there). Here:

- ``plan`` for every n of the kernel's range: each block row on one rank,
  the bytes of one CTA within an H100's 232,448, at most 8 CTAs a cluster,
  and the smallest C that fits;
- ``cluster_tiles``, the kernel's walk over its 4 × 4 tiles: every tile of
  the step's update taken exactly once, by the rank that owns its rows, the
  chain's by warp 0 of the owner of the next diagonal block and the rest by
  the other warps there;
- its plain version ``chol_inv_plain(K, NB)`` against the JAX package's
  ``chol_inv_blocked`` in interpret mode (float32, the Pallas tests' rtol
  2e-4, atol 1e-4: two f32 factorizations rounding in different orders) and
  against numpy float64 (rtol 1e-10 on these well-conditioned inputs), so
  the kernel's order of operations computes the JAX kernel's function;
- ``chol_inv_cluster_plain``, the row instance's ownership and staging
  walked CTA by CTA, bit for bit equal to ``chol_inv_plain(K, NB)`` at
  every C, and NaN from a failing pivot in each CTA's rows; and the rule
  that picks the instance (the pair to n = 320).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.ops.pallas.chol_inv import chol_inv_blocked as jax_chol_inv_blocked
from zigp_tpu_torch.ops.cuda import chol_inv as ci

from .torch_helpers import one_torch_thread_per_module  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

NB = ci.NB


def _spd(rng, shape):
    *batch, n, _ = shape
    A = rng.randn(*batch, n, n)
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


def test_plan_for_every_n_of_the_range():
    for n in range(ci.MAX_N + 1, ci.BLOCKED_MAX_N + 1):
        p = ci.plan(n)
        assert p.C == ci.CLUSTER_C <= 8 and p.bytes <= ci.SMEM_BYTES == 232_448
        assert len(p.owners) == -(-n // NB) and all(o == b % p.C for b, o in enumerate(p.owners))
        rows = sorted(i for r in range(p.C) for i in p.rows(r))
        assert rows == list(range(n)), n  # every row on exactly one rank
        assert ci.blocked_route(n) == ("pair" if ci.pair_bytes(n) <= ci.SMEM_BYTES else "cluster")


def test_plan_reach_and_refusals():
    fits = lambda n, C: ci._cluster_bytes(n, C)[1] <= ci.SMEM_BYTES
    assert (fits(301, 2), fits(302, 2), fits(406, 4), fits(407, 4), fits(512, 8)) == (True, False, True, False, True)
    assert (ci.pair_bytes(320) <= ci.SMEM_BYTES, ci.pair_bytes(321) <= ci.SMEM_BYTES) == (True, False)
    assert ci.plan(250, 2).C == 2
    for bad in ((512, 2), (250, 3), (0, None), (True, None)):
        with pytest.raises(ValueError):
            ci.plan(*bad)


@pytest.mark.parametrize("n, C", [(239, 2), (250, 2), (250, 4), (250, 8), (301, 2), (302, 4), (407, 8), (512, 8)])
def test_cluster_tiles_cover_each_update_once(n, C):
    p = ci.plan(n, C)
    for J in range(len(p.owners)):
        j1 = min(NB * (J + 1), n)
        if j1 == n:
            assert all(ci.cluster_tiles(p, J, r) == ([], []) for r in range(C))
            continue
        seen = []
        for r in range(C):
            look, rest = ci.cluster_tiles(p, J, r)
            assert not look or r == p.owners[J + 1]
            assert all(j1 <= i0 < j1 + NB for i0, _ in look)
            assert all((1 if look else 0) <= w < 16 for w, _, _ in rest)
            for i0, c0 in look + [(i0, c0) for _, i0, c0 in rest]:
                if i0 < n:
                    assert p.owners[i0 // NB] == r  # a rank updates only its own rows
                    seen.append((i0, c0))
        expected = [(i0, c0) for i0 in range(j1, n, 4) for c0 in range(0, i0 + 1, 4)]
        assert sorted(seen) == expected, (n, C, J)


@pytest.mark.parametrize("n", [250, 300, 512])
def test_plain_at_kernel_width_matches_pallas_blocked_f32(n):
    K = _spd(np.random.RandomState(n), (2, n, n)).astype(np.float32)
    L, Linv = ci.chol_inv_plain(torch.as_tensor(K), NB)
    Lp, Linvp = jax_chol_inv_blocked(jnp.asarray(K), interpret=True)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lp), rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(Linv.numpy(), np.asarray(Linvp), rtol=2e-4, atol=1e-4)
    assert np.all(np.triu(L.numpy(), 1) == 0) and np.all(np.triu(Linv.numpy(), 1) == 0)


@pytest.mark.parametrize("n", [250, 300, 512])
def test_plain_at_kernel_width_matches_numpy_f64(n):
    K = _spd(np.random.RandomState(n + 1), (1, n, n))
    L, Linv = ci.chol_inv_plain(torch.as_tensor(K), NB)
    L0 = np.linalg.cholesky(K)
    np.testing.assert_allclose(L.numpy(), L0, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(Linv.numpy(), np.linalg.inv(L0), rtol=1e-10, atol=1e-12)


# Small n with several block rows on every rank (ragged 75 = 9 · 8 + 3, and
# 131): the walk's ownership and staging are the same at any n, and its
# Python loops cost seconds a case at the kernel's n.
@pytest.mark.parametrize("n, C", [(75, 2), (75, 4), (75, 8), (131, 2), (131, 4), (131, 8), (250, 8)])
def test_cluster_walk_equals_plain_bit_for_bit(n, C):
    K = torch.as_tensor(_spd(np.random.RandomState(n + C), (1, n, n)).astype(np.float32))
    L, Linv = ci.chol_inv_cluster_plain(K, C)
    Lp, Linvp = ci.chol_inv_plain(K, NB)
    assert torch.equal(L, Lp) and torch.equal(Linv, Linvp)


@pytest.mark.parametrize("n, C", [(75, 2), (75, 4), (131, 8)])
def test_cluster_walk_nan_from_a_failing_pivot_in_each_cta(n, C):
    p = ci.plan(n, C)
    for r in range(C):
        mine = p.rows(r)
        piv = mine[len(mine) // 2]  # a middle row of this rank's
        K = np.eye(n, dtype=np.float32)[None]
        K[:, piv, piv] = -1.0
        L, Linv = ci.chol_inv_cluster_plain(torch.as_tensor(K), C)
        assert torch.isnan(L[:, piv:, piv:]).any() and torch.isnan(Linv[:, piv:, :]).any()
        eye = torch.eye(piv).expand(1, piv, piv)
        assert torch.equal(L[:, :piv, :piv], eye) and torch.equal(Linv[:, :piv, :piv], eye)


def test_cpu_wrapper_runs_the_two_level_routine_and_counts_no_launch():
    K = torch.as_tensor(_spd(np.random.RandomState(5), (2, 250, 250)).astype(np.float32))
    before = ci.chol_inv_blocked.launches
    L, Linv = ci.chol_inv_blocked(K)
    Lb, Linvb = ci.chol_inv_blocked_plain(K)
    assert torch.equal(L, Lb) and torch.equal(Linv, Linvb)
    assert ci.chol_inv_blocked.launches == before


def test_cluster_launch_refuses_a_cpu_tensor():
    with pytest.raises(ValueError):
        ci.launch_chol_inv_cluster(torch.eye(250)[None])


def test_blocked_route_rule():
    """The pair instance while one CTA holds A beside its staging (n <= 320),
    the row instance above."""
    for n in range(ci.MAX_N + 1, ci.BLOCKED_MAX_N + 1):
        assert ci.blocked_route(n) == ("pair" if n <= 320 else "cluster")
