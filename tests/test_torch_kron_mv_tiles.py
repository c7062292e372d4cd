"""The tile plan of ``csrc/kron_mv.cu``, pinned on the CPU.

The kernel cannot run here, so its plan (``kron_matvec.plan``: grid, cluster
size, instance) and a plain emulation that walks the plan CTA by CTA and
chunk by chunk (``kron_mv_2_tiled_plain``) are what these tests hold:

- the CTAs of the plan's grid (``kron_matvec.ctas``: the cluster instance's
  ranks, the global instance's walk) store every (g, i, j) of Y exactly
  once, with at most 8 CTAs a cluster, the grid's x extent a multiple of the
  cluster and each cluster's ranks covering its slab's rows, on ragged
  shapes, at the cluster's reach (Ma = 8·TM) and one row past it;
- the emulation (staged, zero-filled chunks; the cluster's exchange of the
  slab of T; what neither instance writes is NaN, so reading it would show)
  agrees with the Pallas ``kron_mv_2`` in interpret mode in float32 at
  rtol 1e-4 (the Pallas test's tolerance: both round in their own order),
  and with ``np.kron`` (vec(A X Bᵀ) at the larger shapes) in float64 at
  rtol 1e-12, both orientations, in both instances. It follows the kernel's
  grouping of k, not its order of summation inside a group, so it pins the
  plan and the chunking, not the kernel's last bit;
- the CPU route of ``kron_mv_2_cuda`` is still the two matmuls of
  ``kron_mv_2_plain``, bit for bit, and counts no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.ops.pallas.kron_matvec import kron_mv_2
from zigp_tpu_torch.ops.cuda import kron_matvec as km

from .torch_helpers import one_torch_thread_per_module  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

EDGE = km.MAX_CLUSTER * km.TM  # the cluster's reach
SHAPES = [(1, 1, 1), (3, 1, 5), (2, 6, 9), (2, 10, 100), (2, 105, 250), (1, 33, 70), (1, EDGE, 40),
          (1, EDGE + 1, 40)]


def _inputs(G, Ma, Mb, dtype, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(dtype) for s in ((G, Ma, Ma), (G, Mb, Mb), (G, Ma * Mb))]


def _reference(A, B, x, transpose):
    """(A ⊗ B) x per pair by ``np.kron`` where the Kronecker matrix is small,
    else as vec(Aop X Bopᵀ) (26,250² entries at (105, 250) would take 5.5 GB)."""
    op = (lambda a: a.T) if transpose else (lambda a: a)
    if A.shape[-1] * B.shape[-1] <= 2500:
        return np.stack([np.kron(op(a), op(b)) @ v for a, b, v in zip(A, B, x)])
    return np.stack([(op(a) @ v.reshape(a.shape[0], b.shape[0]) @ op(b).T).ravel() for a, b, v in zip(A, B, x)])


@pytest.mark.parametrize("G,Ma,Mb", SHAPES)
@pytest.mark.parametrize("instance", ["cluster", "global"])
def test_plan_covers_y_once(G, Ma, Mb, instance):
    rows = -(-Ma // km.TM)
    if instance == "cluster" and rows > km.MAX_CLUSTER:
        with pytest.raises(ValueError):
            km.plan(G, Ma, Mb, instance)
        return
    p = km.plan(G, Ma, Mb, instance)
    assert p.instance == instance and p.threads == km.TM * km.TN
    assert 1 <= p.cluster <= km.MAX_CLUSTER and p.grid[0] % p.cluster == 0
    assert p.grid[1:] == (-(-Mb // km.TN), G)
    if instance == "cluster":
        assert p.grid[0] == p.cluster == rows and p.scratch == 0
    else:
        assert p.grid[0] == p.cluster == 1 and p.scratch == G * p.grid[1] * Ma * km.TN
    cover = np.zeros((G, Ma, Mb), int)
    cluster_rows = {}
    for g, rank, tiles, (j0, j1) in km.ctas(p, Ma, Mb):
        assert 0 <= rank < p.cluster and 0 <= j0 < j1 <= min(j0 + km.TN, Mb)
        for i0, i1 in tiles:
            assert 0 <= i0 < i1 <= min(i0 + km.TM, Ma)
            cover[g, i0:i1, j0:j1] += 1
            cluster_rows.setdefault((g, j0), set()).update(range(i0, i1))
    assert (cover == 1).all()
    assert all(r == set(range(Ma)) for r in cluster_rows.values())  # each slab's T is whole before phase 3


def test_plan_instances_at_the_edge():
    assert (km.plan(2, 105, 250).instance, km.plan(2, 105, 250).grid) == ("cluster", (7, 16, 2))
    assert km.plan(2, 105, 250).name == "cluster 16x16"
    assert km.plan(1, EDGE, 40).cluster == 8
    assert km.plan(1, EDGE + 1, 40).instance == "global"
    assert km.plan(1, 1, 1).grid == (1, 1, 1)
    with pytest.raises(ValueError):
        km.plan(1, 4, 4, "shared")  # no such instance


@pytest.mark.parametrize("G,Ma,Mb", SHAPES)
@pytest.mark.parametrize("transpose", [False, True])
def test_emulation_matches_pallas_f32(G, Ma, Mb, transpose):
    A, B, x = _inputs(G, Ma, Mb, np.float32, seed=Ma + Mb)
    got = km.kron_mv_2_tiled_plain(*(torch.as_tensor(a) for a in (A, B, x)), transpose=transpose).numpy()
    op = (lambda a: a.T) if transpose else (lambda a: a)
    want = np.stack([np.asarray(kron_mv_2(jnp.asarray(op(a)), jnp.asarray(op(b)), jnp.asarray(v), interpret=True))
                     for a, b, v in zip(A, B, x)])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("instance", ["cluster", "global"])
@pytest.mark.parametrize("G,Ma,Mb", [(2, 105, 250), (1, 33, 70), (2, 6, 9), (1, EDGE, 40)])
@pytest.mark.parametrize("transpose", [False, True])
def test_emulation_matches_numpy_kron_f64(instance, G, Ma, Mb, transpose):
    A, B, x = _inputs(G, Ma, Mb, np.float64, seed=1)
    got = km.kron_mv_2_tiled_plain(*(torch.as_tensor(a) for a in (A, B, x)), transpose=transpose,
                                   instance=instance).numpy()
    want = _reference(A, B, x, transpose)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("form", ["1-D", "column", "batched", "batched column"])
@pytest.mark.parametrize("transpose", [False, True])
def test_cpu_route_is_the_plain_version(form, transpose):
    G = 2 if form.startswith("batched") else None
    A, B, x = (torch.as_tensor(a if G else a[0]) for a in _inputs(G or 1, 10, 100, np.float32, seed=3))
    if form.endswith("column"):
        x = x[..., None]
    counts = (km.kron_mv_2_cuda.launches, dict(km.kron_mv_2_cuda.launches_by_instance))
    got = km.kron_mv_2_cuda(A, B, x, transpose=transpose)
    X = x.reshape(-1, 10, 100)
    want = A.mT @ (X @ B) if transpose else A @ (X @ B.mT)
    assert torch.equal(got, want.reshape(x.shape)) and got.shape == x.shape
    assert km.kron_mv_2_tiled_plain(A, B, x, transpose=transpose).shape == x.shape
    assert (km.kron_mv_2_cuda.launches, dict(km.kron_mv_2_cuda.launches_by_instance)) == counts
