"""The port's CUDA kernels on the card: needs an NVIDIA GPU, skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch (the repository's conftest imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each kernel and its plain version run the same arithmetic in float32 on the
same inputs, so they differ only by rounding (the kernels fuse multiply-adds,
and expf and torch.exp may differ in the last ulp): on these well-conditioned
matrices and O(1) grams the relative Frobenius distance is held to 1e-5,
about 100 float32 ulps.
"""

import ctypes

import numpy as np
import pytest
import torch

from zigp_tpu_torch.ops import linalg
from zigp_tpu_torch.ops.cuda import chol_inv as ci
from zigp_tpu_torch.ops.cuda import rbf_gram as rg

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spd(n, G=2, seed=0):
    A = np.random.RandomState(seed).randn(G, n, n)
    return (A @ A.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


def _rel(a, b):
    return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))


@pytest.mark.parametrize("n", [1, 5, 10, 31, 32, 33, 100, 127, 128, 200, 238])
def test_kernel_matches_plain(cuda, n):
    """Around the panel widths (31, 32, 33), ragged last blocks, and up to
    MAX_N (238); the plain version at the kernel's width takes its operations in
    the kernel's order."""
    K = torch.as_tensor(_spd(n, seed=n), device=cuda)
    before = ci.chol_inv_cuda.launches
    with torch.inference_mode():
        L, Linv = ci.chol_inv_cuda(K)
        Lp, Linvp = ci.chol_inv_plain(K, ci.NB)
    torch.cuda.synchronize()
    assert ci.chol_inv_cuda.launches == before + 1
    assert _rel(L, Lp) < 1e-5 and _rel(Linv, Linvp) < 1e-5
    assert torch.all(torch.triu(L, 1) == 0) and torch.all(torch.triu(Linv, 1) == 0)


@pytest.mark.parametrize("n", [239, 250])
def test_blocked_on_card_matches_plain(cuda, n):
    assert linalg.chol_inv_route(n, torch.float32, "cuda") == "cluster"
    K = torch.as_tensor(_spd(n, seed=n), device=cuda)
    with torch.inference_mode():
        L, Linv = linalg.chol_inv(K)
        Lp, Linvp = ci.chol_inv_plain(K, ci.NB)
    assert _rel(L, Lp) < 1e-5 and _rel(Linv, Linvp) < 1e-5


@pytest.mark.parametrize("n", [239, 250, 300, 324, 450, 512])
def test_cluster_kernel_matches_plain(cuda, n):
    """chol_inv_blocked makes one launch a call (the pair instance to
    n = 320, the row instance above) and none of chol_inv.cu; the row
    instance launched directly matches too; the plain version at the
    kernel's width takes its operations in its order."""
    K = torch.as_tensor(_spd(n, seed=n), device=cuda)
    before = (ci.chol_inv_blocked.launches, ci.chol_inv_cuda.launches)
    with torch.inference_mode():
        L, Linv = ci.chol_inv_blocked(K)
        torch.cuda.synchronize()
        assert (ci.chol_inv_blocked.launches, ci.chol_inv_cuda.launches) == (before[0] + 1, before[1])
        Lc, Linvc = ci.launch_chol_inv_cluster(K)
        Lp, Linvp = ci.chol_inv_plain(K, ci.NB)
    for a, b in ((L, Lp), (Linv, Linvp), (Lc, Lp), (Linvc, Linvp)):
        assert _rel(a, b) < 1e-5 and torch.all(torch.triu(a, 1) == 0)


def test_cluster_kernel_same_bits_at_every_cluster_size(cuda):
    """Each entry takes the same operations whichever CTA or instance
    computes it: the same bits at C = 2, 4, 8, by the pair instance, and
    those of chol_inv.cu where it runs."""
    K = torch.as_tensor(_spd(250, seed=3), device=cuda)
    with torch.inference_mode():
        outs = [ci.launch_chol_inv_cluster(K, C) for C in ci.CLUSTER_SIZES] + [ci.launch_chol_inv_pair(K)]
        K200 = torch.as_tensor(_spd(200, seed=4), device=cuda)
        direct = ci.launch_chol_inv(K200)
        others = [ci.launch_chol_inv_cluster(K200, 2), ci.launch_chol_inv_pair(K200)]
    for L, Linv in outs[1:]:
        assert torch.equal(L, outs[0][0]) and torch.equal(Linv, outs[0][1])
    for L, Linv in others:
        assert torch.equal(direct[0], L) and torch.equal(direct[1], Linv)


@pytest.mark.parametrize("n", [250, 400, 512])
def test_cluster_kernel_nan_on_non_psd(cuda, n):
    """The failing pivot in the first, a middle and the last CTA's rows."""
    p = ci.plan(n)
    for rank in (0, p.C // 2, p.C - 1):
        rows = p.rows(rank)
        piv = rows[len(rows) // 2]
        K = torch.eye(n, device=cuda)[None].repeat(2, 1, 1)
        K[:, piv, piv] = -1.0
        L, Linv = ci.chol_inv_blocked(K)
        assert torch.isnan(L[:, piv:, piv:]).any() and torch.isnan(Linv[:, piv:, :]).any()
        eye = torch.eye(piv, device=cuda).expand(2, piv, piv)
        assert torch.equal(L[:, :piv, :piv], eye) and torch.equal(Linv[:, :piv, :piv], eye)


def test_cluster_plan_matches_the_kernel(cuda):
    from zigp_tpu_torch.ops.cuda import _build

    pair = _build.load("chol_inv_cluster").zigp_chol_inv_pair_smem
    pair.argtypes, pair.restype = [ctypes.c_int], ctypes.c_longlong
    for n in (239, 250, 301, 302, 320, 406, 407, 512):
        assert pair(n) == ci.pair_bytes(n)
        for C in ci.CLUSTER_SIZES:
            if ci._cluster_bytes(n, C)[1] <= ci.SMEM_BYTES:
                assert ci.cluster_shared_bytes(n, C) == ci.plan(n, C).bytes


def test_cluster_wrapper_raises_on_what_the_kernel_cannot_take(cuda):
    before = ci.chol_inv_blocked.launches
    for n in (ci.MAX_N, ci.BLOCKED_MAX_N + 1):
        with pytest.raises(ValueError):
            ci.chol_inv_blocked(torch.eye(n, device=cuda)[None])
    with pytest.raises(TypeError):
        ci.chol_inv_blocked(torch.eye(250, device=cuda, dtype=torch.float64)[None])
    with pytest.raises(ValueError):
        ci.chol_inv_blocked(torch.eye(500, device=cuda)[::2, ::2][None])
    with pytest.raises(ValueError):
        ci.launch_chol_inv_cluster(torch.eye(512, device=cuda)[None], C=2)  # does not fit two CTAs
    with pytest.raises(ValueError):
        ci.launch_chol_inv_pair(torch.eye(321, device=cuda)[None])  # past the pair instance's reach
    assert ci.chol_inv_blocked.launches == before


@pytest.mark.parametrize("n", [33, 100, 200])
@pytest.mark.parametrize("nb", [4, 8, 16])
def test_kernel_every_width_matches_plain(cuda, n, nb):
    K = torch.as_tensor(_spd(n, seed=n + nb), device=cuda)
    with torch.inference_mode():
        L, Linv = ci.launch_chol_inv(K, nb=nb)
        Lp, Linvp = ci.chol_inv_plain(K, nb)
        Lc = sc.launch_chol(K, "test", nb)
    torch.cuda.synchronize()
    assert _rel(L, Lp) < 1e-5 and _rel(Linv, Linvp) < 1e-5 and _rel(Lc, Lp) < 1e-5


def test_kernel_at_the_shared_memory_limit(cuda):
    """The largest n whose two triangles fit the device's shared memory runs;
    one more is refused at launch (RuntimeError), and the wrapper refuses
    anything above MAX_N before launching (ValueError)."""
    n = ci.kernel_max_n()
    assert ci.MAX_N <= n
    K = torch.as_tensor(_spd(n, seed=1), device=cuda)
    with torch.inference_mode():
        L, Linv = ci.launch_chol_inv(K)
        Lp, Linvp = ci.chol_inv_plain(K, ci.NB)
    assert _rel(L, Lp) < 1e-5 and _rel(Linv, Linvp) < 1e-5
    with pytest.raises(RuntimeError):
        ci.launch_chol_inv(torch.eye(n + 1, device=cuda)[None])


@pytest.mark.parametrize("n, p", [(12, 7), (40, 37)])
def test_kernel_nan_on_non_psd(cuda, n, p):
    K = torch.eye(n, device=cuda)[None].repeat(2, 1, 1)
    K[:, p, p] = -1.0
    L, Linv = ci.chol_inv_cuda(K)
    assert torch.isnan(L[:, p:, p:]).any() and torch.isnan(Linv[:, p:, :]).any()
    eye = torch.eye(p, device=cuda).expand(2, p, p)
    assert torch.equal(L[:, :p, :p], eye) and torch.equal(Linv[:, :p, :p], eye)


def _library_chol_inv(K):
    L = torch.linalg.cholesky(K)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device).expand_as(K)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


@pytest.mark.parametrize("n", [10, 100, 200, 250])
def test_chol_inv_gradient_on_card_launches_the_kernel(cuda, n):
    """With grad, ``linalg.chol_inv`` runs one kernel launch (chol_inv.cu to
    MAX_N, the cluster kernel above) and its backward equals autograd of
    torch.linalg's Cholesky and triangular solve."""
    rng = np.random.RandomState(n)
    K = torch.as_tensor(_spd(n, seed=n), device=cuda)
    dL, dLinv = (torch.as_tensor(rng.randn(2, n, n), dtype=torch.float32, device=cuda) for _ in range(2))
    grads = []
    for fn in (linalg.chol_inv, _library_chol_inv):
        Kr = K.clone().requires_grad_(True)
        before = (ci.chol_inv_cuda.launches, ci.chol_inv_blocked.launches)
        L, Linv = fn(Kr)
        launched = (ci.chol_inv_cuda.launches - before[0], ci.chol_inv_blocked.launches - before[1])
        (g,) = torch.autograd.grad((L * dL).sum() + (Linv * dLinv).sum(), Kr)
        grads.append((g, launched))
    assert grads[0][1] == ((1, 0) if n <= ci.MAX_N else (0, 1)) and grads[1][1] == (0, 0)
    assert _rel(grads[0][0], grads[1][0]) < 1e-4


def test_chol_inv_gradient_at_250_on_card_matches_cpu_f64(cuda):
    """The gradient of a scalar through ``linalg.chol_inv`` at n = 250 (the
    cluster kernel's forward) against the CPU float64 one, within max(3 ×
    the CPU float32 run's error, 1e-5)."""
    n = 250
    t = np.linspace(0.0, 1.0, n)[:, None]
    K64 = 10.0 * np.exp(-0.5 * (t - t.T) ** 2 / 0.05**2) + 1e-3 * np.eye(n)
    K64 = np.stack([K64, 0.5 * K64 + 0.01 * np.eye(n)])
    rng = np.random.RandomState(0)
    dL, dLinv = rng.randn(2, n, n) * 1e-2, rng.randn(2, n, n) * 1e-4

    def grad(device, dtype):
        K = torch.tensor(K64, dtype=dtype, device=device, requires_grad=True)
        L, Linv = linalg.chol_inv(K)
        w = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        (g,) = torch.autograd.grad((L * w(dL)).sum() + (Linv * w(dLinv)).sum(), K)
        return g.detach().cpu().double()

    before = ci.chol_inv_blocked.launches
    card = grad(cuda, torch.float32)
    assert ci.chol_inv_blocked.launches == before + 1
    ref, cpu32 = grad("cpu", torch.float64), grad("cpu", torch.float32)
    assert _rel(card, ref) <= max(3.0 * _rel(cpu32, ref), 1e-5)


def _gram_inputs(G, N, M, D, shared, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(G, N, D)
    Z = rng.randn(M, D) if shared else rng.randn(G, M, D)
    ell = 0.5 + rng.rand(G, D)
    var = 1.0 + rng.rand(G)
    return X, Z, ell, var


@pytest.mark.parametrize(
    "G,N,M,D,shared",
    [
        (2, 10, 10, 2, False), (2, 100, 1000, 1, True), (2, 10, 1000, 2, True), (1, 1, 33, 3, False),
        (3, 67, 45, 3, True), (2, 8, 1000, 4, True), (2, 37, 70, 7, False),  # D > 3: the run-time-D instance
        (2, 250, 8192, 1, True), (2, 7, 4000, 2, True), (2, 5, 64, 3, False),  # M % 4 == 0: the 16-byte stores
    ],
)
def test_rbf_gram_kernel_matches_plain(cuda, G, N, M, D, shared):
    args = [torch.as_tensor(a, dtype=torch.float32, device=cuda) for a in _gram_inputs(G, N, M, D, shared)]
    before = rg.rbf_gram_cuda.launches
    K = rg.rbf_gram_cuda(*args)
    Kp = rg.rbf_gram_plain(*args)
    torch.cuda.synchronize()
    assert rg.rbf_gram_cuda.launches == before + 1
    assert K.shape == (G, N, M) and _rel(K, Kp) < 1e-5


def test_rbf_gram_backward_on_card_matches_autograd_of_plain(cuda):
    X, Z, ell, var = _gram_inputs(2, 40, 300, 2, True, seed=5)
    cot = torch.as_tensor(np.random.RandomState(6).randn(2, 40, 300), dtype=torch.float32, device=cuda)
    grads = []
    for fn in (rg.rbf_gram, lambda *a: rg.rbf_gram_plain(*a)):
        leaves = [torch.as_tensor(a, dtype=torch.float32, device=cuda).requires_grad_(True) for a in (X, ell, var)]
        Zt = torch.as_tensor(Z, dtype=torch.float32, device=cuda)
        (fn(leaves[0], Zt, leaves[1], leaves[2]) * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert _rel(a, b) < 1e-4


def test_rbf_gram_wrapper_raises_on_what_the_kernel_cannot_take(cuda):
    X, Z, ell, var = (torch.as_tensor(a, dtype=torch.float32, device=cuda) for a in _gram_inputs(2, 8, 5, 2, False))
    with pytest.raises(TypeError):
        rg.rbf_gram_cuda(X.double(), Z.double(), ell.double(), var.double())
    with pytest.raises(ValueError):
        rg.rbf_gram_cuda(X, Z, torch.cat([ell, ell], 1), var)  # ell's D is not X's
    with pytest.raises(ValueError):
        rg.rbf_gram_cuda(X.transpose(-1, -2).contiguous().transpose(-1, -2), Z, ell, var)  # column-major rows
    with pytest.raises(ValueError):
        rg.rbf_gram_cuda(X[:1], Z, ell, var)  # X's batch is not G
    with pytest.raises(ValueError):
        rg.rbf_gram_cuda(X, Z.cpu(), ell, var)


def test_rbf_gram_vec4_instance_has_the_one_column_instances_bits(cuda):
    """M = 8192 takes the 4-column instance, its first 8191 columns the
    one-column instance: the same arithmetic, the same bits."""
    X, Z, ell, var = (torch.as_tensor(a, dtype=torch.float32, device=cuda) for a in _gram_inputs(2, 250, 8192, 1, True))
    K4 = rg.rbf_gram_cuda(X, Z, ell, var)
    K1 = rg.rbf_gram_cuda(X, Z[:8191].contiguous(), ell, var)
    assert torch.equal(K4[..., :8191], K1)


# G, N, M, D and the layout: K(X, X) (K_mm), the data shared by the G
# kernels (K_mn's minibatch, no gradient), the other side shared (its
# gradient summed over g), both per kernel
GRAM_BWD_CASES = [
    (2, 10, 10, 2, "K(X, X)"), (2, 100, 100, 1, "K(X, X)"), (2, 250, 250, 1, "K(X, X)"),
    (2, 10, 1000, 2, "shared data"), (2, 100, 1000, 1, "shared data"), (2, 250, 8192, 1, "shared data"),
    (3, 67, 45, 3, "per kernel"), (2, 33, 130, 2, "shared X"), (2, 8, 1000, 5, "shared data"),
    (2, 37, 70, 7, "per kernel"), (2, 9, 30, 11, "shared X"),  # D > 3: the run-time-D instance; D > 8: 2 launches
    (2, 20, 2100, 2, "per kernel"), (2, 20, 2101, 1, "K(X, X)"), (2, 9, 3000, 11, "per kernel"),  # M > 1024: chunks
]


def _bwd_args(G, N, M, D, layout, device, dtype, seed=0):
    """(X, Z, ell, var, K, gK, needs), K by the plain gram in ``dtype``."""
    rng = np.random.RandomState(seed)
    X = rng.rand(N, D) if layout == "shared X" else rng.rand(G, N, D)
    Z = rng.rand(M, D) if layout == "shared data" else rng.rand(G, M, D)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), dtype=dtype, device=device)
    X, Z = t(X), t(Z)
    Z = X if layout == "K(X, X)" else Z
    ell, var = t(0.3 + rng.rand(G, D)), t(1.0 + rng.rand(G))
    K = rg.rbf_gram_plain(X, Z, ell, var)
    gK = t(rng.randn(G, N, Z.shape[-2]))
    return X, Z, ell, var, K, gK, (True, layout != "shared data", True, True)


@pytest.mark.parametrize("G,N,M,D,layout", GRAM_BWD_CASES)
def test_rbf_gram_bwd_kernel_matches_f64(cuda, G, N, M, D, layout):
    """dX, dZ, dℓ and dσ² within max(3 × the plain backward's float32 error,
    1e-5) of float64; the same bits on a second call; one launch a call (a
    block of 8 input dimensions each past D = 3)."""
    args = _bwd_args(G, N, M, D, layout, cuda, torch.float32)
    ref = rg.rbf_gram_bwd_plain(*_bwd_args(G, N, M, D, layout, "cpu", torch.float64))
    plain = rg.rbf_gram_bwd_plain(*args)
    before = rg.rbf_gram_bwd_cuda.launches
    got = rg.rbf_gram_bwd_cuda(*args)
    again = rg.rbf_gram_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert rg.rbf_gram_bwd_cuda.launches - before == 2 * (1 if D <= 8 else -(-D // 8))
    for name, a, b, p, r in zip(("dX", "dZ", "dell", "dvar"), got, again, plain, ref):
        if r is None:
            assert a is None and b is None, name
            continue
        assert torch.equal(a, b), name
        e, e_plain = _rel(a.cpu(), r), _rel(p.cpu(), r)
        assert e <= max(3.0 * e_plain, 1e-5), f"{name}: {e:.3e} vs plain {e_plain:.3e}"


def test_rbf_gram_bwd_graph_replay_equals_eager(cuda):
    X, Z, ell, var, K, gK, needs = _bwd_args(2, 100, 1000, 1, "shared data", cuda, torch.float32)
    eager = rg.rbf_gram_bwd_cuda(X, Z, ell, var, K, gK, needs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rg.rbf_gram_bwd_cuda(X, Z, ell, var, K, gK, needs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        out = rg.rbf_gram_bwd_cuda(X, Z, ell, var, K, gK, needs)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("N,M,D", [(100, 1000, 1), (10, 1000, 2)])
def test_rbf_gram_bwd_folded_stack_equals_each_member(cuda, N, M, D):
    """The vmap rule folds F members into G: one forward and one backward
    launch, and each member's gradients the bits of its own run."""
    F, G = 3, 2
    rng = np.random.RandomState(N + D)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    Z, ell, var = (t(a).requires_grad_(True) for a in (rng.rand(F, G, N, D), 0.3 + rng.rand(F, G, D), 1 + rng.rand(F, G)))
    Xb, cot = t(rng.rand(M, D)), t(rng.randn(F, G, N, M))
    before = (rg.rbf_gram_cuda.launches, rg.rbf_gram_bwd_cuda.launches)
    torch.sum(torch.func.vmap(rg.rbf_gram, in_dims=(0, None, 0, 0))(Z, Xb, ell, var) * cot).backward()
    torch.cuda.synchronize()
    assert (rg.rbf_gram_cuda.launches - before[0], rg.rbf_gram_bwd_cuda.launches - before[1]) == (1, 1)
    assert rg.rbf_gram_bwd_cuda.launches_by_shape[(F * G, N, M, D)] >= 1
    for f in range(F):
        Zf, lf, vf = (a[f].detach().clone().requires_grad_(True) for a in (Z, ell, var))
        torch.sum(rg.rbf_gram(Zf, Xb, lf, vf) * cot[f]).backward()
        for a, b in ((Z.grad[f], Zf.grad), (ell.grad[f], lf.grad), (var.grad[f], vf.grad)):
            assert torch.equal(a, b)


def test_rbf_gram_bwd_wrapper_raises_on_what_the_kernel_cannot_take(cuda):
    X, Z, ell, var, K, gK, needs = _bwd_args(2, 8, 5, 2, "per kernel", cuda, torch.float32)
    before = rg.rbf_gram_bwd_cuda.launches
    with pytest.raises(TypeError):
        rg.rbf_gram_bwd_cuda(X.double(), Z.double(), ell.double(), var.double(), K.double(), gK.double(), needs)
    with pytest.raises(ValueError):
        rg.rbf_gram_bwd_cuda(X, Z, ell, var, K, gK.cpu(), needs)  # gK on another device
    with pytest.raises(ValueError):
        rg.rbf_gram_bwd_cuda(X.transpose(-1, -2).contiguous().transpose(-1, -2), Z, ell, var, K, gK, needs)
    with pytest.raises(ValueError):
        rg.rbf_gram_bwd_cuda(X, Z, ell, var, K, gK[:, :, :4], needs)  # gK is not (G, N, M)
    assert rg.rbf_gram_bwd_cuda.launches == before


def test_use_kernel_model_on_card_launches_both_kernels(cuda):
    from zigp_tpu_torch.experiments import configs
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.io.datasets import synthetic_pptr

    split = synthetic_pptr(8, 24, seed=0)
    model = build_onoff_pptr(configs.OnOffPptrConfig(grid=configs.KronGridConfig(4, 12)), split, use_kernel=True)
    X = torch.as_tensor(split.Xtrain[:64], dtype=torch.float32, device=cuda)
    Y = torch.as_tensor(split.Ytrain[:64], dtype=torch.float32, device=cuda)
    g0, b0, c0 = rg.rbf_gram_cuda.launches, rg.rbf_gram_bwd_cuda.launches, ci.chol_inv_cuda.launches
    model.loss(X, Y).backward()
    torch.cuda.synchronize()
    assert rg.rbf_gram_cuda.launches - g0 == 4  # (K_mm + K_mn) x 2 factors, the f/g pair in one launch
    assert rg.rbf_gram_bwd_cuda.launches - b0 == 4  # each of them differentiated by one backward launch
    assert ci.chol_inv_cuda.launches - c0 == 2
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.requires_grad)


def test_covariate_factor_on_card_launches_the_gram_kernel(cuda):
    """Inputs with covariate columns add a fourth factor over them (here
    D = 4); with the flag on its grams take the kernel too."""
    from zigp_tpu_torch.experiments import configs
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.io.datasets import Split, synthetic_pptr

    split = synthetic_pptr(8, 24, seed=0)
    rng = np.random.RandomState(1)
    split = Split(np.hstack([split.Xtrain, rng.randn(len(split.Xtrain), 4)]), split.Ytrain,
                  np.hstack([split.Xtest, rng.randn(len(split.Xtest), 4)]), split.Ytest)
    cfg = configs.OnOffPptrConfig(grid=configs.KronGridConfig(4, 12, num_exog=5))
    model = build_onoff_pptr(cfg, split, use_kernel=True)
    assert model.f.kernel_flags() == (True, True, True)
    X = torch.as_tensor(split.Xtrain[:64], dtype=torch.float32, device=cuda)
    Y = torch.as_tensor(split.Ytrain[:64], dtype=torch.float32, device=cuda)
    rg.rbf_gram_cuda.launches_by_shape.clear()
    g0 = rg.rbf_gram_cuda.launches
    model.loss(X, Y).backward()
    torch.cuda.synchronize()
    assert rg.rbf_gram_cuda.launches - g0 == 6  # (K_mm + K_mn) x 3 factors
    assert rg.rbf_gram_cuda.launches_by_shape[(2, 5, 5, 4)] == 1
    assert rg.rbf_gram_cuda.launches_by_shape[(2, 5, 64, 4)] == 1
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.requires_grad)


def test_wrapper_raises_on_what_the_kernel_cannot_take(cuda):
    with pytest.raises(TypeError):
        ci.chol_inv_cuda(torch.eye(8, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        ci.chol_inv_cuda(torch.eye(ci.MAX_N + 1, device=cuda))
    with pytest.raises(ValueError):
        ci.chol_inv_cuda(torch.eye(16, device=cuda)[::2, ::2])
    with pytest.raises(ValueError):
        ci.launch_chol_inv(torch.eye(16, device=cuda), nb=12)  # not a built width


def test_wrapper_raises_above_max_n(cuda):
    before = ci.chol_inv_cuda.launches
    for n in (ci.MAX_N + 1, 512):
        with pytest.raises(ValueError):
            ci.chol_inv_cuda(torch.eye(n, device=cuda)[None])
    assert ci.chol_inv_cuda.launches == before


# --- chol.cu (small_cholesky, batched_small_cholesky, chol_pallas) and kron_mv.cu ---

from zigp_tpu_torch.ops.cuda import cholesky as sc  # noqa: E402
from zigp_tpu_torch.ops.cuda import kron_matvec as km  # noqa: E402

CHOL_NS = [1, 10, 31, 32, 33, 100, 105, 128, 200, 240, 250]


@pytest.mark.parametrize("n", CHOL_NS)
@pytest.mark.parametrize("rank", [1, 2, 3, 4, 8])
def test_chol_kernel_matches_plain(cuda, n, rank):
    """Every gated n and rank: the kernel runs at its own width whatever the
    rank, and every rank of the plain version takes each entry's updates in
    the same order, so all agree to rounding."""
    K = torch.as_tensor(_spd(n, seed=n), device=cuda)
    before = ci.chol_cuda.launches
    with torch.inference_mode():
        L = ci.chol_cuda(K, rank=rank)
        Lp = sc.chol_plain(K, rank)
    torch.cuda.synchronize()
    assert ci.chol_cuda.launches == before + 1
    assert ci.chol_cuda.launches_by_shape[(2, n, rank)] >= 1
    assert _rel(L, Lp) < 1e-5
    assert torch.all(torch.triu(L, 1) == 0)


@pytest.mark.parametrize("n", CHOL_NS)
def test_small_cholesky_kernels_match_plain(cuda, n):
    K = torch.as_tensor(_spd(n, seed=n), device=cuda)
    s0, b0 = sc.small_cholesky_cuda.launches, sc.batched_small_cholesky_cuda.launches
    with torch.inference_mode():
        L1 = sc.small_cholesky_cuda(K[0])
        Lb = sc.batched_small_cholesky_cuda(K)
        Lp = sc.chol_plain(K)
    torch.cuda.synchronize()
    assert (sc.small_cholesky_cuda.launches - s0, sc.batched_small_cholesky_cuda.launches - b0) == (1, 1)
    assert sc.small_cholesky_cuda.launches_by_shape[n] >= 1 and sc.batched_small_cholesky_cuda.launches_by_shape[(2, n)] >= 1
    assert _rel(L1, Lp[0]) < 1e-5 and _rel(Lb, Lp) < 1e-5


@pytest.mark.parametrize("past_limit", [0, 1])
def test_chol_kernel_at_the_shared_memory_limit(cuda, past_limit):
    """The largest n the packed triangle holds in shared memory, and one more,
    which the same tiled code factors in place in global memory."""
    n = sc.shared_max_n() + past_limit
    assert n > 250
    K = torch.as_tensor(_spd(n, G=1, seed=3), device=cuda)
    with torch.inference_mode():
        L = sc.batched_small_cholesky_cuda(K)
        Lp = sc.chol_plain(K, sc.NB)
    assert _rel(L, Lp) < 1e-5 and torch.all(torch.triu(L, 1) == 0)
    np.testing.assert_allclose(L.double().cpu().numpy(), np.linalg.cholesky(K.double().cpu().numpy()), rtol=0,
                               atol=1e-4 * float(L.abs().max()))


@pytest.mark.parametrize("n, p", [(12, 7), (40, 37)])
@pytest.mark.parametrize("rank", [1, 2, 4, 8])
def test_chol_kernel_nan_on_non_psd(cuda, rank, n, p):
    K = torch.eye(n, device=cuda)[None].repeat(2, 1, 1)
    K[:, p, p] = -1.0
    L = ci.chol_cuda(K, rank=rank).cpu()
    assert torch.isnan(L[:, p:, p:]).any()
    assert torch.equal(L[:, :p, :p], torch.eye(p).expand(2, p, p))
    L1 = sc.small_cholesky_cuda(K[0].contiguous()).cpu()
    assert torch.isnan(L1[p:, p:]).any() and torch.equal(L1[:p, :p], torch.eye(p))


def test_chol_wrappers_raise_on_what_the_kernel_cannot_take(cuda):
    K = torch.as_tensor(_spd(8), device=cuda)
    with pytest.raises(TypeError):
        ci.chol_cuda(K.double())
    with pytest.raises(ValueError):
        ci.chol_cuda(K.transpose(-1, -2))  # not contiguous
    with pytest.raises(ValueError):
        ci.chol_cuda(K, rank=0)
    with pytest.raises(ValueError):
        sc.small_cholesky_cuda(K)  # (n, n) only
    with pytest.raises(ValueError):
        sc.batched_small_cholesky_cuda(K[0])  # (B, n, n) only
    with pytest.raises(TypeError):
        sc.batched_small_cholesky_cuda(K.double())
    with pytest.raises(ValueError):
        sc.launch_chol(K, "test", nb=12)  # not a built width


def _kron_inputs(G, Ma, Mb, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in ((G, Ma, Ma), (G, Mb, Mb), (G, Ma * Mb))]


KRON_EDGE = 8 * km.TM  # the cluster's reach: one row more takes the global instance


@pytest.mark.parametrize("G,Ma,Mb", [(2, 10, 100), (2, 105, 250), (2, 6, 9), (1, 33, 70), (3, 1, 5), (1, 1, 1),
                                     (1, KRON_EDGE, 40), (1, KRON_EDGE + 1, 40)])
@pytest.mark.parametrize("transpose", [False, True])
def test_kron_mv_kernel_matches_plain(cuda, G, Ma, Mb, transpose):
    A, B, x = (torch.as_tensor(a, device=cuda) for a in _kron_inputs(G, Ma, Mb, seed=Ma + Mb))
    before = km.kron_mv_2_cuda.launches
    name = "cluster 16x16" if Ma <= KRON_EDGE else "global 16x16"
    key = (G, Ma, Mb, transpose, name)
    by_instance = km.kron_mv_2_cuda.launches_by_instance[key]
    y = km.kron_mv_2_cuda(A, B, x, transpose=transpose)
    yp = km.kron_mv_2_plain(A, B, x, transpose=transpose)
    y1 = km.kron_mv_2_cuda(A, B, x[..., None], transpose=transpose)  # (G, N, 1), as q_mu
    torch.cuda.synchronize()
    assert km.kron_mv_2_cuda.launches == before + 2
    assert km.kron_mv_2_cuda.launches_by_shape[(G, Ma, Mb, transpose)] >= 2
    assert km.kron_mv_2_cuda.launches_by_instance[key] == by_instance + 2
    assert y.shape == x.shape and y1.shape == (G, Ma * Mb, 1)
    assert _rel(y, yp) < 1e-5 and torch.equal(y1[..., 0], y)


def test_kron_mv_kernel_unbatched_and_global_scratch(cuda):
    """The JAX function's unbatched shapes, and factors far past the
    cluster's reach (the global instance, T in scratch)."""
    A, B, x = (torch.as_tensor(a[0], device=cuda) for a in _kron_inputs(1, 6, 9, seed=1))
    y = km.kron_mv_2_cuda(A, B, x)
    want = np.kron(A.double().cpu().numpy(), B.double().cpu().numpy()) @ x.double().cpu().numpy()
    np.testing.assert_allclose(y.cpu().numpy(), want, rtol=1e-5, atol=1e-5)
    assert km.kron_mv_2_cuda(A, B, x[:, None]).shape == (54, 1)
    Ma = 2000
    A, B, x = (torch.as_tensor(a, device=cuda) for a in _kron_inputs(1, Ma, 3, seed=2))
    key = (1, Ma, 3, False, "global 16x16")
    before = km.kron_mv_2_cuda.launches_by_instance[key]
    assert _rel(km.kron_mv_2_cuda(A, B, x), km.kron_mv_2_plain(A, B, x)) < 1e-5
    assert km.kron_mv_2_cuda.launches_by_instance[key] == before + 1


@pytest.mark.parametrize("instance", ["cluster", "global"])
@pytest.mark.parametrize("G,Ma,Mb", [(2, 105, 250), (2, 10, 100), (1, 1, 1), (3, 1, 5), (1, 33, 70),
                                     (1, KRON_EDGE, 40)])
def test_kron_mv_both_instances_match_plain(cuda, instance, G, Ma, Mb):
    """Both instances at every shape within the cluster's reach, both
    orientations, against the plain version, each launch counted under the
    instance asked for."""
    A, B, x = (torch.as_tensor(a, device=cuda) for a in _kron_inputs(G, Ma, Mb, seed=Ma))
    for transpose in (False, True):
        key = (G, Ma, Mb, transpose, f"{instance} 16x16")
        before = km.kron_mv_2_cuda.launches_by_instance[key]
        y = km.launch_kron_mv(A, B, x, transpose, instance)
        assert km.kron_mv_2_cuda.launches_by_instance[key] == before + 1
        assert _rel(y, km.kron_mv_2_plain(A, B, x, transpose=transpose)) < 1e-5


def test_kron_mv_library_refuses_the_cluster_past_its_reach(cuda):
    """The library launches the cluster instance only where a cluster of at
    most 8 CTAs holds the rows: one row past the reach, a null scratch is
    refused, and the wrapper's plan refuses it first."""
    Ma, Mb = KRON_EDGE + 1, 40
    A, B, x = (torch.as_tensor(a, device=cuda) for a in _kron_inputs(1, Ma, Mb))
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    err = km._lib()(A.data_ptr(), B.data_ptr(), x.data_ptr(), y.data_ptr(), None, Ma, Mb, 1, 0, stream)
    assert err != 0
    with pytest.raises(ValueError):
        km.launch_kron_mv(A, B, x, False, "cluster")


def test_kron_mv_wrapper_raises_on_what_the_kernel_cannot_take(cuda):
    A, B, x = (torch.as_tensor(a, device=cuda) for a in _kron_inputs(2, 4, 5))
    with pytest.raises(TypeError):
        km.kron_mv_2_cuda(A.double(), B.double(), x.double())
    with pytest.raises(ValueError):
        km.kron_mv_2_cuda(A.transpose(-1, -2), B, x)  # not contiguous
    with pytest.raises(ValueError):
        km.kron_mv_2_cuda(A, B.cpu(), x)
    with pytest.raises(ValueError):
        km.kron_mv_2_cuda(A, B, x[:, :-1])


# --- the training block and the serving chunk as CUDA graphs ---

GRAPH_TOL = 1e-4  # relative; the same kernels run in the same order, so equal bits are expected


def _graph_setup(cuda, K=10, B=256, seed=0):
    """A small on/off model with both kernels on, its optimizer, and two
    blocks of K batches on the card, staged into one static pair."""
    from zigp_tpu_torch.experiments import configs
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.io.datasets import synthetic_pptr
    from zigp_tpu_torch.training import DataSet, cosine_adam, make_optimizer, stage_batches

    split = synthetic_pptr(12, 120, seed=seed)
    cfg = configs.OnOffPptrConfig(grid=configs.KronGridConfig(6, 20), batch_size=B)
    model = build_onoff_pptr(cfg, split, use_kernel=True)
    opt = make_optimizer(model, default_lr=1e-2, schedule=cosine_adam(100))
    ds = DataSet(split.Xtrain, split.Ytrain, seed=3)
    blocks = [stage_batches(ds, B, K, device=cuda, dtype=torch.float32) for _ in range(3)]
    return model, opt, blocks


def _twin(model):
    """A copy of the model with its own optimizer, for the eager side."""
    import copy

    from zigp_tpu_torch.training import cosine_adam, make_optimizer

    m = copy.deepcopy(model)
    return m, make_optimizer(m, default_lr=1e-2, schedule=cosine_adam(100))


def _rel_max(a, b):
    return float(((a.double() - b.double()).abs() / b.double().abs()).max())


def test_graphed_block_matches_eager_and_counts_its_launches(cuda):
    """A warm-up block (eager, on a side stream) on both twins, then 10 steps
    by a replay of the captured block against 10 eager steps on the same
    batches: the losses and the raws within GRAPH_TOL (reported), and the
    replay counted as its kernels' launches."""
    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import make_graphed_scan_step, make_scan_train_step

    model, opt, blocks = _graph_setup(cuda)
    twin, topt = _twin(model)
    Xs, Ys = (b.clone() for b in blocks[0])
    on_side_stream(lambda: make_scan_train_step(opt)(model, Xs, Ys))
    make_scan_train_step(topt)(twin, Xs, Ys)
    graphed = make_graphed_scan_step(opt, model, Xs, Ys)
    Xs.copy_(blocks[1][0])
    Ys.copy_(blocks[1][1])
    g0, c0 = rg.rbf_gram_cuda.launches, ci.chol_inv_cuda.launches
    got = graphed()
    torch.cuda.synchronize()
    assert (rg.rbf_gram_cuda.launches - g0, ci.chol_inv_cuda.launches - c0) == (10 * 4, 10 * 2)
    want = make_scan_train_step(topt)(twin, *blocks[1])
    err = _rel_max(got, want)
    print(f"graphed vs eager, 10 steps: largest relative loss difference {err:.3e}")
    assert torch.isfinite(got).all() and err <= GRAPH_TOL
    for (n, a), b in zip(model.named_parameters(), twin.parameters()):
        assert torch.allclose(a, b, rtol=GRAPH_TOL, atol=GRAPH_TOL * float(b.abs().max())), n
    assert float(opt.step_count) == float(topt.step_count) == 20.0


def test_restore_under_the_graph_matches_an_eager_restore(cuda, tmp_path):
    """Checkpoint after the first replay, replay block 3, restore in place
    and replay block 3 again: the same losses (the graph reads the restored
    storage), equal to an eager twin restored from the same checkpoint."""
    from zigp_tpu_torch.io.checkpoint import CheckpointManager
    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import make_graphed_scan_step, make_scan_train_step

    model, opt, blocks = _graph_setup(cuda)
    Xs, Ys = (b.clone() for b in blocks[0])
    on_side_stream(lambda: make_scan_train_step(opt)(model, Xs, Ys))
    graphed = make_graphed_scan_step(opt, model, Xs, Ys)
    Xs.copy_(blocks[1][0])
    Ys.copy_(blocks[1][1])
    graphed()
    mgr = CheckpointManager(str(tmp_path / "ck"), every=10)
    mgr.save_at(20, model, opt)
    ptrs = [p.data_ptr() for p in model.parameters()] + [t.data_ptr() for ts in opt.state_tensors().values()
                                                         for t in ts.values()]
    Xs.copy_(blocks[2][0])
    Ys.copy_(blocks[2][1])
    first = graphed()
    mgr.restore_latest(model, opt)
    again = graphed()
    twin, topt = _twin(model)
    mgr.restore_latest(twin, topt)
    eager = make_scan_train_step(topt)(twin, *blocks[2])
    torch.cuda.synchronize()
    assert ptrs == [p.data_ptr() for p in model.parameters()] + [t.data_ptr() for ts in opt.state_tensors().values()
                                                                 for t in ts.values()]
    assert torch.equal(first, again)
    err = _rel_max(again, eager)
    print(f"graphed restore vs eager restore, 10 steps: largest relative loss difference {err:.3e}")
    assert err <= GRAPH_TOL


def test_fit_scanned_and_fit_on_card_replay_their_graphs(cuda):
    """fit_scanned (device sampler, blocks of 5) and the per-step fit run the
    captured block on the card, count every step's launches, and say so."""
    from zigp_tpu_torch.training import DataSet, fit, fit_scanned
    from zigp_tpu_torch.io.datasets import synthetic_pptr

    model, opt, _ = _graph_setup(cuda)
    split = synthetic_pptr(12, 120, seed=0)
    for name, run, steps in (
        ("fit_scanned", lambda logs: fit_scanned(model, DataSet(split.Xtrain, split.Ytrain), num_iter=20,
                                                 batch_size=256, num_inner=5, optimizer=opt, sampler="device",
                                                 log_fn=logs.append), 20),
        ("fit", lambda logs: fit(model, DataSet(split.Xtrain, split.Ytrain), num_iter=8, batch_size=256,
                                 optimizer=opt, log_every=4, log_fn=logs.append), 8),
    ):
        logs = []
        g0, c0 = rg.rbf_gram_cuda.launches, ci.chol_inv_cuda.launches
        res = run(logs)
        torch.cuda.synchronize()
        assert any("graph" in line and "capture" in line for line in logs), (name, logs)
        assert torch.isfinite(res.step_losses).all() and res.step_losses.shape == (steps,)
        assert (rg.rbf_gram_cuda.launches - g0, ci.chol_inv_cuda.launches - c0) == (steps * 4, steps * 2), name


def test_predict_batched_graph_matches_eager_chunks(cuda):
    """predict_batched replays its captured chunk: every field equal to the
    eager chunks' within 1e-6 relative, one chol_inv launch per factor and
    chunk."""
    from zigp_tpu_torch.experiments import configs
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.experiments.runners import predict_batched
    from zigp_tpu_torch.io.datasets import synthetic_pptr

    split = synthetic_pptr(12, 120, seed=0)
    model = build_onoff_pptr(configs.OnOffPptrConfig(grid=configs.KronGridConfig(6, 20)), split)
    X = split.Xtrain[:1000]
    c0 = ci.chol_inv_cuda.launches
    got = predict_batched(model.predict, X, batch=256)
    torch.cuda.synchronize()
    assert ci.chol_inv_cuda.launches - c0 == 4 * 2
    with torch.inference_mode():
        for start in range(0, 1000, 256):
            rows = torch.as_tensor(X[start:start + 256], dtype=torch.float32, device=cuda)
            pad = 256 - rows.shape[0]
            chunk = torch.cat([rows, rows[-1:].expand(pad, -1)]) if pad else rows
            want = model.predict(chunk)._asdict()
            for k, v in want.items():
                a = torch.as_tensor(got[k][start:start + 256])
                b = v[: 256 - pad].cpu()
                assert float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-30)) <= 1e-6, k


def test_predict_batched_keeps_its_graph_across_calls(cuda):
    """The second call replays the first call's graph for every chunk (no new
    capture, each chunk's launches counted), and sees a parameter changed in
    place; a copy of the model captures its own."""
    import copy

    from zigp_tpu_torch.experiments import configs, runners
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.io.datasets import synthetic_pptr

    split = synthetic_pptr(12, 120, seed=0)
    model = build_onoff_pptr(configs.OnOffPptrConfig(grid=configs.KronGridConfig(6, 20)), split)
    X = split.Xtrain[:1000]
    runners.predict_batched(model.predict, X, batch=256)
    (graph,) = runners._CHUNK_GRAPHS[model].values()
    with torch.no_grad():
        model.f.q_mu.raw.add_(0.25)
    c0 = ci.chol_inv_cuda.launches
    got = runners.predict_batched(model.predict, X, batch=256)
    torch.cuda.synchronize()
    assert ci.chol_inv_cuda.launches - c0 == 4 * 2
    assert list(runners._CHUNK_GRAPHS[model].values()) == [graph]
    with torch.inference_mode():
        want = model.predict(torch.as_tensor(X[:256], dtype=torch.float32, device=cuda))._asdict()
    for k, v in want.items():
        a, b = torch.as_tensor(got[k][:256]), v.cpu()
        assert float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-30)) <= 1e-6, k
    twin = copy.deepcopy(model)
    runners.predict_batched(twin.predict, X, batch=256)
    (twin_graph,) = runners._CHUNK_GRAPHS[twin].values()
    assert twin_graph is not graph


# --- the other model families on the card ---


def _family(name, split):
    """A small model of each family, its training targets and its serving
    method: the SVGP (Gaussian), the classifier (Gauss–Hermite Bernoulli,
    gram kernel on) and the joint hurdle (Gamma head, f and g stacked)."""
    from zigp_tpu_torch.experiments import builders, configs

    grid = configs.KronGridConfig(6, 20)
    if name == "svgp":
        return builders.build_svgp_pptr(configs.SvgpPptrConfig(grid=grid), split), split.Ytrain, "predict_latent"
    if name == "classifier":
        model = builders.build_classifier_pptr(configs.ClassifierPptrConfig(grid=grid, num_gh=20), split,
                                               use_kernel=True)
        return model, builders.binarize_targets(split.Ytrain), "predict_class"
    model = builders.build_hurdle_joint_pptr(configs.HurdleJointConfig(grid=grid, likelihood="gamma"), split)
    return model, split.Ytrain, "predict"


@pytest.mark.parametrize("name", ["svgp", "classifier", "hurdlej"])
def test_family_graphed_block_matches_eager_and_counts_its_launches(cuda, name):
    """A family's block of 10 steps by one replay against 10 eager steps on
    the same batches (GH nodes and lgamma constants inside the capture):
    losses within GRAPH_TOL, chol_inv 2 launches a step (G = 1 for one GP,
    the stacked pair for the hurdle), rbf_gram 4 a step with the kernel on."""
    import copy

    from zigp_tpu_torch.io.datasets import synthetic_pptr
    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import DataSet, make_graphed_scan_step, make_optimizer, make_scan_train_step
    from zigp_tpu_torch.training import stage_batches

    split = synthetic_pptr(12, 120, seed=0)
    model, Y, _ = _family(name, split)
    twin = copy.deepcopy(model)
    opt, topt = make_optimizer(model, default_lr=1e-2), make_optimizer(twin, default_lr=1e-2)
    ds = DataSet(split.Xtrain, Y, seed=3)
    blocks = [stage_batches(ds, 256, 10, device=cuda, dtype=torch.float32) for _ in range(2)]
    Xs, Ys = (b.clone() for b in blocks[0])
    on_side_stream(lambda: make_scan_train_step(opt)(model, Xs, Ys))
    make_scan_train_step(topt)(twin, Xs, Ys)
    graphed = make_graphed_scan_step(opt, model, Xs, Ys)
    Xs.copy_(blocks[1][0])
    Ys.copy_(blocks[1][1])
    g0, c0 = rg.rbf_gram_cuda.launches, ci.chol_inv_cuda.launches
    got = graphed()
    torch.cuda.synchronize()
    grams = 4 if name == "classifier" else 0
    assert (rg.rbf_gram_cuda.launches - g0, ci.chol_inv_cuda.launches - c0) == (10 * grams, 10 * 2)
    want = make_scan_train_step(topt)(twin, *blocks[1])
    err = _rel_max(got, want)
    print(f"{name}: graphed vs eager, 10 steps: largest relative loss difference {err:.3e}")
    assert torch.isfinite(got).all() and err <= GRAPH_TOL


@pytest.mark.parametrize("family, grams", [("periodic*rbf", 4), ("matern52+linear", 2)])
def test_zoo_graphed_block_matches_eager_and_counts_its_launches(cuda, family, grams):
    """The small on/off model with a zoo temporal factor on both GPs (the
    gram kernel on its RBF leaves): 10 steps by one replay against 10 eager
    steps on the same batches within GRAPH_TOL, rbf_gram launched for K_mm
    and K_mn of each RBF leaf, chol_inv once a factor, every step."""
    import copy
    import dataclasses

    from zigp_tpu_torch.experiments import configs
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.io.datasets import synthetic_pptr
    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import DataSet, make_graphed_scan_step, make_optimizer, make_scan_train_step
    from zigp_tpu_torch.training import stage_batches

    split = synthetic_pptr(12, 120, seed=0)
    base = configs.OnOffPptrConfig(grid=configs.KronGridConfig(6, 20), batch_size=256)
    zoo = lambda ki: dataclasses.replace(ki, family=family, period=(0.001,))
    cfg = dataclasses.replace(base, fk_temporal=zoo(base.fk_temporal), gk_temporal=zoo(base.gk_temporal))
    model = build_onoff_pptr(cfg, split, use_kernel=True)
    twin = copy.deepcopy(model)
    opt, topt = make_optimizer(model, default_lr=1e-2), make_optimizer(twin, default_lr=1e-2)
    ds = DataSet(split.Xtrain, split.Ytrain, seed=3)
    blocks = [stage_batches(ds, 256, 10, device=cuda, dtype=torch.float32) for _ in range(2)]
    Xs, Ys = (b.clone() for b in blocks[0])
    on_side_stream(lambda: make_scan_train_step(opt)(model, Xs, Ys))
    make_scan_train_step(topt)(twin, Xs, Ys)
    graphed = make_graphed_scan_step(opt, model, Xs, Ys)
    Xs.copy_(blocks[1][0])
    Ys.copy_(blocks[1][1])
    g0, c0 = rg.rbf_gram_cuda.launches, ci.chol_inv_cuda.launches
    got = graphed()
    torch.cuda.synchronize()
    assert (rg.rbf_gram_cuda.launches - g0, ci.chol_inv_cuda.launches - c0) == (10 * grams, 10 * 2)
    want = make_scan_train_step(topt)(twin, *blocks[1])
    err = _rel_max(got, want)
    print(f"{family}: graphed vs eager, 10 steps: largest relative loss difference {err:.3e}")
    assert torch.isfinite(got).all() and err <= GRAPH_TOL


def test_toy_elbo_and_gradients_on_card_match_cpu_f64(cuda):
    """The toy model on a synthetic toy-shaped set in float64: the card's
    ELBO and every raw's gradient within 1e-10 relative of the CPU's."""
    from zigp_tpu_torch.experiments.toy import build_toy_model
    from zigp_tpu_torch.io.datasets import synthetic_toydata

    x, y, _ = synthetic_toydata(seed=0)
    out = {}
    for dev in (cuda, "cpu"):
        m, _, _ = build_toy_model(None, x, y, device=dev, dtype=torch.float64)
        elbo = m.elbo(*(torch.as_tensor(a, device=dev) for a in (x, y)))
        grads = torch.autograd.grad(elbo, list(m.parameters()))
        out[str(dev)] = (float(elbo.detach()), torch.cat([g.reshape(-1) for g in grads]).cpu())
    (e_card, g_card), (e_cpu, g_cpu) = out[str(cuda)], out["cpu"]
    print(f"toy ELBO card {e_card!r}, cpu {e_cpu!r}")
    assert abs(e_card - e_cpu) <= 1e-10 * abs(e_cpu)
    assert _rel(g_card, g_cpu) <= 1e-10


@pytest.mark.parametrize("name", ["svgp", "classifier", "hurdlej"])
def test_family_serving_keeps_its_graph_across_calls(cuda, name):
    """Serving a family by its bound method captures once: a second call
    (and a second runner-style eval on the same model) replays it."""
    from zigp_tpu_torch.experiments import runners
    from zigp_tpu_torch.io.datasets import synthetic_pptr

    split = synthetic_pptr(12, 120, seed=0)
    model, _, method = _family(name, split)
    X = split.Xtrain[:1000]
    first = runners.predict_batched(getattr(model, method), X, batch=256)
    (graph,) = runners._CHUNK_GRAPHS[model].values()
    c0 = ci.chol_inv_cuda.launches
    again = runners.predict_batched(getattr(model, method), X, batch=256)
    torch.cuda.synchronize()
    assert ci.chol_inv_cuda.launches - c0 == 4 * 2
    assert list(runners._CHUNK_GRAPHS[model].values()) == [graph]
    for k in first:
        assert np.array_equal(first[k], again[k]) and np.isfinite(first[k]).all(), k


# --- the other trainers: the block-coordinate schedule and natural gradients ---


def _natural_case(cuda, sizes=(10, 100), seed=0):
    """A stacked pair's (m, C_q, ∂L/∂m, ∂L/∂C_q) in float32 on the card: C_q
    the Cholesky factors of seeded SPD matrices scaled to O(1)."""
    rng = np.random.RandomState(seed)
    M = int(np.prod(sizes))
    Cs = [torch.as_tensor(np.linalg.cholesky(_spd(n, seed=seed + n).astype(np.float64) / n).astype(np.float32),
                          device=cuda) for n in sizes]
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=cuda)
    gC = [t(0.3 * rng.randn(2, n, n)) for n in sizes]
    return t(rng.randn(2, M, 1)), Cs, t(0.3 * rng.randn(2, M, 1)), gC


@pytest.mark.parametrize("kl_cap", [None, 10.0])
def test_natural_block_step_through_chol_inv_kernel_matches_its_plain_path(cuda, kl_cap):
    """The joint natural step on the card, every factorization through
    ``chol_inv.cu`` (4 launches a step with the KL budget, 3 without),
    against the same step with ``ops.linalg.chol_inv_forward`` on the
    kernel's plain version, for each p: within 1e-5 relative."""
    from zigp_tpu_torch.training import natgrad_update_block_kron

    m, Cs, gm, gC = _natural_case(cuda)
    gamma = torch.tensor(0.1, device=cuda)
    forward = linalg.chol_inv_forward

    def plain(K):
        return ci.chol_inv_plain(K.contiguous(), ci.NB)

    for p in range(2):
        before = ci.chol_inv_cuda.launches
        got = natgrad_update_block_kron(m, Cs, p, gm, gC[p], gamma, max_mean_step=10.0, kl_cap=kl_cap)
        torch.cuda.synchronize()
        assert ci.chol_inv_cuda.launches - before == (4 if kl_cap else 3)
        linalg.chol_inv_forward = plain
        try:
            want = natgrad_update_block_kron(m, Cs, p, gm, gC[p], gamma, max_mean_step=10.0, kl_cap=kl_cap)
        finally:
            linalg.chol_inv_forward = forward
        for a, b in zip(got, want):
            assert torch.isfinite(a).all() and _rel(a, b) < 1e-5


def test_natural_step_out_of_the_cone_keeps_the_previous_state_on_card(cuda):
    """A γ that takes A′ = A + (2γ/M_rest)·D out of the positive-definite
    cone (D with a negative eigenvalue, computed in float64; no KL budget,
    no growth limit): ``chol_inv.cu``'s NaN from the failing pivot makes the
    step keep the previous (m, C_p) to the bit; the opposite step moves."""
    from zigp_tpu_torch.training import natgrad_update_block_kron

    m, Cs, gm, gC = _natural_case(cuda, sizes=(6, 8), seed=3)
    C = Cs[1].double().cpu().expand(2, 8, 8)
    L, Li = linalg.chol_inv_forward(C @ C.transpose(-1, -2))
    D = linalg.chol_vjp(L, Li, torch.tril(gC[1].double().cpu()))
    lam = torch.linalg.eigvalsh(0.5 * (D + D.transpose(-1, -2)))
    A_max = torch.linalg.eigvalsh(Li.transpose(-1, -2) @ Li)[..., -1]
    sign = torch.where(lam[..., 0] < 0, 1.0, -1.0)  # a negative eigenvalue for each of the pair
    lam_neg = torch.linalg.eigvalsh(0.5 * (D + D.transpose(-1, -2)) * sign[:, None, None])[..., 0]
    gamma = float((100 * A_max * 6 / (2 * -lam_neg)).max())
    g = gC[1] * sign.to(gC[1])[:, None, None]
    kw = dict(max_mean_step=0.0, max_var_growth=1e30)
    new_m, new_C = natgrad_update_block_kron(m, Cs, 1, gm, g, torch.tensor(gamma, device=cuda), **kw)
    assert torch.equal(new_m, m) and torch.equal(new_C, torch.tril(Cs[1]).expand(2, 8, 8))
    moved, _ = natgrad_update_block_kron(m, Cs, 1, gm, 1e-3 * g, torch.tensor(0.1, device=cuda), **kw)
    assert torch.isfinite(moved).all() and not torch.equal(moved, m)


def test_captured_alternating_block_makes_no_chol_inv_launch_in_its_q_only_steps(cuda):
    """10 steps in two groups of 5 captured as one graph: its replay launches
    ``chol_inv.cu`` 4 times a group (the hyper step's and the factor
    state's, one a factor for the stacked pair) and never in the 8 q-only
    steps, and the gram's backward kernel once for each of the hyper step's
    4 grams a group (the factor state and the q-only steps' grams take no
    gradient); equal to the eager block on a twin within GRAPH_TOL."""
    import copy

    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import capture_block, init_alt_optimizers, make_alternating_block

    model, _, blocks = _graph_setup(cuda)
    twin = copy.deepcopy(model)
    body = make_alternating_block(model, init_alt_optimizers(model, learning_rate=1e-2), 5)
    tbody = make_alternating_block(twin, init_alt_optimizers(twin, learning_rate=1e-2), 5)
    Xs, Ys = (b.clone() for b in blocks[0])
    on_side_stream(lambda: body(Xs, Ys))
    tbody(Xs, Ys)
    graphed = capture_block(lambda: body(Xs, Ys))
    assert graphed.graph.launches == {(ci.chol_inv_cuda, "launches"): 4 * 2,
                                      (ci.chol_inv_cuda, "launches_by_n"): {6: 4, 20: 4},
                                      (ci.chol_inv_cuda, "launches_by_batch"): {(2, 6): 4, (2, 20): 4},
                                      (rg.rbf_gram_cuda, "launches"): 2 * (4 + 2) + 8 * 2,
                                      (rg.rbf_gram_cuda, "launches_by_shape"):
                                          graphed.graph.launches[(rg.rbf_gram_cuda, "launches_by_shape")],
                                      (rg.rbf_gram_bwd_cuda, "launches"): 2 * 4,
                                      (rg.rbf_gram_bwd_cuda, "launches_by_shape"):
                                          {(2, 6, 6, 2): 2, (2, 6, 256, 2): 2, (2, 20, 20, 1): 2, (2, 20, 256, 1): 2}}
    Xs.copy_(blocks[1][0])
    Ys.copy_(blocks[1][1])
    got = graphed()
    want = tbody(*blocks[1])
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and _rel_max(got, want) <= GRAPH_TOL


# --- the batched member stack ---


@pytest.mark.parametrize("n", [100, 200, 250])
def test_folded_chol_inv_equals_per_member_launches_bit_for_bit(cuda, n):
    """Under ``torch.func.vmap`` the member dim folds into one launch of
    (F·G, n, n) (``chol_inv.cu`` to 238, the cluster kernel above); the
    kernels run one CTA or one cluster per matrix, so each member's factors
    are the bits of its own launch."""
    F = 5
    K = torch.as_tensor(np.stack([_spd(n, seed=n + f) for f in range(F)]), device=cuda)
    wrapper = ci.chol_inv_cuda if n <= ci.MAX_N else ci.chol_inv_blocked
    before = wrapper.launches
    with torch.inference_mode():
        L, Linv = torch.func.vmap(linalg.chol_inv)(K)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        for f in range(F):
            Lf, Linvf = linalg.chol_inv(K[f])
            assert torch.equal(L[f], Lf) and torch.equal(Linv[f], Linvf)


def _stack_setup(cuda, F, K=10, B=256):
    """F small on/off models (one per seed) with both kernels on, stacked,
    their Adam, and the stack's blocks on the card."""
    import dataclasses

    from zigp_tpu_torch.experiments import configs
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.io.datasets import synthetic_pptr
    from zigp_tpu_torch.training import StackedBlocks, make_optimizer, stack_models

    split = synthetic_pptr(12, 120, seed=0)
    cfg = configs.OnOffPptrConfig(grid=configs.KronGridConfig(6, 20), batch_size=B)
    stack = stack_models([build_onoff_pptr(dataclasses.replace(cfg, seed=f), split, use_kernel=True)
                          for f in range(F)])
    blocks = StackedBlocks([(split.Xtrain, split.Ytrain)] * F, B, K, seeds=list(range(F)), device=cuda,
                           dtype=torch.float32)
    return stack, make_optimizer(stack, default_lr=1e-2), blocks


def test_graphed_stacked_block_matches_eager_stacked_block(cuda):
    """10 stacked steps (F = 3) by one replay of the captured block against
    10 eager stacked steps on a twin, on the same rows: losses (10, F) and
    raws within GRAPH_TOL."""
    import copy

    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import capture_block, make_batched_block, make_optimizer

    stack, opt, blocks = _stack_setup(cuda, 3)
    twin = copy.deepcopy(stack)
    topt = make_optimizer(twin, default_lr=1e-2)
    body, tbody = make_batched_block(stack, opt), make_batched_block(twin, topt)
    blocks.fill(0)
    on_side_stream(lambda: body(blocks.Xs, blocks.Ys))
    tbody(blocks.Xs, blocks.Ys)
    graphed = capture_block(lambda: body(blocks.Xs, blocks.Ys))
    blocks.fill(1)
    got = graphed()
    want = tbody(blocks.Xs, blocks.Ys)
    torch.cuda.synchronize()
    assert got.shape == (10, 3) and torch.isfinite(got).all() and _rel_max(got, want) <= GRAPH_TOL
    for (n, a), b in zip(stack.named_parameters(), twin.parameters()):
        assert torch.allclose(a, b, rtol=GRAPH_TOL, atol=GRAPH_TOL * float(b.abs().max())), n


@pytest.mark.parametrize("F", [1, 2, 5])
def test_stacked_step_launches_do_not_grow_with_members(cuda, F):
    """A captured stacked step launches ``chol_inv.cu`` once per factor (two
    a step for the f/g pair's two factors) and ``rbf_gram`` four times,
    whatever F."""
    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import capture_block, make_batched_block

    stack, opt, blocks = _stack_setup(cuda, F, K=2)
    body = make_batched_block(stack, opt)
    blocks.fill(0)
    on_side_stream(lambda: body(blocks.Xs, blocks.Ys))
    graphed = capture_block(lambda: body(blocks.Xs, blocks.Ys))
    launches = graphed.graph.launches
    assert launches[(ci.chol_inv_cuda, "launches")] == 2 * 2
    assert launches[(ci.chol_inv_cuda, "launches_by_batch")] == {(2 * F, 6): 2, (2 * F, 20): 2}
    assert launches[(rg.rbf_gram_cuda, "launches")] == 2 * 4
    assert all(G == 2 * F for G, *_ in launches[(rg.rbf_gram_cuda, "launches_by_shape")])


# --- the registered ops and the exported program ---


def test_opcheck_of_the_ops_on_the_card(cuda):
    """``torch.library.opcheck`` (schema, fake implementation, dynamic
    shapes) of the three ops on CUDA float32 tensors: chol_inv.cu at n = 100,
    the cluster kernel's pair (n = 250) and row (n = 400) instances, and the
    gram with a shared and a batched X, D = 1 and 5."""
    for fn, n in ((ci.chol_inv_op, 100), (ci.chol_inv_blocked_op, 250), (ci.chol_inv_blocked_op, 400)):
        torch.library.opcheck(fn, (torch.as_tensor(_spd(n, seed=n), device=cuda),))
    rng = np.random.RandomState(0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    for X, Z in ((rng.rand(2, 30, 1), rng.rand(257, 1)), (rng.rand(2, 8, 5), rng.rand(2, 64, 5))):
        torch.library.opcheck(rg.rbf_gram_op, (t(X), t(Z), t(rng.rand(2, X.shape[-1]) + 0.5), t(rng.rand(2) + 0.5)))


def test_an_artifact_exported_on_the_card_launches_the_kernels(cuda, tmp_path):
    """The on/off model at a 4 x 250 grid with the gram kernel on, exported
    with a symbolic batch: each served call launches chol_inv.cu once (n =
    4), the cluster kernel once (n = 250) and rbf_gram.cu four times, at 300
    rows and at 50, within 1e-5 of each field's largest value of the live
    model's predict."""
    from zigp_tpu_torch.experiments import configs
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.io.datasets import synthetic_pptr
    from zigp_tpu_torch.io.export import export_predictor, load_predictor

    split = synthetic_pptr(12, 120, seed=0)
    model = build_onoff_pptr(configs.OnOffPptrConfig(grid=configs.KronGridConfig(4, 250)), split, use_kernel=True)
    served = load_predictor(export_predictor(model, "onoff", 3, str(tmp_path / "onoff.zigp")))
    assert served.meta["device"] == "cuda"
    for n in (300, 50):
        X = split.Xtrain[:n]
        before = (ci.chol_inv_cuda.launches, ci.chol_inv_blocked.launches, rg.rbf_gram_cuda.launches)
        out = served(X)
        torch.cuda.synchronize()
        after = (ci.chol_inv_cuda.launches, ci.chol_inv_blocked.launches, rg.rbf_gram_cuda.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 4)
        with torch.no_grad():
            want = model.predict(torch.as_tensor(X, dtype=torch.float32, device=cuda))._asdict()
        for k, v in want.items():
            v = v.cpu().numpy()
            assert np.abs(out[k] - v).max() <= 1e-5 * np.abs(v).max(), k


def test_a_captured_block_counts_each_op_launch_once(cuda):
    """The kernels launched through their registered ops: a captured block
    of 10 flagship-like steps (both kernels on) counts, per replay, the
    launches of the same block run eagerly, 2 chol_inv.cu and 4 rbf_gram.cu
    a step."""
    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import make_graphed_scan_step, make_scan_train_step

    model, opt, blocks = _graph_setup(cuda)
    Xs, Ys = (b.clone() for b in blocks[0])
    before = (ci.chol_inv_cuda.launches, rg.rbf_gram_cuda.launches)
    on_side_stream(lambda: make_scan_train_step(opt)(model, Xs, Ys))
    torch.cuda.synchronize()
    eager = (ci.chol_inv_cuda.launches - before[0], rg.rbf_gram_cuda.launches - before[1])
    graphed = make_graphed_scan_step(opt, model, Xs, Ys)
    per_replay = (graphed.graph.launches[(ci.chol_inv_cuda, "launches")],
                  graphed.graph.launches[(rg.rbf_gram_cuda, "launches")])
    assert eager == per_replay == (10 * 2, 10 * 4)


def test_one_rank_nccl_mesh_graphed_block_equals_the_no_mesh_block_bit_for_bit(cuda, tmp_path):
    """``train_onoff_pptr`` with ``mesh_data=1`` on a one-rank NCCL process
    group: every block after the warm-up is one replay with the gradient's
    and the losses' all-reduces inside the graph, and at one rank they leave
    their buffers as they were, so the losses and raws equal the no-mesh
    graphed run's bit for bit."""
    import dataclasses

    import torch.distributed as dist

    from zigp_tpu_torch.experiments import configs
    from zigp_tpu_torch.experiments.runners import train_onoff_pptr
    from zigp_tpu_torch.io.datasets import synthetic_pptr
    from zigp_tpu_torch.parallel.distributed import initialize, shutdown

    split = synthetic_pptr(6, 20, seed=0)
    cfg = configs.OnOffPptrConfig(grid=configs.KronGridConfig(6, 20), batch_size=256, num_iter=40, scan_inner=10,
                                  sampler="device", log_every=0)
    plain = train_onoff_pptr(cfg, split, use_kernel=True, log_fn=lambda s: None)
    assert initialize(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl")
    try:
        logs = []
        meshed = train_onoff_pptr(dataclasses.replace(cfg, mesh_data=1), split, use_kernel=True, log_fn=logs.append)
    finally:
        shutdown()
    assert not dist.is_initialized()
    assert any("block graph of 10 steps" in line for line in logs) and "mesh: 1-way data parallel" in logs
    assert torch.equal(meshed.step_losses, plain.step_losses)
    for (n, a), b in zip(meshed.model.named_parameters(), plain.model.parameters()):
        assert torch.equal(a, b), n


def test_selfcheck_on_the_card_launches_every_production_kernel(cuda):
    """``run_selfcheck()`` on the card: every gate passes and each check's
    launches are exact (the check raises otherwise); in all, chol_inv.cu at
    n = 100 (check 1), in the ELBO (2), the ten steps (20) and the
    single-path predict (2); the cluster kernel once (n = 250); the gram 1 +
    4 + 40 times and its backward 1 + 40."""
    from zigp_tpu_torch.experiments.selfcheck import run_selfcheck

    res = run_selfcheck(lambda s: None)
    assert res["launches"] == {"chol_inv": 25, "chol_inv_blocked": 1, "rbf_gram": 45, "rbf_gram_bwd": 41}
    assert res["scan_ab"]["err"] <= 5e-3


def test_measure_block_equals_fit_scanned_on_the_same_seed(cuda):
    """``measure.prepare_step``'s blocks (the warm-up block, the capture, then
    replays) give ``fit_scanned``'s device-sampler losses on the same seed,
    bit for bit, both with the gram kernel on."""
    import copy

    from zigp_tpu_torch.experiments import configs, measure
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.io.datasets import synthetic_pptr
    from zigp_tpu_torch.training import DataSet, fit_scanned, make_optimizer

    split = synthetic_pptr(12, 120, seed=0)
    cfg = configs.OnOffPptrConfig(grid=configs.KronGridConfig(6, 40), batch_size=256)
    model = build_onoff_pptr(cfg, split, use_kernel=True)
    arrays = (split.Xtrain, split.Ytrain)
    step, _, _ = measure.prepare_step(model, arrays, 256, cfg, num_inner=10)
    got = measure.losses_of(step, range(3))
    assert step.ready and step.runner.graphed is not None
    ref = copy.deepcopy(model)
    res = fit_scanned(ref, DataSet(*arrays), num_iter=30, batch_size=256, num_inner=10,
                      optimizer=make_optimizer(ref, default_lr=cfg.indp_lr), sampler="device", sampler_seed=0,
                      log_every_blocks=0, log_fn=lambda s: None)
    np.testing.assert_array_equal(got, res.step_losses.numpy())


def test_serve_bench_on_the_card(cuda):
    """``serve_bench.run`` at 10,000 rows: the artifact's fields within 1e-5
    of ``predict_batched``'s, every exported call through the kernels' ops."""
    from zigp_tpu_torch.experiments import configs, serve_bench
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.io.datasets import synthetic_pptr

    split = synthetic_pptr(20, 600, seed=0)
    model = build_onoff_pptr(configs.best_onoff_config(), split, use_kernel=True)
    before = ci.chol_inv_cuda.launches
    res = serve_bench.run(batch=4096, rows=10_000, model=model, X=split.Xtrain, repeats=1, log_fn=lambda s: None)
    assert res["max_rel_diff"] <= serve_bench.GATE and res["device"] == torch.cuda.get_device_name(0)
    assert ci.chol_inv_cuda.launches > before


def test_make_mesh_takes_an_index_less_cuda_device(cuda):
    """``make_mesh(1, 1, devices=["cuda"])``: the current card, stored by its
    index (``torch.cuda.set_device`` refuses a device without one)."""
    from zigp_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, 1, devices=["cuda"])
    assert mesh.device == torch.device("cuda", torch.cuda.current_device())
    assert mesh.device.index is not None and torch.cuda.current_device() == mesh.device.index
    x = torch.ones(3, device=mesh.device)
    assert torch.equal(mesh.all_reduce_data(x), x)


# --- the 3-pass bf16 product of the solve-precision policy (csrc/bf16x3_mm.cu) ---


def _split64(a, b):
    """hi·hi + hi·lo + lo·hi in float64 of float32 a, b, and K·2⁻²⁴·Σ|a||b|."""
    from zigp_tpu_torch.ops.cuda.bf16x3 import split_bf16

    (ah, al), (bh, bl) = split_bf16(a), split_bf16(b)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    return ah @ bh + (ah @ bl + al @ bh), a.shape[-1] * 2.0**-24 * (a.double().abs() @ b.double().abs())


@pytest.mark.parametrize("n", [10, 32, 100, 105, 200, 250])
@pytest.mark.parametrize("B, layout", [(1000, "ab"), (4000, "ab"), (8192, "ab"), (16384, "ab"), (8192, "aT b"),
                                       (8192, "a bT"), (None, "aT a"), (8192, "dots"), (8192, "split k"),
                                       (8192, "short k")])
def test_bf16x3_matches_its_split_and_float64(cuda, n, B, layout):
    """The kernel against the float64 value of its own three products
    (within 2·K·2⁻²⁴·Σ|a||b|, the bound of float32 accumulation with
    truncation; a lost cross term misses by about 2⁻⁹) and against the
    float64 product within max(3 × the plain version's error, 1e-5); one
    launch a call."""
    from zigp_tpu_torch.ops.cuda import bf16x3 as bx

    g = torch.Generator(device=cuda).manual_seed(n)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda)
    a, b = {
        "ab": lambda: (r(2, n, n), r(2, n, B)),
        "aT b": lambda: (r(2, n, n).transpose(-1, -2), r(2, n, B)),
        "a bT": lambda: (r(2, n, n), r(2, B, n).transpose(-1, -2)),
        "aT a": lambda: (r(2, n, n).transpose(-1, -2), r(2, n, n)),
        "dots": lambda: (r(2, B, 1, n), r(2, n, B).transpose(-1, -2).unsqueeze(-1)),
        "split k": lambda: (r(2, n, B), r(2, n, B).transpose(-1, -2)),
        "short k": lambda: (r(2, B, 1, 1), r(2, n, B).transpose(-1, -2).unsqueeze(-2)),
    }[layout]()
    before = bx.bf16x3_mm_cuda.launches
    c = bx.bf16x3_mm_cuda(a, b)
    torch.cuda.synchronize()
    assert bx.bf16x3_mm_cuda.launches == before + 1
    split, bound = _split64(a, b)
    assert torch.all((c.double() - split).abs() <= 2.0 * bound)
    exact = a.double() @ b.double()
    e_k = float(torch.linalg.norm(c.double() - exact) / torch.linalg.norm(exact))
    e_p = float(torch.linalg.norm(bx.bf16x3_mm_plain(a, b).double() - exact) / torch.linalg.norm(exact))
    assert e_k <= max(3.0 * e_p, 1e-5)


@pytest.mark.parametrize("M, N, K", [(100, 1000, 64), (1, 1, 64), (100, 100, 8192), (100, 1, 1)])
def test_bf16x3_carries_nan(cuda, M, N, K):
    """In every instance of the plan: tiles, dots, k split, short k."""
    from zigp_tpu_torch.ops.cuda import bf16x3 as bx

    a = torch.randn(4, M, K, device=cuda)
    b = torch.randn(4, K, N, device=cuda)
    a[2, M // 2, K // 2] = float("nan")
    c = bx.bf16x3_mm_cuda(a, b)
    assert torch.isnan(c[2, M // 2]).all()
    c[2, M // 2] = 0.0
    assert torch.isfinite(c).all()


def test_bf16x3_refuses_what_it_cannot_take(cuda):
    from zigp_tpu_torch.ops.cuda import bf16x3 as bx

    with pytest.raises(TypeError):
        bx.bf16x3_mm_cuda(torch.randn(2, 3, 4, device=cuda, dtype=torch.float64),
                          torch.randn(2, 4, 5, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        bx.bf16x3_mm_cuda(torch.randn(2, 3, 4, device=cuda), torch.randn(2, 5, 5, device=cuda))
    with pytest.raises(ValueError):
        bx.bf16x3_mm_cuda(torch.randn(2, 3, 4, device=cuda), torch.randn(2, 4, 5))


def test_graphed_block_under_mixed_matches_eager(cuda):
    """A block captured under "mixed" against the same steps run eagerly
    under "mixed", within GRAPH_TOL, each replay counting its 3-pass
    launches; after a switch to "highest" the replay still launches them
    (the graph keeps the policy it captured)."""
    from zigp_tpu_torch.ops import linalg
    from zigp_tpu_torch.ops.cuda import bf16x3 as bx
    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import make_graphed_scan_step, make_scan_train_step

    model, opt, blocks = _graph_setup(cuda)
    twin, topt = _twin(model)
    Xs, Ys = (b.clone() for b in blocks[0])
    linalg.set_solve_precision("mixed")
    try:
        on_side_stream(lambda: make_scan_train_step(opt)(model, Xs, Ys))
        before = bx.bf16x3_mm_cuda.launches
        make_scan_train_step(topt)(twin, Xs, Ys)
        per_block = bx.bf16x3_mm_cuda.launches - before
        graphed = make_graphed_scan_step(opt, model, Xs, Ys)
        Xs.copy_(blocks[1][0])
        Ys.copy_(blocks[1][1])
        want = make_scan_train_step(topt)(twin, *blocks[1])
    finally:
        linalg.set_solve_precision("highest")
    before = bx.bf16x3_mm_cuda.launches
    got = graphed()
    torch.cuda.synchronize()
    assert per_block > 0 and bx.bf16x3_mm_cuda.launches - before == per_block
    assert torch.isfinite(got).all() and _rel_max(got, want) <= GRAPH_TOL


def test_opcheck_of_the_bf16x3_op(cuda):
    from zigp_tpu_torch.ops.cuda import bf16x3 as bx

    a = torch.randn(2, 30, 17, device=cuda)
    torch.library.opcheck(bx.bf16x3_mm_op, (a, torch.randn(2, 17, 70, device=cuda)))
    torch.library.opcheck(bx.bf16x3_mm_op, (a.transpose(-1, -2), torch.randn(2, 30, 5, device=cuda)))


# --- bf16x3_mm.cu's tile instance: its copy routes, its cluster's k ranges, its bits ---


def _bf16x3_route_cases(cuda):
    """(name, a, b) covering each copy route on each operand: TMA, cp.async
    of 16, 8 and 4 bytes (a base one float off, an odd row pitch, a
    broadcast batch, a (G, B) batch of views, neither dim of unit stride)."""
    g = torch.Generator(device=cuda).manual_seed(18)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda)
    return [
        ("tma both", r(2, 200, 200), r(2, 200, 4000)),
        ("a offset by one float", r(2, 250, 251)[..., 1:], r(2, 250, 8192)),
        ("b offset by one float", r(2, 250, 250), r(2, 250, 8193)[..., 1:]),
        ("a odd pitch n = 105", r(2, 105, 105), r(2, 105, 8192)),
        ("b odd pitch n = 105, k split", r(2, 105, 8192), r(2, 8192, 105)),
        ("a transposed odd pitch", r(2, 105, 105).transpose(-1, -2), r(2, 105, 1000)),
        ("a broadcast batch", r(250, 250).expand(2, 250, 250), r(2, 250, 1000)),
        ("b broadcast batch", r(2, 200, 200), r(200, 1000).expand(2, 200, 1000)),
        ("(G, B) batch of views", r(4, 1, 200, 200).expand(4, 3, 200, 200), r(4, 3, 200, 1000)),
        ("a neither dim of unit stride", r(2, 64, 64, 2)[..., 0], r(2, 64, 300)),
    ]


@pytest.mark.parametrize("case", range(10))
def test_bf16x3_copy_routes_match_the_split(cuda, case):
    """Each route against the float64 value of the kernel's own three
    products (2·K·2⁻²⁴·Σ|a||b|), the route the plan names, one launch a call
    and one more in its instance's count."""
    from zigp_tpu_torch.ops.cuda import bf16x3 as bx

    name, a, b = _bf16x3_route_cases(cuda)[case]
    p = bx.plan_of(a, b)
    G, M, N, K = int(np.prod(a.shape[:-2])), a.shape[-2], b.shape[-1], a.shape[-1]
    key = (G, M, N, K, p.label)
    before, by = bx.bf16x3_mm_cuda.launches, bx.bf16x3_mm_cuda.launches_by_instance[key]
    c = bx.bf16x3_mm_cuda(a, b)
    torch.cuda.synchronize()
    assert bx.bf16x3_mm_cuda.launches == before + 1
    assert bx.bf16x3_mm_cuda.launches_by_instance[key] == by + 1, (name, p.label)
    split, bound = _split64(a, b)
    assert torch.all((c.double() - split).abs() <= 2.0 * bound), name


def test_bf16x3_routes_the_plan_names(cuda):
    """The routes of the cases above are the ones the plan is meant to take:
    every cp.async width, TMA on both operands, and each on A and on B."""
    from zigp_tpu_torch.ops.cuda import bf16x3 as bx

    labels = {name: bx.plan_of(a, b).label for name, a, b in _bf16x3_route_cases(cuda)}
    routes = {r for label in labels.values() for r in label.split()[1:]}
    assert {"A:tma", "B:tma", "A:cp.async4", "B:cp.async4", "A:cp.async8", "A:cp.async16", "B:cp.async16"} <= routes


@pytest.mark.parametrize("K", [1000, 4000, 8192])
def test_bf16x3_long_k_cluster_matches_the_split(cuda, K):
    """The long-k product, k cut into a cluster's ranges by K alone, against
    the split's float64 value (2·K·2⁻²⁴·Σ|a||b|), at n = 250 and 105."""
    from zigp_tpu_torch.ops.cuda import bf16x3 as bx

    g = torch.Generator(device=cuda).manual_seed(K)
    for n in (250, 105):
        a = torch.randn(2, n, K, generator=g, device=cuda)
        b = torch.randn(2, n, K, generator=g, device=cuda).transpose(-1, -2)
        p = bx.plan_of(a, b)
        assert (p.splits, p.ks) == bx.k_ranges(K) and p.splits > 1
        c = bx.bf16x3_mm_cuda(a, b)
        split, bound = _split64(a, b)
        assert torch.all((c.double() - split).abs() <= 2.0 * bound), (n, K)


def test_bf16x3_same_bits_every_call_and_in_a_graph(cuda):
    """No atomics: two calls give the same bits, and a graph replay the bits
    of the eager call, in a plain tile and in a cluster's k ranges."""
    from zigp_tpu_torch.ops.cuda import bf16x3 as bx

    g = torch.Generator(device=cuda).manual_seed(1)
    pairs = [(torch.randn(2, 250, 250, generator=g, device=cuda), torch.randn(2, 250, 8192, generator=g, device=cuda)),
             (torch.randn(2, 250, 8192, generator=g, device=cuda),
              torch.randn(2, 250, 8192, generator=g, device=cuda).transpose(-1, -2)),
             _bf16x3_short_k_operands(cuda, "n-major", 8192, 250, g),
             _bf16x3_short_k_operands(cuda, "batch-major", 8192, 250, g)]
    for a, b in pairs:
        eager = bx.bf16x3_mm_cuda(a, b)
        assert torch.equal(eager, bx.bf16x3_mm_cuda(a, b))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            bx.bf16x3_mm_cuda(a, b)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = bx.bf16x3_mm_cuda(a, b)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_bf16x3_batch_member_keeps_its_bits(cuda):
    """The k partition follows K alone: each member's slice of a batched call
    is the bits of the call on that member alone, long k included."""
    from zigp_tpu_torch.ops.cuda import bf16x3 as bx

    g = torch.Generator(device=cuda).manual_seed(2)
    for M, N, K in [(100, 1000, 100), (105, 105, 8192), (250, 250, 4000)]:
        a = torch.randn(10, M, K, generator=g, device=cuda)
        b = torch.randn(10, K, N, generator=g, device=cuda)
        c = bx.bf16x3_mm_cuda(a, b)
        for f in range(0, 10, 3):
            assert torch.equal(c[f], bx.bf16x3_mm_cuda(a[f], b[f])), (M, N, K, f)


@pytest.mark.parametrize("instance", ["dots", "short_k n-major st16", "short_k n-major st4",
                                      "short_k batch-major st16", "short_k batch-major st4"])
def test_bf16x3_counts_each_instance(cuda, instance):
    """The warp-a-dot instance and the short-k instance in each of the
    path's two layouts, with and without 16-byte stores, count their
    launches under their own labels, one a call."""
    from zigp_tpu_torch.ops.cuda import bf16x3 as bx

    a, b = {"dots": (torch.randn(64, 1, 250, device=cuda), torch.randn(64, 250, 1, device=cuda)),
            "short_k n-major st16": (torch.randn(64, 1, 1, device=cuda), torch.randn(64, 1, 200, device=cuda)),
            "short_k n-major st4": (torch.randn(64, 1, 1, device=cuda), torch.randn(64, 1, 250, device=cuda)),
            "short_k batch-major st16": (torch.randn(200, 64, device=cuda).T.unsqueeze(-1),
                                         torch.randn(64, 1, 1, device=cuda)),
            "short_k batch-major st4": (torch.randn(250, 64, device=cuda).T.unsqueeze(-1),
                                        torch.randn(64, 1, 1, device=cuda))}[instance]
    key = (64, a.shape[-2], b.shape[-1], a.shape[-1], instance)
    assert bx.plan_of(a, b).label == instance
    before = bx.bf16x3_mm_cuda.launches_by_instance[key]
    bx.bf16x3_mm_cuda(a, b)
    torch.cuda.synchronize()
    assert bx.bf16x3_mm_cuda.launches_by_instance[key] == before + 1


# --- bf16x3_mm.cu's short-k instance in the layouts of the factored contraction's backward ---


def _bf16x3_short_k_operands(cuda, layout, B, n, g):
    """(a, b) of a K = 1 product of the path at B rows (a (2, B) batch) and
    the later factor's n: dF = dC·tᵀ with t contiguous along n ("n-major"),
    dt = Fᵀ·dC with Fᵀ a view of the (2, n, B) factor ("batch-major"), the
    factor as the long B operand ("batch-major B"), a contiguous (2, B, n, 1)
    ("m-major"), the factor's rows two floats apart ("strided")."""
    r = lambda *s: torch.randn(*s, generator=g, device=cuda)
    return {"n-major": lambda: (r(2, B, 1, 1), r(2, B, n, 1).mT),
            "batch-major": lambda: (r(2, n, B).mT.unsqueeze(-1), r(2, B, 1, 1)),
            "batch-major B": lambda: (r(2, B, 1, 1), r(2, n, B).mT.unsqueeze(-2)),
            "m-major": lambda: (r(2, B, n, 1), r(2, B, 1, 1)),
            "strided": lambda: (r(2, B, 1, 1), r(2, B, n, 2)[..., 0].unsqueeze(-2))}[layout]()


@pytest.mark.parametrize("B, n", [(8192, 250), (4000, 200), (1000, 100)])
@pytest.mark.parametrize("layout", ["n-major", "batch-major", "batch-major B", "m-major", "strided"])
def test_bf16x3_short_k_matches_the_split(cuda, layout, B, n):
    """The short-k instance at the grid's, the champion's and the flagship's
    K = 1 products in each layout, within 2·K·2⁻²⁴·Σ|a||b| of the float64
    value of its split, one launch a call counted under the plan's label."""
    from zigp_tpu_torch.ops.cuda import bf16x3 as bx

    a, b = _bf16x3_short_k_operands(cuda, layout, B, n, torch.Generator(device=cuda).manual_seed(n))
    p = bx.plan_of(a, b)
    assert p.instance == "short_k" and p.layout == layout.split()[0]
    key = (2 * B, a.shape[-2], b.shape[-1], 1, p.label)
    before, by = bx.bf16x3_mm_cuda.launches, bx.bf16x3_mm_cuda.launches_by_instance[key]
    c = bx.bf16x3_mm_cuda(a, b)
    torch.cuda.synchronize()
    assert bx.bf16x3_mm_cuda.launches == before + 1 and bx.bf16x3_mm_cuda.launches_by_instance[key] == by + 1
    split, bound = _split64(a, b)
    assert torch.all((c.double() - split).abs() <= 2.0 * bound)


@pytest.mark.parametrize("M, N, K", [(15, 70, 16), (70, 15, 7), (3, 2501, 2), (2000, 4, 5), (10, 1000, 10),
                                     (10, 0, 3), (4, 6, 0)])
@pytest.mark.parametrize("layout", ["contiguous", "transposed", "along the batch"])
def test_bf16x3_short_k_generic_shapes_match_the_split(cuda, M, N, K, layout):
    """K up to 16, a thin side up to 15 on either side, long sides past one
    tile with N % 4 ≠ 0, K = 0 and an empty C, each operand contiguous,
    given transposed or with unit stride along the batch."""
    from zigp_tpu_torch.ops.cuda import bf16x3 as bx

    g = torch.Generator(device=cuda).manual_seed(M * N + K)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda)
    G = 40
    a, b = {"contiguous": lambda: (r(G, M, K), r(G, K, N)),
            "transposed": lambda: (r(G, K, M).mT, r(G, N, K).mT),
            "along the batch": lambda: (r(M, K, G).permute(2, 0, 1), r(K, N, G).permute(2, 0, 1))}[layout]()
    assert bx.plan_of(a, b).instance == "short_k"
    c = bx.bf16x3_mm_cuda(a, b)
    split, bound = _split64(a, b)
    assert c.shape == (G, M, N) and torch.all((c.double() - split).abs() <= 2.0 * bound)


@pytest.mark.parametrize("layout", ["n-major", "batch-major", "batch-major B", "m-major"])
def test_bf16x3_short_k_carries_nan(cuda, layout):
    """A NaN in one row of A makes that row of C NaN and leaves the rest
    finite, in each layout of the short-k instance."""
    from zigp_tpu_torch.ops.cuda import bf16x3 as bx

    a, b = _bf16x3_short_k_operands(cuda, layout, 1000, 200, torch.Generator(device=cuda).manual_seed(3))
    row = a.shape[-2] // 2
    a[1, 7, row, 0] = float("nan")
    c = bx.bf16x3_mm_cuda(a, b)
    assert torch.isnan(c[1, 7, row]).all()
    c[1, 7, row] = 0.0
    assert torch.isfinite(c).all()


@pytest.mark.parametrize("layout", ["n-major", "batch-major", "batch-major B"])
def test_bf16x3_short_k_member_keeps_its_bits(cuda, layout):
    """The F = 5 stack's folded launch of a K = 1 product: each member's
    slice is the bits of the member launched alone (a tiling of its own:
    the tiling changes no bit)."""
    from zigp_tpu_torch.ops.cuda import bf16x3 as bx

    g = torch.Generator(device=cuda).manual_seed(5)
    F = torch.randn(5, 2, 100, 1000, generator=g, device=cuda)  # each member's (2, n, B) factor
    dc = torch.randn(5, 2, 1000, 1, 1, generator=g, device=cuda)
    t = torch.randn(5, 2, 1000, 100, 1, generator=g, device=cuda)
    a, b = {"n-major": (dc, t.mT), "batch-major": (F.mT.unsqueeze(-1), dc),
            "batch-major B": (dc, F.mT.unsqueeze(-2))}[layout]
    assert bx.plan_of(a, b).layout == layout.split()[0]
    c = bx.bf16x3_mm_cuda(a, b)
    for f in range(5):
        assert torch.equal(c[f], bx.bf16x3_mm_cuda(a[f], b[f])), f



# --- the exact float32 product of the batch-reducing shapes with k split (ops/split_k.py) ---


def _split_operands(cuda, name, g):
    """(a, b) of a batch-reducing product as the path lays it out: the grid's
    dw = K_mn,s·dt (the (2, 105, B) factor by a contiguous (2, B, 250)) and
    dL_p⁻¹ = dV·K_mn,pᵀ with dV contiguous or m-contiguous, at B = 8192; the
    champion's at B = 4000."""
    r = lambda *s: torch.randn(*s, generator=g, device=cuda)
    B = 8192
    return {"grid dw": lambda: (r(2, 105, B), r(2, B, 250)),
            "grid dLinv 250": lambda: (r(2, 250, B), r(2, 250, B).mT),
            "grid dLinv 250 m-contiguous": lambda: (r(2, B, 250).mT, r(2, 250, B).mT),
            "grid dLinv 105": lambda: (r(2, 105, B), r(2, 105, B).mT),
            "grid dLinv 105 m-contiguous": lambda: (r(2, B, 105).mT, r(2, 105, B).mT),
            "champion dw": lambda: (r(2, 32, 4000), r(2, 4000, 200)),
            "champion dLinv 200": lambda: (r(2, 200, 4000), r(2, 200, 4000).mT)}[name]()


SPLIT_CASES = ["grid dw", "grid dLinv 250", "grid dLinv 250 m-contiguous", "grid dLinv 105",
               "grid dLinv 105 m-contiguous", "champion dw", "champion dLinv 200"]


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_split_k_matches_float64_with_the_same_bits_twice(cuda, name):
    """The split product at the grid's and the champion's products, in the
    path's layouts, within (K // S + S)·2⁻²⁴·Σ|a||b| of float64, and the same
    bits on a second call."""
    from zigp_tpu_torch.ops import split_k as sk

    a, b = _split_operands(cuda, name, torch.Generator(device=cuda).manual_seed(len(name)))
    c = sk.split_k_mm(a, b)
    K = a.shape[-1]
    exact = a.double() @ b.double()
    bound = (K // sk.SPLITS + sk.SPLITS) * 2.0**-24 * (a.double().abs() @ b.double().abs())
    assert c.shape == exact.shape and torch.all((c.double() - exact).abs() <= bound), name
    assert torch.equal(c, sk.split_k_mm(a, b)), name


def test_bdot_highest_forward_bits_and_split_backward(cuda, monkeypatch):
    """Under "highest", ``bdot`` on CUDA float32 tensors that need a gradient:
    the forward is the bits of ``a @ b``; the backward splits dL⁻¹ = dV·K_mnᵀ
    (within its float64 bound) and leaves dK_mn = L⁻ᵀ·dV to ``torch.matmul``
    (its bits)."""
    from zigp_tpu_torch.ops import linalg
    from zigp_tpu_torch.ops import split_k as sk

    calls = []
    split = sk.split_k_mm
    monkeypatch.setattr(sk, "split_k_mm", lambda a, b: calls.append(tuple(a.shape)) or split(a, b))
    g = torch.Generator(device=cuda).manual_seed(3)
    Li = torch.randn(2, 250, 250, generator=g, device=cuda).requires_grad_()
    Kmn = torch.randn(2, 250, 8192, generator=g, device=cuda).requires_grad_()
    dV = torch.randn(2, 250, 8192, generator=g, device=cuda)
    V = linalg.bdot(Li, Kmn)
    assert torch.equal(V, Li.detach() @ Kmn.detach())
    V.backward(dV)
    torch.cuda.synchronize()
    assert calls == [(2, 250, 8192)]
    exact = dV.double() @ Kmn.detach().double().mT
    bound = (8192 // sk.SPLITS + sk.SPLITS) * 2.0**-24 * (dV.double().abs() @ Kmn.detach().double().abs().mT)
    assert torch.all((Li.grad.double() - exact).abs() <= bound)
    assert torch.equal(Kmn.grad, Li.detach().mT @ dV)


def test_split_k_backward_in_a_graph_replay(cuda):
    """A step whose backward splits the grid's dL⁻¹ product, captured in a
    ``CountedGraph``: each replay gives the eager step's gradient bits."""
    from zigp_tpu_torch.ops import linalg
    from zigp_tpu_torch.ops.cuda.graphs import CountedGraph, on_side_stream

    g = torch.Generator(device=cuda).manual_seed(4)
    Li = torch.randn(2, 105, 105, generator=g, device=cuda).requires_grad_()
    Kmn = torch.randn(2, 105, 8192, generator=g, device=cuda)

    def step():
        Li.grad = None
        torch.sum(torch.square(linalg.bdot(Li, Kmn))).backward()
        return Li.grad

    on_side_stream(step)
    eager = step().clone()
    graph = CountedGraph()
    with graph.capture():
        out = step()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
