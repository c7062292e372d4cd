"""The exact float32 product of the batch-reducing shapes with k split
(``ops.split_k``) on the CPU:

- ``split_k_mm``'s ranges cover K once, in order, and it agrees with
  float64 within (K // S + S)·2⁻²⁴·Σ|a||b| in the path's layouts, the rest
  of k included;
- the route rule on the path's shapes: the grid step's six batch-reducing
  products are split (recorded from a real backward of the Kronecker
  conditional), the forward products, thin outputs and K = 1 are not;
- ``matmul``'s forward is the bits of ``a @ b`` and its backward agrees with
  autograd's; ``bdot`` under "highest" builds the Function only for float32
  card tensors that need a gradient and whose backward has a product to
  split (the card's test stands in for the card here), and under "high" and
  "mixed" never;
- the ``vmap`` rule folds the member dim into one product, equal to a loop
  over members; a ``make_fx`` step records the split product.
"""


import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from zigp_tpu_torch.ops import conditionals, linalg
from zigp_tpu_torch.ops import split_k as sk
from zigp_tpu_torch.ops.kernels import RBFValues

from .torch_helpers import one_torch_thread_per_module  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

U = 2.0**-24  # float32's unit roundoff


@pytest.fixture(autouse=True)
def _highest_after():
    yield
    linalg.set_solve_precision("highest")


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [2048, 2049, 2063, 4000, 8192, 8205])
def test_the_ranges_cover_k_once(K):
    """A row of ones against the (K, K) identity comes back as ones: each k
    in exactly one range or in the rest, whatever K modulo ``SPLITS``."""
    assert torch.equal(sk.split_k_mm(torch.ones(2, 1, K), torch.eye(K).expand(2, K, K)), torch.ones(2, 1, K))


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M, N, K, takes", [
    (250, 250, 8192, True), (105, 105, 8192, True), (105, 250, 8192, True),  # the grid's backward
    (200, 200, 4000, True), (32, 32, 4000, True), (32, 200, 4000, True),  # the champion's
    (250, 8192, 250, False), (105, 8192, 105, False), (8192, 250, 105, False),  # the forward products
    (8192, 105, 250, False),  # d(F0ᵀ) = dt·wᵀ: k = 250
    (200, 1, 8192, False), (1, 200, 8192, False),  # thin outputs: the dense conditional's df
    (1, 250, 1, False), (250, 1, 1, False), (1, 1, 250, False),  # K = 1 products and dots
    (10, 10, 1000, False), (10, 100, 1000, False),  # the flagship's factor-10 sides
    (1024, 1024, 8192, False),  # an output of many tiles
])
def test_the_route_rule_by_shape(M, N, K, takes):
    assert sk.batch_reducing(M, N, K) is takes


def _grid_step(B, monkeypatch):
    """The shapes ``matmul``'s backward splits in one backward of
    the grid's Kronecker conditional (105 × 250, G = 2, diagonal q,
    unwhitened) at batch B, with ``LONG_K`` at B and ``bdot`` taking
    ``matmul`` as it does on the card."""
    seen = []
    real = sk.split_k_mm
    monkeypatch.setattr(sk, "LONG_K", B)
    monkeypatch.setattr(linalg, "_on_card", lambda t: True)
    monkeypatch.setattr(sk, "split_k_mm", lambda a, b: seen.append(
        (int(np.prod(a.shape[:-2])), a.shape[-2], b.shape[-1], a.shape[-1])) or real(a, b))
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g)
    Zs = [r(2, 105, 2) * 4, r(2, 250, 1)]
    kerns = [RBFValues(torch.full((2, 2), 1.5), torch.full((2,), 2.0)), RBFValues(torch.full((2, 1), 0.1),
                                                                                  torch.full((2,), 2.0))]
    q_mu = (0.1 * torch.randn(2, 105 * 250, 1, generator=g)).requires_grad_()
    q_sqrt = (0.5 + r(2, 105 * 250, 1)).requires_grad_()
    X = torch.cat([r(B, 2) * 4, r(B, 1)], dim=1)
    Zs = [Z.requires_grad_() for Z in Zs]
    mu, var = conditionals.kron_conditional(X, kerns, Zs, q_mu, q_sqrt, [(0, 1), (2,)], jitter=1e-4)
    (mu.sum() + var.sum()).backward()
    assert all(t.grad is not None for t in (q_mu, q_sqrt, *Zs))
    return sorted(seen)


def test_the_grid_steps_six_products_engage(monkeypatch):
    """dL_p⁻¹ = dV·K_mn,pᵀ for the projection and the mean at 250 and 105, and
    the factored contraction's dw for the mean and for c2: six products, two
    of each shape; nothing else of the step."""
    B = 1024
    assert _grid_step(B, monkeypatch) == sorted([(2, 250, 250, B)] * 2 + [(2, 105, 105, B)] * 2
                                                + [(2, 105, 250, B)] * 2)


# ---------------------------------------------------------------------------
# the split product and the Function
# ---------------------------------------------------------------------------


def _pair(rng, G, M, K, N, layout):
    a = rng.randn(G, M, K).astype(np.float32)
    b = rng.randn(G, K, N).astype(np.float32)
    ta = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1))).mT if "aT" in layout else torch.from_numpy(a)
    tb = torch.from_numpy(np.ascontiguousarray(b.transpose(0, 2, 1))).mT if "bT" in layout else torch.from_numpy(b)
    return a, b, ta, tb


@pytest.mark.parametrize("G, M, K, N", [(2, 105, 8192, 250), (2, 250, 2100, 250), (1, 40, 4000, 33), (3, 7, 2063, 5)])
@pytest.mark.parametrize("layout", ["a b", "aT b", "a bT"])
def test_split_matches_float64(G, M, K, N, layout):
    a, b, ta, tb = _pair(np.random.RandomState(M + K + N), G, M, K, N, layout)
    S = sk.SPLITS
    got = sk.split_k_mm(ta, tb).double().numpy()
    exact = a.astype(np.float64) @ b.astype(np.float64)
    bound = (K // S + S) * U * (np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64)))
    assert np.all(np.abs(got - exact) <= bound)


@pytest.mark.parametrize("shapes", [((2, 40, 40), (2, 40, 2100)), ((2, 40, 2100), (2, 2100, 50)),
                                    ((3, 40, 40), (40, 2100)), ((2100, 40), (40, 64)), ((5, 2, 1, 40), (5, 2, 40, 3))])
def test_forward_bits_and_backward_agree_with_autograd(shapes):
    g = torch.Generator().manual_seed(1)
    a0, b0 = (torch.randn(*s, generator=g) for s in shapes)
    a, b = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    c = sk.matmul(a, b)
    assert torch.equal(c, a0 @ b0)
    gc = torch.randn(c.shape, generator=g)
    c.backward(gc)
    a1, b1 = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    (a1 @ b1).backward(gc)
    for got, want, x, y in ((a.grad, a1.grad, gc, b0.mT), (b.grad, b1.grad, a0.mT, gc)):
        exact = torch.matmul(x.double(), y.double())
        scale = torch.matmul(x.double().abs(), y.double().abs())
        K = x.shape[-1]
        assert got.shape == want.shape
        assert torch.all((got.double() - exact.sum_to_size(got.shape)).abs()
                         <= (K + 8) * U * scale.sum_to_size(got.shape) + 1e-30)


def test_bdot_builds_the_function_only_where_it_may(monkeypatch):
    """With the card's test standing in for the card: a float32 product that
    needs a gradient takes ``matmul`` (forward bits of ``a @ b``); a batch of
    dots, whose backward has no batch-reducing product, no gradient,
    float64, a CPU tensor, "high" and "mixed" take what they took before."""
    built = []
    real = sk.matmul
    monkeypatch.setattr(sk, "matmul", lambda a, b: built.append(a.shape) or real(a, b))
    g = torch.Generator().manual_seed(2)
    a, b = torch.randn(2, 40, 40, generator=g), torch.randn(2, 40, 2100, generator=g)
    assert torch.equal(linalg.bdot(a.requires_grad_(), b), a.detach() @ b) and built == []  # the CPU: untouched
    monkeypatch.setattr(linalg, "_on_card", lambda t: True)
    out = linalg.bdot(a, b)
    assert torch.equal(out, a.detach() @ b) and len(built) == 1 and "SplitKMatmul" in type(out.grad_fn).__name__
    dots = torch.randn(2, 2100, 1, 250, generator=g).requires_grad_(), torch.randn(2, 2100, 250, 1, generator=g)
    assert "SplitKMatmul" not in type(linalg.bdot(*dots).grad_fn).__name__ and len(built) == 1  # no product for it
    with torch.no_grad():
        assert torch.equal(linalg.bdot(a, b), a.detach() @ b)
    assert torch.equal(linalg.bdot(a.detach(), b), a.detach() @ b)
    linalg.bdot(a.double(), b.double())
    assert len(built) == 1
    for policy in ("high", "mixed"):
        linalg.set_solve_precision(policy)
        assert "SplitKMatmul" not in type(linalg.bdot(a, b).grad_fn).__name__
    assert len(built) == 1


def test_vmap_folds_the_members_into_one_product(monkeypatch):
    """The member stack's vmap: forward equal to a loop over members, and the
    backward's batch-reducing product one split product over every member."""
    calls = []
    split = sk.split_k_mm
    monkeypatch.setattr(sk, "split_k_mm", lambda a, b: calls.append(tuple(a.shape)) or split(a, b))
    g = torch.Generator().manual_seed(4)
    Ls = torch.randn(5, 2, 40, 40, generator=g).requires_grad_()
    Kmn = torch.randn(2, 40, 2100, generator=g)
    got = torch.func.vmap(sk.matmul, in_dims=(0, None))(Ls, Kmn)
    assert torch.equal(got, torch.stack([Ls[f].detach() @ Kmn for f in range(5)]))
    got.square().sum().backward()
    assert calls == [(5, 2, 40, 2100)]
    want = torch.stack([2 * (Ls[f].detach() @ Kmn) @ Kmn.mT for f in range(5)])
    torch.testing.assert_close(Ls.grad, want, rtol=1e-5, atol=1e-3)
    A = torch.randn(5, 40, 2100, generator=g)
    B3 = torch.randn(3, 2100, 50, generator=g)  # an unbatched operand of a higher rank broadcasts per member
    assert torch.equal(torch.func.vmap(sk.matmul, in_dims=(0, None))(A, B3), torch.stack([A[f] @ B3 for f in range(5)]))


@pytest.mark.parametrize("tracing_mode", ["fake", "real"])
def test_a_make_fx_step_records_the_split(tracing_mode):
    """The backward's batch-reducing product is traced as one product of the
    16 ranges, (2, 16, 40, 131)·(2, 16, 131, 40), and their sum."""

    def step(L, Kmn):
        L = L.detach().requires_grad_()
        return torch.autograd.grad(sk.matmul(L, Kmn).square().sum(), L)

    g = torch.Generator().manual_seed(5)
    L, Kmn = torch.randn(2, 40, 40, generator=g), torch.randn(2, 40, 2100, generator=g)
    traced = make_fx(step, tracing_mode=tracing_mode)(L, Kmn)
    shapes = [tuple(n.meta["val"].shape) for n in traced.graph.nodes
              if n.op == "call_function" and n.target in (torch.ops.aten.bmm.default, torch.ops.aten.sum.dim_IntList)]
    assert (32, 40, 40) in shapes and (2, 40, 40) in shapes  # the ranges' partials, then their sum
    if tracing_mode == "real":
        assert torch.equal(traced(L, Kmn)[0], step(L, Kmn)[0])
