"""The solve-product precision policy (``ops.linalg.set_solve_precision``)
and its 3-pass bf16 product (``ops.cuda.bf16x3``) against the JAX package,
on the CPU, where the product is ``bf16x3_mm_plain``:

- ``bf16x3_mm_plain`` against a numpy oracle of the split (``ml_dtypes``'
  bfloat16, round to nearest even as ``torch``'s): hi·hi + (hi·lo + lo·hi)
  of the bf16 parts in float64 agrees with the float32 sums to within
  K·2⁻²⁴·Σ|a||b| (each of the K products exact in float32, the sums
  rounded), at ragged shapes, both transposes, a batch, and NaN carried;
- the Function's backward is the same 3-pass product, dC·op(B)ᵀ and
  op(A)ᵀ·dC (JAX's ``dot_general`` transpose rule keeps the precision), and
  its ``vmap`` rule folds the member dim into one call equal to a loop;
- the routing: under each policy, the contractions the port sends to the
  3-pass product during one flagship and one champion ELBO and backward in
  float32 are, by (contracted size, output size) with their counts, those
  that ``jax.make_jaxpr`` of the JAX package's same ELBO gradient marks
  ``Precision.HIGH``: all of them under "high", the bulk class alone under
  "mixed" (no factor-space product), none under "highest";
- float64 is untouched: the ELBO and its gradients under "high" and "mixed"
  equal the JAX package's at the training slice's rtol 1e-8; the float32
  ELBO of the flagship's family under "high" errs against float64 by at
  most 3 × what it errs under "highest" (or 1e-5 of it);
- a traced step keeps the policy it was traced under after a switch, and a
  step traced after the switch takes the new one (``make_fx``, the CPU's
  analog of a captured CUDA graph; the card's own graph is in
  ``tests/test_torch_cuda.py``).
"""

import copy
import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from zigp_tpu.experiments import builders as jbuilders
from zigp_tpu.experiments import configs as jconfigs
from zigp_tpu.ops import linalg as jlinalg
from zigp_tpu_torch.experiments import builders as tbuilders
from zigp_tpu_torch.experiments import configs as tconfigs
from zigp_tpu_torch.io.convert import jax_key, load_jax_arrays
from zigp_tpu_torch.ops import linalg
from zigp_tpu_torch.ops.cuda import bf16x3

from .test_torch_runners import _jsplit, _tiny_split
from .test_torch_train import _jraws, _pair_models
from .test_golden import _kron_fixture
from .torch_helpers import one_torch_thread_per_module  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

POLICIES = ("highest", "high", "mixed")


@pytest.fixture(autouse=True)
def _highest_after():
    yield
    linalg.set_solve_precision("highest")
    jlinalg.set_solve_precision("highest")


# ---------------------------------------------------------------------------
# the product
# ---------------------------------------------------------------------------


def _oracle(a: np.ndarray, b: np.ndarray):
    """(hi·hi + hi·lo + lo·hi in float64, K·2⁻²⁴·Σ|a||b|) of float32 a, b."""
    def split(x):
        hi = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        return hi.astype(np.float64), (x - hi).astype(ml_dtypes.bfloat16).astype(np.float64)

    (ah, al), (bh, bl) = split(a), split(b)
    bound = a.shape[-1] * 2.0**-24 * (np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64)))
    return ah @ bh + (ah @ bl + al @ bh), bound


def _operands(rng, G, M, K, N, ta, tb):
    """float32 a (G, M, K) and b (G, K, N), as transposed views when asked."""
    a = rng.randn(G, K, M).astype(np.float32).transpose(0, 2, 1) if ta else rng.randn(G, M, K).astype(np.float32)
    b = rng.randn(G, N, K).astype(np.float32).transpose(0, 2, 1) if tb else rng.randn(G, K, N).astype(np.float32)
    ta_, tb_ = (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).transpose(-1, -2) if t
                else torch.from_numpy(np.ascontiguousarray(x)) for x, t in ((a, ta), (b, tb)))
    return a, b, ta_, tb_


@pytest.mark.parametrize("G, M, K, N", [(1, 10, 10, 16), (2, 105, 105, 33), (2, 250, 250, 17), (3, 16, 48, 64),
                                        (4, 1, 37, 1)])
@pytest.mark.parametrize("ta, tb", [(False, False), (True, False), (False, True), (True, True)])
def test_plain_matches_the_split_oracle(G, M, K, N, ta, tb):
    rng = np.random.RandomState(M * 7 + K + N)
    a, b, at, bt = _operands(rng, G, M, K, N, ta, tb)
    got = bf16x3.bf16x3_mm_plain(at, bt).double().numpy()
    want, bound = _oracle(a, b)
    assert np.all(np.abs(got - want) <= bound)
    # the dropped lo·lo term: the 3-pass product is not the exact one
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(got - exact).max() > np.abs(got - want).max()


@pytest.mark.parametrize("G, M, N, K", [(2, 250, 8192, 250), (2, 250, 250, 8192), (2, 105, 105, 8192),
                                        (2, 10, 10, 1000), (16384, 1, 250, 1), (16384, 250, 1, 1),
                                        (16384, 1, 1, 250), (2, 6, 6, 96), (10, 100, 100, 1000), (3, 64, 64, 257)])
def test_plan_covers_k_once(G, M, N, K):
    """The kernel's plan: the instance by shape; the tiles' S k ranges of ks
    (a multiple of 32; S ≤ 8, the CTAs of one cluster) cover k with none
    empty, and are cut by K alone, so the batch G does not change them."""
    p = bf16x3.plan(G, M, N, K)
    if M == N == 1:
        assert p.instance == "dots"
    elif K <= 16 and min(M, N) < 16:
        assert p.instance == "short_k"
    else:
        assert p.instance == "tiles" and p.ks % bf16x3.CHUNK == 0 and p.splits * p.ks >= K
        assert 1 <= p.splits <= bf16x3.MAX_CLUSTER and p.grid[0] == p.splits
        assert (p.splits - 1) * p.ks < K or p.splits == 1
        assert p.splits == max(1, min(bf16x3.MAX_CLUSTER, K // bf16x3.RANGE_MIN_K))
        one = bf16x3.plan(1, M, N, K)
        assert (p.splits, p.ks) == (one.splits, one.ks)


def test_nan_in_gives_nan_out():
    a = torch.randn(2, 10, 7)
    b = torch.randn(2, 7, 5)
    a[1, 3, 2] = float("nan")
    c = bf16x3.bf16x3_mm_cuda(a, b)  # a CPU tensor: the plain version
    assert torch.isnan(c[1, 3]).all() and torch.isfinite(c[0]).all()
    assert torch.isfinite(c[1, :3]).all() and torch.isfinite(c[1, 4:]).all()


def test_backward_is_the_three_pass_product():
    rng = np.random.RandomState(3)
    a = torch.tensor(rng.randn(2, 9, 13), dtype=torch.float32, requires_grad=True)
    b = torch.tensor(rng.randn(13, 6), dtype=torch.float32, requires_grad=True)  # broadcast over the batch
    gc = torch.tensor(rng.randn(2, 9, 6), dtype=torch.float32)
    bf16x3.bf16x3_mm(a, b).backward(gc)
    with torch.no_grad():
        want_a = bf16x3.bf16x3_mm_plain(gc, b.t().expand(2, 6, 13))
        want_b = bf16x3.bf16x3_mm_plain(a.transpose(-1, -2), gc).sum(0)
    torch.testing.assert_close(a.grad, want_a, rtol=0, atol=0)
    torch.testing.assert_close(b.grad, want_b, rtol=0, atol=0)
    assert not torch.equal(a.grad, gc @ b.detach().t())  # not the exact product


def test_vmap_folds_the_members_into_one_call(monkeypatch):
    rng = np.random.RandomState(4)
    A = torch.tensor(rng.randn(5, 2, 8, 11), dtype=torch.float32)
    B = torch.tensor(rng.randn(2, 11, 7), dtype=torch.float32)
    calls = []
    plain = bf16x3.bf16x3_mm_plain
    monkeypatch.setattr(bf16x3, "bf16x3_mm_plain", lambda a, b: calls.append(a.shape) or plain(a, b))
    got = torch.func.vmap(bf16x3.bf16x3_mm, in_dims=(0, None))(A, B)
    assert calls == [(5, 2, 8, 11)]
    want = torch.stack([bf16x3.bf16x3_mm(A[f], B) for f in range(5)])
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the routing against JAX's Precision.HIGH contractions
# ---------------------------------------------------------------------------


def _cfg(pkg, name):
    base = pkg.OnOffPptrConfig() if name == "flagship" else pkg.best_onoff_config()
    return dataclasses.replace(base, grid=pkg.KronGridConfig(num_spatial=3, num_temporal=5), batch_size=16)


@pytest.fixture(scope="module")
def pair():
    """{config: (JAX model, port float32 model, port float64 model, X, Y)}
    from the same inits (the builders' own, equal at 1e-14)."""
    split = _tiny_split()
    out = {}
    for name in ("flagship", "champion"):
        jm = jbuilders.build_onoff_pptr(_cfg(jconfigs, name), _jsplit(split))
        t64 = tbuilders.build_onoff_pptr(_cfg(tconfigs, name), split, device="cpu", dtype=torch.float64)
        t32 = tbuilders.build_onoff_pptr(_cfg(tconfigs, name), split, device="cpu", dtype=torch.float32)
        load_jax_arrays(t64, _jraws(jm))
        load_jax_arrays(t32, _jraws(jm))
        out[name] = jm, t32, t64, split.Xtrain[:16], split.Ytrain[:16]
    return out


def _jax_high(jaxpr, out: Counter) -> Counter:
    """(contracted size, output size) of every dot_general marked
    Precision.HIGH in ``jaxpr`` and the jaxprs inside it."""
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            prec = e.params["precision"]
            if jax.lax.Precision.HIGH in (prec if isinstance(prec, tuple) else (prec,)):
                (contract, _), _ = e.params["dimension_numbers"]
                K = int(np.prod([e.invars[0].aval.shape[i] for i in contract]))
                out[(K, int(np.prod(e.outvars[0].aval.shape)))] += 1
        for v in e.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if hasattr(sub, "eqns"):
                    _jax_high(sub, out)
                elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    _jax_high(sub.jaxpr, out)
    return out


def _port_three_pass(fn) -> Counter:
    """(contracted size, output size) of every product the port sends to the
    3-pass product while ``fn`` runs, forward and backward."""
    seen = Counter()
    product = bf16x3.bf16x3_mm_cuda

    def recorded(a, b):
        seen[(a.shape[-1], int(np.prod(a.shape[:-1])) * b.shape[-1])] += 1
        return product(a, b)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bf16x3, "bf16x3_mm_cuda", recorded)  # the op looks it up at call time
        fn()
    return seen


@pytest.mark.parametrize("name", ["flagship", "champion"])
def test_routing_matches_jax_high_contractions(pair, name):
    jm, t32, _, X, Y = pair[name]
    Xt, Yt = (torch.as_tensor(a, dtype=torch.float32) for a in (X, Y))
    seen = {}
    for policy in POLICIES:
        jlinalg.set_solve_precision(policy)
        linalg.set_solve_precision(policy)
        want = _jax_high(jax.make_jaxpr(jax.grad(lambda m: m.elbo(jnp.asarray(X), jnp.asarray(Y))))(jm).jaxpr,
                         Counter())
        t32.zero_grad()
        got = _port_three_pass(lambda: t32.elbo(Xt, Yt).backward())
        assert got == want, (policy, sorted(got.items()), sorted(want.items()))
        seen[policy] = got
    assert not seen["highest"] and seen["mixed"]
    factor_space = set(seen["high"]) - set(seen["mixed"])
    assert factor_space  # the chol_inv VJP and the Kronecker solves: exact under "mixed"
    assert not factor_space & set(seen["mixed"])


# ---------------------------------------------------------------------------
# float64 parity and the float32 ELBO
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["high", "mixed"])
def test_float64_is_untouched_by_the_policy(pair, policy):
    jm, _, t64, X, Y = pair["flagship"]
    jlinalg.set_solve_precision(policy)
    linalg.set_solve_precision(policy)
    # a fresh function: JAX reads the policy when it traces
    want_elbo, jg = jax.jit(jax.value_and_grad(lambda m: m.elbo(jnp.asarray(X), jnp.asarray(Y))))(jm)
    jg = _jraws(jg)
    t64.zero_grad()
    seen = _port_three_pass(lambda: t64.elbo(torch.as_tensor(X), torch.as_tensor(Y)).backward())
    assert not seen  # a float64 product is a plain matmul under every policy
    with torch.no_grad():
        got = float(t64.elbo(torch.as_tensor(X), torch.as_tensor(Y)))
    np.testing.assert_allclose(got, float(want_elbo), rtol=1e-8)
    checked = 0
    for name, p in t64.named_parameters():
        if p.requires_grad:
            want = jg[jax_key(name)]
            scale = np.abs(want).max()
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-8, atol=1e-11 * scale, err_msg=name)
            checked += 1
    assert checked > 10


def test_float32_flagship_elbo_under_high_against_float64():
    """The flagship's family (the unwhitened diagonal Kronecker on/off model)
    at the golden fixture, off its init. The 3-pass product errs by about
    2⁻¹⁶ of Σ|a||b| a contraction against exact float32 (the dropped lo·lo
    term); what the float32 ELBO already loses to float64 in the
    factorization of these grams (jitter 1e-5, 4e-4 of the ELBO here) is far
    more. So the gate is the repository's form: the error under "high"
    within max(3 × the "highest" float32 error, 1e-5 of the ELBO)."""
    Zs, X, Y, _, _ = _kron_fixture()
    _, t64 = _pair_models(perturb=True)
    t32 = copy.deepcopy(t64).float()
    X32, Y32 = torch.as_tensor(X, dtype=torch.float32), torch.as_tensor(Y, dtype=torch.float32)
    with torch.no_grad():
        want = float(t64.elbo(torch.as_tensor(X), torch.as_tensor(Y)))
        highest = float(t32.elbo(X32, Y32))
        linalg.set_solve_precision("high")
        high = float(t32.elbo(X32, Y32))
    assert high != highest
    assert abs(high - want) <= max(3 * abs(highest - want), 1e-5 * abs(want))


# ---------------------------------------------------------------------------
# when the policy is read
# ---------------------------------------------------------------------------


def test_a_traced_step_keeps_its_policy():
    """A step of both classes: the gradient of ‖L⁻¹ Kmn‖² + tr(L⁻¹ C) in K
    (``chol_inv``'s VJP and the trace are hdot-class, the projection
    bdot-class)."""
    rng = np.random.RandomState(5)
    A = rng.randn(2, 6, 6)
    K = torch.tensor(A @ A.transpose(0, 2, 1) + 6 * np.eye(6), dtype=torch.float32)
    Kmn = torch.tensor(rng.randn(2, 6, 16), dtype=torch.float32)
    C = torch.tensor(np.tril(rng.randn(2, 6, 6)), dtype=torch.float32)

    def step(K, Kmn, C):
        K = K.detach().requires_grad_()
        Linv = linalg.chol_inv(K)[1]
        loss = torch.sum(linalg.bdot(Linv, Kmn) ** 2) + torch.sum(linalg.hdot(Linv, C))
        return torch.autograd.grad(loss, K)

    def traced_under(policy):
        linalg.set_solve_precision(policy)
        return make_fx(step)(K, Kmn, C)

    def calls(fn):
        return sum(_port_three_pass(fn).values())

    high = traced_under("high")
    highest = traced_under("highest")  # traced after the switch: the new policy
    n_high = calls(lambda: high(K, Kmn, C))
    assert n_high > 0 and calls(lambda: highest(K, Kmn, C)) == 0 and calls(lambda: step(K, Kmn, C)) == 0
    linalg.set_solve_precision("mixed")
    assert calls(lambda: high(K, Kmn, C)) == n_high  # still "high"
    assert calls(lambda: highest(K, Kmn, C)) == 0  # still "highest"
    assert 0 < calls(lambda: step(K, Kmn, C)) < n_high  # eager code: "mixed" now
    assert torch.equal(high(K, Kmn, C)[0], step.__call__(K, Kmn, C)[0]) is False
