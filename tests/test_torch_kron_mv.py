"""The port's two-factor Kronecker matvec against the Pallas ``kron_mv_2`` and
numpy, on the CPU.

``kron_mv_2_cuda`` runs ``kron_mv_2_plain`` on CPU tensors. Against the
Pallas kernel in interpret mode, in float32 at rtol 1e-4 (both round in
their own order; the Pallas test's tolerance). In float64 against
``np.kron(A, B) @ x`` at rtol 1e-12 with non-symmetric factors of different
sizes, so a transposed convention cannot pass. Then the serving path's
use: the unwhitened mean's (⊗K_p⁻¹) q_mu through two kron_mv_2 calls (the
route ``chip_smoke.py`` patches in on the card) equals the production
``kron_linv_solve`` in float64 at rtol 1e-10 on the flagship's 10 × 100
grid, and the model's prediction with it agrees as two float64 orders of
summation can.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.ops.pallas.kron_matvec import kron_mv_2
from zigp_tpu_torch.experiments import builders, configs
from zigp_tpu_torch.io.datasets import synthetic_pptr
from zigp_tpu_torch.models.kron import _stack
from zigp_tpu_torch.ops import linalg
from zigp_tpu_torch.ops.cuda import kron_matvec as km

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(G, Ma, Mb, dtype=np.float64, seed=0):
    rng = np.random.RandomState(seed)
    lead = () if G is None else (G,)
    return [rng.randn(*lead, *s).astype(dtype) for s in ((Ma, Ma), (Mb, Mb), (Ma * Mb,))]


@pytest.mark.parametrize("shape", ["1-D", "column"])
def test_matches_pallas_f32(shape):
    A, B, x = _inputs(None, 6, 9, np.float32)
    if shape == "column":
        x = x[:, None]
    got = km.kron_mv_2_cuda(*(torch.as_tensor(a) for a in (A, B, x)))
    want = np.asarray(kron_mv_2(jnp.asarray(A), jnp.asarray(B), jnp.asarray(x), interpret=True))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("form", ["1-D", "column", "batched", "batched column"])
def test_matches_numpy_kron_f64(form, transpose):
    G = 3 if form.startswith("batched") else None
    A, B, x = _inputs(G, 6, 9, seed=1)
    if form.endswith("column"):
        x = x[..., None]
    got = km.kron_mv_2_cuda(*(torch.as_tensor(a) for a in (A, B, x)), transpose=transpose).numpy()
    assert got.shape == x.shape
    op = (lambda a: a.T) if transpose else (lambda a: a)
    if G is None:
        want = np.kron(op(A), op(B)) @ x
    else:
        want = np.stack([np.kron(op(A[g]), op(B[g])) @ x[g] for g in range(G)])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_shape_checks():
    A, B, x = (torch.as_tensor(a) for a in _inputs(2, 4, 5))
    with pytest.raises(ValueError):
        km.kron_mv_2_plain(A, B, x[:, :-1])
    with pytest.raises(ValueError):
        km.kron_mv_2_plain(A, B[0], x)
    with pytest.raises(ValueError):
        km.kron_mv_2_plain(A[:1], B, x)


def _model(grid, hours):
    """The flagship configuration (diagonal q, unwhitened) on a small
    synthetic split, float64, with seeded noise on q_mu."""
    split = synthetic_pptr(12, hours, seed=0)
    cfg = configs.OnOffPptrConfig(grid=configs.KronGridConfig(*grid))
    model = builders.build_onoff_pptr(cfg, split, device="cpu", dtype=torch.float64)
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for gp in (model.f, model.g):
            gp.q_mu.raw.add_(0.5 * torch.as_tensor(rng.randn(*gp.q_mu.raw.shape)))
    return model, split


def test_flagship_kron_linv_solve_through_kron_mv_2_f64():
    model, _ = _model((10, 100), 100)
    with torch.no_grad():
        vals = _stack([model.f.values(), model.g.values()])
        _, Linvs = model.f._factor_state(vals)
        assert [Li.shape for Li in Linvs] == [(2, 10, 10), (2, 100, 100)]
        prod = linalg.kron_linv_solve(Linvs, vals.q_mu)
        route = _chip_smoke().kron_linv_solve_kron_mv(Linvs, vals.q_mu)
    assert route.shape == prod.shape == (2, 1000, 1)
    np.testing.assert_allclose(route.numpy(), prod.numpy(), rtol=1e-10, atol=1e-12 * prod.abs().max().item())


def test_predict_through_kron_mv_2_f64():
    """The whole prediction with the route patched in. The unwhitened mean
    sums terms cond(⊗K) larger than itself, so two float64 orders of
    summation agree only to that: on the 6 × 16 grid of
    ``tests/test_torch_predict.py`` (cond 2e9) the atol is its 2e-8 of each
    field's largest value (measured 6e-9)."""
    model, split = _model((6, 16), 40)
    cs = _chip_smoke()
    X = torch.as_tensor(split.Xtest[:64])
    solve = linalg.kron_linv_solve
    with torch.no_grad():
        want = model.predict(X)
        linalg.kron_linv_solve = cs.kron_linv_solve_kron_mv
        try:
            got = model.predict(X)
        finally:
            linalg.kron_linv_solve = solve
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=2e-8 * b.abs().max().item())
