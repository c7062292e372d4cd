"""The port's serving slice against the JAX package, end to end on the CPU.

A small pptr-shaped split (12 stations × 40 hours) goes through both
``build_onoff_pptr``s with the flagship options (diagonal q, unwhitened,
bound Owen's T) and the champion options (Kronecker-factored q, whitened,
exact Owen's T). The JAX model's raws, moved off their init by seeded noise,
are loaded into both models, and all nine ``OnOffPrediction`` fields are
compared in float64 at rtol 1e-9, plus an atol that is a fixed share of
the field's largest value. The two packages run the same formulas; only the
order of summation differs between XLA and torch, and the atol is what that
difference reaches at each option's conditioning:

- whitened (champion): 1e-9. It covers fields that are differences of O(1)
  terms (Var[Φ(g)] is E[Φ²] − E[Φ]²), where a 1e-16 rounding is 1e-9 of a
  small result.
- unwhitened (flagship): 2e-8. The mean is Kmnᵀ(⊗K_p⁻¹)q_mu, a sum whose
  terms are cond(⊗K) larger than the result: at the config's temporal
  lengthscale 0.005 over 16 knots in 40 hours cond(K_t) reaches 7e5 and
  cond(K_s ⊗ K_t) 2e9. The JAX package disagrees with itself by up to
  3.8e-9 of the largest value between its eager and jitted evaluation of
  the same model; the port's gap to the eager one is 4.6e-9
  (``test_flagship_gap_is_the_order_of_summation`` measures both).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.experiments import builders as jbuilders
from zigp_tpu.experiments import configs as jconfigs
from zigp_tpu.experiments.runners import predict_batched as jax_predict_batched
from zigp_tpu.io import datasets as jdatasets
from zigp_tpu_torch.experiments import builders as tbuilders
from zigp_tpu_torch.experiments import configs as tconfigs
from zigp_tpu_torch.experiments.runners import predict_batched
from zigp_tpu_torch.io import datasets as tdatasets
from zigp_tpu_torch.io.convert import dump_arrays, load_jax_arrays

from .torch_helpers import one_torch_thread_per_module  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

ATOL_SHARE = {"flagship": 2e-8, "champion": 1e-9}  # see the module docstring
FIELDS = ("gfmean", "gfvar", "gfmeanu", "fmean", "fvar", "gmean", "gvar", "pgmean", "pgvar")


def _split():
    s = tdatasets.synthetic_pptr(12, 40, seed=0)
    return s, jdatasets.Split(s.Xtrain, s.Ytrain, s.Xtest, s.Ytest)


def _configs(kind):
    if kind == "flagship":
        jc, tc = jconfigs.OnOffPptrConfig(), tconfigs.OnOffPptrConfig()
        grid = (6, 16)
    else:
        jc, tc = jconfigs.best_onoff_config(), tconfigs.best_onoff_config()
        grid = (5, 24)
    jc = dataclasses.replace(jc, grid=jconfigs.KronGridConfig(*grid))
    tc = dataclasses.replace(tc, grid=tconfigs.KronGridConfig(*grid))
    return jc, tc


def _perturbed_raws(jmodel, seed=1):
    """The JAX model's raws with seeded noise on the variational and kernel
    parameters, so the comparison is away from the init."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jmodel)
    rng = np.random.RandomState(seed)
    arrays = {}
    for path, leaf in leaves:
        key = jax.tree_util.keystr(path)
        a = np.array(leaf, dtype=np.float64)
        if ".q_mu" in key:
            a = a + 0.5 * rng.randn(*a.shape)
        elif ".q_sqrt" in key:  # q_sqrt and q_sqrt_factors
            a = a + 0.2 * rng.randn(*a.shape)
        elif ".kernels" in key:
            a = a + 0.1 * rng.randn(*a.shape)
        arrays[key] = a
    keys = [jax.tree_util.keystr(p) for p, _ in leaves]
    jnew = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(arrays[k]) for k in keys])
    return jnew, arrays


def _pair(kind):
    tsplit, jsplit = _split()
    jc, tc = _configs(kind)
    jmodel = jbuilders.build_onoff_pptr(jc, jsplit)
    tmodel = tbuilders.build_onoff_pptr(tc, tsplit, device="cpu", dtype=torch.float64)
    jmodel, arrays = _perturbed_raws(jmodel)
    load_jax_arrays(tmodel, arrays)
    return jmodel, tmodel, tsplit


@pytest.mark.parametrize("kind", ["flagship", "champion"])
def test_predict_matches_jax_f64(kind):
    jmodel, tmodel, split = _pair(kind)
    X = split.Xtest[:64]
    jp = jmodel.predict(jnp.asarray(X))
    with torch.no_grad():
        tp = tmodel.predict(torch.as_tensor(X))
    assert tp._fields == FIELDS
    for name in FIELDS:
        a = getattr(tp, name).numpy()
        b = np.asarray(getattr(jp, name))
        assert a.shape == b.shape == (64, 1), name
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=ATOL_SHARE[kind] * np.abs(b).max(), err_msg=name)


def _largest_gap(a, b):
    """Largest |a − b| over the nine fields, as a share of each field's max |b|."""
    return max(
        float(np.abs(np.asarray(x) - np.asarray(y)).max() / np.abs(np.asarray(y)).max())
        for x, y in zip(a, b)
    )


def test_flagship_gap_is_the_order_of_summation(capsys):
    """The flagship's atol is the reordering noise of its conditioning: the
    JAX package's jitted predict differs from its eager one by about as much
    as the port does (3.8e-9 and 4.6e-9 of the largest value when measured),
    and the factor grams' condition numbers say why."""
    jmodel, tmodel, split = _pair("flagship")
    X = split.Xtest[:64]
    eager = jmodel.predict(jnp.asarray(X))
    jitted = jax.jit(jmodel.predict)(jnp.asarray(X))
    with torch.no_grad():
        port = tmodel.predict(torch.as_tensor(X))
        conds = [f"{float(torch.linalg.cond(K)):.1e}" for gp in (tmodel.f, tmodel.g) for K in gp.gram_factors()]
    jax_gap = _largest_gap(jitted, eager)
    port_gap = _largest_gap([t.numpy() for t in port], eager)
    with capsys.disabled():
        print(f"\nflagship: cond of the f and g factor grams {conds}, JAX jit-vs-eager gap {jax_gap:.2e}, "
              f"port-vs-JAX-eager gap {port_gap:.2e} (shares of each field's largest value)")
    assert port_gap <= max(5.0 * jax_gap, ATOL_SHARE["flagship"])


@pytest.mark.parametrize("kind", ["flagship", "champion"])
def test_predict_pairs_f_and_g(kind):
    """The stacked f/g pass equals the two GPs run one by one."""
    _, tmodel, split = _pair(kind)
    X = torch.as_tensor(split.Xtest[:32])
    assert tmodel._pairable()
    with torch.no_grad():
        paired = tmodel.predict(X)
        tmodel.pair_gps = False
        single = tmodel.predict(X)
    for a, b, name in zip(paired, single, FIELDS):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14, err_msg=name)


@pytest.mark.parametrize("kind", ["flagship", "champion"])
def test_factor_state_matches_jax(kind):
    """The stacked f/g (L, L⁻¹) of the factor grams, f64 CPU (library route)."""
    jmodel, tmodel, _ = _pair(kind)
    jLs, jLinvs = jmodel.factor_state()
    with torch.no_grad():
        tLs, tLinvs = tmodel.factor_state()
    for a, b in zip(list(tLs) + list(tLinvs), list(jLs) + list(jLinvs)):
        b = np.asarray(b)
        assert a.shape == b.shape and a.shape[0] == 2
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-9 * np.abs(b).max())


def test_three_factor_build_matches_jax():
    """lat ⊗ lon ⊗ time grid: same raws, and the same predictions."""
    tsplit, jsplit = _split()
    jc = dataclasses.replace(jconfigs.OnOffPptrConfig(), grid=jconfigs.KronGridConfig(spatial_factors=(3, 4), num_temporal=8))
    tc = dataclasses.replace(tconfigs.OnOffPptrConfig(), grid=tconfigs.KronGridConfig(spatial_factors=(3, 4), num_temporal=8))
    jmodel = jbuilders.build_onoff_pptr(jc, jsplit)
    tmodel = tbuilders.build_onoff_pptr(tc, tsplit, device="cpu", dtype=torch.float64)
    jraw = {jax.tree_util.keystr(p): np.asarray(l) for p, l in jax.tree_util.tree_flatten_with_path(jmodel)[0]}
    traw = dump_arrays(tmodel)
    assert traw.keys() == jraw.keys()
    for k in jraw:
        np.testing.assert_allclose(traw[k], jraw[k], rtol=1e-12, atol=1e-12, err_msg=k)
    X = tsplit.Xtest[:16]
    with torch.no_grad():
        tp = tmodel.predict(torch.as_tensor(X))
    jp = jmodel.predict(jnp.asarray(X))
    for name in FIELDS:
        b = np.asarray(getattr(jp, name))
        np.testing.assert_allclose(
            getattr(tp, name).numpy(), b, rtol=1e-9, atol=ATOL_SHARE["flagship"] * np.abs(b).max(), err_msg=name
        )


@pytest.mark.parametrize("seed", [0, 3])
def test_kron_inducing_init_matches_jax(seed):
    s = tdatasets.synthetic_pptr(12, 40, seed=seed)
    for kw in ({}, {"spatial_factors": (3, 4)}):
        a = tdatasets.kron_inducing_init(s.Xtrain, 6, 16, seed=seed, **kw)
        b = jdatasets.kron_inducing_init(s.Xtrain, 6, 16, seed=seed, **kw)
        assert len(a) == len(b)
        for za, zb in zip(a, b):
            np.testing.assert_array_equal(za, zb)


def test_synthetic_pptr_shape():
    s = tdatasets.synthetic_pptr(12, 40, seed=0)
    X = np.concatenate([s.Xtrain, s.Xtest])
    Y = np.concatenate([s.Ytrain, s.Ytest])
    assert X.shape == (480, 3) and Y.shape == (480, 1)
    assert len(np.unique(X[:, :2], axis=0)) == 12
    assert X[:, 0].min() >= 59.8 and X[:, 0].max() <= 70.1
    assert X[:, 1].min() >= 20.0 and X[:, 1].max() <= 31.0
    np.testing.assert_allclose(np.unique(X[:, 2]), (4368 + np.arange(40)) / 1000.0)
    assert 0.8 < np.mean(Y == 0) < 0.97
    assert (Y >= 0).all()


def test_predict_batched_ragged_equals_one_call():
    _, tmodel, split = _pair("flagship")
    X = split.Xtest[:70]
    out = predict_batched(tmodel.predict, X, batch=32, device="cpu", dtype=torch.float64)
    with torch.no_grad():
        ref = tmodel.predict(torch.as_tensor(X))
    assert list(out) == list(FIELDS)
    for name in FIELDS:
        assert out[name].shape == (70, 1)
        np.testing.assert_allclose(out[name], getattr(ref, name).numpy(), rtol=1e-12, atol=1e-14)


def test_predict_batched_matches_jax_predict_batched():
    jmodel, tmodel, split = _pair("champion")
    X = split.Xtest[:50]
    a = predict_batched(tmodel.predict, X, batch=16, device="cpu", dtype=torch.float64)
    b = jax_predict_batched(jmodel.predict, X, batch=16)
    for name in FIELDS:
        np.testing.assert_allclose(a[name], b[name], rtol=1e-9, atol=1e-9 * np.abs(b[name]).max(), err_msg=name)


def test_dump_load_round_trip_and_errors():
    _, tmodel, _ = _pair("champion")
    arrays = dump_arrays(tmodel)
    assert ".f.kernels[0].lengthscales.raw" in arrays
    assert ".g.q_sqrt_factors[1].raw" in arrays
    other = tbuilders.build_onoff_pptr(*_build_args("champion"), device="cpu", dtype=torch.float64)
    load_jax_arrays(other, arrays)
    back = dump_arrays(other)
    assert back.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])

    missing = dict(arrays)
    del missing[".likelihood.variance.raw"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_arrays(other, missing)
    with pytest.raises(KeyError, match="unknown"):
        load_jax_arrays(other, {**arrays, ".f.extra.raw": np.zeros(1)})
    bad = {**arrays, ".f.q_mu.raw": np.zeros((3, 1))}
    with pytest.raises(ValueError, match="shape"):
        load_jax_arrays(other, bad)


def _build_args(kind):
    tsplit, _ = _split()
    _, tc = _configs(kind)
    return tc, tsplit


def test_jax_keys_match_port_names():
    """Every JAX pytree path has a port parameter and no more, both configs."""
    for kind in ("flagship", "champion"):
        jmodel, tmodel, _ = _pair(kind)
        jkeys = {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jmodel)[0]}
        assert set(dump_arrays(tmodel)) == jkeys


def test_build_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the check is for machines without one")
    tc, split = _build_args("flagship")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbuilders.build_onoff_pptr(tc, split)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_batched(lambda x: {"y": x}, split.Xtest[:4], batch=4)


def test_trust_bound_matches_jax():
    init_j = jconfigs.KernelInit((0.5, 2.0), 3.0, trust=4.0)
    init_t = tconfigs.KernelInit((0.5, 2.0), 3.0, trust=4.0)
    kj = jbuilders.make_kernel(init_j)
    kt = tbuilders.make_kernel(init_t)
    np.testing.assert_allclose(kt.lengthscales.raw.detach().numpy(), np.asarray(kj.lengthscales.raw), rtol=1e-12)
    np.testing.assert_allclose(kt.lengthscales.value.detach().numpy(), np.asarray(kj.lengthscales.value), rtol=1e-12)
