"""The port's on-device self-check (``experiments/selfcheck.py``) against the
JAX package's, on the CPU.

- Its fixtures are the JAX package's: ``_spd_gram`` and ``_elbo_batch``
  equal to JAX's array for array, and ``_small_model``'s float64 ELBO (and
  the ``oracle_elbos`` the ELBO check gates against) within rtol 1e-10 of
  the JAX model's, built from the same numpy seeds;
- ``run_selfcheck(device="cpu")`` (the kernels' plain versions) passes
  every gate, returns the JAX package's result keys (with the inner keys of
  each) and counts no launch; a check that fails exits with
  ``SystemExit`` naming it, with nothing caught;
- ``step_launches``: what a loss evaluation launches on the card, from the
  model's shapes;
- ``--oracle-elbo`` prints the JAX package's two lines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.experiments import selfcheck as jsc
from zigp_tpu_torch.experiments import selfcheck as tsc
from zigp_tpu_torch.io.convert import load_jax_arrays

from .test_torch_train import _jraws
from .torch_helpers import one_torch_thread_per_module  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

# the JAX package's results (zigp_tpu/experiments/selfcheck.py, run_selfcheck)
JAX_KEYS = {
    "chol_inv_pallas[n=100]": {"err_L", "err_Linv", "xla_err_L", "xla_err_Linv"},
    "chol_inv_blocked[n=250]": {"err_L", "err_Linv", "xla_err_L", "xla_err_Linv"},
    "rbf_gram": {"err"},
    "elbo": {"device", "cpu_f32", "cpu_f64", "err_backend", "err_precision"},
    "scan_ab": {"pallas", "xla", "err"},
    "tp": {"err_mu", "err_var", "err_kl"},
}


@pytest.mark.parametrize("n", [100, 250])
def test_spd_gram_is_jax(n):
    np.testing.assert_array_equal(tsc._spd_gram(n), jsc._spd_gram(n))


@pytest.mark.parametrize("B, seed", [(128, 0), (256, 17), (128, 105)])
def test_elbo_batch_is_jax(B, seed):
    for a, b in zip(tsc._elbo_batch(B, seed), jsc._elbo_batch(B, seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [{}, {"seed": 7, "n_t": 100, "ls_t": 0.02}], ids=["elbo model", "scan model"])
def test_small_model_elbo_matches_jax(kw):
    jm = jsc._small_model(**kw)
    tm = tsc._small_model(**kw)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    load_jax_arrays(tm, _jraws(jm))  # the bijectors' inverses may part in the last bit: JAX's raws carried over
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), before[n].numpy(), rtol=1e-14, atol=0, err_msg=n)
    X, Y = jsc._elbo_batch()
    want = float(jax.jit(lambda m, x, y: m.elbo(x, y))(jm, jnp.asarray(X), jnp.asarray(Y)))
    with torch.no_grad():
        got = float(tm.elbo(torch.as_tensor(X), torch.as_tensor(Y)))
    np.testing.assert_allclose(got, want, rtol=1e-10)
    if not kw:
        np.testing.assert_allclose(tsc.oracle_elbos()[0], want, rtol=1e-10)


def test_oracle_elbo_prints_the_jax_lines(capsys):
    assert tsc.main(["--oracle-elbo"]) == 0
    out = capsys.readouterr().out.split("\n")
    assert out[0].startswith("ORACLE_ELBO_F64 ") and out[1].startswith("ORACLE_ELBO_F32 ")
    v64, v32 = (float(line.split()[1]) for line in out[:2])
    assert (v64, v32) == tsc.oracle_elbos()


def test_run_selfcheck_on_the_cpu_passes_with_the_jax_keys():
    lines = []
    res = tsc.run_selfcheck(lines.append, device="cpu")
    assert lines[-1] == "selfcheck: ALL PASS"
    assert sum(": rel err" in line and line.endswith("PASS") for line in lines) == 15
    assert not any("FAIL" in line for line in lines)
    assert set(res) == set(JAX_KEYS) | {"launches"}
    for key, inner in JAX_KEYS.items():
        assert inner <= set(res[key]), key
        assert res[key]["launches"] == dict.fromkeys(tsc.LAUNCH_KEYS, 0)
    assert res["launches"] == dict.fromkeys(tsc.LAUNCH_KEYS, 0)
    assert set(res["rbf_gram"]["bwd"]) == {"dX", "dZ", "dell", "dvar"}
    assert res["scan_ab"]["err"] == 0.0  # the same plain route both ways on the CPU


def test_a_failing_check_exits_naming_it(monkeypatch):
    from zigp_tpu_torch.ops.cuda import chol_inv as ci

    monkeypatch.setattr(ci, "chol_inv_plain", lambda K, nb=1: (2.0 * torch.linalg.cholesky(K), K))
    with pytest.raises(SystemExit, match=r"selfcheck FAILED: chol_inv_pallas\[n=100\] L rel err"):
        tsc.run_selfcheck(lambda s: None, device="cpu")


def test_step_launches_from_the_shapes():
    m = tsc._small_model(n_t=250, use_kernel=True)
    assert tsc.step_launches(m, training=True) == {"chol_inv": 1, "chol_inv_blocked": 1, "rbf_gram": 4,
                                                   "rbf_gram_bwd": 4}
    assert tsc.step_launches(tsc._small_model(), training=False) == {"chol_inv": 2, "chol_inv_blocked": 0,
                                                                     "rbf_gram": 0, "rbf_gram_bwd": 0}


# ---------------------------------------------------------------------------
# graft_entry: the counterpart of the repository root's __graft_entry__.py
# ---------------------------------------------------------------------------


def test_graft_entry_elbo_matches_jax():
    """``entry()``'s flagship ELBO at B = 1000, float64 on the CPU, within
    rtol 1e-10 of the JAX entry's (JAX's raws carried over: the bijectors'
    inverses may part in the last bit)."""
    import __graft_entry__ as jgraft
    from zigp_tpu_torch import graft_entry

    jfn, jargs = jgraft.entry()
    want = float(jax.jit(jfn)(*jargs))
    fn, (model, X, Y) = graft_entry.entry(device="cpu", dtype=torch.float64)
    load_jax_arrays(model, _jraws(jargs[0]))
    np.testing.assert_array_equal(X.numpy(), np.asarray(jargs[1]))
    np.testing.assert_allclose(float(fn(model, X, Y)), want, rtol=1e-10)


def test_graft_dryrun_on_two_gloo_ranks():
    """One data-parallel step and the tensor-parallel predict and KL on two
    spawned gloo ranks, each within 1e-10 of the one-rank path in float64."""
    from zigp_tpu_torch import graft_entry

    ranks = graft_entry.dryrun_multichip(2, device="cpu", log_fn=lambda s: None)
    assert len(ranks) == 2 and ranks[0] == ranks[1]
    assert set(ranks[0]) == {"dp_loss", "dp_rel", "tp_kl", "tp_kl_rel", "tp_mu_rel", "tp_var_rel"}
