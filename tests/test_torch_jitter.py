"""The default jitter of ``KronGP.create(jitter=None)`` against the JAX package's.

The JAX package takes ``default_jitter()`` of the precision it runs in
(``zigp_tpu/core/config.py``: 1e-6 in float64, max(1e-6, 1e-5) in float32);
the port resolves the default by the dtype of the grams it adds it to. The
grams are compared bit for bit with ``add_jitter`` of the JAX default: the
same torch operations on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.core.config import default_jitter as jax_default_jitter
from zigp_tpu_torch.models import KronGP, KronOnOffSVGP
from zigp_tpu_torch.likelihoods import OnOffGaussian
from zigp_tpu_torch.ops import linalg
from zigp_tpu_torch.ops.kernels import RBF

DTYPES = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _gp(jitter):
    rng = np.random.RandomState(0)
    Zs = [rng.randn(5, 2), np.linspace(0.0, 1.0, 7)[:, None]]
    kernels = [RBF.create([1.0, 1.5], 2.0), RBF.create([0.3], 1.5)]
    return KronGP.create(kernels, Zs, jitter=jitter)


def _raw_grams(gp):
    return [k.K(Z.value) for k, Z in zip(gp.kernels, gp.Zs)]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_default_jitter_follows_the_dtype(dtype):
    gp = _gp(None).to(dtype=dtype)
    expected = jax_default_jitter(DTYPES[dtype])
    assert gp.jitter_for(dtype) == expected
    for K, raw in zip(gp.gram_factors(), _raw_grams(gp)):
        assert K.dtype == dtype
        assert torch.equal(K, linalg.add_jitter(raw, expected))
    if dtype == torch.float32:  # the float32 default is the JAX package's floor, not the float64 value
        assert expected == 1e-5 and expected != jax_default_jitter(jnp.float64)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_explicit_jitter_is_unchanged(dtype):
    gp = _gp(3e-4).to(dtype=dtype)
    assert gp.jitter == 3e-4 and gp.jitter_for(dtype) == 3e-4
    for K, raw in zip(gp.gram_factors(), _raw_grams(gp)):
        assert torch.equal(K, linalg.add_jitter(raw, 3e-4))


def test_default_jitter_keeps_the_pair_stackable():
    """f and g created with the default jitter have one signature, so they
    still run as one stacked pass."""
    rng = np.random.RandomState(1)
    Zs = [rng.randn(4, 2), np.linspace(0.0, 1.0, 6)[:, None]]
    kernels = [RBF.create([1.0, 1.0], 1.0), RBF.create([0.5], 1.0)]
    model = KronOnOffSVGP.create(kernels, Zs, kernels, Zs, OnOffGaussian.create(), num_data=10)
    assert model.f.jitter is None and model._pairable()
