"""Helpers the port's tests share: the rows the JAX package's device
sampler draws, and a fixture that makes the port's device samplers draw
them (the two generators differ by design, so a trajectory is compared with
JAX's on JAX's own rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def jax_rows(key_pair, count, N):
    """The rows JAX's device sampler draws for block key ``key_pair``."""
    key = jnp.asarray(np.array(key_pair, dtype=np.uint32))
    return np.asarray(jax.random.randint(key, (count,), 0, N))


def draw_jax_rows(generator, seed, N, count):
    """``training.scan._draw`` drawing JAX's rows for the block seed
    ``seed`` (the pair (sampler seed, block) as one integer)."""
    return torch.from_numpy(jax_rows([seed >> 32, seed & 0xFFFFFFFF], count, N).copy())


@pytest.fixture
def jax_rows_as_port(monkeypatch):
    """The port's device samplers (``StagedBlocks``, ``StackedBlocks``) draw
    JAX's rows for each block."""
    from zigp_tpu_torch.training import scan as tscan

    monkeypatch.setattr(tscan, "_draw", draw_jax_rows)
