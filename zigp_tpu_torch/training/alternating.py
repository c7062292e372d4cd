"""Block-coordinate (alternating) training: the factorization-free q-step.

Counterpart of ``zigp_tpu/training/alternating.py:43-253``. The two
partitions of the model train block-coordinate-wise: once every
``hyper_every`` steps a hyper step updates the kernel, inducing and
likelihood raws (the full gradient at the current q; it factorizes), then
the factor state (``chol_inv`` of every Kronecker factor gram) is computed
once, out of autograd, and the ``hyper_every − 1`` q-only steps between take
it: no factorization and no hyperparameter cotangent in their forward or
backward. Each partition's update is the exact gradient of the same ELBO at
the other's current value; only the update schedule differs from joint
training.

Each partition has its own per-lr-group Adam (``make_optimizer`` over its
raws) and its own schedule, held together by ``AdamPair``, which the
checkpoints save and restore in place. A step takes the gradients of its own
partition alone (``loss.backward(inputs=...)``), so a q-only step never runs
the backward through the grams into a kernel raw.

``make_batched_alternating_step`` runs the same groups on a member stack
(``training.batched``): every member's loss under ``torch.func.vmap``, the
factor state of all members computed at once (one ``chol_inv`` launch per
factor for the whole stack), one ``AdamPair`` over the stacked raws, whose
update is elementwise and so each member's own.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch
from torch import nn

from ..io.convert import jax_key
from .optim import GroupedAdam, make_optimizer

# Fragments of the JAX parameter paths that form the variational (q)
# partition; everything else (kernel hyperparameters, inducing locations,
# likelihood parameters) is the hyper partition.
_Q_KEYS = (
    ".q_mu",
    ".q_sqrt",
    ".q_sqrt_factors",
    ".mean_const",
    ".u_fm",
    ".u_gm",
    ".u_fs_sqrt",
    ".u_gs_sqrt",
)

Named = List[Tuple[str, nn.Parameter]]


def partition_model(model: nn.Module) -> Tuple[Named, Named]:
    """(q, h): the model's raws as (name, raw) pairs, in the model's order,
    split by the JAX path of each (``io.convert.jax_key``) as the JAX
    package splits its Parameter leaves, so both packages put the same
    names in the same order. Frozen raws are listed too, as JAX lists its
    frozen leaves."""
    q, h = [], []
    for name, raw in model.named_parameters():
        (q if any(k in jax_key(name) for k in _Q_KEYS) else h).append((name, raw))
    if not q:
        raise ValueError(f"alternating training found no variational parameters to partition (looked for {_Q_KEYS})")
    return q, h


class AdamPair:
    """The two optimizers of the schedule, ``h`` (the hyper partition) and
    ``q``, each a ``GroupedAdam`` with its own step count and schedule. Its
    state is the pair's ({"h": ..., "q": ...}), for a checkpoint; a restore
    writes into both in place."""

    def __init__(self, h: GroupedAdam, q: GroupedAdam):
        self.h, self.q = h, q

    def state_tensors(self) -> dict:
        return {"h": self.h.state_tensors(), "q": self.q.state_tensors()}

    def load_state(self, state: dict) -> None:
        """Copy ``state`` into both optimizers in place; every name and
        shape of both is checked before anything is written."""
        if set(state) != {"h", "q"}:
            raise KeyError(f"load_state: expected the pair's keys ['h', 'q'], got {sorted(state)}")
        self.h.check_state(state["h"])
        self.q.check_state(state["q"])
        self.h.load_state(state["h"])
        self.q.load_state(state["q"])


def init_alt_optimizers(model: nn.Module, *, learning_rate: float = 1e-3, opt_factories=None) -> AdamPair:
    """The pair of per-partition optimizers, each ``make_optimizer`` over its
    partition at ``learning_rate``. ``opt_factories``: the (q, h) schedules
    (``cosine_adam``), sized to each partition's own update count (q:
    num_iter·(K−1)/K, h: num_iter/K); None for constant rates."""
    q, h = partition_model(model)
    q_sched, h_sched = opt_factories if opt_factories else (None, None)
    return AdamPair(
        h=make_optimizer(model, default_lr=learning_rate, schedule=h_sched, names=[n for n, _ in h]),
        q=make_optimizer(model, default_lr=learning_rate, schedule=q_sched, names=[n for n, _ in q]),
    )


def _check_schedule(model: nn.Module, hyper_every: int) -> None:
    if hyper_every < 2:
        raise ValueError(f"hyper_every must be >= 2 (got {hyper_every})")
    if not (hasattr(model, "factor_state") and hasattr(model, "loss")):
        raise ValueError(
            "alternating training needs a model with factor_state()/loss(factor_state=...) — the Kronecker families")


def _group_block(model: nn.Module, opt: AdamPair, hyper_every: int, loss: Callable, factor_state: Callable):
    """The block of the schedule over ``loss(X, Y, factor_state=None)`` (a
    scalar, or one loss per member of a stack, whose sum is differentiated)
    and ``factor_state()``; the losses (K,) or (K, F) stay on the device."""
    q, h = partition_model(model)
    q_in = [raw for _, raw in q if raw.requires_grad]
    h_in = [raw for _, raw in h if raw.requires_grad]

    def block(Xs: torch.Tensor, Ys: torch.Tensor) -> torch.Tensor:
        K = Xs.shape[0]
        if K % hyper_every:
            raise ValueError(f"num_inner ({K}) must divide by hyper_every ({hyper_every})")
        losses = []
        for g0 in range(0, K, hyper_every):
            opt.h.zero_grad()
            value = loss(Xs[g0], Ys[g0])
            (value.sum() if value.ndim else value).backward(inputs=h_in)
            opt.h.step()
            losses.append(value.detach())
            with torch.no_grad():  # factorize once, at the new hypers
                state = factor_state()
            for k in range(g0 + 1, g0 + hyper_every):
                opt.q.zero_grad()
                value = loss(Xs[k], Ys[k], factor_state=state)
                (value.sum() if value.ndim else value).backward(inputs=q_in)
                opt.q.step()
                losses.append(value.detach())
        return torch.stack(losses)

    return block


def make_alternating_block(model: nn.Module, opt: AdamPair, hyper_every: int) -> Callable:
    """A block step ``(Xs, Ys) -> losses`` of the schedule, the counterpart
    of ``_alternating_dispatch``: Xs (K, B, D), Ys (K, B, L) with K a
    multiple of ``hyper_every``, in groups of ``hyper_every`` steps: one
    hyper step on the group's first minibatch, ``model.factor_state()``
    under ``torch.no_grad()``, then ``hyper_every − 1`` q-only steps that
    take it. Losses (K,) stay on the device. Like the joint block it
    allocates no lasting storage, so it can be captured in a CUDA graph."""
    _check_schedule(model, hyper_every)

    def loss(X, Y, factor_state=None):
        return model.loss(X, Y) if factor_state is None else model.loss(X, Y, factor_state=factor_state)

    return _group_block(model, opt, hyper_every, loss, model.factor_state)


def make_batched_alternating_step(stack: nn.Module, opt: AdamPair, hyper_every: int) -> Callable:
    """The schedule's block on a member stack (``training.batched.
    stack_models``), the counterpart of ``zigp_tpu/training/alternating.py:
    256-323``: Xs (K, F, B, D), Ys (K, F, B, L); each step's losses of the F
    members under ``torch.func.vmap``, the sum differentiated, and
    ``factor_state()`` of every member under ``torch.no_grad()`` in one
    vmapped call, so each factor is one ``chol_inv`` launch for the stack.
    ``opt`` is ``init_alt_optimizers(stack)``. Losses (K, F) on the device.
    Member f follows its own ``make_alternating_block`` run."""
    from .batched import stacked_factor_state, stacked_loss

    _check_schedule(stack, hyper_every)
    return _group_block(stack, opt, hyper_every, lambda X, Y, factor_state=None: stacked_loss(
        stack, X, Y, factor_state), lambda: stacked_factor_state(stack))


__all__ = ["AdamPair", "init_alt_optimizers", "make_alternating_block", "make_batched_alternating_step", "partition_model"]
