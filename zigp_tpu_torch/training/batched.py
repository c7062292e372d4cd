"""Batched training over a stacked member axis: every CV fold, or every seed
of an ensemble, of one configuration trained as one stack.

Counterpart of ``zigp_tpu/training/batched.py:44-762``. The JAX package
stacks F models into one pytree with a leading member axis and ``jax.vmap``s
the scanned step over it. Here:

- ``stack_models`` makes one module of the template's structure whose every
  raw is the F members' raws stacked on a new leading dim (an
  ``nn.Parameter`` of (F, ·)); ``unstack_model`` gives member f back as an
  ordinary module. Checkpoints (``io.checkpoint``), the optimizers
  (``training.optim``) and the natural steps (``training.natgrad``, written
  over a leading batch) take the stack as they take one model: Adam, its
  NaN zeroing and its lr schedule are elementwise or shared, so one Adam
  over the stacked raws is each member's own.
- ``over_members(stack, fn, *args)`` runs ``fn(member, *member_args)`` for
  every member under ``torch.func.vmap`` over ``torch.func.functional_call``
  of the stacked raws. The two autograd Functions on the path
  (``ops.linalg._CholInv``, ``ops.cuda.rbf_gram._RBFGram``) have ``vmap``
  rules that fold the member dim into their leading batch, so a stacked
  step launches each kernel as often as one member's step does, at batch
  F·G. The losses' sum is differentiated outside the vmap.
- ``StackedBlocks`` stages each block's minibatches as one static
  (K, F, B, ·) pair: member f's rows come from
  ``block_seed(seeds[f], block)`` (one ``randint`` and one gather per
  member per block, outside the graph), so member f sees the rows a
  sequential ``fit_scanned(sampler="device", sampler_seed=seeds[f])`` run
  sees. Ragged members are padded to the longest; their rows are drawn in
  [0, num_rows[f]), never from the padding.
- On the card each block is one CUDA-graph replay (``training.scan.
  BlockRunner``), and ``predict_batched_stacked`` serves every chunk of
  every member by one replay of a graph captured once per stack, predict
  function and chunk shape (``experiments.runners.predict_batched``).

Member f's trajectory is its sequential run's. On the CPU in float64 the two
agree to rounding; on the card a batched product may sum in another order
than F separate ones, so they agree to a tolerance. Meshes (the member axis
over several devices) are not ported: passing one raises
``NotImplementedError``.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.bijectors import Bijector
from ..io.convert import jax_key, stack_size
from . import scan as _scan
from .loop import FitResult, save_final
from .natgrad import NaturalGradientTrainer


def _static(value):
    if isinstance(value, Bijector):
        return type(value).__name__, tuple(sorted(vars(value).items()))
    if isinstance(value, torch.Tensor):
        return value.dtype, tuple(value.shape), tuple(value.detach().cpu().flatten().tolist())
    return value


def _structure(model: nn.Module) -> list:
    """What must match for models to stack: every submodule's class and its
    static fields (``num_data``, ``whiten``, ``jitter``, the bijectors, the
    kernel flags, ...), the buffers' values and the raws' names, dtypes,
    devices and trainability."""
    out = []
    for name, m in model.named_modules():
        fields = tuple(sorted((k, _static(v)) for k, v in vars(m).items() if not k.startswith("_")
                              and k not in ("training", "stack_size")))
        out.append((name, type(m).__name__, fields))
    out.append(tuple((n, _static(b)) for n, b in model.named_buffers()))
    out.append(tuple((n, p.dtype, str(p.device), p.requires_grad) for n, p in model.named_parameters()))
    return out


def _set_raw(module: nn.Module, name: str, value: nn.Parameter) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(module.get_submodule(owner) if owner else module, leaf, value)


def stack_models(models: Sequence[nn.Module]) -> nn.Module:
    """One module of the models' common structure whose every raw is theirs
    stacked on a new leading dim (``stack_size`` members). The models must
    have the same structure, static fields included (``num_data``,
    ``whiten``, ``jitter``: build with a shared placeholder and pass the
    true value through ``loss_fn``/``aux``), and raws of equal shapes; else
    it raises, as ``stack_pytrees`` does."""
    models = list(models)
    if not models:
        raise ValueError("cannot stack: no models")
    structures = [_structure(m) for m in models]
    if any(s != structures[0] for s in structures[1:]):
        raise ValueError("cannot stack: module structures differ (check static fields such as "
                         "num_data/whiten/jitter)")
    named = [dict(m.named_parameters()) for m in models]
    for name in named[0]:
        shapes = {tuple(n[name].shape) for n in named}
        if len(shapes) > 1:
            raise ValueError(f"cannot stack: leaf {jax_key(name)} has mismatched shapes across members: "
                             f"{sorted(shapes)}")
    raws = {id(p): p for p in models[0].parameters()}
    # the template's structure, its raws replaced (not copied) by the stacked ones
    memo = {i: None for i in raws}
    stack = copy.deepcopy(models[0], memo)
    with torch.no_grad():
        for name, p in named[0].items():
            _set_raw(stack, name, nn.Parameter(torch.stack([n[name].detach() for n in named]),
                                               requires_grad=p.requires_grad))
    stack.stack_size = len(models)
    stack._stacked_predictors = {}
    return stack


def unstack_model(stack: nn.Module, index: int) -> nn.Module:
    """Member ``index`` of ``stack`` as an ordinary module, with storage of
    its own (the ``unstack_pytree`` counterpart)."""
    stack_size(stack)
    memo = {id(p): nn.Parameter(p.detach()[index].clone(), requires_grad=p.requires_grad)
            for p in stack.parameters()}
    memo[id(stack._stacked_predictors)] = {}
    member = copy.deepcopy(stack, memo)
    del member.stack_size, member._stacked_predictors
    return member


class _Call(nn.Module):
    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def over_members(stack: nn.Module, fn: Callable, *args):
    """``fn(member, *member_args)`` for every member of ``stack``, stacked on
    a leading member dim: ``torch.func.vmap`` over ``functional_call`` of
    the stacked raws. Each of ``args`` (a tensor or a tuple tree of them)
    has a leading member dim, or is None."""
    stack_size(stack)
    names, raws = zip(*stack.named_parameters())
    call = _Call(stack, fn)

    def one(member_raws, *a):
        return torch.func.functional_call(call, {f"model.{n}": r for n, r in zip(names, member_raws)}, a)

    return torch.func.vmap(one, in_dims=(0, *(None if a is None else 0 for a in args)))(raws, *args)


def stacked_loss(stack: nn.Module, X, Y, factor_state=None) -> torch.Tensor:
    """Each member's ``loss(X_f, Y_f)``, with its ``factor_state`` when one
    is given (stacked, as ``stacked_factor_state`` returns it): (F,)."""
    if factor_state is None:
        return over_members(stack, lambda m, X, Y: m.loss(X, Y), X, Y)
    return over_members(stack, lambda m, X, Y, st: m.loss(X, Y, factor_state=st), X, Y, factor_state)


def stacked_factor_state(stack: nn.Module):
    """Every member's ``factor_state()``, stacked: one ``chol_inv`` launch
    per factor for the whole stack."""
    return over_members(stack, lambda m: m.factor_state())


def _arrays(d):
    return d.arrays if hasattr(d, "arrays") else d


class StackedBlocks:
    """One static (K, F, B, ·) pair ``Xs``, ``Ys`` on ``device``, refilled
    for each block by ``fill(block)``: member f's K·B rows drawn by
    ``block_seed(seeds[f], block)`` in [0, num_rows[f]) and gathered once
    from its training set on the device, the sequential device sampler's
    rows. ``xys``: the members' (X, Y) arrays, ragged lengths padded to the
    longest by repeating the last row."""

    def __init__(self, xys, batch_size: int, num_inner: int, *, seeds: Sequence[int], device, dtype):
        xys = [(np.asarray(x), np.asarray(y)) for x, y in xys]
        self.rows = [x.shape[0] for x, _ in xys]
        N = max(self.rows)
        pad = lambda a: a if a.shape[0] == N else np.concatenate([a, np.repeat(a[-1:], N - a.shape[0], axis=0)])
        self.Xtrain = torch.as_tensor(np.stack([pad(x) for x, _ in xys]), dtype=dtype).to(device)
        self.Ytrain = torch.as_tensor(np.stack([pad(y) for _, y in xys]), dtype=dtype).to(device)
        F = len(xys)
        self.seeds = list(seeds)
        self.Xs = torch.empty((num_inner, F, batch_size, *self.Xtrain.shape[2:]), dtype=dtype, device=device)
        self.Ys = torch.empty((num_inner, F, batch_size, *self.Ytrain.shape[2:]), dtype=dtype, device=device)
        self.generator = torch.Generator(device=device)

    def fill(self, block: int) -> None:
        K, _, B = self.Xs.shape[:3]
        for f, (seed, n) in enumerate(zip(self.seeds, self.rows)):
            idx = _scan._draw(self.generator, _scan.block_seed(seed, block), n, K * B).to(self.Xs.device)
            self.Xs[:, f].copy_(self.Xtrain[f].index_select(0, idx).view(K, B, *self.Xs.shape[3:]))
            self.Ys[:, f].copy_(self.Ytrain[f].index_select(0, idx).view(K, B, *self.Ys.shape[3:]))


def _member_loss(loss_fn: Optional[Callable]) -> Callable:
    if loss_fn is None:
        return lambda m, X, Y, a: m.loss(X, Y)
    return loss_fn


def make_batched_block(stack: nn.Module, optimizer, loss_fn: Optional[Callable] = None, aux=None) -> Callable:
    """A block step ``(Xs, Ys) -> losses`` of the stack: K steps over
    Xs (K, F, B, D), Ys (K, F, B, L), each the F members' losses under
    ``torch.func.vmap`` (``loss_fn(member, X, Y, aux_f)``, by default
    ``member.loss(X, Y)``), their sum differentiated, and one update of
    ``optimizer`` (over the stacked raws). Losses (K, F) stay on the
    device; the block allocates no lasting storage, so it can be captured
    in a CUDA graph."""
    loss = _member_loss(loss_fn)

    def block(Xs: torch.Tensor, Ys: torch.Tensor) -> torch.Tensor:
        losses = []
        for k in range(Xs.shape[0]):
            optimizer.zero_grad()
            value = over_members(stack, loss, Xs[k], Ys[k], aux)
            value.sum().backward()
            optimizer.step()
            losses.append(value.detach())
        return torch.stack(losses)

    return block


def _stacked_first_rows_loss(stack, xys, batch_size, *, loss_fn=None, aux=None) -> np.ndarray:
    """Each member's loss on its first min(batch_size, shortest member) rows:
    the health signal of a resumed run that trains nothing."""
    b0 = min(batch_size, min(np.asarray(x).shape[0] for x, _ in xys))
    p0 = next(stack.parameters())
    as_t = lambda arrs: torch.as_tensor(np.stack([np.asarray(a)[:b0] for a in arrs]), dtype=p0.dtype).to(p0.device)
    with torch.no_grad():
        losses = over_members(stack, _member_loss(loss_fn), as_t([x for x, _ in xys]), as_t([y for _, y in xys]),
                              aux)
    return losses.cpu().numpy()


def _aux_tensor(aux, like: torch.Tensor):
    """Per-member ``aux`` (F values) as a tensor on the stack's device, in
    its dtype: the ELBO scale of a ragged member enters as a float."""
    return None if aux is None else torch.as_tensor(np.asarray(aux), dtype=like.dtype).to(like.device)


def _member_results(stack, optimizer, F, losses_log, sps, final, restored) -> List[FitResult]:
    return [
        FitResult(
            model=unstack_model(stack, f),
            optimizer=optimizer,  # the stack's: member f's state is index f of its tensors
            losses=[float(row[f]) for row in losses_log],
            steps_per_sec=sps,  # one stream for the stack: every member's rate is the stack's
            final_loss=float("nan") if restored else float(final[f]),
        )
        for f in range(F)
    ]


def _run_blocks(stack, optimizer, blocks, runner_for, *, start_step, num_iter, num_inner, block_index,
                log_every_blocks, log_fn, ckpt_manager, recover_on_nan, metric_logger, name, extra_scalars=None):
    """The block loop both stacked trainers share: ``runner_for(steps_done)``
    gives the block's ``BlockRunner`` (after staging its inputs), the host
    reads the losses at the log points and checkpoint boundaries, a
    non-finite loss in any member restores the whole stack, and a
    non-finite end raises. Returns (losses at the log points, steps/s,
    the last block's losses (F,), whether it was restored)."""
    F = stack_size(stack)
    num_blocks = max(1, -(-(num_iter - start_step) // num_inner))
    losses_log: list = []
    t_start = time.perf_counter()
    timed_steps = 0
    steps_done = start_step
    restored_this_block = False
    block_losses = None
    for b in range(num_blocks):
        restored_this_block = False
        blocks.fill(block_index(steps_done))
        block_losses = runner_for(steps_done)()
        prev_steps = steps_done
        steps_done += num_inner
        nxt = runner_for(steps_done, stage=False)
        capture = nxt.wants_capture and b + 1 < num_blocks  # only for blocks to come
        if b == 0 or capture:
            block_losses.cpu()  # waits: the first block and the capture are not timed
            if capture:
                log_fn(f"step {steps_done:>8d}  stacked block graph of {num_inner} steps x {F} members: "
                       f"{nxt.capture().graph.describe()}")
            t_start = time.perf_counter()
            timed_steps = 0
        else:
            timed_steps += num_inner

        is_log = log_every_blocks and b % log_every_blocks == 0
        ckpt_due = ckpt_manager is not None and ckpt_manager.crossed(prev_steps, steps_done)
        if is_log or ckpt_due:
            last = block_losses[-1].cpu().numpy()
            if not np.all(np.isfinite(last)):
                bad = [f for f in range(F) if not np.isfinite(last[f])]
                log_fn(f"step {steps_done:>8d}  NON-FINITE loss in members {bad}")
                if ckpt_manager is not None and recover_on_nan:
                    restored = ckpt_manager.restore_latest(stack, optimizer)
                    if restored is not None:
                        restored_this_block = True
                        log_fn(f"restored the stack from checkpoint at step {restored[2]}")
                continue
            if ckpt_due:
                ckpt_manager.save_at(steps_done, stack, optimizer)
            if is_log:
                losses_log.append(last)
                joined = " ".join(f"{v:.4f}" for v in last)
                log_fn(f"step {steps_done:>8d}  losses [{joined}]")
                if metric_logger is not None:
                    scalars = {f"loss_{f}": float(last[f]) for f in range(F)}
                    if extra_scalars is not None:
                        scalars.update(extra_scalars(prev_steps))
                    metric_logger.log(steps_done, scalars=scalars)
    final = block_losses[-1].cpu().numpy()  # waits for the device
    elapsed = max(time.perf_counter() - t_start, 1e-12)
    if not np.all(np.isfinite(final)) and not restored_this_block:
        bad = [f for f in range(F) if not np.isfinite(final[f])]
        raise FloatingPointError(
            f"{name} finished at step {steps_done} with non-finite losses in members {bad}; the trained stack is "
            "unusable. Enable checkpointing (ckpt_manager) for NaN recovery.")
    save_final(ckpt_manager, steps_done, restored_this_block, stack, optimizer, log_fn)
    return losses_log, (timed_steps / elapsed if timed_steps else 0.0), final, restored_this_block


def _check_members(models, datas, seeds, mesh, name):
    if mesh is not None:
        raise NotImplementedError(f"{name}: the member-axis mesh is not ported to zigp_tpu_torch yet")
    F = len(models)
    if F == 0:
        raise ValueError("no models to train")
    seeds = list(range(F)) if seeds is None else list(seeds)
    if len(seeds) != F or len(datas) != F:
        raise ValueError("models, datas and seeds must have equal length")
    return F, seeds, [_arrays(d) for d in datas]


def fit_batched_scanned(
    models: Sequence[nn.Module],
    datas: Sequence,
    *,
    num_iter: int,
    batch_size: int,
    num_inner: int = 50,
    schedule: Optional[Callable] = None,
    learning_rate: float = 1e-3,
    loss_fn: Optional[Callable] = None,
    aux=None,
    seeds: Optional[Sequence[int]] = None,
    log_every_blocks: int = 1,
    log_fn: Callable[[str], None] = print,
    ckpt_manager=None,
    recover_on_nan: bool = True,
    metric_logger=None,
    resume: bool = False,
    mesh=None,
    hyper_every: int = 0,
    alt_opt_factories=None,
) -> List[FitResult]:
    """Train F models of one structure as one stack; returns F
    ``FitResult``s, each with its member unstacked (``unstack_model``).

    ``datas``: F ``DataSet``s or (X, Y) pairs; ragged lengths are padded
    and each member draws from its own rows only. ``seeds``: the members'
    sampler seeds (default 0..F−1): member f's minibatches are those of a
    sequential ``fit_scanned(sampler="device", sampler_seed=seeds[f])``.
    ``loss_fn(member, X, Y, aux_f)`` with ``aux`` (F values, e.g. the true
    ``num_data`` of ragged members): by default ``member.loss(X, Y)``.
    The optimizer is per-lr-group Adam at ``learning_rate`` over the
    stacked raws (``make_optimizer``), its lrs multiplied by ``schedule``
    (``cosine_adam``) when one is given: the JAX package's optax
    transformation, which the port binds to the stack it builds.

    ``hyper_every`` > 0: the block-coordinate schedule
    (``make_batched_alternating_step``, a pair of Adams with the
    ``alt_opt_factories`` (q, h) schedules); it needs the models' own loss
    and ``num_inner`` a multiple of it.

    As the JAX package's: the checkpoints (``ckpt_manager``) hold the whole
    stack and its optimizer, one at the start when there is none; a
    non-finite loss in any member at a log point or checkpoint boundary
    restores the whole stack; a non-finite end raises
    ``FloatingPointError``; ``resume`` restores the latest checkpoint in
    place, and a resumed run already at ``num_iter`` trains nothing and
    gives each member's loss on its first rows. Every member's
    ``steps_per_sec`` is the stack's. On the card each block after the
    warm-up is one CUDA-graph replay."""
    from .alternating import init_alt_optimizers, make_batched_alternating_step
    from .optim import make_optimizer

    F, seeds, xys = _check_members(models, datas, seeds, mesh, "fit_batched_scanned")
    stack = stack_models(models)
    if hyper_every:
        if loss_fn is not None or aux is not None:
            raise ValueError("hyper_every (block-coordinate schedule) requires the models' own loss — "
                             "loss_fn/aux are unsupported")
        if num_inner % hyper_every:
            raise ValueError(f"num_inner ({num_inner}) must divide by hyper_every ({hyper_every})")
        optimizer = init_alt_optimizers(stack, learning_rate=learning_rate, opt_factories=alt_opt_factories)
    else:
        optimizer = make_optimizer(stack, default_lr=learning_rate, schedule=schedule)
    p0 = next(stack.parameters())
    aux = _aux_tensor(aux, p0)

    start_step = None
    if resume and ckpt_manager is not None:
        restored = ckpt_manager.restore_latest(stack, optimizer)
        if restored is not None:
            start_step = restored[2]
            log_fn(f"resumed the stacked run from step {start_step}")
    if start_step is not None and start_step >= num_iter:
        log_fn("checkpoint is already at or past num_iter; nothing to train")
        finals = _stacked_first_rows_loss(stack, xys, batch_size, loss_fn=loss_fn, aux=aux)
        return _member_results(stack, optimizer, F, [], 0.0, finals, False)
    start_step = start_step or 0

    blocks = StackedBlocks(xys, batch_size, num_inner, seeds=seeds, device=p0.device, dtype=p0.dtype)
    if hyper_every:
        body = make_batched_alternating_step(stack, optimizer, hyper_every)
    else:
        body = make_batched_block(stack, optimizer, loss_fn, aux)
    runner = _scan.BlockRunner(lambda: body(blocks.Xs, blocks.Ys), blocks.Xs)

    if ckpt_manager is not None and ckpt_manager.latest_step() is None:
        ckpt_manager.save_at(start_step, stack, optimizer)
    losses_log, sps, final, restored = _run_blocks(
        stack, optimizer, blocks, lambda steps, stage=True: runner, start_step=start_step, num_iter=num_iter,
        num_inner=num_inner, block_index=lambda steps: steps // num_inner, log_every_blocks=log_every_blocks,
        log_fn=log_fn, ckpt_manager=ckpt_manager, recover_on_nan=recover_on_nan, metric_logger=metric_logger,
        name="fit_batched_scanned")
    return _member_results(stack, optimizer, F, losses_log, sps, final, restored)


class StackedNaturalGradientTrainer(NaturalGradientTrainer):
    """``training.natgrad.NaturalGradientTrainer`` on a member stack: its
    steps differentiate the sum of the members' losses (``over_members``)
    and take the members' factor states in one vmapped call; its Adam and
    natural steps run on the stacked raws, the Kronecker steps per matrix
    (each member's own KL budget). Blocks take Xs (K, F, B, D) and return
    losses (K, F)."""

    def _loss(self, X, Y, factor_state=None):
        return stacked_loss(self.model, X, Y, factor_state)

    def _factor_state(self):
        return stacked_factor_state(self.model)


def fit_natgrad_batched(
    models: Sequence[nn.Module],
    datas: Sequence,
    *,
    num_iter: int,
    batch_size: int,
    num_inner: int = 50,
    gamma: float = 0.1,
    gamma_warmup: int = 2000,
    gamma_init: float = 1e-4,
    adam_lr: float = 1e-3,
    adam_warmup: int = 0,
    max_mean_step: float = 10.0,
    kron_joint: bool = False,
    kl_cap: Optional[float] = 10.0,
    seeds: Optional[Sequence[int]] = None,
    log_every_blocks: int = 4,
    log_fn: Callable[[str], None] = print,
    ckpt_manager=None,
    recover_on_nan: bool = True,
    metric_logger=None,
    resume: bool = False,
    mesh=None,
) -> List[FitResult]:
    """Natural-gradient training of F members as one stack, the counterpart
    of ``zigp_tpu/training/batched.py:474-730``: each member's recipe is
    ``fit_natgrad_scanned(sampler="device", sampler_seed=seeds[f])``'s (the
    Adam warm-start through ``fit_batched_scanned``, the γ schedule of the
    natural phase shared by all members, block keys at
    ⌈steps / num_inner⌉). The natural steps run on the stacked raws, which
    they take as a leading batch: the diagonal and mean steps elementwise or
    per matrix, the joint step on f and g of every member at once (each of
    its Choleskys one ``chol_inv`` launch for 2F matrices), every KL budget
    per member. Equal-shaped members only (no ragged or ``aux`` path).
    Checkpoints and NaN handling as in ``fit_batched_scanned``."""
    F, seeds, xys = _check_members(models, datas, seeds, mesh, "fit_natgrad_batched")
    if len({np.asarray(x).shape for x, _ in xys}) > 1:
        raise ValueError(f"fit_natgrad_batched requires equal-shaped member datasets "
                         f"(got {[np.asarray(x).shape for x, _ in xys]})")
    num_iter = int(num_iter)
    adam_warmup = min(int(adam_warmup), num_iter // 2)
    num_inner = max(1, min(int(num_inner), num_iter - adam_warmup))

    def trainer_of(stack):
        return StackedNaturalGradientTrainer(stack, gamma=gamma, adam_lr=adam_lr, gamma_warmup=gamma_warmup, gamma_init=gamma_init,
                            max_mean_step=max_mean_step, kron_joint=kron_joint, kl_cap=kl_cap)

    stack = trainer = None
    start_step = None
    if resume and ckpt_manager is not None:
        stack = stack_models(models)
        trainer = trainer_of(stack)
        restored = ckpt_manager.restore_latest(stack, trainer.adam)
        if restored is not None:
            start_step = restored[2]
            log_fn(f"resumed the natgrad stack from step {start_step}")
    if start_step is not None and start_step >= num_iter:
        log_fn("checkpoint is already at or past num_iter; nothing to train")
        finals = _stacked_first_rows_loss(stack, xys, batch_size)
        return _member_results(stack, trainer.adam, F, [], 0.0, finals, False)
    if start_step is None:
        if adam_warmup:
            warm = fit_batched_scanned(models, datas, num_iter=adam_warmup, batch_size=batch_size,
                                       num_inner=min(num_inner, adam_warmup), learning_rate=adam_lr, seeds=seeds,
                                       log_every_blocks=0, log_fn=log_fn)
            models = [r.model for r in warm]
        stack = stack_models(models)
        trainer = trainer_of(stack)
        start_step = adam_warmup
    num_iter = max(num_iter, start_step + num_inner)

    p0 = next(stack.parameters())
    blocks = StackedBlocks(xys, batch_size, num_inner, seeds=seeds, device=p0.device, dtype=p0.dtype)
    # float32: the JAX step's γ is a float32 scalar (training.natgrad)
    gammas = torch.empty((num_inner,), dtype=torch.float32, device=p0.device)
    runners = {}

    def runner_for(steps: int, stage: bool = True) -> _scan.BlockRunner:
        local = steps - adam_warmup  # the γ ramp runs on the natural phase's steps
        if stage:
            gammas.copy_(torch.from_numpy(trainer.gamma_at(np.arange(local, local + num_inner))))
        r = local % trainer.period
        if r not in runners:
            runners[r] = _scan.BlockRunner(lambda: trainer.block(blocks.Xs, blocks.Ys, gammas, r), blocks.Xs)
        return runners[r]

    if ckpt_manager is not None and ckpt_manager.latest_step() is None:
        ckpt_manager.save_at(start_step, stack, trainer.adam)
    losses_log, sps, final, restored = _run_blocks(
        stack, trainer.adam, blocks, runner_for, start_step=start_step, num_iter=num_iter, num_inner=num_inner,
        # ceil: past the warm-up's block indices when it is not a multiple of num_inner
        block_index=lambda steps: -(-steps // num_inner), log_every_blocks=log_every_blocks, log_fn=log_fn,
        ckpt_manager=ckpt_manager, recover_on_nan=recover_on_nan, metric_logger=metric_logger,
        name="fit_natgrad_batched",
        extra_scalars=lambda prev: {"gamma": float(trainer.gamma_at(prev + num_inner - 1 - adam_warmup))})
    return _member_results(stack, trainer.adam, F, losses_log, sps, final, restored)


class _StackedPredict(nn.Module):
    """``predict_fn(member, X)`` of every member of a stack on a staged
    (batch, F, D) chunk (row b of each member in row b): each field
    (F, batch, k) laid out as (batch, F·k), the layout
    ``experiments.runners.predict_batched`` stages and joins. One per stack
    and function (the stack keeps it), so its chunk graph is captured once."""

    def __init__(self, stack: nn.Module, predict_fn: Callable):
        super().__init__()
        self.stack = stack
        self.predict_fn = predict_fn

    def forward(self, chunk: torch.Tensor) -> dict:
        res = over_members(self.stack, self.predict_fn, chunk.transpose(0, 1).contiguous())
        fields = res._asdict() if hasattr(res, "_asdict") else dict(res)
        return {k: v.transpose(0, 1).reshape(v.shape[1], -1) for k, v in fields.items()}


def predict_batched_stacked(predict_fn: Callable, stack: nn.Module, Xs: np.ndarray, batch: int = 4096) -> List[dict]:
    """``predict_fn(member, X_chunk)`` (a NamedTuple or dict of (batch, k)
    tensors) over the F members of ``stack`` in fixed-shape chunks of
    (F, batch, D): Xs (F, N, D), equal-length per-member inputs (pad ragged
    ones upstream). Returns F dicts of (N, k) numpy arrays. On the card
    each chunk is one replay of a graph captured once per stack, function
    and chunk shape (``predict_batched``); pass the same function object
    each time to reuse it."""
    from ..experiments.runners import predict_batched

    F = stack_size(stack)
    Xs = np.asarray(Xs)
    if Xs.shape[0] != F:
        raise ValueError(f"predict_batched_stacked: Xs has {Xs.shape[0]} members, the stack {F}")
    predictor = stack._stacked_predictors.get(predict_fn)
    if predictor is None:
        predictor = stack._stacked_predictors[predict_fn] = _StackedPredict(stack, predict_fn)
    p0 = next(stack.parameters())
    out = predict_batched(predictor, np.ascontiguousarray(np.swapaxes(Xs, 0, 1)), batch, device=p0.device,
                          dtype=p0.dtype)
    return [{k: v.reshape(v.shape[0], F, -1)[:, f] for k, v in out.items()} for f in range(F)]


__all__ = [
    "StackedBlocks",
    "StackedNaturalGradientTrainer",
    "fit_batched_scanned",
    "fit_natgrad_batched",
    "make_batched_block",
    "over_members",
    "predict_batched_stacked",
    "stack_models",
    "stack_size",
    "stacked_factor_state",
    "stacked_loss",
    "unstack_model",
]
