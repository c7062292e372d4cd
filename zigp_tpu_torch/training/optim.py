"""Adam with per-parameter learning-rate groups, safe to capture in a CUDA graph.

Counterpart of ``zigp_tpu/training/optim.py:20-61``. The JAX package labels
each raw by its ``Parameter.lr`` (``core.parameters.lr_labels``) and runs one
optax Adam per label under ``multi_transform``; Adam is elementwise, so that
is one ``torch.optim.Adam`` with a param group per label. Its update is
optax's: eps 1e-8 outside the square root, bias-corrected moments. A
non-trainable Parameter ("frozen") holds no gradient and joins no group.

Everything the update reads or writes lives in storage allocated once, at
construction, as optax's ``init`` allocates its state:

- the moments and the step counts (``torch.optim.Adam``'s state, filled in
  before the first step; ``capturable=True`` on the card, so the step count
  and the bias corrections stay on the device);
- every gradient, as a view of one flat buffer: ``zero_grad`` is one fill
  and the backward accumulates into the views in place;
- each group's learning rate, a 0-d tensor of the parameters' dtype and
  device, rewritten on the device after each update from Adam's step count
  (the schedule's value at that count, as ``LambdaLR`` sets it), so the
  first update uses the schedule's value at step 0, as optax's counter does.

So an eager step and a step captured in a CUDA graph run the same
operations on the same storage, and a checkpoint restore that writes into
that storage in place (``load_state``) leaves a captured graph valid.

``zero_nans`` zeroes NaN gradient entries before the update, as
``optax.zero_nans`` does (``where(isnan(g), 0, g)``); ±inf passes through.
It is one ``nan_to_num_`` over the flat buffer.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn

from ..core.parameters import collect_lrs, lr_labels

STATE_KEYS = ("step", "exp_avg", "exp_avg_sq")


class GradBuffer:
    """The gradients of ``params`` as views of one flat buffer ``flat``:
    zeroing them is one fill, and a backward accumulates into the views in
    place, so the storage a captured step reads stays the same."""

    def __init__(self, params):
        self.params = list(params)
        p0 = self.params[0]
        self.flat = torch.zeros(sum(p.numel() for p in self.params), dtype=p0.dtype, device=p0.device)
        self.views = []
        offset = 0
        for p in self.params:
            self.views.append(self.flat[offset : offset + p.numel()].view_as(p))
            offset += p.numel()
        self.bind()

    def bind(self) -> None:
        """Point every ``.grad`` at its view of the flat buffer. A gradient
        that was put in its place (by an assignment, or a backward after
        ``zero_grad(set_to_none=True)`` on the model) is copied in; a
        missing one is zero."""
        for p, v in zip(self.params, self.views):
            g = p.grad
            if g is None:
                v.zero_()
            elif g.data_ptr() != v.data_ptr():
                v.copy_(g)
            else:
                continue
            p.grad = v

    def zero_(self) -> None:
        """Zero every gradient in place: the views stay bound."""
        self.bind()
        self.flat.zero_()


class GroupedAdam:
    """``torch.optim.Adam`` over the per-lr groups, with the optional NaN
    zeroing and learning-rate schedule. ``step()`` applies one update from
    the gradients in ``.grad``; ``zero_grad()`` clears them.

    ``groups``: ``[{"label": str, "lr": float, "params": [(name, raw), ...]}]``.
    ``schedule(step)`` maps the number of updates taken, as a 0-d tensor, to
    the multiplier of every group's lr (``cosine_adam``)."""

    def __init__(self, groups, schedule: Optional[Callable] = None, zero_nans: bool = True):
        named = [(n, p) for g in groups for n, p in g["params"]]
        if not named:
            raise ValueError("GroupedAdam: no trainable parameters")
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        device, dtype = self.params[0].device, self.params[0].dtype
        capturable = device.type == "cuda"  # torch's capturable Adam runs on the card only
        self.schedule = schedule
        self.zero_nans = zero_nans
        self.grads = GradBuffer(self.params)
        self.adam = torch.optim.Adam(
            [{"params": [p for _, p in g["params"]], "lr": torch.tensor(g["lr"], dtype=dtype, device=device),
              "base_lr": g["lr"], "label": g["label"]} for g in groups if g["params"]],
            betas=(0.9, 0.999), eps=1e-8, capturable=capturable,
        )
        # Eager steps on the card are by design (a capture's warm-up, the
        # per-step paths): silence torch's one warning about them.
        self.adam._warned_capturable_if_run_uncaptured = True
        for p in self.params:
            self.adam.state[p].update(
                step=torch.zeros((), dtype=torch.float32, device=device if capturable else "cpu"),
                exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                exp_avg_sq=torch.zeros_like(p, memory_format=torch.preserve_format),
            )
        self._set_lrs()

    @property
    def step_count(self) -> torch.Tensor:
        """The number of updates taken (Adam's step count, shared by every
        parameter), a 0-d float32 tensor."""
        return self.adam.state[self.params[0]]["step"]

    def _set_lrs(self) -> None:
        """Each group's lr for the next update: its base lr times the
        schedule at the number of updates taken, computed on the device."""
        if self.schedule is None:
            return
        scale = self.schedule(self.step_count.to(self.grads.flat.dtype))
        for g in self.adam.param_groups:
            torch.mul(scale, g["base_lr"], out=g["lr"])

    def step(self) -> None:
        with torch.no_grad():
            self.grads.bind()
            if self.zero_nans:
                torch.nan_to_num_(self.grads.flat, nan=0.0, posinf=math.inf, neginf=-math.inf)
            self.adam.step()
            self._set_lrs()

    def zero_grad(self) -> None:
        """Zero every gradient in place: the views stay bound."""
        self.grads.zero_()

    def state_tensors(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{parameter name: {"step", "exp_avg", "exp_avg_sq"}}: the live
        state tensors, for a checkpoint."""
        return {n: {k: self.adam.state[p][k] for k in STATE_KEYS} for n, p in zip(self.names, self.params)}

    def check_state(self, state: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Raise unless ``state`` has ``state_tensors``'s names and shapes."""
        live = self.state_tensors()
        if set(state) != set(live):
            raise KeyError(f"load_state: missing {sorted(set(live) - set(state))}, "
                           f"unknown {sorted(set(state) - set(live))}")
        for n, ts in live.items():
            for k, t in ts.items():
                if tuple(state[n][k].shape) != tuple(t.shape):
                    raise ValueError(f"load_state: {n}.{k} has shape {tuple(state[n][k].shape)}, "
                                     f"expected {tuple(t.shape)}")

    def load_state(self, state: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Copy ``state`` (``state_tensors``'s layout, any device) into the
        live state tensors in place, then set the lrs from the restored step
        count. Raises on a missing or unknown name or a shape mismatch before
        anything is written (``check_state``)."""
        self.check_state(state)
        with torch.no_grad():
            for n, ts in self.state_tensors().items():
                for k, t in ts.items():
                    t.copy_(state[n][k])
            self._set_lrs()


def cosine_scale(step, total_steps: int, *, warmup: int = 0, final_scale: float = 0.01):
    """The learning-rate multiplier at ``step`` of optax's
    ``cosine_decay_schedule(1, total_steps, alpha=final_scale)``, or with
    ``warmup`` of ``warmup_cosine_decay_schedule(0, 1, warmup, total_steps,
    end_value=final_scale)``: a linear ramp from 0, then the cosine from 1 to
    ``final_scale`` over the remaining steps, held there after the end.

    ``step`` an int gives a float; a 0-d tensor (the optimizer's step count)
    gives a tensor of its dtype on its device, by the same operations in the
    same order."""
    if isinstance(step, torch.Tensor):
        return _cosine_scale_tensor(step, total_steps, warmup, final_scale)
    if warmup:
        if step < warmup:
            return step / warmup
        step, total_steps = step - warmup, total_steps - warmup
    t = min(step, total_steps)
    return (1.0 - final_scale) * 0.5 * (1.0 + math.cos(math.pi * t / total_steps)) + final_scale


def _cosine_scale_tensor(step: torch.Tensor, total_steps: int, warmup: int, final_scale: float) -> torch.Tensor:
    s, total = step, total_steps
    if warmup:
        s, total = step - warmup, total_steps - warmup
    t = torch.clamp(s, max=total)
    scale = (1.0 - final_scale) * 0.5 * (1.0 + torch.cos(math.pi * t / total)) + final_scale
    return torch.where(step < warmup, step / warmup, scale) if warmup else scale


def cosine_adam(total_steps: int, *, warmup: int = 0, final_scale: float = 0.01) -> Callable:
    """A schedule for ``make_optimizer``: Adam with (optional warmup +) cosine
    decay to final_scale·lr over total_steps, for every group."""

    def schedule(step):
        return cosine_scale(step, total_steps, warmup=warmup, final_scale=final_scale)

    return schedule


def make_optimizer(
    model: nn.Module,
    *,
    default_lr: float = 1e-3,
    schedule: Optional[Callable] = None,
    zero_nans: bool = True,
    names: Optional[Iterable[str]] = None,
) -> GroupedAdam:
    """Adam over ``model``'s trainable raws, one param group per lr label
    ("default" at ``default_lr``, "lr:<value>" at that value), each group's
    learning rate multiplied by ``schedule(step)`` when one is given.
    ``names``: only these raws (a partition of the model, as the JAX
    package's ``make_optimizer`` takes a list of its leaves); the labels and
    lrs are those of the raws taken."""
    keep = None if names is None else set(names)
    lrs = collect_lrs(model, default_lr)
    labels = lr_labels(model)
    members: dict[str, list] = {label: [] for label in lrs}
    for name, raw in model.named_parameters():
        if labels[name] != "frozen" and (keep is None or name in keep):
            members[labels[name]].append((name, raw))
    groups = [{"label": label, "lr": lrs[label], "params": ps} for label, ps in members.items() if ps]
    return GroupedAdam(groups, schedule, zero_nans)


def adam_per_group(model: nn.Module, default_lr: float = 1e-3) -> GroupedAdam:
    return make_optimizer(model, default_lr=default_lr)
