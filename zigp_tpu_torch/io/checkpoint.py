"""Checkpoints of a model and its optimizer state, restored in place.

Counterpart of ``zigp_tpu/io/checkpoint.py`` (Orbax there, ``torch.save``
here), with its layout: a checkpoint is the directory ``step_{step:010d}``
under the manager's directory, holding one ``checkpoint.pt`` of plain
tensors: ``{"model": {raw name: tensor}, "opt_state": {raw name: {"step",
"exp_avg", "exp_avg_sq"}} or None, "step": int}``; the alternating
schedule's pair of optimizers nests one such dict under "h" and one under
"q". It is read back with ``weights_only=True``.

A restore writes into the storage that exists: every parameter, and every
Adam tensor with the step counts, is ``copy_``-ed in place
(``training.optim.GroupedAdam.load_state``). A CUDA graph captured over that
storage stays valid after a restore, where ``load_state_dict`` (which
allocates new tensors) would leave it training stale ones.

A member stack (``training.batched.stack_models``) is a module like any
other: its checkpoint holds every raw with its leading member axis and the
stack's optimizer state, in the JAX package's directory ``ckpt_{kind}_stack``
(``experiments.cv_batched``), and restores in place the same way.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional, Tuple

import torch

from .convert import jax_key, load_jax_arrays

FILE = "checkpoint.pt"


def _to_cpu(tree):
    """A nested dict of tensors, each detached and copied to the host."""
    return {k: _to_cpu(v) if isinstance(v, dict) else v.detach().cpu().clone() for k, v in tree.items()}


def save(path: str, model, opt_state=None, step: Optional[int] = None) -> str:
    """Save ``model``'s raws and ``opt_state``'s state to the directory
    ``path``, replacing what is there; the files are written beside it and
    renamed into place. ``opt_state`` is anything with ``state_tensors()``
    and ``load_state``: a ``GroupedAdam`` (the joint Adam, or the
    natural-gradient trainer's), or the alternating schedule's
    ``AdamPair``."""
    path = os.path.abspath(path)
    payload = {
        "model": {n: p.detach().cpu().clone() for n, p in model.named_parameters()},
        "opt_state": None if opt_state is None else _to_cpu(opt_state.state_tensors()),
        "step": int(step or 0),
    }
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def restore(path: str, like, opt_state_like=None) -> Tuple[Any, Any, Optional[int]]:
    """Restore the checkpoint at ``path`` into ``like`` (the model) and, when
    given, ``opt_state_like`` (its ``GroupedAdam`` or ``AdamPair``), in place; returns
    (like, opt_state_like, step). With ``opt_state_like=None`` only the model
    and the step are read: a partial restore for prediction, whatever
    optimizer wrote the checkpoint."""
    payload = torch.load(os.path.join(os.path.abspath(path), FILE), map_location="cpu", weights_only=True)
    # in place, all names and shapes checked before anything is written
    load_jax_arrays(like, {jax_key(n): t.numpy() for n, t in payload["model"].items()})
    if opt_state_like is not None:
        if payload["opt_state"] is None:
            raise KeyError(f"restore: {path} holds no optimizer state")
        opt_state_like.load_state(payload["opt_state"])
    return like, opt_state_like, payload["step"]


class CheckpointManager:
    """Periodic save with resume-from-latest, at the reference's cadence of
    every 10k iterations by default."""

    def __init__(self, directory: str, every: int = 10_000):
        self.directory = os.path.abspath(directory)
        self.every = every
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def maybe_save(self, step: int, model, opt_state=None):
        if self.every and step % self.every == 0:
            return self.save_at(step, model, opt_state)
        return None

    def save_at(self, step: int, model, opt_state=None):
        """Unconditional save at ``step``."""
        return save(self._path(step), model, opt_state, step)

    def crossed(self, prev_step: int, step: int) -> bool:
        """True when (prev_step, step] contains a checkpoint boundary: the
        cadence test of a loop that advances many steps at a time."""
        return bool(self.every) and (prev_step // self.every) != (step // self.every)

    def latest_step(self) -> Optional[int]:
        if not os.path.isdir(self.directory):
            return None
        steps = [
            int(d.split("_")[1])
            for d in os.listdir(self.directory)
            if d.startswith("step_") and d.split("_")[1].isdigit()
        ]
        return max(steps) if steps else None

    def restore_latest(self, like, opt_state_like=None):
        """(like, opt_state_like, step) restored in place from the latest
        checkpoint, or None when there is none."""
        step = self.latest_step()
        if step is None:
            return None
        model, opt_state, _ = restore(self._path(step), like, opt_state_like)
        return model, opt_state, step
