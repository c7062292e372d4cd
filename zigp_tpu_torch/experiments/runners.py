"""Runners: batched prediction over a large input set, and the on/off
model's training.

Counterpart of ``zigp_tpu/experiments/runners.py``: ``predict_batched``
(:55-80) and the training half of ``run_onoff`` / ``_fit_auto`` (:83-275) as
``train_onoff_pptr``. On the card ``predict_batched`` replays its chunk as
one CUDA graph, captured once per model and chunk shape, as training replays
its block.
"""

from __future__ import annotations

import os
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.config import resolve_device
from ..io.checkpoint import CheckpointManager
from ..io.datasets import Split
from ..training import DataSet, FitResult, cosine_adam, fit, fit_scanned, make_optimizer
from ..utils.logging import MetricLogger
from .builders import build_onoff_pptr
from .configs import OnOffPptrConfig


def train_onoff_pptr(
    cfg: OnOffPptrConfig,
    split: Split,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
    model=None,
    log_fn: Callable[[str], None] = print,
    workdir: Optional[str] = None,
    resume: bool = False,
    monitor_cb: Optional[Callable] = None,
) -> FitResult:
    """Build the on/off model of ``cfg`` for ``split`` (or take ``model``)
    and train it for ``cfg.num_iter`` steps at ``cfg.batch_size`` by
    ``cfg.sampler``, with per-lr-group Adam (cosine decay over
    ``cfg.num_iter`` when ``cfg.lr_schedule == "cosine"``), as the JAX
    package's ``_fit_auto`` does: ``fit_scanned`` in blocks of
    ``cfg.scan_inner``, or the per-step ``fit`` when ``scan_inner`` is 0 or
    longer than what is left of the run. ``device=None`` is the CUDA card;
    ``use_kernel`` builds the factor grams with the ``rbf_gram`` kernel.

    With a ``workdir`` the production machinery is on: checkpoints every
    ``cfg.ckpt_every`` steps in ``workdir/ckpt_onoff`` with NaN recovery,
    JSONL metrics in ``workdir/metrics_onoff.jsonl`` (histograms at
    ``cfg.hist_every``), and ``monitor_cb(step, model)`` every
    ``cfg.monitor_every`` steps. ``resume=True`` restores the latest
    checkpoint in place, moves the host sampler's stream past the steps
    taken (the device sampler takes its block index from the step) and
    trains what is left, on the uninterrupted run's trajectory; a checkpoint
    at or past ``cfg.num_iter`` returns without training.

    What the port does not have raises ``NotImplementedError``: natural
    gradients, the block-coordinate schedule (``hyper_every``) and meshes."""
    unported = [
        what
        for what, on in (
            ("optimizer='natgrad'", cfg.optimizer == "natgrad"),
            ("hyper_every > 0", cfg.hyper_every > 0),
            ("mesh_data/mesh_model", bool(cfg.mesh_data or cfg.mesh_model)),
        )
        if on
    ]
    if unported:
        raise NotImplementedError(f"train_onoff_pptr: {unported} not ported to zigp_tpu_torch yet")
    if cfg.optimizer != "adam":
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if model is None:
        model = build_onoff_pptr(cfg, split, device=device, dtype=dtype, use_kernel=use_kernel)
    schedule = cosine_adam(cfg.num_iter) if cfg.lr_schedule == "cosine" else None
    optimizer = make_optimizer(model, default_lr=cfg.indp_lr, schedule=schedule)
    ds = DataSet(split.Xtrain, split.Ytrain)

    ckpt = metric = None
    if workdir:
        os.makedirs(workdir, exist_ok=True)
        if cfg.ckpt_every:
            ckpt = CheckpointManager(os.path.join(workdir, "ckpt_onoff"), every=cfg.ckpt_every)
        metric = MetricLogger(os.path.join(workdir, "metrics_onoff.jsonl"))
    try:
        start_step = 0
        if resume and ckpt is not None:
            restored = ckpt.restore_latest(model, optimizer)
            if restored is not None:
                start_step = restored[2]
                log_fn(f"resumed from checkpoint at step {start_step}")
                # The host stream moves past the batches taken. The device
                # sampler's block index comes from the step; skipping would
                # epoch-shuffle the arrays it gathers from (the JAX runner
                # does, so its resumed device run leaves the uninterrupted
                # trajectory).
                if start_step and cfg.sampler == "host":
                    ds.skip(cfg.batch_size, start_step)
        remaining = cfg.num_iter - start_step
        if remaining <= 0:
            log_fn("checkpoint is already at or past num_iter; nothing to train")
            return FitResult(model=model, optimizer=optimizer)
        if cfg.scan_inner and remaining >= cfg.scan_inner:
            return fit_scanned(
                model,
                ds,
                num_iter=remaining,
                batch_size=cfg.batch_size,
                num_inner=cfg.scan_inner,
                optimizer=optimizer,
                # log_every 0: no loss is read mid-run
                log_every_blocks=max(1, cfg.log_every // cfg.scan_inner) if cfg.log_every else 0,
                log_fn=log_fn,
                start_step=start_step,
                ckpt_manager=ckpt,
                metric_logger=metric,
                hist_every=cfg.hist_every,
                callback=monitor_cb,
                callback_every=cfg.monitor_every if monitor_cb else 0,
                sampler=cfg.sampler,
                sampler_seed=cfg.seed,
            )
        return fit(
            model,
            ds,
            num_iter=remaining,
            batch_size=cfg.batch_size,
            optimizer=optimizer,
            log_every=cfg.log_every,
            log_fn=log_fn,
            ckpt_manager=ckpt,
            start_step=start_step,
        )
    finally:
        if metric is not None:
            metric.close()


# {owner of a predict function: {(function, batch, trailing shape, dtype, device): ChunkGraph}}
_CHUNK_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class ChunkGraph:
    """``predict_fn`` captured once on a static (batch, ·) ``chunk``: its
    fields joined into ``static`` (the graph's output) by ``names`` of
    ``widths``; ``storage`` the data pointers of the owner's parameters and
    buffers at the capture."""

    def __init__(self, graph, chunk, static, names, widths, storage):
        self.graph, self.chunk, self.static, self.names, self.widths, self.storage = (
            graph, chunk, static, names, widths, storage)


def _owner_and_key(predict_fn, batch, X, dtype, device):
    owner = getattr(predict_fn, "__self__", predict_fn)
    key = (getattr(predict_fn, "__func__", predict_fn), batch, tuple(X.shape[1:]), dtype, device)
    return owner, key


def _storage(owner) -> tuple:
    if not isinstance(owner, torch.nn.Module):
        return ()
    return tuple(t.data_ptr() for t in (*owner.parameters(), *owner.buffers()))


def predict_batched(
    predict_fn: Callable,
    X: np.ndarray,
    batch: int = 4096,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, np.ndarray]:
    """Run ``predict_fn`` over X in fixed-shape chunks of ``batch`` rows.

    ``predict_fn(X_chunk)`` returns a NamedTuple or dict of (batch, k)
    tensors. X goes to ``device`` (``None`` = the CUDA card) in one copy, and
    each chunk is copied into one static (batch, D) chunk; the last is padded
    to ``batch`` rows by repeating its last row. The host never waits on the
    card between chunks: the one copy of all results to the host comes at the
    end. Runs under ``torch.inference_mode()``.

    On the card every chunk is one replay of a CUDA graph of ``predict_fn``
    on the static chunk, its fields copied into one preallocated result
    before the next replay overwrites them. The graph is captured once for a
    model (the bound method's owner), function, chunk shape, dtype and
    device, by the first call, whose chunk 0 runs eagerly on a side stream
    (the capture's warm-up; its result is kept); later calls replay it. It
    lives, with its memory pool, as long as the model does. A replay reads
    the parameters' current values, so training and checkpoint restores,
    which write them in place, are seen; a parameter or buffer moved to new
    storage (``model.to``) makes the next call capture again. What the
    function runs is fixed at the capture: to predict with another code path
    (a flag, a patched route), use another model object. A failed capture
    raises."""
    device = resolve_device(device)
    N = X.shape[0]
    if N == 0:
        return {}
    on_card = device.type == "cuda"
    with torch.inference_mode():
        Xd = torch.as_tensor(np.asarray(X), dtype=dtype).to(device)
        cached = None
        if on_card:
            owner, key = _owner_and_key(predict_fn, batch, Xd, dtype, device)
            graphs = _CHUNK_GRAPHS.setdefault(owner, {})
            cached = graphs.get(key)
            if cached is not None and cached.storage != _storage(owner):
                del graphs[key]  # the parameters moved: capture again
                cached = None
        chunk = cached.chunk if cached is not None else torch.empty(
            (batch, *Xd.shape[1:]), dtype=dtype, device=device)

        def stage(start: int) -> int:
            rows = Xd[start : start + batch]
            n = rows.shape[0]
            chunk[:n].copy_(rows)
            if n < batch:
                chunk[n:].copy_(rows[-1:].expand(batch - n, *rows.shape[1:]))
            return n

        def fields():
            res = predict_fn(chunk)
            return res._asdict() if hasattr(res, "_asdict") else dict(res)

        joined = lambda d, names: torch.cat([d[k] for k in names], dim=-1)
        first_end = 0
        if cached is None:
            n = stage(0)
            if on_card:
                from ..ops.cuda.graphs import on_side_stream

                first = on_side_stream(fields)
            else:
                first = fields()
            names = list(first)
            widths = [first[k].shape[-1] for k in names]
            head = joined(first, names)
            out = torch.empty((N, head.shape[-1]), dtype=head.dtype, device=device)
            out[:n].copy_(head[:n])
            first_end = batch
            del first, head
            if on_card:
                from ..ops.cuda.graphs import CountedGraph

                graph = CountedGraph()
                with graph.capture():
                    static = joined(fields(), names)
                cached = graphs[key] = ChunkGraph(graph, chunk, static, names, widths, _storage(owner))
        else:
            names, widths = cached.names, cached.widths
            out = torch.empty((N, cached.static.shape[-1]), dtype=cached.static.dtype, device=device)
        if cached is not None:
            def run():
                cached.graph.replay()
                return cached.static
        else:
            run = lambda: joined(fields(), names)
        for start in range(first_end, N, batch):
            n = stage(start)
            out[start : start + n].copy_(run()[:n])
        host = out.cpu().numpy()
    cols = np.cumsum([0] + widths)
    return {k: host[:, cols[i] : cols[i + 1]] for i, k in enumerate(names)}
