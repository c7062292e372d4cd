"""Runners: the experiments end to end (train → predict → metrics → results
dict and pickle), batched prediction, and the shared training entry.

Counterpart of ``zigp_tpu/experiments/runners.py``:

- ``predict_batched`` (:55-80). On the card each chunk is one replay of a
  CUDA graph captured once per model, method and chunk shape, so the eval
  blocks pass bound methods of the model (``model.predict``,
  ``KronSVGP.predict_latent``, ``KronSVGP.predict_class``), never a new
  closure per call;
- ``_fit_auto`` (:83-290): the scanned or per-step production loop, the
  natural-gradient trainer (``optimizer="natgrad"``) and the
  block-coordinate schedule (``hyper_every``), with ``kind``-scoped
  artifacts (``ckpt_{kind}``, ``metrics_{kind}.jsonl``), so the five
  variants share one fold workdir; ``train_onoff_pptr`` is its on/off
  entry;
- ``run_onoff``, ``run_svgp``, ``run_classifier``, ``run_hurdle`` (the
  two-stage hurdle), ``run_hurdle_joint`` and ``run_zero_inflated``
  (:299-1083), with ``recalibrate_noise`` and the metric blocks;
- ``_restore_model``, ``run_predict`` (restore the latest checkpoint and
  score without training, with ``samples`` predictive draws) and
  ``run_export`` (a standalone ``io.export`` artifact) (:1085-1199).

Every runner takes ``device`` (``None`` = the CUDA card), ``dtype`` and
``use_kernel`` (the ``rbf_gram`` kernel for the factor grams). Training,
prediction and the latent moments run on the device; the y-scale moments
and every metric run on the host in float64 (``utils.metrics``).
"""

from __future__ import annotations

import logging
import os
import pickle
import time
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.config import resolve_device
from ..core.parameters import hyperparam_summary
from ..io.checkpoint import CheckpointManager
from ..io.datasets import Split
from ..io.native import make_dataset
from ..likelihoods import Gamma, Gaussian, LogNormal
from ..models import hurdle_combine, hurdle_on_indices, zero_inflated_combine
from ..training import (
    DataSet,
    FitResult,
    cosine_adam,
    fit,
    fit_natgrad_scanned,
    fit_scanned,
    init_alt_optimizers,
    make_optimizer,
)
from ..utils import metrics
from ..utils.logging import MetricLogger
from ..utils.profiling import span
from .builders import (
    binarize_targets,
    build_classifier_pptr,
    build_hurdle_joint_pptr,
    build_onoff_pptr,
    build_svgp_pptr,
)
from .configs import ClassifierPptrConfig, HurdleJointConfig, OnOffPptrConfig, SvgpPptrConfig

logger = logging.getLogger("zigp")


def _fit_auto(
    model,
    ds: DataSet,
    cfg,
    *,
    learning_rate: float,
    log_fn: Callable[[str], None],
    kind: str,
    workdir: Optional[str] = None,
    resume: bool = False,
    monitor_cb: Optional[Callable] = None,
) -> FitResult:
    """Train ``model`` in place for ``cfg.num_iter`` steps at
    ``cfg.batch_size`` on ``ds`` by ``cfg.sampler``, with per-lr-group Adam
    at ``learning_rate`` (cosine decay over ``cfg.num_iter`` when
    ``cfg.lr_schedule == "cosine"``): ``fit_scanned`` in blocks of
    ``cfg.scan_inner``, or the per-step ``fit`` when ``scan_inner`` is 0 or
    longer than what is left of the run.

    With a ``workdir`` the production machinery is on: checkpoints every
    ``cfg.ckpt_every`` steps in ``workdir/ckpt_{kind}`` with NaN recovery,
    JSONL metrics in ``workdir/metrics_{kind}.jsonl`` (histograms at
    ``cfg.hist_every``), and ``monitor_cb(step, model)`` every
    ``cfg.monitor_every`` steps. ``kind`` scopes the artifacts, so the
    variants of one fold share its workdir without restoring each other's
    checkpoints. ``resume=True`` restores the latest checkpoint in place,
    moves the host sampler's stream past the steps taken (the device
    sampler takes its block index from the step) and trains what is left,
    on the uninterrupted run's trajectory; a checkpoint at or past
    ``cfg.num_iter`` returns without training.

    ``cfg.optimizer == "natgrad"``: ``training.fit_natgrad_scanned`` with
    the config's γ, warm-up, Adam warm-start, ``natgrad_kron_joint`` and KL
    budget, and ``cfg.hyper_every`` groups (device sampler only), with the
    same artifacts; it resumes by itself. ``cfg.hyper_every`` > 0 with Adam:
    the block-coordinate schedule through ``fit_scanned(alternating=...)``,
    a pair of per-partition optimizers (cosine over each partition's own
    update count when ``lr_schedule`` is "cosine") that the checkpoints
    hold; it needs the device sampler and the scanned path. The JAX
    runner's guard rails stop the run with its messages (``SystemExit``).

    ``cfg.mesh_data`` / ``cfg.mesh_model`` (this process one rank of a
    ``torchrun`` launch, ``parallel.initialize`` called): the scanned
    trainer on the mesh, the minibatch split over ``data`` and, with
    ``mesh_model`` > 1, the variational rows and their moments over
    ``model`` (``fit_scanned(mesh=, mesh_tp=)``); natural gradients take
    the data axis only (a warning drops ``mesh_model``); ``hyper_every``
    with a mesh exits; the per-step loop ignores the mesh, with a log line.
    The mesh must be the launch's world (``parallel.make_mesh`` raises
    otherwise, saying how to launch)."""
    if cfg.optimizer not in ("adam", "natgrad"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")

    ckpt = metric = None
    if workdir:
        os.makedirs(workdir, exist_ok=True)
        if cfg.ckpt_every:
            ckpt = CheckpointManager(os.path.join(workdir, f"ckpt_{kind}"), every=cfg.ckpt_every)
        metric = MetricLogger(os.path.join(workdir, f"metrics_{kind}.jsonl"))
    try:
        if cfg.optimizer == "natgrad":
            return _fit_natgrad(model, ds, cfg, learning_rate=learning_rate, log_fn=log_fn, ckpt=ckpt,
                                metric=metric, resume=resume)
        hyper_every = cfg.hyper_every or 0
        if hyper_every:
            if cfg.sampler != "device":
                raise SystemExit("error: --hyper-every requires --sampler device (the alternating q-scan needs "
                                 "HBM-resident data)")
            facs = None
            if cfg.lr_schedule == "cosine":  # each partition's own update count
                facs = (cosine_adam(cfg.num_iter * (hyper_every - 1) // hyper_every),
                        cosine_adam(max(1, cfg.num_iter // hyper_every)))
            optimizer = init_alt_optimizers(model, learning_rate=learning_rate, opt_factories=facs)
        else:
            schedule = cosine_adam(cfg.num_iter) if cfg.lr_schedule == "cosine" else None
            optimizer = make_optimizer(model, default_lr=learning_rate, schedule=schedule)
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
        mesh, mesh_tp = None, False
        n_data, n_model = cfg.mesh_data or 0, cfg.mesh_model or 0
        if n_data or n_model:
            from ..parallel import make_mesh
            from ..parallel.mesh import barrier

            mesh = make_mesh(n_data=n_data or None, n_model=max(1, n_model))
            mesh_tp = n_model > 1
            log_fn(f"mesh: {mesh.shape['data']}-way data parallel"
                   + (f" × {mesh.shape['model']}-way tensor parallel" if mesh_tp else ""))
            if resume:
                barrier()  # every rank has read the checkpoint before rank 0 writes the next
        scanned = cfg.scan_inner and remaining >= cfg.scan_inner
        if hyper_every and not scanned:
            raise SystemExit("error: --hyper-every requires the scanned path (scan_inner > 0 and num_iter >= "
                             "scan_inner)")
        if hyper_every and mesh is not None:
            raise SystemExit("error: --hyper-every does not compose with --mesh-*")
        if scanned:
            return fit_scanned(
                model,
                ds,
                num_iter=remaining,
                batch_size=cfg.batch_size,
                num_inner=cfg.scan_inner,
                optimizer=optimizer,
                alternating=hyper_every,
                # log_every 0: no loss is read mid-run
                log_every_blocks=max(1, cfg.log_every // cfg.scan_inner) if cfg.log_every else 0,
                log_fn=log_fn,
                start_step=start_step,
                ckpt_manager=ckpt,
                metric_logger=metric,
                hist_every=cfg.hist_every,
                callback=monitor_cb,
                callback_every=getattr(cfg, "monitor_every", 0) if monitor_cb else 0,
                sampler=cfg.sampler,
                sampler_seed=cfg.seed,
                mesh=mesh,
                mesh_tp=mesh_tp,
            )
        if mesh is not None:
            log_fn("mesh training requires the scanned path; ignoring mesh for the per-step loop")
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


def _fit_natgrad(model, ds: DataSet, cfg, *, learning_rate: float, log_fn, ckpt, metric, resume: bool) -> FitResult:
    """The natural-gradient route of ``_fit_auto`` (JAX :123-184)."""
    hyper_every = cfg.hyper_every or 0
    if hyper_every and cfg.sampler != "device":
        raise SystemExit("error: --hyper-every with --optimizer natgrad requires --sampler device")
    if hyper_every and cfg.mesh_data:
        raise SystemExit("error: --hyper-every does not compose with --mesh-data under --optimizer natgrad")
    # Data parallelism composes with natgrad; tensor parallelism does not
    # (the factored natural steps need the full variational rows).
    mesh = None
    if cfg.mesh_model and cfg.mesh_model > 1:
        log_fn("warning: tensor parallelism (mesh_model > 1) is not supported with optimizer=natgrad; "
               + ("keeping the requested data parallelism" if cfg.mesh_data else "training single-device"))
    if cfg.mesh_data:
        from ..parallel import make_mesh

        mesh = make_mesh(n_data=cfg.mesh_data, n_model=1)
        log_fn(f"mesh: {mesh.shape['data']}-way data parallel (natgrad)")
    if cfg.natgrad_kron_joint and cfg.q_cov != "kron":
        log_fn("warning: --natgrad-joint requires q_cov='kron'; taking the diagonal-family natural step instead")
    scan_inner = cfg.scan_inner or 50
    return fit_natgrad_scanned(
        model,
        ds,
        num_iter=cfg.num_iter,
        batch_size=cfg.batch_size,
        num_inner=scan_inner,
        gamma=cfg.natgrad_gamma,
        gamma_warmup=cfg.natgrad_warmup,
        adam_warmup=cfg.natgrad_adam_warmup,
        kron_joint=cfg.natgrad_kron_joint,
        kl_cap=cfg.natgrad_kl_cap,  # ≤ 0 disables
        adam_lr=learning_rate,
        log_every_blocks=max(1, (cfg.log_every or 200) // scan_inner),
        log_fn=log_fn,
        ckpt_manager=ckpt,
        metric_logger=metric,
        resume=resume,
        sampler=cfg.sampler,
        sampler_seed=cfg.seed,
        mesh=mesh,
        hyper_every=hyper_every,
    )


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
    data=None,
) -> FitResult:
    """Build the on/off model of ``cfg`` for ``split`` (or take ``model``)
    and train it by ``_fit_auto`` with ``kind="onoff"`` (checkpoints in
    ``workdir/ckpt_onoff``, metrics in ``workdir/metrics_onoff.jsonl``) on
    ``data`` (by default the numpy ``DataSet`` of the split's training
    rows). ``device=None`` is the CUDA card; ``use_kernel`` builds the
    factor grams with the ``rbf_gram`` kernel."""
    if model is None:
        model = build_onoff_pptr(cfg, split, device=device, dtype=dtype, use_kernel=use_kernel)
    ds = data if data is not None else DataSet(split.Xtrain, split.Ytrain)
    return _fit_auto(model, ds, cfg, learning_rate=cfg.indp_lr, log_fn=log_fn, kind="onoff", workdir=workdir,
                     resume=resume, monitor_cb=monitor_cb)


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
    raises. Under a recording ``torch.profiler`` the call is the span
    ``zigp.serve.call`` and its parts are spans of their own
    (``utils.profiling``)."""
    device = resolve_device(device)
    N = X.shape[0]
    if N == 0:
        return {}
    on_card = device.type == "cuda"
    with span("serve.call"), torch.inference_mode():
        with span("serve.rows_in"):
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
        out = names = None
        if cached is not None:
            names, widths = cached.names, cached.widths
            out = torch.empty((N, cached.static.shape[-1]), dtype=cached.static.dtype, device=device)
        elif on_card:
            with span("serve.capture"):
                from ..ops.cuda.graphs import CountedGraph, on_side_stream

                n = stage(0)
                first = on_side_stream(fields)
                names = list(first)
                widths = [first[k].shape[-1] for k in names]
                head = joined(first, names)
                out = torch.empty((N, head.shape[-1]), dtype=head.dtype, device=device)
                out[:n].copy_(head[:n])
                first_end = batch
                del first, head
                graph = CountedGraph()
                with graph.capture():
                    static = joined(fields(), names)
                cached = graphs[key] = ChunkGraph(graph, chunk, static, names, widths, _storage(owner))

        with span("serve.chunks"):
            for start in range(first_end, N, batch):
                with span("serve.chunk"):
                    n = stage(start)
                    if cached is not None:
                        cached.graph.replay()
                        res = cached.static
                    else:  # no graph: every chunk eager, the result sized by the first
                        first = fields()
                        names = names or list(first)
                        widths = [first[k].shape[-1] for k in names]
                        res = joined(first, names)
                        if out is None:
                            out = torch.empty((N, res.shape[-1]), dtype=res.dtype, device=device)
                    out[start : start + n].copy_(res[:n])
        with span("serve.fields_out"):
            host = out.cpu().numpy()
            cols = np.cumsum([0] + widths)
            return {k: host[:, cols[i] : cols[i + 1]] for i, k in enumerate(names)}


# --- the experiment runners ---------------------------------------------------


def _serve(method: Callable, X: np.ndarray) -> Dict[str, np.ndarray]:
    """``predict_batched`` of a bound method of a model, on the model's
    device and in its dtype."""
    p = next(method.__self__.parameters())
    return predict_batched(method, X, device=p.device, dtype=p.dtype)


def _log_hyperparams(model, log_fn) -> None:
    """One line per learned hyperparameter at the end of a run."""
    for name, val in hyperparam_summary(model).items():
        log_fn(f"learned {name} = {np.array2string(val, precision=6)}")


def _maybe_pickle(results: dict, workdir: Optional[str], name: str) -> None:
    """Write ``results`` to ``workdir/name``: rank 0 alone on a mesh."""
    from ..parallel.mesh import is_main_process

    if workdir and is_main_process():
        os.makedirs(workdir, exist_ok=True)
        with open(os.path.join(workdir, name), "wb") as f:
            pickle.dump(results, f)


def _fit_results(res: FitResult) -> dict:
    return {"steps_per_sec": res.steps_per_sec, "losses": res.losses, "interrupted": bool(res.interrupted)}


def run_onoff(
    split: Split,
    cfg: Optional[OnOffPptrConfig] = None,
    *,
    workdir: Optional[str] = None,
    log_fn: Callable[[str], None] = logger.info,
    resume: bool = False,
    device=None,
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
) -> dict:
    """The zero-inflated on/off GP on a pptr split: train on the native
    batcher's batches (``io.native.make_dataset``, as the JAX runner),
    recalibrate the noise when ``cfg.recalibrate_noise``, predict the test
    set, score. With a ``workdir`` and ``cfg.monitor_every`` the inducing
    monitor (``utils.plotting.plot_inducing_monitor``) is drawn every that
    many steps into ``workdir/monitor_<step>.png``; when the run is long
    enough to draw one and matplotlib is missing, the run stops before
    training."""
    cfg = cfg or OnOffPptrConfig()
    monitor_cb = None
    if workdir and getattr(cfg, "monitor_every", 0):
        from ..utils.plotting import plot_inducing_monitor, require_matplotlib

        if cfg.monitor_every <= cfg.num_iter:
            require_matplotlib(f"the inducing monitor (monitor_every {cfg.monitor_every}; 0 turns it off)")

        def monitor_cb(step, m):
            path = os.path.join(workdir, f"monitor_{step:08d}.png")
            plot_inducing_monitor(m, split.Xtrain, split.Ytrain, save_path=path)
            log_fn(f"inducing monitor saved to {path}")

    t0 = time.time()
    res = train_onoff_pptr(cfg, split, device=device, dtype=dtype, use_kernel=use_kernel, log_fn=log_fn,
                           workdir=workdir, resume=resume, monitor_cb=monitor_cb,
                           data=make_dataset(split.Xtrain, split.Ytrain))
    train_time = time.time() - t0
    model = res.model
    _log_hyperparams(model, log_fn)
    if cfg.recalibrate_noise:
        recalibrate_noise(model, split, "onoff", log_fn=log_fn)
    results = _eval_onoff(model, split, log_fn)
    results.update(train_time_sec=train_time, **_fit_results(res))
    _maybe_pickle(results, workdir, "results_onoff.pickle")
    results["model"] = model
    return results


def recalibrate_noise(model, split: Split, kind: str, log_fn=logger.info):
    """Post-hoc likelihood-variance recalibration by train-residual moment
    matching: E[(y − m̂)²] = Var[predictive latent] + σ², so σ²_new =
    mean((y − m̂)² − v̂) over the training set, clipped at 1e-6. The point
    predictions are untouched. The new variance is written into the raw in
    place, so the model's captured chunk graphs stay valid; returns the
    model."""
    if kind == "svgp" and not isinstance(model.likelihood, Gaussian):
        raise ValueError(
            "recalibrate_noise assumes a Gaussian observation model; the "
            f"{type(model.likelihood).__name__} head's noise is not on the y scale"
        )
    y = np.asarray(split.Ytrain)
    if kind == "onoff":
        pt = _serve(model.predict, split.Xtrain)
        resid2 = (y - pt["gfmean"]) ** 2
        latent_var = pt["gfvar"] + pt["gfmeanu"]
    elif kind == "svgp":
        pt = _serve(model.predict_latent, split.Xtrain)
        resid2 = (y - pt["fmean"]) ** 2
        latent_var = pt["fvar"]
    else:
        raise ValueError(f"recalibrate_noise: unsupported kind {kind!r}")
    old = float(model.likelihood.variance.value)
    s2_new = max(float(np.mean(resid2 - latent_var)), 1e-6)
    log_fn(f"recalibrated likelihood variance: {old:.6f} -> {s2_new:.6f}")
    model.likelihood.variance.assign_(s2_new)
    return model


def _eval_onoff(model, split: Split, log_fn) -> dict:
    return _onoff_metrics(model, _serve(model.predict, split.Xtest), split, log_fn)


def _onoff_metrics(model, pred_test: dict, split: Split, log_fn) -> dict:
    """Point metrics of the clipped gated mean and of the hard gate, the
    moment-matched NLPD, the exact gated CRPS (and its 256-draw cross-check)
    and the exceedance scores. An ensemble's mixture (``pred_test`` with
    ``member_preds``, ``experiments.ensemble.mix_onoff_preds``) is scored
    as the mixture of its members' gated predictives."""
    pred_test_clip = np.maximum(pred_test["gfmean"], 0)
    test_rmse = metrics.rmse(pred_test_clip, split.Ytest, clip_at_zero=False)
    test_mae = metrics.mae(pred_test_clip, split.Ytest, clip_at_zero=False)
    log_fn(f"test rmse: {test_rmse}")
    log_fn(f"test mae: {test_mae}")
    # hard gate: zero the prediction wherever the gate says off
    hard = np.where(pred_test["pgmean"] > 0.5, np.maximum(pred_test["fmean"], 0), 0.0)
    test_rmse_hard = metrics.rmse(hard, split.Ytest, clip_at_zero=False)
    test_mae_hard = metrics.mae(hard, split.Ytest, clip_at_zero=False)
    log_fn(f"test rmse (hard gate): {test_rmse_hard}")
    noise = float(model.likelihood.variance.value)
    test_nlpd = metrics.gaussian_nlpd(
        pred_test["gfmean"], pred_test["gfvar"] + pred_test["gfmeanu"], split.Ytest, noise_var=noise
    )
    log_fn(f"test nlpd: {test_nlpd}")
    if "member_preds" in pred_test:  # an ensemble's mixture: score the members' mixture exactly
        samples = metrics.sample_gated_mixture(pred_test["member_preds"], noise_var=noise, num_samples=256, seed=0)
        exc_pred = list(pred_test["member_preds"])
    else:
        samples = metrics.sample_gated_predictive(pred_test, noise_var=noise, num_samples=256, seed=0)
        exc_pred = pred_test
    test_crps = metrics.crps_gated(exc_pred, split.Ytest, noise_var=noise)
    test_crps_mc = metrics.crps_from_samples(samples, split.Ytest)
    test_exceedance = metrics.exceedance_summary_gated(exc_pred, split.Ytest, noise_var=noise)
    log_fn(f"test crps: {test_crps} (mc cross-check {test_crps_mc})")
    return {
        "test_rmse": test_rmse,
        "test_mae": test_mae,
        "test_rmse_hard": test_rmse_hard,
        "test_mae_hard": test_mae_hard,
        "test_nlpd": test_nlpd,
        "test_crps": test_crps,
        "test_crps_mc": test_crps_mc,
        "test_exceedance": test_exceedance,
        "pred_test": pred_test,
    }


def run_svgp(
    split: Split,
    cfg: Optional[SvgpPptrConfig] = None,
    *,
    workdir: Optional[str] = None,
    log_fn: Callable[[str], None] = logger.info,
    resume: bool = False,
    fit_idx: Optional[np.ndarray] = None,
    device=None,
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
) -> dict:
    """Kronecker SVGP regression on a pptr split. ``fit_idx`` restricts the
    training set to those rows of ``split.Xtrain`` while the evaluation
    covers the whole split (the hurdle's positive heads fit on the strictly
    positive targets and predict at every classifier-"on" point)."""
    cfg = cfg or SvgpPptrConfig()
    model = build_svgp_pptr(cfg, split, subset_idx=fit_idx, device=device, dtype=dtype, use_kernel=use_kernel)
    rows = slice(None) if fit_idx is None else fit_idx
    res = _fit_auto(model, DataSet(split.Xtrain[rows], split.Ytrain[rows]), cfg, learning_rate=cfg.lr,
                    log_fn=log_fn, kind="svgp", workdir=workdir, resume=resume)
    _log_hyperparams(model, log_fn)
    if cfg.recalibrate_noise:
        recalibrate_noise(model, split, "svgp", log_fn=log_fn)
    results = _eval_svgp(model, split, log_fn)
    results.update(_fit_results(res))
    _maybe_pickle(results, workdir, "results_svgp.pickle")
    results["model"] = model
    return results


def _eval_svgp(model, split: Split, log_fn) -> dict:
    pred_train = _serve(model.predict_latent, split.Xtrain)
    pred_test = _serve(model.predict_latent, split.Xtest)
    return _svgp_metrics(model, pred_train, pred_test, split, log_fn)


def _amount_head_kw(lik):
    """(head name, its keyword) of an amount or regression likelihood, for
    the metrics of the mixed predictive."""
    if isinstance(lik, LogNormal):
        return "lognormal", {"noise_var": float(lik.variance.value)}
    if isinstance(lik, Gamma):
        return "gamma", {"shape": float(lik.shape.value)}
    return "gaussian", {"noise_var": float(lik.variance.value)}


def _svgp_metrics(model, pred_train: dict, pred_test: dict, split: Split, log_fn) -> dict:
    """For the positive heads the latent is on a log scale: the point
    prediction is the predictive mean E[y] (stamped into the pred dicts as
    ``ymean`` for the hurdle and zi combiners), computed on the host in
    float64 (exp of a latent variance overflows float32), the NLPD is the
    head's own on the true positives, and the lognormal head also reports
    the median's point metrics. CRPS and exceedance score the head's whole
    predictive over the whole test set."""
    lik = model.likelihood
    extras = {}
    if isinstance(lik, (LogNormal, Gamma)):
        head, head_kw = _amount_head_kw(lik)
        moments = metrics.lognormal_mean_var if head == "lognormal" else metrics.gamma_mean_var
        for pred in (pred_train, pred_test):
            pred["ymean"], pred["yvar"] = moments(pred["fmean"], pred["fvar"], **head_kw)
        test_rmse = metrics.rmse(pred_test["ymean"], split.Ytest)
        test_mae = metrics.mae(pred_test["ymean"], split.Ytest)
        # the amount model's density lives on y > 0: NLPD over the true positives
        pos = np.asarray(split.Ytest, dtype=np.float64).reshape(-1) > 0
        fm = np.asarray(pred_test["fmean"]).reshape(-1)[pos]
        fv = np.asarray(pred_test["fvar"]).reshape(-1)[pos]
        ypos = np.asarray(split.Ytest).reshape(-1)[pos]
        if head == "lognormal":
            test_nlpd = metrics.lognormal_nlpd(fm, fv, ypos, **head_kw)
            for pred in (pred_train, pred_test):
                pred["ymedian"] = np.exp(np.asarray(pred["fmean"], dtype=np.float64))
            extras = {
                "test_rmse_median": metrics.rmse(pred_test["ymedian"], split.Ytest),
                "test_mae_median": metrics.mae(pred_test["ymedian"], split.Ytest),
            }
        else:
            test_nlpd = metrics.gamma_nlpd(fm, fv, ypos, **head_kw)
        ones = np.ones(np.asarray(pred_test["fmean"]).reshape(-1).shape[0])
        samples = metrics.sample_hurdle_predictive(
            ones, pred_test["fmean"], pred_test["fvar"], head=head, num_samples=256, seed=0, **head_kw
        )
        extras["test_crps"] = metrics.crps_hurdle(
            ones, pred_test["fmean"], pred_test["fvar"], split.Ytest, head=head, **head_kw
        )
        extras["test_crps_mc"] = metrics.crps_from_samples(samples, split.Ytest)
        extras["test_exceedance"] = metrics.exceedance_summary_hurdle(
            ones, pred_test["fmean"], pred_test["fvar"], split.Ytest, head=head, **head_kw
        )
        extras.update(head_kw)
    else:
        test_rmse = metrics.rmse(pred_test["fmean"], split.Ytest)
        test_mae = metrics.mae(pred_test["fmean"], split.Ytest)
        noise = float(lik.variance.value)
        test_nlpd = metrics.gaussian_nlpd(pred_test["fmean"], pred_test["fvar"], split.Ytest, noise_var=noise)
        # noise_variance lets the zi composite rebuild the predictive
        extras = {
            "test_crps": metrics.crps_gaussian(pred_test["fmean"], pred_test["fvar"], split.Ytest, noise_var=noise),
            "test_exceedance": metrics.exceedance_summary_gaussian(
                pred_test["fmean"], pred_test["fvar"], split.Ytest, noise_var=noise
            ),
            "noise_variance": noise,
        }
    log_fn(f"test rmse: {test_rmse}")
    log_fn(f"test nlpd: {test_nlpd}")
    return {
        "pred_train": pred_train,
        "pred_test": pred_test,
        "test_rmse": test_rmse,
        "test_mae": test_mae,
        "test_nlpd": test_nlpd,
        **extras,
    }


def run_classifier(
    split: Split,
    cfg: Optional[ClassifierPptrConfig] = None,
    *,
    workdir: Optional[str] = None,
    log_fn: Callable[[str], None] = logger.info,
    resume: bool = False,
    device=None,
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
) -> dict:
    """The sparse GP classifier on the binarized pptr targets."""
    cfg = cfg or ClassifierPptrConfig()
    model = build_classifier_pptr(cfg, split, device=device, dtype=dtype, use_kernel=use_kernel)
    res = _fit_auto(model, DataSet(split.Xtrain, binarize_targets(split.Ytrain)), cfg, learning_rate=cfg.lr,
                    log_fn=log_fn, kind="classifier", workdir=workdir, resume=resume)
    _log_hyperparams(model, log_fn)
    results = _eval_classifier(model, split, log_fn)
    results.update(_fit_results(res))
    _maybe_pickle(results, workdir, "results_scgp.pickle")
    results["model"] = model
    return results


def _eval_classifier(model, split: Split, log_fn) -> dict:
    pred_train = _serve(model.predict_class, split.Xtrain)
    pred_test = _serve(model.predict_class, split.Xtest)
    return _classifier_metrics(pred_train, pred_test, split, log_fn)


def _classifier_metrics(pred_train: dict, pred_test: dict, split: Split, log_fn) -> dict:
    results = {"pred_train": pred_train, "pred_test": pred_test}
    for name, pred, actual in (
        ("train", pred_train["pfmean"], binarize_targets(split.Ytrain)),
        ("test", pred_test["pfmean"], binarize_targets(split.Ytest)),
    ):
        results[f"{name}_accuracy"] = metrics.accuracy(pred, actual)
        results[f"{name}_precision"] = metrics.precision(pred, actual)
        results[f"{name}_recall"] = metrics.recall(pred, actual)
        results[f"{name}_auc"] = metrics.roc_auc(pred, actual)
        log_fn(f"{name}: acc {results[f'{name}_accuracy']:.4f} auc {results[f'{name}_auc']:.4f}")
    return results


def run_hurdle(
    split: Split,
    clf_results: dict,
    cfg: Optional[SvgpPptrConfig] = None,
    *,
    workdir: Optional[str] = None,
    log_fn: Callable[[str], None] = logger.info,
    device=None,
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
) -> dict:
    """The two-stage hurdle: an SVGP regression on the classifier's "on"
    subset (``run_classifier``'s results), recombined with the classifier's
    hard labels. A positive head (lognormal, gamma) fits on the strictly
    positive "on" points only and predicts at all of them."""
    cfg = cfg or SvgpPptrConfig()
    train_on_idx = hurdle_on_indices(clf_results["pred_train"]["pfmean"])
    test_on_idx = hurdle_on_indices(clf_results["pred_test"]["pfmean"])
    sub = Split(split.Xtrain[train_on_idx], split.Ytrain[train_on_idx], split.Xtest[test_on_idx],
                split.Ytest[test_on_idx])
    head = (cfg.likelihood or "gaussian").lower()
    fit_idx = None
    if head != "gaussian":
        fit_idx = np.flatnonzero(np.asarray(sub.Ytrain, dtype=np.float64).reshape(-1) > 0)
        log_fn(f"[hurdle] {head} head: fitting on {fit_idx.size}/{sub.Xtrain.shape[0]} strictly-positive 'on' points")
    reg = run_svgp(sub, cfg, log_fn=lambda m: log_fn(f"[hurdle on-subset] {m}"), fit_idx=fit_idx, device=device,
                   dtype=dtype, use_kernel=use_kernel)
    results = _eval_hurdle(split, clf_results, reg, sub, train_on_idx, test_on_idx, log_fn)
    pfmean_test = clf_results["pred_test"]["pfmean"]
    results["test_hurdle_nlpd"] = _hurdle_nlpd(reg["model"], pfmean_test, split)
    log_fn(f"hurdle test nlpd: {results['test_hurdle_nlpd']}")
    results.update(_hurdle_probabilistic_scores(reg["model"], pfmean_test, split))
    log_fn(f"hurdle test crps: {results['test_crps']}")
    results["interrupted"] = bool(reg.get("interrupted", False))
    _maybe_pickle(results, workdir, "results_hurdle.pickle")
    results["model"] = reg["model"]
    return results


def _cond_nlpd_pointwise(lik, fm, fv, y):
    """The amount head's −log q(y | on) at each positive y."""
    head, head_kw = _amount_head_kw(lik)
    fn = {"lognormal": metrics.lognormal_nlpd_pointwise, "gamma": metrics.gamma_nlpd_pointwise,
          "gaussian": metrics.gaussian_nlpd_pointwise}[head]
    return fn(fm, fv, y, **head_kw)


def _hurdle_nlpd(model, pfmean_test, split: Split) -> float:
    """The mixed-measure NLPD of the two-stage hurdle over the whole test
    set: an atom 1−p at y = 0 and density p·q(y | on) on y > 0, the amount
    head predicted at every strictly positive test row."""
    y = np.asarray(split.Ytest, dtype=np.float64).reshape(-1)
    pos = np.flatnonzero(y > 0)
    pred = _serve(model.predict_latent, split.Xtest[pos])
    return metrics.hurdle_nlpd(pfmean_test, _cond_nlpd_pointwise(model.likelihood, pred["fmean"], pred["fvar"],
                                                                  y[pos]), y)


def _hurdle_probabilistic_scores(model, pfmean_test, split: Split) -> dict:
    """CRPS (exact, and its 256-draw cross-check) and exceedance of the
    two-stage hurdle's mixed predictive over the whole test set."""
    pred = _serve(model.predict_latent, split.Xtest)
    head, head_kw = _amount_head_kw(model.likelihood)
    samples = metrics.sample_hurdle_predictive(
        pfmean_test, pred["fmean"], pred["fvar"], head=head, num_samples=256, seed=0, **head_kw
    )
    return {
        "test_crps": metrics.crps_hurdle(pfmean_test, pred["fmean"], pred["fvar"], split.Ytest, head=head,
                                         **head_kw),
        "test_crps_mc": metrics.crps_from_samples(samples, split.Ytest),
        "test_exceedance": metrics.exceedance_summary_hurdle(
            pfmean_test, pred["fmean"], pred["fvar"], split.Ytest, head=head, **head_kw
        ),
    }


def _eval_hurdle(split: Split, clf_results: dict, reg: dict, sub: Split, train_on_idx, test_on_idx, log_fn) -> dict:
    """The hurdle's recombination and point metrics; a positive head's
    ``ymean`` stands for ``fmean``, which is on the log scale."""
    ptr = reg["pred_train"].get("ymean", reg["pred_train"]["fmean"])
    pte = reg["pred_test"].get("ymean", reg["pred_test"]["fmean"])
    train_comb = hurdle_combine(clf_results["pred_train"]["pfmean"], ptr, train_on_idx)
    test_comb = hurdle_combine(clf_results["pred_test"]["pfmean"], pte, test_on_idx)
    results = {
        "train_pred_on_idx": train_on_idx,
        "test_pred_on_idx": test_on_idx,
        "train_hurdle_reg_rmse": metrics.rmse(ptr, sub.Ytrain),
        "test_hurdle_reg_rmse": metrics.rmse(pte, sub.Ytest),
        "train_hurdle_reg_mae": metrics.mae(ptr, sub.Ytrain),
        "test_hurdle_reg_mae": metrics.mae(pte, sub.Ytest),
        "train_pred_hurdle_comb": train_comb,
        "test_pred_hurdle_comb": test_comb,
        "train_hurdle_comb_rmse": metrics.rmse(train_comb, split.Ytrain),
        "test_hurdle_comb_rmse": metrics.rmse(test_comb, split.Ytest),
        "train_hurdle_comb_mae": metrics.mae(train_comb, split.Ytrain),
        "test_hurdle_comb_mae": metrics.mae(test_comb, split.Ytest),
    }
    log_fn(f"hurdle test rmse: {results['test_hurdle_comb_rmse']}")
    return results


def run_hurdle_joint(
    split: Split,
    cfg: Optional[HurdleJointConfig] = None,
    *,
    workdir: Optional[str] = None,
    log_fn: Callable[[str], None] = logger.info,
    resume: bool = False,
    device=None,
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
) -> dict:
    """The jointly trained hurdle (``models.KronHurdleSVGP``): gate and
    amount GP in one ELBO and one training run, no classifier first."""
    cfg = cfg or HurdleJointConfig()
    model = build_hurdle_joint_pptr(cfg, split, device=device, dtype=dtype, use_kernel=use_kernel)
    res = _fit_auto(model, DataSet(split.Xtrain, split.Ytrain), cfg, learning_rate=cfg.lr, log_fn=log_fn,
                    kind="hurdlej", workdir=workdir, resume=resume)
    _log_hyperparams(model, log_fn)
    results = _eval_hurdle_joint(model, split, log_fn)
    results.update(_fit_results(res))
    _maybe_pickle(results, workdir, "results_hurdlej.pickle")
    results["model"] = model
    return results


def _amount_ymean(lik, fmean, fvar) -> np.ndarray:
    """The amount head's y-scale predictive mean, numpy float64."""
    head, head_kw = _amount_head_kw(lik)
    if head == "lognormal":
        return metrics.lognormal_mean_var(fmean, fvar, **head_kw)[0]
    if head == "gamma":
        return metrics.gamma_mean_var(fmean, fvar, **head_kw)[0]
    return np.asarray(fmean, dtype=np.float64)


def _hurdlej_predict(model, X: np.ndarray) -> dict:
    """The joint hurdle's gate probability and amount latent at X."""
    pred = _serve(model.predict, X)
    return {k: pred[k] for k in ("p_on", "fmean", "fvar")}


def _eval_hurdle_joint(model, split: Split, log_fn) -> dict:
    pred_train = _hurdlej_predict(model, split.Xtrain)
    pred_test = _hurdlej_predict(model, split.Xtest)
    return _hurdlej_metrics(model, pred_train, pred_test, split, log_fn)


def _hurdlej_metrics(model, pred_train: dict, pred_test: dict, split: Split, log_fn) -> dict:
    """Hard-gated and probability-weighted point predictions, the
    mixed-measure NLPD, CRPS and exceedance, and the gate's classification
    metrics, under the two-stage hurdle's names where they coincide."""
    lik = model.amount_likelihood
    for pred in (pred_train, pred_test):
        pred["ymean"] = _amount_ymean(lik, pred["fmean"], pred["fvar"]).reshape(pred["fmean"].shape)
        p = np.asarray(pred["p_on"], dtype=np.float64)
        pred["comb_hard"] = np.where(p > 0.5, pred["ymean"], 0.0)
        pred["comb_prob"] = p * pred["ymean"]
    y = np.asarray(split.Ytest, dtype=np.float64).reshape(-1)
    pos = np.flatnonzero(y > 0)
    fm = np.asarray(pred_test["fmean"]).reshape(-1)[pos]
    fv = np.asarray(pred_test["fvar"]).reshape(-1)[pos]
    cond = _cond_nlpd_pointwise(lik, fm, fv, y[pos])
    head, head_kw = _amount_head_kw(lik)
    samples = metrics.sample_hurdle_predictive(
        pred_test["p_on"], pred_test["fmean"], pred_test["fvar"], head=head, num_samples=256, seed=0, **head_kw
    )
    Ytest_b = binarize_targets(split.Ytest)
    results = {
        "pred_train": pred_train,
        "pred_test": pred_test,
        "test_pred_hurdle_comb": pred_test["comb_hard"],
        "test_hurdle_comb_rmse": metrics.rmse(pred_test["comb_hard"], split.Ytest),
        "test_hurdle_comb_mae": metrics.mae(pred_test["comb_hard"], split.Ytest),
        "test_hurdle_prob_rmse": metrics.rmse(pred_test["comb_prob"], split.Ytest),
        "test_hurdle_prob_mae": metrics.mae(pred_test["comb_prob"], split.Ytest),
        "test_hurdle_nlpd": metrics.hurdle_nlpd(pred_test["p_on"], cond, y),
        "test_crps": metrics.crps_hurdle(pred_test["p_on"], pred_test["fmean"], pred_test["fvar"], split.Ytest,
                                         head=head, **head_kw),
        "test_crps_mc": metrics.crps_from_samples(samples, split.Ytest),
        "test_exceedance": metrics.exceedance_summary_hurdle(
            pred_test["p_on"], pred_test["fmean"], pred_test["fvar"], split.Ytest, head=head, **head_kw
        ),
        "test_gate_accuracy": metrics.accuracy(pred_test["p_on"], Ytest_b),
        "test_gate_auc": metrics.roc_auc(pred_test["p_on"], Ytest_b),
    }
    log_fn(f"hurdle-joint test rmse: {results['test_hurdle_comb_rmse']}")
    log_fn(f"hurdle-joint test nlpd: {results['test_hurdle_nlpd']}")
    log_fn(f"hurdle-joint gate acc {results['test_gate_accuracy']:.4f} auc {results['test_gate_auc']:.4f}")
    return results


def run_zero_inflated(
    split: Split,
    clf_results: dict,
    reg_results: dict,
    *,
    workdir: Optional[str] = None,
    log_fn: Callable[[str], None] = logger.info,
) -> dict:
    """The zero-inflated GPC × GPR product composite of ``run_classifier``'s
    and ``run_svgp``'s results (``ymean`` over ``fmean`` where the
    regression carries it). With a Gaussian regression head its proper
    scores read the product as the mixed measure it implies: an atom at 0
    with probability 1 − p, else the SVGP's predictive."""
    reg_tr, reg_te = reg_results["pred_train"], reg_results["pred_test"]
    train = zero_inflated_combine(clf_results["pred_train"]["pfmean"], reg_tr.get("ymean", reg_tr["fmean"]))
    test = zero_inflated_combine(clf_results["pred_test"]["pfmean"], reg_te.get("ymean", reg_te["fmean"]))
    results = {
        "pred_train_zi_prob": train.pred_prob,
        "pred_test_zi_prob": test.pred_prob,
        "pred_train_zi_indc": train.pred_indicator,
        "pred_test_zi_indc": test.pred_indicator,
        "train_zi_prob_reg_rmse": metrics.rmse(train.pred_prob, split.Ytrain),
        "test_zi_prob_reg_rmse": metrics.rmse(test.pred_prob, split.Ytest),
        "train_zi_prob_reg_mae": metrics.mae(train.pred_prob, split.Ytrain),
        "test_zi_prob_reg_mae": metrics.mae(test.pred_prob, split.Ytest),
        "train_zi_indc_reg_rmse": metrics.rmse(train.pred_indicator, split.Ytrain),
        "test_zi_indc_reg_rmse": metrics.rmse(test.pred_indicator, split.Ytest),
        "train_zi_indc_reg_mae": metrics.mae(train.pred_indicator, split.Ytrain),
        "test_zi_indc_reg_mae": metrics.mae(test.pred_indicator, split.Ytest),
    }
    if "noise_variance" in reg_results and "fvar" in reg_te:
        p_on = np.asarray(clf_results["pred_test"]["pfmean"]).reshape(-1)
        noise = float(reg_results["noise_variance"])
        samples = metrics.sample_hurdle_predictive(
            p_on, reg_te["fmean"], reg_te["fvar"], head="gaussian", noise_var=noise, num_samples=256, seed=0
        )
        results["test_crps"] = metrics.crps_hurdle(
            clf_results["pred_test"]["pfmean"], reg_te["fmean"], reg_te["fvar"], split.Ytest, head="gaussian",
            noise_var=noise,
        )
        results["test_crps_mc"] = metrics.crps_from_samples(samples, split.Ytest)
        results["test_exceedance"] = metrics.exceedance_summary_hurdle(
            clf_results["pred_test"]["pfmean"], reg_te["fmean"], reg_te["fvar"], split.Ytest, head="gaussian",
            noise_var=noise,
        )
        log_fn(f"zi test crps: {results['test_crps']}")
    log_fn(f"zi prob test rmse: {results['test_zi_prob_reg_rmse']}")
    _maybe_pickle(results, workdir, "results_zi.pickle")
    return results


# --- restore-and-predict and export -------------------------------------------


def _restore_model(split: Split, kind: str, cfg, workdir: str, log_fn, *, device=None,
                   dtype: torch.dtype = torch.float32, use_kernel: bool = False):
    """Rebuild the ``kind`` model of ``cfg`` (the kind's default config when
    None; it must match the training run's model shape) on ``device`` and
    restore the latest checkpoint of ``workdir/ckpt_{kind}`` into it, in
    place. Returns (model, step, its eval block)."""
    builders = {
        "onoff": (build_onoff_pptr, OnOffPptrConfig, _eval_onoff),
        "svgp": (build_svgp_pptr, SvgpPptrConfig, _eval_svgp),
        "classifier": (build_classifier_pptr, ClassifierPptrConfig, _eval_classifier),
        "hurdlej": (build_hurdle_joint_pptr, HurdleJointConfig, _eval_hurdle_joint),
    }
    if kind not in builders:
        raise SystemExit(f"error: unknown predict kind {kind!r} (onoff|svgp|classifier|hurdlej)")
    build, default_cfg, evaluate = builders[kind]
    model = build(cfg or default_cfg(), split, device=device, dtype=dtype, use_kernel=use_kernel)
    ckpt_dir = os.path.join(workdir, f"ckpt_{kind}")
    restored = CheckpointManager(ckpt_dir).restore_latest(model, None)
    if restored is None:
        raise SystemExit(f"error: no checkpoint under {ckpt_dir} — train '{kind}' with this --workdir first")
    model, _, step = restored
    log_fn(f"restored {kind} checkpoint at step {step}")
    _log_hyperparams(model, log_fn)
    return model, step, evaluate


def run_export(
    split: Split,
    kind: str,
    cfg=None,
    *,
    workdir: str,
    out: Optional[str] = None,
    batch_size: Optional[int] = None,
    log_fn: Callable[[str], None] = logger.info,
    device=None,
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
) -> str:
    """Restore the latest ``kind`` checkpoint and write a standalone serving
    artifact (``io.export``: ``torch.export`` of the model's predict, the
    parameters in the program, a symbolic batch unless ``batch_size`` pins
    it), traced on ``device``: on the card it calls the kernels. Returns the
    artifact's path (default ``workdir/export_{kind}.zigp``)."""
    from ..io.export import export_predictor

    model, step, _ = _restore_model(split, kind, cfg, workdir, log_fn, device=device, dtype=dtype,
                                    use_kernel=use_kernel)
    out = out or os.path.join(workdir, f"export_{kind}.zigp")
    export_predictor(model, kind, int(split.Xtrain.shape[1]), out, batch_size=batch_size)
    log_fn(f"exported {kind} (checkpoint step {step}) to {out}")
    return out


def run_predict(
    split: Split,
    kind: str,
    cfg=None,
    *,
    workdir: str,
    log_fn: Callable[[str], None] = logger.info,
    samples: int = 0,
    sample_seed: int = 0,
    device=None,
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
) -> dict:
    """Restore the latest ``kind`` checkpoint in ``workdir`` (the model only:
    checkpoints of any optimizer predict alike) and run the training
    runner's predict and metric block, without training. ``kind``: "onoff",
    "svgp", "classifier" or "hurdlej"; ``cfg`` must match the training
    config's model shape.

    ``samples`` > 0 also draws that many predictive samples per test point
    into ``results["y_samples"]`` (S, N, 1), from a ``torch.Generator`` on
    the model's device seeded with ``sample_seed``: the gated y* for onoff and
    hurdlej, f* pushed through the likelihood's ``sample_y`` for svgp (f* + ε
    for the Gaussian head, as the JAX runner draws it), Bernoulli labels
    (uniform < p) for the classifier. Writes ``predictions_<kind>.pickle``
    into ``workdir``."""
    model, step, evaluate = _restore_model(split, kind, cfg, workdir, log_fn, device=device, dtype=dtype,
                                           use_kernel=use_kernel)
    results = evaluate(model, split, log_fn)
    results["restored_step"] = step
    if samples:
        p = next(model.parameters())
        gen = torch.Generator(device=p.device)
        gen.manual_seed(sample_seed)
        Xte = torch.as_tensor(np.asarray(split.Xtest), dtype=p.dtype, device=p.device)
        with torch.no_grad():
            if kind in ("onoff", "hurdlej"):
                s = model.predict_y_samples(gen, Xte, samples)
            elif kind == "svgp":
                s = model.likelihood.sample_y(gen, model.predict_f_samples(gen, Xte, samples))
            else:  # classifier
                prob = model.predict_prob(Xte)[0]
                u = torch.rand((samples, *prob.shape), generator=gen, dtype=prob.dtype, device=prob.device)
                s = (u < prob[None]).to(prob.dtype)
        results["y_samples"] = s.cpu().numpy()
        log_fn(f"drew {samples} predictive samples per point: {results['y_samples'].shape}")
    _maybe_pickle(results, workdir, f"predictions_{kind}.pickle")
    results["model"] = model
    return results
