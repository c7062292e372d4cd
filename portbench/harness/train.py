"""A training cell: ``fit_scanned``'s graphed blocks as the program's
``experiments.runners.train_onoff_pptr`` drives them, timed over a window.

Set-up builds the model from the seed's inputs and starts one
``train_onoff_pptr`` call (device sampler, blocks of ``scan_inner``, a loss
read at the mix's log points, no checkpoints). Its first block runs
eagerly (the capture's warm-up), its graph is captured, and its second
block is the first replay; the window opens at the boundary after it, once
the card has finished, so nothing compiles or captures inside it. At every
block boundary the runner's monitor callback looks at the clock; the first
boundary past ``--seconds`` (and past the traced stretch, with
``--trace 1``) stops the run by the ``KeyboardInterrupt`` that
``fit_scanned`` honours between blocks, and the window closes when the last
block's losses are on the host. The rate is the optimizer steps enqueued in
the window over its length.

The correctness check follows the same call, in two stretches of it:

- the start: a global optimizer hook copies the first moment after step 1
  and the parameters after step 3 of the eager first block (steps of the
  run itself, on its own batches), and removes itself; the program's KL
  at the initial state, read before the run, takes the first loss apart
  into its data term;
- the first replayed block, the window's own graph: at the boundary
  before it the monitor callback copies the parameters, Adam's moments and
  step count and the program's KL there; at the boundary after it, the
  parameters. That block's losses are the run's own.

Once the window has closed and the program's state is freed, the
reference (``reference.onoff``) redraws the sampler's rows of blocks 0 and
1, takes the start's three Adam steps from the benchmark's inputs, and
follows the replayed block's K steps from the program's state at its
boundary (a replay can be judged only from the state it started from), all
in float64, and is compared (``harness.compare``).
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from . import compare, data as D, program
from .trace import Stretch, TraceView, warm_profiler

BETA1 = 0.9


class FirstSteps:
    """A global optimizer step hook over the run's first three steps. It
    keeps the optimizer, whose state a replay updates in place."""

    def __init__(self, model, log, t_process: float):
        from torch.optim.optimizer import register_optimizer_step_post_hook

        self.log, self.t_process = log, t_process
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.count = 0
        self.opt = self.m1 = self.theta3 = None
        self.handle = register_optimizer_step_post_hook(self.hook)

    def hook(self, opt, args, kwargs):
        self.count += 1
        self.opt = opt
        if self.count in (1, 3):
            self.log(f"set-up: step {self.count} taken at {time.perf_counter() - self.t_process:.3f} s")
        params = [p for g in opt.param_groups for p in g["params"]]
        if self.count == 1:
            self.m1 = {self.names[id(p)]: opt.state[p]["exp_avg"].detach().clone() for p in params}
        if self.count == 3:
            self.theta3 = {self.names[id(p)]: p.detach().clone() for p in params}
            self.remove()

    def remove(self):
        if self.handle is not None:
            self.handle.remove()
            self.handle = None


def program_kl(model) -> float:
    """The program's KL at its current parameters (``prior_kl``, the
    same reading ``fit_scanned`` takes apart from the loss at its log
    points)."""
    with torch.no_grad():
        return float(model.prior_kl())


def boundary_state(model, opt) -> dict:
    """The program's state at a block boundary, on the host: its raws,
    Adam's moments and step count (zero for a raw Adam does not hold) and
    its KL there."""
    names = {id(p): n for n, p in model.named_parameters()}
    raws = {n: _host(p) for n, p in model.named_parameters()}
    m = {n: np.zeros_like(v) for n, v in raws.items()}
    v = {n: np.zeros_like(x) for n, x in raws.items()}
    t = 0
    for group in opt.param_groups if opt is not None else []:
        for p in group["params"]:
            st = opt.state[p]
            m[names[id(p)]] = _host(st["exp_avg"])
            v[names[id(p)]] = _host(st["exp_avg_sq"])
            t = int(float(st["step"]))
    return {"raws": raws, "m": m, "v": v, "t": t, "kl": program_kl(model)}


class Window:
    """The monitor callback: opens the window after the first replay,
    profiles ``stretch_blocks`` blocks from 40 % of it with ``trace``, and
    stops the run at the first block boundary past ``seconds``."""

    def __init__(self, seconds: float, num_inner: int, device, stretch_blocks: int, log, t_process: float,
                 first: FirstSteps):
        self.seconds, self.K, self.device = seconds, num_inner, device
        self.first = first
        self.boundary = self.after = None  # the program's state around the first replayed block
        self.log, self.t_process = log, t_process
        self.start = self.start_step = self.final_step = None
        self.stretch = Stretch(device) if stretch_blocks else None
        self.stretch_blocks = stretch_blocks
        self.stretch_step = None
        self.stretch_steps = 0
        self.marks = []  # (host time, step) at each boundary of the window

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def callback(self, step, model):
        if self.start is None:
            if step == self.K:
                self.log(f"set-up: eager block and capture done at {time.perf_counter() - self.t_process:.3f} s")
                self.boundary = boundary_state(model, self.first.opt)
            if step >= 2 * self.K:  # the eager block and the first replay are done
                self._sync()
                self.after = {n: _host(p) for n, p in model.named_parameters()}
                self.log(f"set-up: first replay done at {time.perf_counter() - self.t_process:.3f} s")
                self.start, self.start_step = time.perf_counter(), step
            return
        elapsed = time.perf_counter() - self.start
        self.marks.append((elapsed, step))
        s = self.stretch
        if s is not None:
            if self.stretch_step is None and elapsed >= 0.4 * self.seconds:
                s.start()
                self.stretch_step = step
            elif self.stretch_step is not None and s.events is None and step - self.stretch_step >= self.stretch_blocks * self.K:
                s.stop()
                self.stretch_steps = step - self.stretch_step
        if elapsed >= self.seconds and (s is None or s.events is not None):
            self.final_step = step
            raise KeyboardInterrupt


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def block_batches(inputs, B: int, K: int, sampler_seed: int, block: int, count: int, dtype, device) -> list:
    """The first ``count`` batches (X, Y) of the device sampler's block
    ``block``, redrawn from its seed: all K·B indices of the block from
    one generator seeded with the pair (seed, block)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((sampler_seed & 0xFFFFFFFF) << 32) | (block & 0xFFFFFFFF))
    N = inputs.Xtrain.shape[0]
    idx = torch.randint(0, N, (K * B,), generator=gen, device=device)
    Xt = torch.as_tensor(inputs.Xtrain, dtype=dtype, device=device)
    Yt = torch.as_tensor(inputs.Ytrain, dtype=dtype, device=device)
    return [(Xt[idx[k * B : (k + 1) * B]], Yt[idx[k * B : (k + 1) * B]]) for k in range(count)]


def reference_readings(cell, inputs, state, sampler_seed: int, device, boundary=None, *, dtype=torch.float64,
                       bulk="exact", factor="exact", batch_fault=None, replay_block: int = 1):
    """The reference's readings on the host: {"start": its three steps from
    the benchmark's inputs on block 0's first batches ({"losses", "data",
    "grad", "delta", "data_leaves"}), "replay": with ``boundary`` (the
    program's state before the first replayed block, ``boundary_state``)
    block 1's K steps from there ({"losses", "data", "delta"})}.
    ``batch_fault``: a function of the (X, Y) batch that the reference's
    loss takes in its place, ``replay_block`` the block whose rows the
    replayed block takes (the fault readings plant them here)."""
    from ..reference import onoff as R

    cfg, traffic = cell.config, cell.traffic
    B, K = int(cfg["batch_size"]), int(traffic["scan_inner"])
    fault = batch_fault or (lambda X, Y: (X, Y))
    ref = R.OnOffReference(cfg, inputs.Xtrain.shape[0], bulk=bulk, factor=factor)
    lrs = R.learning_rates(cfg)
    raws0 = R.initial_raws(state, dtype, device)
    batches = [fault(X, Y) for X, Y in block_batches(inputs, B, K, sampler_seed, 0, 3, dtype, device)]
    st = R.train_steps(ref, raws0, batches, lrs)
    out = {"start": {"losses": st["losses"], "data": st["data"], "data_leaves": st["data_leaves"],
                     "grad": {n: _host(g) for n, g in st["grad"].items()},
                     "delta": {n: _host(st["raws"][n] - raws0[n]) for n in raws0}}}
    if boundary is not None:
        on = lambda d: {n: torch.as_tensor(a, dtype=dtype, device=device) for n, a in d.items()}
        rawsK = on(boundary["raws"])
        batches = [fault(X, Y) for X, Y in block_batches(inputs, B, K, sampler_seed, replay_block, K, dtype, device)]
        rp = R.train_steps(ref, rawsK, batches, lrs, moments=(on(boundary["m"]), on(boundary["v"])),
                           t0=boundary["t"])
        out["replay"] = {"losses": rp["losses"], "data": rp["data"],
                         "delta": {n: _host(rp["raws"][n] - rawsK[n]) for n in rawsK}}
    return out


def inputs_of(cell, seed: int):
    cfg = cell.config
    d = D.pptr(cfg["data"], seed)
    Zs = D.grid_factors(cfg, d, seed)
    return d, D.train_state(cfg, Zs, seed), D.derived_seed(seed, D.SAMPLER)


def run(cell, seed: int, seconds: float, trace: bool, device, t_process: float, log=None) -> dict:
    from zigp_tpu_torch.experiments.configs import OnOffPptrConfig
    from zigp_tpu_torch.experiments.runners import train_onoff_pptr
    from zigp_tpu_torch.training import DataSet

    log = log or (lambda s: print(s, file=sys.stderr))
    cfg, traffic = cell.config, cell.traffic
    K, B = int(traffic["scan_inner"]), int(cfg["batch_size"])
    d, state, sampler_seed = inputs_of(cell, seed)
    log(f"set-up: inputs made at {time.perf_counter() - t_process:.3f} s")
    if trace:
        warm_profiler(device)
    with program.solve_precision(traffic["solve_precision"]):
        model = program.build_model(cfg, state, d.Xtrain.shape[0], device)
        raws0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        kl0 = program_kl(model)
        first = FirstSteps(model, log, t_process)
        window = Window(seconds, K, device, int(traffic["stretch_blocks"]) if trace else 0, log, t_process, first)
        log(f"set-up: model built at {time.perf_counter() - t_process:.3f} s")
        run_cfg = OnOffPptrConfig(
            num_iter=10**9, batch_size=B, scan_inner=K, log_every=int(traffic["log_every"]),
            sampler=traffic["sampler"], seed=sampler_seed, monitor_every=K, ckpt_every=0,
            kern_lr=cfg["lr"]["kern"], indp_lr=cfg["lr"]["indp"])
        try:
            res = train_onoff_pptr(run_cfg, None, model=model, data=DataSet(d.Xtrain, d.Ytrain),
                                   monitor_cb=window.callback, log_fn=log)
        finally:
            first.remove()
        t_end = time.perf_counter()
    if window.start is None or window.final_step is None or window.boundary is None:
        raise RuntimeError("the training run ended before its window closed")
    steps = window.final_step - window.start_step
    quarters = [m for m in window.marks if m[0] > 0]
    if len(quarters) >= 8:
        edges = [quarters[len(quarters) * i // 4] for i in range(4)] + [quarters[-1]]
        rates = [(b[1] - a[1]) / (b[0] - a[0]) for a, b in zip(edges, edges[1:])]
        log("window: steps/s by quarter, host clock at block boundaries: " + " ".join(f"{r:.1f}" for r in rates))
    losses = res.step_losses.numpy().astype(np.float64)
    failed = int(np.sum(~np.isfinite(losses[window.start_step : window.final_step])))
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    # A program whose optimizer took fewer than three steps is read as it
    # stands: no first moment is a zero one, no third step the state at the end.
    m1 = first.m1 or {n: torch.zeros_like(p) for n, p in raws0.items()}
    theta3 = first.theta3 or {n: p.detach().clone() for n, p in model.named_parameters()}
    boundary, after = window.boundary, window.after
    prog = {"start": {"losses": [float(x) for x in losses[:3]], "data": float(losses[0]) - kl0,
                      "grad": {n: _host(m) / (1.0 - BETA1) for n, m in m1.items()},
                      "delta": {n: _host(theta3[n] - raws0[n]) for n in raws0}},
            "replay": {"losses": [float(x) for x in losses[K : K + 3]], "data": float(losses[K]) - boundary["kl"],
                       "delta": {n: after[n] - boundary["raws"][n] for n in after}}}
    out = {
        "metrics": {
            "train_steps_per_s": steps / (t_end - window.start),
            "setup_s": window.start - t_process,
        },
        "attempted": steps, "failed": failed, "memory_peak_bytes": int(memory_peak),
        "stretch": None,
    }
    if window.stretch is not None:
        out["stretch"] = dict(view=TraceView(window.stretch.events), census=window.stretch.census,
                              steps=window.stretch_steps)
    del model, res, first, window, raws0, m1, theta3
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_readings(cell, d, state, sampler_seed, device, boundary)
    log(f"check: the reference's {3 + K} steps took {time.perf_counter() - t_ref:.3f} s")
    out["numbers"] = compare.train_numbers(prog, ref, **cell.numbers)
    out["readings"] = {"program": prog, "reference": ref, "boundary": boundary}
    return out
