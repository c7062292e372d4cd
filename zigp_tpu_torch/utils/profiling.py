"""Profiling: ``torch.profiler`` traces and per-call timing that waits for the card.

Counterpart of ``zigp_tpu/utils/profiling.py``. ``trace(logdir)`` records a
``torch.profiler`` trace of a block (CPU operators, and the CUDA kernels
when a card is present) and writes it as Chrome-trace JSON into ``logdir``
(``utils.xprof`` reads it; Perfetto and chrome://tracing open it);
``time_fn`` times a callable with ``torch.cuda.synchronize`` around the
timed calls, where the JAX module has ``block_until_ready``, so work queued
on the card cannot hide behind the launches.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Tuple

import torch

TRACE_SUFFIX = ".pt.trace.json"


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` trace around a block; on exit it is
    written to ``logdir/trace_<pid>_<ns>.pt.trace.json``. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}{TRACE_SUFFIX}"))


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 50) -> Tuple[float, object]:
    """(seconds per call, last result) of ``fn(*args)`` after ``warmup``
    untimed calls (builds and captures excluded), the card synchronised
    before and after the timed calls."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters, out


class StepTimer:
    """Rolling steps/s with the first step (builds, captures) excluded: the
    first ``tick`` waits for the card and starts the clock; each later one
    counts a step and returns the rate so far."""

    def __init__(self):
        self.t0 = None
        self.steps = 0

    def tick(self, result=None) -> float:
        if self.t0 is None:
            if result is not None:
                _sync()
            self.t0 = time.perf_counter()
            return 0.0
        self.steps += 1
        return self.steps / (time.perf_counter() - self.t0)
