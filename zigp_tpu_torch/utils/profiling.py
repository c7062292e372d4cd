"""Profiling: ``torch.profiler`` traces and the program's spans in them.

Counterpart of ``zigp_tpu/utils/profiling.py``. ``trace(logdir)`` records a
``torch.profiler`` trace of a block (CPU operators, and the CUDA kernels
when a card is present) and writes it as Chrome-trace JSON into ``logdir``
(``utils.xprof`` reads it; Perfetto and chrome://tracing open it).

``span(name)`` marks a stretch of the program's own work in whatever
``torch.profiler`` session is recording: a range named ``zigp.<name>``,
recorded as an operator (torch's ``_RecordFunctionFast``, category
``cpu_op`` in the Chrome trace, beside the ``aten::`` operators; it makes
no Python range object, so it costs about a seventh of a
``record_function``: 2.0-2.3 µs against 14.1-14.6 on an H100 host), on the
profiler's clock beside the kernels it launched, nested by time in the span
that encloses it. With no session recording it is one shared null context.
The spans the program opens:

- ``zigp.train.block``: one block of ``training.fit_scanned``; inside it
  ``train.fill`` (the block's minibatches staged), ``train.replay`` (one
  graph replay) or ``train.eager`` (a block run eagerly: the capture's
  warm-up, or no graph), ``train.sync`` (a host read of a loss: the first
  block's, the capture's, a log point's, a checkpoint boundary's),
  ``train.log`` (the log line, the KL, the metric logger),
  ``train.checkpoint`` and ``train.callback`` (the caller's ``callback``);
  ``train.capture`` around the block's graph capture, and ``train.sync``
  around the final read of the losses;
- ``zigp.serve.call``: one ``experiments.runners.predict_batched`` call;
  inside it ``serve.rows_in`` (the rows to the device), ``serve.capture``
  (the first call's eager chunk and graph capture), ``serve.chunks`` (the
  chunk loop, one ``serve.chunk`` a chunk: stage, replay, copy into the
  result) and ``serve.fields_out`` (the result to the host, split into
  fields).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE_SUFFIX = ".pt.trace.json"
SPAN_PREFIX = "zigp."
_OFF = contextlib.nullcontext()
_range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """``zigp.<name>`` in the recording ``torch.profiler`` session, or,
    with none recording, a shared null context: one branch on torch's
    Python-side flag, which ``torch.profiler.profile`` sets while it
    records. Never inside a captured graph's body, and never with an
    argument that waits on the card."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _range(SPAN_PREFIX + name)


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
