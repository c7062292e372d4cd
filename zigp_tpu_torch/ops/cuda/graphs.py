"""CUDA graphs whose replays count the kernel launches they make.

Each kernel wrapper counts its launches in Python (``.launches`` and its
by-shape or by-n ``Counter``s), where it launches. A graph replay runs no
Python, so ``CountedGraph`` records how the counters changed while its work
was captured, puts them back (a capture launches nothing), and adds that
change on every replay. A run that mixes eager launches and replays then
counts every launch it made, as an eager run would.

The capture runs in ``capture_error_mode="relaxed"``: the kernels' C entry
points call ``cudaFuncSetAttribute`` (the dynamic shared-memory size) before
every launch, which the default "global" mode may refuse while any thread
captures. The attribute does not change between launches, so the graph
holds the same launch as the eager path.
"""

from __future__ import annotations

import time
from collections import Counter
from contextlib import contextmanager

import torch

COUNTER_ATTRS = ("launches_by_n", "launches_by_shape", "launches_by_instance", "launches_by_batch")


def counted_wrappers() -> dict:
    """Every kernel wrapper that counts its launches, by name."""
    from .bf16x3 import bf16x3_mm_cuda
    from .chol_inv import chol_cuda, chol_inv_blocked, chol_inv_cuda
    from .cholesky import batched_small_cholesky_cuda, small_cholesky_cuda
    from .kron_matvec import kron_mv_2_cuda
    from .rbf_gram import rbf_gram_bwd_cuda, rbf_gram_cuda

    return {"rbf_gram": rbf_gram_cuda, "rbf_gram_bwd": rbf_gram_bwd_cuda, "chol_inv": chol_inv_cuda,
            "chol_inv_blocked": chol_inv_blocked,
            "chol": chol_cuda, "small_cholesky": small_cholesky_cuda,
            "batched_small_cholesky": batched_small_cholesky_cuda, "kron_mv_2": kron_mv_2_cuda,
            "bf16x3_mm": bf16x3_mm_cuda}


def snapshot() -> dict:
    """{(wrapper, attribute): value} of every launch counter, copied."""
    out = {}
    for fn in counted_wrappers().values():
        out[(fn, "launches")] = fn.launches
        for attr in COUNTER_ATTRS:
            if hasattr(fn, attr):
                out[(fn, attr)] = Counter(getattr(fn, attr))
    return out


def restore(snap: dict) -> None:
    """Set every counter back to ``snap``, in place."""
    for (fn, attr), value in snap.items():
        if attr == "launches":
            fn.launches = value
        else:
            counter = getattr(fn, attr)
            counter.clear()
            counter.update(value)


def change(before: dict, after: dict) -> dict:
    """What each counter gained from ``before`` to ``after`` (the counters
    only grow), leaving out the ones that did not move."""
    out = {}
    for key, a in after.items():
        b = before[key]
        d = a - b if key[1] == "launches" else Counter({k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)})
        if d:
            out[key] = d
    return out


def add(delta: dict, times: int = 1) -> None:
    for (fn, attr), d in delta.items():
        if attr == "launches":
            fn.launches += times * d
        else:
            counter = getattr(fn, attr)
            for k, v in d.items():
                counter[k] += times * v


def on_side_stream(fn):
    """Run ``fn()`` on a side stream that waits for the current one, and make
    the current stream wait for it: the warm-up ``torch.cuda.graph`` asks for
    before a capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    return out


class CountedGraph:
    """One captured graph, in its own memory pool. ``capture()`` is the
    context to run the work in; ``replay()`` runs it again and counts its kernel launches. After the
    capture: ``capture_ms`` (host time of the capture), ``instantiate_ms``,
    ``pool_bytes`` (device memory the capture reserved) and ``launches``
    (each counter's change in one replay).

    The capture records on a side stream that waits for the current one, as
    ``torch.cuda.graph`` does, without its device synchronise and
    ``empty_cache``: recording runs nothing, and emptying the cache would
    make the eager work around the capture reserve its memory again."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.launches: dict = {}
        self.capture_ms = self.instantiate_ms = float("nan")
        self.pool_bytes = 0

    @contextmanager
    def capture(self):
        reserved = torch.cuda.memory_reserved()
        before = snapshot()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        t0 = time.perf_counter()
        try:
            with torch.cuda.stream(stream):
                self.graph.capture_begin(capture_error_mode="relaxed")
                try:
                    yield
                finally:
                    self.graph.capture_end()
        finally:
            self.launches = change(before, snapshot())
            restore(before)
        torch.cuda.current_stream().wait_stream(stream)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        self.graph.instantiate()
        self.instantiate_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved() - reserved

    def replay(self) -> None:
        self.graph.replay()
        add(self.launches)

    def describe(self) -> str:
        return (f"capture {self.capture_ms:.1f} ms, instantiate {self.instantiate_ms:.1f} ms, "
                f"graph pool {self.pool_bytes / 2**20:.1f} MiB")
