"""The traced stretch and its reading.

``Stretch`` profiles one fixed short stretch of a window with
``torch.profiler`` (CPU and CUDA activities): it waits for the card, copies
the program's launch counters, starts the profiler and opens the span
``portbench.stretch``; ``stop`` waits for the card again, closes both,
writes the Chrome trace to a temporary file under ``TMPDIR``, reads it and
deletes it. The harness's own spans (``portbench.call`` …) are
``record_function`` ranges opened around its calls into the program.

``TraceView`` reads the trace's complete events: the device's (kernels,
copies, sets) clipped to the stretch, their union (busy time), the
families (``harness.families``), the harness's spans, and the host's
operations that name an idle gap.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import families

STRETCH = "portbench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def warm_profiler(device) -> None:
    """One tiny profile in set-up, so the stretch's profiler starts warm."""
    import torch

    with torch.profiler.profile(activities=_activities(device)):
        (torch.ones(8, device=device) + 1).sum().item()


def _activities(device):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stretch:
    def __init__(self, device):
        self.device = device
        self.events: Optional[List[dict]] = None
        self.census: Dict = {}

    def start(self) -> None:
        import torch

        from . import program

        _sync(self.device)
        self.before = program.counters()
        self.prof = torch.profiler.profile(activities=_activities(self.device))
        self.prof.__enter__()
        self.span = torch.profiler.record_function(STRETCH)
        self.span.__enter__()

    def stop(self) -> None:
        from . import program

        _sync(self.device)
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.census = program.counter_change(self.before, program.counters())
        fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.events = load_events(path)
        finally:
            os.unlink(path)
        del self.prof


def span(name: str):
    """A harness span: a ``record_function`` range named ``portbench.<name>``."""
    import torch

    return torch.profiler.record_function(f"portbench.{name}")


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class TraceView:
    """The stretch of a trace: times in µs on the trace's clock."""

    def __init__(self, events: List[dict]):
        spans = [e for e in events if e.get("name") == STRETCH and e.get("cat") == "user_annotation"]
        if not spans:
            raise ValueError(f"no {STRETCH} span in the trace")
        s = max(spans, key=lambda e: float(e.get("dur", 0.0)))
        self.t0, self.t1 = float(s["ts"]), float(s["ts"]) + float(s.get("dur", 0.0))
        self.device = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            if b > self.t0 and a < self.t1:
                self.device.append((max(a, self.t0), min(b, self.t1), e["name"], e["cat"]))
        self.busy = _union([(a, b) for a, b, _, _ in self.device])
        self.spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]) for e in events
                      if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("portbench.")
                      and e["name"] != STRETCH]
        self.host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]) for e in events
                     if e.get("cat") in HOST_CATS]

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy)

    def busy_in(self, a: float, b: float) -> float:
        return sum(max(0.0, min(y, b) - max(x, a)) for x, y in self.busy)

    @property
    def kernels(self) -> int:
        return sum(1 for *_, cat in self.device if cat == "kernel")

    def family_us(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for a, b, name, _ in self.device:
            out[families.family(name)] += b - a
        return dict(out)

    def kernel_us(self, names) -> float:
        return sum(b - a for a, b, name, cat in self.device if cat == "kernel" and any(n in name for n in names))

    def spans_named(self, name: str) -> List[Tuple[float, float]]:
        full = f"portbench.{name}"
        return [(a, b) for a, b, n in self.spans if n == full]

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for a, b, name, _ in self.device:
            by[name[:160]] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: float) -> str:
        """The innermost harness span and host operation open at time t."""
        inner = lambda items: min((x for x in items if x[0] <= t < x[1]), key=lambda x: x[1] - x[0], default=None)
        s = inner(self.spans)
        h = inner(self.host)
        where = s[2] if s else STRETCH
        return where + (f"/{h[2][:100]}" if h else "")

    def idle_gaps(self, n: int = 10) -> List[list]:
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at(a), (b - a) / 1e6] for a, b in gaps[:n]]
