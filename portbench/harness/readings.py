"""What a per-layer metric's reader (``metrics/<name>.py``) is handed.

A reader defines ``read(r)`` alone (its unit, layer and ``moves`` are the
manifest's entry), where
``r`` is a ``Reading``: the traced stretch (``view``, a
``harness.trace.TraceView``), the cell, the program's launch counters'
change over the stretch (``census``), the work the stretch held (``steps``
in a training cell; ``calls``, ``chunks`` and ``rows`` in a serving cell)
and every call's latency of the window (``latencies``, seconds). ``read``
returns a number, or None where it finds nothing to read; the harness then
leaves the metric out of the line. A share of a roofline or a peak is never
returned as 0 for want of a reading.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import counts, peaks
from .manifest import load_module, load_reader

PEAKS = {"f32": peaks.F32_FLOPS, "bf16": peaks.BF16_FLOPS}


@dataclass
class Reading:
    view: object
    cell: object
    census: Dict = field(default_factory=dict)
    steps: int = 0
    calls: int = 0
    chunks: int = 0
    rows: int = 0
    latencies: List[float] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.view.window_us / 1e6

    @property
    def sizes(self):
        g = self.cell.config["grid"]
        return int(g["num_spatial"]), int(g["num_temporal"])

    def roofline(self, kernel: str) -> Optional[float]:
        """Σ the kernel's bound over its launches in the stretch ÷ Σ its
        device time, in %: the bound is max(bytes ÷ HBM, ops ÷ peak) of each
        launch's logical work (``rooflines/<kernel>.py``)."""
        mod = load_module("rooflines", kernel, self.cell.root)
        wrapper, attr = mod.COUNTER
        launches = self.census.get(wrapper, {}).get(attr, {})
        device_us = self.view.kernel_us(mod.NAMES)
        if not launches or device_us <= 0:
            return None
        bound_s = 0.0
        for key, n in launches.items():
            ops, nbytes = mod.ops_bytes(key)
            bound_s += n * max(nbytes / peaks.HBM_BYTES_PER_S, ops / PEAKS[mod.PEAK])
        return 100.0 * bound_s / (device_us / 1e6)

    def train_flops(self) -> float:
        Ms, Mt = self.sizes
        return counts.train_step_flops(int(self.cell.config["batch_size"]), Ms, Mt) * self.steps

    def serve_flops(self) -> float:
        Ms, Mt = self.sizes
        return counts.serve_row_flops(Ms, Mt) * self.rows

    def idle_share(self) -> Optional[float]:
        if self.view.window_us <= 0:
            return None
        return 100.0 * (1.0 - self.view.busy_us / self.view.window_us)


def read_metrics(reading: Reading, entries: list) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the per-layer metrics ``entries`` that
    find something to read."""
    out = {}
    for m in entries:
        mod = load_reader(m["name"], reading.cell.root)
        value = mod.read(reading)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
