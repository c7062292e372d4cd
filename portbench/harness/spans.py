"""Readings of the program's own spans in a traced stretch.

The program opens spans named ``zigp.<name>`` while a profiler records
(``zigp_tpu_torch.utils.profiling.span``). They are recorded as operators
(category ``cpu_op``), so ``TraceView.host`` holds them beside the ``aten::``
operators; only those that lie wholly inside the stretch are read here (one
open when the profiler started or stopped is not recorded whole). Device
idle inside a set of spans is the length of their union less the device's
busy time over it, as ``serve.device_gap_ms_per_call`` reads it inside the
harness's own calls. A program without the spans gives no reading (None),
never 0.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .trace import _union

PROGRAM = "zigp."


def program_spans(view) -> List[Tuple[float, float, str]]:
    """(start, end, name) of the program's spans wholly inside the stretch."""
    return [(a, b, n) for a, b, n in view.host if n.startswith(PROGRAM) and view.t0 <= a and b <= view.t1]


def named(view, name: str) -> List[Tuple[float, float]]:
    """(start, end) of the stretch's ``zigp.<name>`` spans."""
    full = PROGRAM + name
    return [(a, b) for a, b, n in program_spans(view) if n == full]


def idle_us(view, spans: List[Tuple[float, float]]) -> float:
    """Device idle inside the union of ``spans``, µs."""
    return sum((b - a) - view.busy_in(a, b) for a, b in _union(spans))


def serve_gap_ms_per_call(r, part: str) -> Optional[float]:
    """Device idle inside ``zigp.serve.<part>`` over the stretch's
    ``zigp.serve.call`` spans, ms a call."""
    calls = named(r.view, "serve.call")
    if not calls:
        return None
    return idle_us(r.view, named(r.view, f"serve.{part}")) / len(calls) / 1e3


def blocks(r) -> Optional[float]:
    """The stretch's blocks, ``r.steps`` over the mix's ``scan_inner`` (a
    block open when the profiler stopped has its parts in the stretch but
    not its own span, so block spans are not counted); None without the
    program's spans."""
    inner = int(r.cell.traffic.get("scan_inner", 0))
    if not program_spans(r.view) or not r.steps or not inner:
        return None
    return r.steps / inner
