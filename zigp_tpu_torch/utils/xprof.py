"""Device-time breakdown from a ``torch.profiler`` trace.

Counterpart of ``zigp_tpu/utils/xprof.py``, which decodes the XSpace
protobuf that ``jax.profiler`` writes. ``torch.profiler`` exports
Chrome-trace JSON instead (``utils.profiling.trace``,
``profile.export_chrome_trace``): a ``traceEvents`` list whose complete
events (``"ph": "X"``) carry ``name``, ``cat`` and ``dur`` (µs). The device's
work is the events of categories ``kernel``, ``gpu_memcpy`` and
``gpu_memset``; ``gpu_user_annotation`` events (an optimizer step's range)
span kernels that are counted on their own, so they are reported apart and
never summed, as the JAX reader keeps control and async events apart. A
trace with no device events (a CPU run) is summarised by its operators'
self time (each ``cpu_op``'s duration less its nested operators'), which
counts every busy microsecond of a thread once; the program's own spans
(``profiling.span``, ``cpu_op`` events named ``zigp.*``) enclose operators
and are left out.

One aggregation serves both sources: ``summarize_events`` over
(name, category, µs, calls) records, fed by ``trace_records`` (a trace
file) or ``profiler_records`` (a live profiler's ``key_averages``, what
``experiments.profile_predict.summarize`` reads).

Used by ``python -m zigp_tpu_torch.experiments.profile_step`` and ad hoc:
``summarize_trace(logdir, steps=N)``.
"""

from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple

from .profiling import SPAN_PREFIX, TRACE_SUFFIX

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OVERLAPPING_CATS = ("gpu_user_annotation",)

# the port's own kernels (zigp_tpu_torch/ops/cuda/csrc), most specific first
PORT_KERNELS = ("chol_inv_cluster_kernel", "chol_inv_pair_kernel", "chol_inv_kernel", "chol_kernel",
                "kron_mv_cluster", "kron_mv_global", "rbf_gram_bwd_kernel", "rbf_gram_kernel")
_GEMM_MARKS = ("gemm", "cutlass", "sm90_", "sm80_", "ampere_", "gemv")
_CPU_GEMM = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul")


class Record(NamedTuple):
    name: str
    cat: str
    us: float
    calls: int


def find_trace_files(logdir: str) -> List[str]:
    """The Chrome-trace files under ``logdir``, oldest name first."""
    return sorted(glob.glob(os.path.join(logdir, "**", f"*{TRACE_SUFFIX}"), recursive=True))


def load_trace(path: str) -> List[dict]:
    """The trace's complete events (``"ph": "X"``)."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def op_category(name: str) -> str:
    """A kernel's family: the port's own kernels by their name (``zigp_``
    names kept whole), ``gemm`` (cuBLAS, CUTLASS and the ``sm90_``/``ampere_``
    kernels), ``elementwise``, ``reduction``, ``memcpy``, ``memset``, else
    ``other``; a CPU operator (``aten::…``): ``gemm`` for the products, its
    own name otherwise."""
    if name.startswith("aten::"):
        return "gemm" if name in _CPU_GEMM else name[len("aten::"):]
    for k in PORT_KERNELS:
        if k in name:
            return k
    if "zigp_" in name:
        return name.split("(")[0].split()[-1]
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    if any(m in low for m in _GEMM_MARKS):
        return "gemm"
    if "elementwise" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduction"
    return "other"


def _self_times(events: List[dict]) -> Iterable[Record]:
    """Each ``cpu_op``'s self time: its duration less its direct children's
    on the same thread; the program's spans left out."""
    by_thread = defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op" and not str(e.get("name", "")).startswith(SPAN_PREFIX):
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        stack: List[list] = []  # [end, event, children's µs]

        def close(item):
            yield Record(item[1]["name"], "cpu_op", max(float(item[1].get("dur", 0.0)) - item[2], 0.0), 1)

        for e in evs:
            start, dur = float(e["ts"]), float(e.get("dur", 0.0))
            while stack and start >= stack[-1][0]:
                yield from close(stack.pop())
            if stack:
                stack[-1][2] += dur
            stack.append([start + dur, e, 0.0])
        while stack:
            yield from close(stack.pop())


def trace_records(events: List[dict]) -> List[Record]:
    """The device's records of a trace (kernels, copies, sets, and the
    annotations that span them); a trace without device events, its CPU
    operators' self time."""
    device = [Record(e["name"], e["cat"], float(e.get("dur", 0.0)), 1) for e in events
              if e.get("cat") in DEVICE_CATS + OVERLAPPING_CATS]
    if any(r.cat in DEVICE_CATS for r in device):
        return device
    return list(_self_times(events))


def profiler_records(prof) -> List[Record]:
    """The device records of a live ``torch.profiler`` profile, from its
    ``key_averages``: each CUDA entry with device time (µs, summed over its
    calls); user annotations as overlapping."""
    import torch

    out = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0:
            cat = "gpu_user_annotation" if getattr(e, "is_user_annotation", False) else "kernel"
            out.append(Record(e.key, cat, float(e.device_time_total), int(e.count)))
    return out


def summarize_events(records: Iterable[Record], steps: int = 1, plane: str = "") -> dict:
    """{"device_plane", "total_us", "per_step_us", "by_category" {category:
    µs}, "by_op" {name: µs}, "calls" {name: calls}, "overlapping_us"} over
    the records; the categories sum to the total; µs over the whole window
    (divide by ``steps`` for per-step numbers)."""
    by_op: Dict[str, float] = defaultdict(float)
    calls: Dict[str, int] = defaultdict(int)
    overlap: Dict[str, float] = defaultdict(float)
    cpu = True
    for r in records:
        if r.cat in OVERLAPPING_CATS:
            overlap[r.name] += r.us
            continue
        cpu = cpu and r.cat == "cpu_op"
        by_op[r.name] += r.us
        calls[r.name] += r.calls
    by_cat: Dict[str, float] = defaultdict(float)
    for name, us in by_op.items():
        by_cat[op_category(name)] += us
    total = sum(by_op.values())
    desc = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))
    return {
        "device_plane": plane or ("cpu operators (self time)" if cpu and by_op else "cuda"),
        "total_us": total,
        "per_step_us": total / max(steps, 1),
        "by_category": desc(by_cat),
        "by_op": desc(by_op),
        "calls": dict(calls),
        "overlapping_us": dict(list(desc(overlap).items())[:8]),
    }


def summarize_trace(logdir: str, steps: int = 1, device_hint: str = "cuda") -> dict:
    """The breakdown of the newest trace under ``logdir`` (``summarize_events``'
    keys), with ``port_kernels_us``: the port's own kernels' µs by name.
    ``device_hint`` names the device plane; a trace without device events is
    summarised by CPU operators' self time."""
    files = find_trace_files(logdir)
    if not files:
        raise FileNotFoundError(f"no *{TRACE_SUFFIX} under {logdir}")
    records = trace_records(load_trace(files[-1]))
    summary = summarize_events(records, steps)
    if summary["device_plane"] == "cuda":
        summary["device_plane"] = device_hint
    summary["port_kernels_us"] = {c: us for c, us in summary["by_category"].items() if c in PORT_KERNELS
                                  or c.startswith("zigp_")}
    return summary


def format_summary(summary: dict, steps: int, top: int = 12) -> str:
    lines = [
        f"device plane: {summary['device_plane']}",
        f"device time: {summary['total_us']:.1f} µs over {steps} steps = {summary['per_step_us']:.2f} µs/step",
        "",
        f"{'category':<28} {'µs/step':>10} {'share':>7}",
    ]
    total = summary["total_us"] or 1.0
    for cat, us in summary["by_category"].items():
        lines.append(f"{cat:<28} {us / steps:>10.2f} {us / total:>6.1%}")
    lines.append("")
    lines.append(f"top {top} operations (µs/step):")
    for name, us in list(summary["by_op"].items())[:top]:
        lines.append(f"  {us / steps:>9.2f}  {name[:140]}")
    if summary.get("overlapping_us"):
        lines.append("")
        lines.append("annotations spanning the kernels (µs/step, not added to the total):")
        for name, us in summary["overlapping_us"].items():
            lines.append(f"  {us / steps:>9.2f}  {name[:140]}")
    return "\n".join(lines)
