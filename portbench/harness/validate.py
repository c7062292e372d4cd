"""What the harness checks of ``BENCHMARK.json`` and the files it names,
before a run: a list of the problems found, empty when there are none.

It covers the manifest's shape and characters, that each name finds its
files (``configs/``, ``traffic/``, ``workloads/``, a reader in
``metrics/``), that every
``moves`` names an end-to-end metric the cell reports, and that every cell
reports ``setup_s``, another end-to-end metric and a per-layer metric.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import List

from .manifest import NAME_RE, ROOT, UNIT_RE, Cell, ManifestError, load_json, load_reader

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
PATH_RE = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def problems(manifest: dict, root: Path = ROOT) -> List[str]:
    out: List[str] = []
    if set(manifest) != TOP_KEYS:
        out.append(f"top-level keys {sorted(manifest)}")
    paths = manifest.get("paths", [])
    if not 1 <= len(paths) <= 16 or not all(PATH_RE.match(p) and ".." not in p for p in paths):
        out.append(f"paths {paths}")
    if not 1 <= int(manifest.get("run_seconds", 0)) <= 51:
        out.append("run_seconds outside 1..51")
    cmd = manifest.get("command", [])
    if not 1 <= len(cmd) <= 32 or not all(_line(w) and not w.startswith("/") and ".." not in w for w in cmd):
        out.append(f"command {cmd}")
    names = set()
    for section, keys in (("configs", CONFIG_KEYS), ("workloads", CELL_KEYS)):
        for e in manifest.get(section, []):
            if set(e) != keys:
                out.append(f"{section} {e.get('name')}: keys {sorted(e)}")
            if not NAME_RE.match(str(e.get("name", ""))):
                out.append(f"{section}: bad name {e.get('name')!r}")
            if not _line(e.get("why")):
                out.append(f"{section} {e.get('name')}: why")
    for c in manifest.get("configs", []):
        if not _line(c.get("source")) or not any(c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            out.append(f"config {c['name']}: source or file")
        if len(c.get("reduced", [])) > 16 or not all(NAME_RE.match(k) for k in c.get("reduced", [])):
            out.append(f"config {c['name']}: reduced")
        try:
            load_json("configs", c["name"], root)
        except ManifestError as e:
            out.append(str(e))
    e2e = {m["name"]: m for m in manifest.get("end_to_end", [])}
    for m in manifest.get("end_to_end", []) + manifest.get("per_layer", []):
        name = m.get("name", "")
        if name in names or not NAME_RE.match(name):
            out.append(f"metric {name!r}: duplicate or bad name")
        names.add(name)
        if not UNIT_RE.match(str(m.get("unit", ""))) or m.get("better") not in ("lower", "higher"):
            out.append(f"metric {name}: unit or better")
    for m in manifest.get("end_to_end", []):
        if set(m) - {"workloads"} != E2E_KEYS or m["source"] not in ("host_clock", "device_trace"):
            out.append(f"end_to_end {m['name']}: keys or source")
        if not 0 < float(m.get("bound", 0)) <= 0.25:
            out.append(f"end_to_end {m['name']}: bound")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    layers = {}
    for m in manifest.get("per_layer", []):
        if set(m) - {"workloads"} != LAYER_KEYS or not _line(m.get("layer")):
            out.append(f"per_layer {m['name']}: keys or layer")
        if m.get("moves") not in e2e:
            out.append(f"per_layer {m['name']}: moves {m.get('moves')!r} is no end-to-end metric")
        if m.get("source") not in ("device_trace", "program_span", "program_counter", "host_clock"):
            out.append(f"per_layer {m['name']}: source")
        try:
            if not callable(getattr(load_reader(m["name"], root), "read", None)):
                out.append(f"per_layer {m['name']}: its reader has no read")
        except ManifestError as e:
            out.append(str(e))
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    for variants in layers.values():
        if len(variants) > 1:
            out.append(f"layer spelled {sorted(variants)}")
    cells = {w["name"] for w in manifest.get("workloads", [])}
    for m in list(e2e.values()) + manifest.get("per_layer", []):
        if not set(m.get("workloads", [])) <= cells:
            out.append(f"metric {m['name']}: unknown cells {sorted(set(m['workloads']) - cells)}")
    for w in manifest.get("workloads", []):
        try:
            cell = Cell(manifest, w["name"], root)
        except (ManifestError, KeyError) as e:
            out.append(f"cell {w['name']}: {e}")
            continue
        reported = {m["name"] for m in cell.end_to_end}
        if "setup_s" not in reported or len(reported) < 2 or not cell.per_layer:
            out.append(f"cell {w['name']}: reports {sorted(reported)} and {len(cell.per_layer)} per-layer metrics")
        for m in cell.per_layer:
            if m["moves"] not in reported:
                out.append(f"cell {w['name']}: {m['name']} moves {m['moves']}, which the cell does not report")
        if int(w["chips"]) not in (1, 4):
            out.append(f"cell {w['name']}: chips")
    pairs = [(w["config"], w["traffic"]) for w in manifest.get("workloads", [])]
    if len(pairs) != len(set(pairs)):
        out.append("a (config, traffic) pair appears twice")
    used = {w["config"] for w in manifest.get("workloads", [])}
    if used != {c["name"] for c in manifest.get("configs", [])}:
        out.append("a configuration is used by no cell, or a cell names an unknown one")
    n = len(manifest.get("workloads", []))
    if (2 + 14 * 24) * (int(manifest.get("run_seconds", 0)) + 60) + 24 * 2 * 90 + 1200 > 43200:
        out.append("run_seconds does not fit 24 cells into a check")
    if not 1 <= n <= 24:
        out.append(f"{n} cells")
    return out

