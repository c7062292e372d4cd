"""``BENCHMARK.json`` and the files the harness finds by name.

Everything that belongs to one configuration, traffic mix, cell, per-layer
metric or kernel lives in a file of its own under the benchmark's root:

- ``configs/<config>.json``: the model's sizes, source, ``reduced`` and
  ``assumed``;
- ``traffic/<traffic>.json``: the parameters the general generator
  (``harness.traffic``) reads;
- ``workloads/<cell>.json``: the cell's configuration, traffic, chips and
  why, the limits of its correctness check, the control's precision
  (``control``) and which statistics it compares (``numbers``);
- ``metrics/<metric>.py``: one reader of the trace, spans or counters
  (``read`` alone: the unit, layer and ``moves`` are the manifest's); a
  quantity split by what it moves may share one reader
  (``load_reader``);
- ``rooflines/<kernel>.py``: the logical operations and bytes of one kernel.

A later cell, mix, metric or kernel is added by adding files and manifest
entries alone. ``root`` is the benchmark's directory (this package's
parent) unless a caller passes another, as the tests do.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
CHECKOUT = ROOT.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class ManifestError(ValueError):
    """A manifest, cell, configuration or metric that the harness cannot run."""


def load_manifest(path: Optional[Path] = None) -> dict:
    path = Path(path) if path is not None else CHECKOUT / "BENCHMARK.json"
    if not path.exists():
        raise ManifestError(f"no manifest at {path}")
    return json.loads(path.read_text())


def _file(root: Path, kind: str, name: str, suffix: str) -> Path:
    if not NAME_RE.match(name):
        raise ManifestError(f"{kind}: {name!r} is not a name")
    path = Path(root) / kind / f"{name}{suffix}"
    if not path.exists():
        raise ManifestError(f"{kind}: no file {path}")
    return path


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    """``<root>/<kind>/<name>.json``."""
    return json.loads(_file(root, kind, name, ".json").read_text())


def load_module(kind: str, name: str, root: Path = ROOT):
    """``<root>/<kind>/<name>.py`` as a module (its file name may hold dots,
    so it is loaded by path, not imported)."""
    path = _file(root, kind, name, ".py")
    mod_name = f"portbench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def load_reader(name: str, root: Path = ROOT):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    where there is none, the reader it shares with the same quantity in
    other cells, ``metrics/<name less its last dotted part>.py`` (one
    ``idle.py`` reads ``idle.train`` and ``idle.serve``)."""
    if not (Path(root) / "metrics" / f"{name}.py").exists() and "." in name:
        return load_module("metrics", name.rsplit(".", 1)[0], root)
    return load_module("metrics", name, root)


def cell_metrics(manifest: dict, cell: str, section: str) -> list:
    """The entries of ``section`` ("end_to_end" or "per_layer") that ``cell``
    reports: those without a ``workloads`` key, and those that list it. A
    per-layer metric without the key goes with the end-to-end metric it
    moves, so it is reported where that one is."""
    e2e = {m["name"]: m for m in manifest["end_to_end"]}

    def reports(m, sec):
        if "workloads" in m:
            return cell in m["workloads"]
        if sec == "per_layer":
            return reports(e2e[m["moves"]], "end_to_end") if m["moves"] in e2e else False
        return True

    return [m for m in manifest[section] if reports(m, section)]


class Cell:
    """One cell: its manifest entry with its workload file, configuration and
    traffic mix, all read by name."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT):
        entries = {w["name"]: w for w in manifest["workloads"]}
        if name not in entries:
            raise ManifestError(f"unknown workload {name!r}; the manifest has {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        self.spec = load_json("workloads", name, root)
        for key in ("config", "traffic", "chips"):
            if self.spec.get(key) != self.entry[key]:
                raise ManifestError(f"workloads/{name}.json: {key} {self.spec.get(key)!r} is not the "
                                    f"manifest's {self.entry[key]!r}")
        self.config = load_json("configs", self.entry["config"], root)
        self.traffic = load_json("traffic", self.entry["traffic"], root)
        self.chips = int(self.entry["chips"])
        self.limits = dict(self.spec["limits"])
        self.control = dict(self.spec.get("control", {}))
        self.numbers = dict(self.spec.get("numbers", {}))
        self.end_to_end = cell_metrics(manifest, name, "end_to_end")
        self.per_layer = cell_metrics(manifest, name, "per_layer")
        self.root = Path(root)

    @property
    def kind(self) -> str:
        return self.traffic["kind"]
