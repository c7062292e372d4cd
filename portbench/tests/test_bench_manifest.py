"""The manifest against the harness's own checks (``harness.validate``), and files found by name:
a cell, a configuration, a traffic mix, a metric and a roofline added from
new files, with no file that is there edited."""

import json

import pytest

from portbench.harness import manifest as M
from portbench.harness import validate
from portbench.harness.readings import Reading, read_metrics
from portbench.tests.tiny import copy_root


@pytest.fixture(scope="module")
def man():
    return M.load_manifest()


def test_manifest_has_no_problems(man):
    assert validate.problems(man) == []


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_names_and_units(man, section):
    for m in man[section]:
        assert M.NAME_RE.match(m["name"]) and M.UNIT_RE.match(m["unit"])


def test_every_moves_is_an_end_to_end_metric_of_its_cells(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


@pytest.mark.parametrize("cell", ["grid.train", "flagship.train", "grid.serve", "flagship.train_mixed"])
def test_cells_are_found_by_name(man, cell):
    c = M.Cell(man, cell)
    assert c.config["name"] == c.entry["config"] and c.kind in ("train", "serve")
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and c.per_layer
    assert set(c.limits) and all(v > 0 for v in c.limits.values())


def test_unknown_names_are_refused(man):
    with pytest.raises(M.ManifestError):
        M.Cell(man, "grid.nothing")
    with pytest.raises(M.ManifestError):
        M.load_json("configs", "../BENCHMARK")


def test_a_cell_config_mix_metric_and_roofline_come_from_new_files(man, tmp_path):
    root = copy_root(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "grid.json").read_text())
    cfg.update(name="grid_b2", batch_size=2048)
    (root / "configs" / "grid_b2.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "train.json").read_text())
    mix.update(log_every=400)
    (root / "traffic" / "train_rare_log.json").write_text(json.dumps(mix))
    spec = json.loads((root / "workloads" / "grid.train.json").read_text())
    spec.update(name="grid_b2.train_rare_log", config="grid_b2", traffic="train_rare_log")
    (root / "workloads" / "grid_b2.train_rare_log.json").write_text(json.dumps(spec))
    (root / "rooflines" / "toy_kernel.py").write_text(
        'NAMES = ("toy_kernel",)\nCOUNTER = ("toy", "launches_by_shape")\nPEAK = "f32"\n\n\n'
        "def ops_bytes(key):\n    (n,) = key\n    return float(n), float(4 * n)\n")
    (root / "metrics" / "toy_kernel_roofline.train.py").write_text(
        'def read(r):\n'
        '    return r.roofline("toy_kernel")\n')
    new = json.loads(json.dumps(man))
    new["configs"].append({"name": "grid_b2", "source": "https://example.org/grid-b2",
                           "file": "portbench/configs/grid_b2.json", "reduced": ["batch_size"], "why": "a test"})
    new["workloads"].append({"name": "grid_b2.train_rare_log", "config": "grid_b2", "traffic": "train_rare_log",
                             "chips": 1, "why": "a test"})
    new["end_to_end"][0]["workloads"].append("grid_b2.train_rare_log")
    new["per_layer"].append({"name": "toy_kernel_roofline.train", "unit": "%", "better": "higher",
                             "source": "device_trace", "layer": "kernels", "moves": "train_steps_per_s",
                             "workloads": ["grid_b2.train_rare_log"]})
    assert validate.problems(new, root) == []
    cell = M.Cell(new, "grid_b2.train_rare_log", root)
    assert cell.config["batch_size"] == 2048 and cell.traffic["log_every"] == 400
    assert "toy_kernel_roofline.train" in [m["name"] for m in cell.per_layer]

    class View:
        def kernel_us(self, names):
            return 2.0 if "toy_kernel" in names else 0.0

    r = Reading(view=View(), cell=cell, census={"toy": {"launches_by_shape": {(3.35e6,): 1}}})
    out = read_metrics(r, [m for m in cell.per_layer if m["name"] == "toy_kernel_roofline.train"])
    assert out["toy_kernel_roofline.train"]["value"] == pytest.approx(100.0 * (4 * 3.35e6 / 3.35e12) / 2e-6)
    assert {p: p.read_bytes() for p in before} == before  # nothing that was there changed
