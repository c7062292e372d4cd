"""What a run loads: after a tiny CPU run of the harness no module whose
top-level name (before the first dot, compared whole) is ``jax``,
``jaxlib``, ``flax`` or ``zigp_tpu`` is loaded; the reference imports
nothing of the program."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from portbench.harness.manifest import CHECKOUT, ROOT

SCRIPT = """
import json, sys, time, torch
from portbench.tests.tiny import tiny_root
from portbench.harness import manifest as M
from portbench.run import forbidden_modules, run_cell
root = tiny_root(sys.argv[1])
for cell in ("grid.train", "grid.serve"):
    c = M.Cell(M.load_manifest(), cell, root)
    run_cell(c, 5, 0.1, True, torch.device("cpu"), t_process=time.perf_counter(), log=lambda s: None)
print(json.dumps({"forbidden": forbidden_modules(), "port": "zigp_tpu_torch" in sys.modules}))
"""


def test_a_run_loads_no_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(CHECKOUT))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)], cwd=CHECKOUT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen == {"forbidden": [], "port": True}


def test_forbidden_names_are_compared_whole():
    from portbench.run import forbidden_modules

    sys.modules["zigp_tpu_torch_lookalike"] = sys.modules[__name__]
    try:
        assert "zigp_tpu_torch_lookalike" not in forbidden_modules()
    finally:
        del sys.modules["zigp_tpu_torch_lookalike"]


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(Path(path).read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("zigp_tpu_torch", "zigp_tpu", "jax", "jaxlib", "flax"), path
                assert not (isinstance(node, ast.ImportFrom) and node.level and "harness" in (node.module or "")), path
