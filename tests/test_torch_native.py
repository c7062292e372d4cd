"""The port's native batcher (``zigp_tpu_torch/io/native.py``) against the JAX
package's, on the CPU.

Both bind the same C++ source (``native/batcher.cc``); the port builds its
own copy into ``zigp_tpu_torch/io/_build/`` under a file lock. Held here:

- ``next_batch``, ``next_block``, ``skip`` and ``epochs_completed`` draw
  exactly the JAX package's rows at the same seed (bit for bit: both are
  gathers of the same float64 rows in the same order);
- a block staged by ``training.scan.StagedBlocks`` ("host") is one
  ``next_block`` call and equals K sequential ``next_batch`` draws;
- processes that build at once (pytest-xdist workers) wait on the lock
  and load one complete library;
- ``make_dataset`` falls back to the numpy ``DataSet`` when the library is
  not available;
- ``run_onoff`` on the native batches of both packages (5 host-staged
  blocks of 2 steps), from the same inits, float64: every metric within
  rtol 1e-8 (the two trainings agree to about 1e-10).

Nothing here builds at import. When the JAX package's library did not load
in this worker (several workers ran its ``make`` at once), its cache is
reset and it is loaded again: no case skips.
"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from zigp_tpu.experiments import configs as jconfigs
from zigp_tpu.experiments import runners as jrunners
from zigp_tpu.io import native as jnative
from zigp_tpu_torch.experiments import configs as tconfigs
from zigp_tpu_torch.experiments import runners as trunners
from zigp_tpu_torch.io import native as tnative
from zigp_tpu_torch.training import DataSet, StagedBlocks

from .test_torch_runners import CPU64, _jsplit, _same, _tiny, _tiny_split

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's native module with its library loaded."""
    for _ in range(3):
        if jnative._load() is not None:
            return jnative
        monkeypatch.setattr(jnative, "_lib", None)
        monkeypatch.setattr(jnative, "_build_failed", False)
        time.sleep(1.0)
    assert jnative._load() is not None, "the JAX package's native batcher did not load"
    return jnative


def _arrays(n=37, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 3), rng.randn(n, 1)


def _pair(jn, seed=5, n=37):
    X, Y = _arrays(n)
    return jn.NativeDataSet(X, Y, seed=seed), tnative.NativeDataSet(X, Y, seed=seed)


def test_the_port_builds_its_own_library():
    assert tnative.available(), tnative.build_error()
    path = tnative.library_path()
    assert path.exists() and path.parent == REPO / "zigp_tpu_torch" / "io" / "_build"


@pytest.mark.parametrize("what", ["next_batch", "next_block", "skip"])
def test_draws_match_the_jax_batcher(jax_native, what):
    """Batches of 8 from 37 rows: the epochs wrap inside batches; ``skip``
    moves both past 7 batches, then they draw alike."""
    j, t = _pair(jax_native)
    for step in range(6):
        if what == "next_batch":
            a, b = j.next_batch(8), t.next_batch(8)
        elif what == "next_block":
            a, b = j.next_block(8, 3), t.next_block(8, 3)
        else:
            j.skip(8, 7)
            t.skip(8, 7)
            a, b = j.next_batch(8), t.next_batch(8)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.float64
            np.testing.assert_array_equal(y, x)
        assert t.epochs_completed == j.epochs_completed
    assert t.epochs_completed >= 1
    assert t.num_examples == 37
    np.testing.assert_array_equal(t.arrays[0], _arrays()[0])


def test_a_staged_host_block_is_one_next_block_call():
    X, Y = _arrays()
    ds, ref = tnative.NativeDataSet(X, Y, seed=3), tnative.NativeDataSet(X, Y, seed=3)
    calls = []
    block = ds.next_block
    ds.next_block = lambda b, k: calls.append((b, k)) or block(b, k)
    ds.next_batch = None  # a host block must not draw batch by batch
    blocks = StagedBlocks(ds, "host", 8, 4, device="cpu", dtype=torch.float64)
    for b in range(3):
        blocks.fill(b)
        want = [ref.next_batch(8) for _ in range(4)]
        np.testing.assert_array_equal(blocks.Xs.numpy(), np.stack([x for x, _ in want]))
        np.testing.assert_array_equal(blocks.Ys.numpy(), np.stack([y for _, y in want]))
    assert calls == [(8, 4)] * 3


def test_concurrent_builds_wait_on_the_lock_and_load_one_library(tmp_path):
    """Three processes build into an empty directory at once: one compiler
    run, every process loads the same complete file, no temporary left. The
    module is loaded from its file alone (it imports numpy only), so the
    processes do not import torch."""
    code = ("import importlib.util, sys; from pathlib import Path; "
            "spec = importlib.util.spec_from_file_location('native', sys.argv[2]); "
            "n = importlib.util.module_from_spec(spec); spec.loader.exec_module(n); "
            "n.BUILD_DIR = Path(sys.argv[1]); print(n.available(), n.library_path(), n.build_error())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path), tnative.__file__], stdout=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert {tuple(o) for o in outs} == {("True", str(tmp_path / tnative.library_path().name), "None")}
    assert sorted(p.name for p in tmp_path.iterdir()) == [".lock", tnative.library_path().name]


def test_make_dataset_falls_back_to_numpy_without_the_library(monkeypatch):
    X, Y = _arrays()
    assert isinstance(tnative.make_dataset(X, Y), tnative.NativeDataSet)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_error", "RuntimeError: no compiler")
    ds = tnative.make_dataset(X, Y, seed=4)
    assert isinstance(ds, DataSet)
    np.testing.assert_array_equal(ds.next_batch(5)[0], DataSet(X, Y, seed=4).next_batch(5)[0])
    with pytest.raises(RuntimeError, match="no compiler"):
        tnative.NativeDataSet(X, Y)


def test_run_onoff_on_native_batches_matches_jax(jax_native, monkeypatch):
    """Both runners draw from ``make_dataset``, the native batcher in both
    (checked), 20 host-sampled steps from the same inits, float64."""
    kinds = {}
    for pkg, module in (("jax", jrunners), ("port", trunners)):
        make = module.make_dataset
        monkeypatch.setattr(module, "make_dataset", lambda x, y, _m=make, _p=pkg, **kw: kinds.setdefault(
            _p, _m(x, y, **kw)))
    split = _tiny_split()
    quiet = lambda s: None
    kw = dict(monitor_every=0, num_iter=10, scan_inner=2, log_every=2)  # a short scan: JAX's compile is the cost
    want = jrunners.run_onoff(_jsplit(split), _tiny("OnOffPptrConfig", jconfigs, **kw), log_fn=quiet)
    got = trunners.run_onoff(split, _tiny("OnOffPptrConfig", tconfigs, **kw), log_fn=quiet, **CPU64)
    assert isinstance(kinds["jax"], jnative.NativeDataSet) and isinstance(kinds["port"], tnative.NativeDataSet)
    untimed = ("model", "steps_per_sec", "train_time_sec")
    _same({k: v for k, v in got.items() if k not in untimed}, {k: v for k, v in want.items() if k not in untimed},
          "run_onoff", rtol=1e-8)
