"""The port's multi-process bootstrap (``zigp_tpu_torch.parallel.
distributed``), mirroring ``tests/test_multihost.py``: single-process
behaviour unconditionally, and a two-process CPU smoke over gloo (one
spawn, a ``FileStore`` rendezvous in the test's directory: no TCP port)."""

import pickle

import numpy as np
import pytest
import torch.multiprocessing as mp

from zigp_tpu_torch.parallel import initialize_distributed, make_multihost_mesh
from zigp_tpu_torch.parallel.mesh import MeshLaunchError

from . import torch_helpers as h

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "SLURM_PROCID", "SLURM_NTASKS", "SLURM_JOB_ID")


@pytest.fixture
def no_launcher(monkeypatch):
    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)


def test_initialize_noop_single_process(no_launcher):
    assert initialize_distributed() is False


def test_multihost_mesh_falls_back_single_process(no_launcher):
    mesh = make_multihost_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.backend is None and mesh.coords == (0, 0)
    with pytest.raises(MeshLaunchError, match="torchrun --nproc-per-node 8"):
        make_multihost_mesh(n_data=4, n_model=2)


def test_multihost_mesh_rejects_model_axis_crossing_hosts(monkeypatch):
    import zigp_tpu_torch.parallel.distributed as dist

    monkeypatch.setattr(dist, "world_size", lambda: 8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="cannot cross a DCN boundary"):
        dist.make_multihost_mesh(n_model=3)
    with pytest.raises(ValueError, match="inconsistent"):
        dist.make_multihost_mesh(n_data=3, n_model=1)


def test_an_nccl_mesh_refuses_two_ranks_on_one_gpu():
    from zigp_tpu_torch.parallel.mesh import refuse_shared_gpus

    refuse_shared_gpus([("host", 0), ("host", 1), ("other", 0)])
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one GPU"):
        refuse_shared_gpus([("host", 0), ("host", 0)])


def test_two_process_cpu_smoke(tmp_path):
    mp.spawn(h.multihost_smoke, args=(2, str(tmp_path / "store"), str(tmp_path)), nprocs=2, join=True)
    for rank in range(2):
        with open(tmp_path / f"smoke.{rank}.pkl", "rb") as f:
            res = pickle.load(f)
        assert res["initialized"] == (True, True)
        assert res["shape"] == {"data": 2, "model": 1} and res["coords"] == (rank, 0)
        assert res["backend"] == "gloo"
        np.testing.assert_array_equal(res["sum"], [2.0, 2.0])
