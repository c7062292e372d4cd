"""The trace reader on a small hand-written Chrome trace: the stretch, the
union of device activity and the idle share, the families, the harness's
spans, the idle gaps named by the host, and the metrics read from them."""

import pytest

from portbench.harness import manifest as M
from portbench.harness.readings import Reading, read_metrics
from portbench.harness.trace import STRETCH, TraceView

K = "kernel"


def ev(name, cat, ts, dur, **kw):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, **kw}


EVENTS = [
    ev(STRETCH, "user_annotation", 100.0, 100.0),
    ev("portbench.call", "user_annotation", 100.0, 50.0),
    ev("portbench.call", "user_annotation", 150.0, 50.0),
    ev("cudaGraphLaunch", "cuda_runtime", 95.0, 20.0),
    ev("aten::copy_", "cpu_op", 160.0, 10.0),
    ev("void at::native::vectorized_elementwise_kernel<4, add>", K, 90.0, 20.0),  # clipped to 100..110
    ev("sm90_xmma_gemm_f32f32", K, 120.0, 10.0),
    ev("zigp::rbf_gram_kernel(float const*)", K, 125.0, 10.0),  # overlaps the gemm: union 120..135
    ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 180.0, 5.0),
    ev("zigp_cluster::chol_inv_pair_kernel", K, 195.0, 10.0),  # clipped to 195..200
    ev("void reduce_kernel<512>", K, 250.0, 10.0),  # outside the stretch
]


@pytest.fixture
def view():
    return TraceView(EVENTS)


def test_window_busy_and_idle(view):
    assert view.window_us == 100.0
    assert view.busy_us == pytest.approx(10.0 + 15.0 + 5.0 + 5.0)
    assert view.kernels == 4
    assert view.busy_in(100.0, 150.0) == pytest.approx(25.0)


def test_families_sum_to_the_device_time(view):
    fam = view.family_us()
    assert fam == {"elementwise": 10.0, "gemm": 10.0, "rbf_gram_kernel": 10.0, "memcpy": 5.0,
                   "chol_inv_pair_kernel": 5.0}
    assert view.kernel_us(("rbf_gram_kernel",)) == 10.0


def test_gaps_are_named_by_the_host(view):
    gaps = view.idle_gaps(10)
    assert [round(g[1] * 1e6, 6) for g in gaps] == [45.0, 10.0, 10.0]
    assert gaps[0][0] == "portbench.call"  # 135..180: inside the first call, no host operation open
    assert gaps[1][0] == "portbench.call/cudaGraphLaunch"  # 110..120 inside the first call, the launch open
    assert view.top_ops(2)[0][1] == pytest.approx(1e-5)


def test_metrics_read_the_view(view):
    man = M.load_manifest()
    serve = M.Cell(man, "grid.serve")
    r = Reading(view=view, cell=serve, census={"rbf_gram": {"launches_by_shape": {(2, 250, 4096, 1): 1}}},
                calls=2, chunks=5, rows=1000)
    out = read_metrics(r, serve.per_layer)
    assert out["idle.serve"]["value"] == pytest.approx(65.0)
    assert out["serve.kernels_per_chunk"]["value"] == pytest.approx(4 / 5)
    assert out["serve.device_gap_ms_per_call"]["value"] == pytest.approx(((50 - 25) + (50 - 10)) / 2 / 1e3)
    bound = 4.0 * (250 + 4096 + 4 + 2 * 250 * 4096) / 3.35e12
    assert out["rbf_gram_roofline.serve"]["value"] == pytest.approx(100.0 * bound / 10e-6)
    assert "chol_inv_cluster_roofline.serve" not in out  # no launches counted: nothing to read
    train = M.Cell(man, "grid.train")
    r = Reading(view=view, cell=train, steps=2)
    out = read_metrics(r, train.per_layer)
    assert out["train.kernels_per_step"]["value"] == 2.0
    assert out["train.device_us_per_step"]["value"] == pytest.approx(35.0 / 2)
    assert out["mfu.train"]["value"] == pytest.approx(100.0 * 2 * 19.6117e9 / 100e-6 / 989e12, rel=1e-3)
