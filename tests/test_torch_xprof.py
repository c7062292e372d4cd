"""The port's trace reader (``utils/xprof.py``) and profiling helpers
(``utils/profiling.trace``), on the CPU.

The JAX package's reader decodes XSpace protobuf; the port's reads the
Chrome-trace JSON ``torch.profiler`` writes, so there is no JAX output to
hold it against. Held here:

- ``summarize_trace`` on a handmade trace of a card's run: the kernels,
  copies and sets summed, the annotations that span them kept apart, the
  categories (GEMM, the port's kernels by name, elementwise, reduction,
  memcpy/memset, other) summing to the total exactly, per-step division,
  the newest file read;
- the CPU fallback: operators' self time (nested operators counted once),
  on a handmade trace and on a real ``torch.profiler`` trace of a small
  model written by ``profiling.trace``;
- ``op_category`` on kernel names of the kinds a card's trace holds;
- ``profile_predict.summarize``'s aggregation is xprof's (the same records).
"""

import json
import time

import pytest
import torch

from zigp_tpu_torch.utils import profiling, xprof


def _x(name, cat, dur, ts=0.0, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "dur": dur, "ts": ts, "pid": 1, "tid": tid}


CARD_EVENTS = [
    _x("void chol_inv_kernel<8>(float const*, float*, float*, int, bool)", "kernel", 40.0),
    _x("chol_inv_kernel", "kernel", 2.0),
    _x("void rbf_gram_kernel_vec4(float const*, float const*, float const*, float const*, float*, int)", "kernel", 3.0),
    _x("void rbf_gram_bwd_kernel<3>(BwdArgs)", "kernel", 7.0),
    _x("void chol_inv_pair_kernel(float const*, float*, float*, int, bool)", "kernel", 20.0),
    _x("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_warpgroupsize1x1x1", "kernel", 11.0),
    _x("void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5_nn_align1>(Params)", "kernel", 5.0),
    _x("void at::native::vectorized_elementwise_kernel<4, at::native::MulFunctor<float>>(int, F, A)", "kernel", 4.0),
    _x("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>(R)", "kernel", 6.0),
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1.5),
    _x("Memset (Device)", "gpu_memset", 0.5),
    _x("void trsm_left_kernel<float, 256, 4>(int, int, float const*)", "kernel", 9.0),
    _x("Optimizer.step#Adam.step", "gpu_user_annotation", 500.0),
    _x("aten::mm", "cpu_op", 1000.0),  # host work: not the device's
    _x("cudaLaunchKernel", "cuda_runtime", 3.0),
]


def _write(tmp_path, events, name="trace_1_1.pt.trace.json"):
    (tmp_path / name).write_text(json.dumps({"traceEvents": events + [{"ph": "M", "name": "process_name"}]}))
    return tmp_path


@pytest.mark.parametrize("name, category", [
    ("void chol_inv_kernel<8>(float const*, float*, float*, int, bool)", "chol_inv_kernel"),
    ("void chol_inv_cluster_kernel(float const*, float*, float*, int, bool, Marks)", "chol_inv_cluster_kernel"),
    ("void rbf_gram_kernel_any_d(float const*)", "rbf_gram_kernel"),
    ("void rbf_gram_bwd_kernel<0>(BwdArgs)", "rbf_gram_bwd_kernel"),
    ("void kron_mv_cluster<16, 16>(float const*)", "kron_mv_cluster"),
    ("void zigp_other_kernel(int)", "zigp_other_kernel"),
    ("ampere_sgemm_64x32_sliced1x4_nn", "gemm"),
    ("sm90_xmma_gemm_f32f32", "gemm"),
    ("void gemv2T_kernel_val<int, int, float>(float)", "gemm"),
    ("void at::native::unrolled_elementwise_kernel<at::native::AddFunctor>()", "elementwise"),
    ("void at::native::reduce_kernel<256, 2>()", "reduction"),
    ("Memcpy DtoD (Device -> Device)", "memcpy"),
    ("Memset (Device)", "memset"),
    ("void potrf_kernel()", "other"),
    ("aten::bmm", "gemm"),
    ("aten::tril", "tril"),
])
def test_op_category(name, category):
    assert xprof.op_category(name) == category


def test_summarize_trace_of_a_card_run(tmp_path):
    s = xprof.summarize_trace(_write(tmp_path, CARD_EVENTS), steps=4)
    device = [e for e in CARD_EVENTS if e["cat"] in xprof.DEVICE_CATS]
    assert s["device_plane"] == "cuda"
    assert s["total_us"] == pytest.approx(sum(e["dur"] for e in device), rel=1e-15)
    assert sum(s["by_category"].values()) == pytest.approx(s["total_us"], rel=1e-15)
    assert s["per_step_us"] == s["total_us"] / 4
    assert s["by_category"]["chol_inv_kernel"] == 42.0 and s["calls"]["chol_inv_kernel"] == 1
    assert s["by_category"]["gemm"] == 16.0 and s["by_category"]["other"] == 9.0
    assert s["port_kernels_us"] == {"chol_inv_kernel": 42.0, "chol_inv_pair_kernel": 20.0, "rbf_gram_bwd_kernel": 7.0,
                                    "rbf_gram_kernel": 3.0}
    assert s["overlapping_us"] == {"Optimizer.step#Adam.step": 500.0}
    assert list(s["by_category"]) == sorted(s["by_category"], key=lambda c: -s["by_category"][c])
    text = xprof.format_summary(s, 4)
    assert "µs/step" in text and "chol_inv_kernel" in text and "not added to the total" in text


def test_summarize_trace_reads_the_newest_file(tmp_path):
    _write(tmp_path, CARD_EVENTS[:1], "trace_1_1.pt.trace.json")
    _write(tmp_path, CARD_EVENTS[2:3], "trace_1_2.pt.trace.json")
    assert len(xprof.find_trace_files(str(tmp_path))) == 2
    assert list(xprof.summarize_trace(str(tmp_path))["by_category"]) == ["rbf_gram_kernel"]
    with pytest.raises(FileNotFoundError):
        xprof.summarize_trace(str(tmp_path / "empty"))


def test_cpu_operators_are_counted_by_self_time(tmp_path):
    """A parent's self time is its duration less its direct children's; a
    grandchild counts once, under its own name; threads apart."""
    events = [_x("aten::linear", "cpu_op", 100.0, 0.0), _x("aten::addmm", "cpu_op", 60.0, 10.0),
              _x("aten::copy_", "cpu_op", 20.0, 20.0), _x("aten::relu", "cpu_op", 30.0, 70.0),
              _x("aten::mul", "cpu_op", 5.0, 200.0), _x("aten::add", "cpu_op", 8.0, 0.0, tid=2)]
    s = xprof.summarize_trace(_write(tmp_path, events))
    assert s["device_plane"] == "cpu operators (self time)"
    assert s["by_op"] == {"aten::addmm": 40.0, "aten::relu": 30.0, "aten::copy_": 20.0, "aten::linear": 10.0,
                          "aten::add": 8.0, "aten::mul": 5.0}
    assert s["total_us"] == 113.0 and s["by_category"]["gemm"] == 40.0


def test_the_program_spans_are_not_cpu_operators(tmp_path):
    """A ``zigp.*`` span around operators adds no self time of its own and
    takes none from them."""
    events = [_x("aten::linear", "cpu_op", 100.0, 10.0), _x("aten::addmm", "cpu_op", 60.0, 20.0)]
    spans = [_x("zigp.train.block", "cpu_op", 200.0, 0.0), _x("zigp.train.replay", "cpu_op", 120.0, 5.0)]
    (tmp_path / "plain").mkdir()
    (tmp_path / "spans").mkdir()
    plain = xprof.summarize_trace(_write(tmp_path / "plain", events))
    s = xprof.summarize_trace(_write(tmp_path / "spans", events + spans))
    assert s["by_op"] == plain["by_op"] == {"aten::addmm": 60.0, "aten::linear": 40.0}
    assert s["total_us"] == 100.0


def test_a_real_cpu_trace_of_a_model_step(tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.Tanh(), torch.nn.Linear(64, 1))
    x = torch.randn(128, 32)
    with profiling.trace(str(tmp_path)):
        t0 = time.perf_counter()
        for _ in range(3):
            model(x).square().sum().backward()
        wall_us = (time.perf_counter() - t0) * 1e6
    (path,) = xprof.find_trace_files(str(tmp_path))
    assert path.endswith(profiling.TRACE_SUFFIX)
    s = xprof.summarize_trace(str(tmp_path), steps=3)
    assert s["device_plane"] == "cpu operators (self time)"
    assert 0 < s["total_us"] <= wall_us * 1.05  # one thread's self time cannot pass the wall time
    assert s["by_category"]["gemm"] > 0
    assert sum(s["by_category"].values()) == pytest.approx(s["total_us"], rel=1e-12)
    assert "device time" in xprof.format_summary(s, 3)


def test_profile_predict_summarize_uses_the_same_aggregation():
    class Entry:
        def __init__(self, key, us, count, note=False):
            self.key, self.device_time_total, self.count, self.is_user_annotation = key, us, count, note
            self.device_type = torch.autograd.DeviceType.CUDA

    class Prof:
        def key_averages(self):
            return [Entry("chol_inv_kernel", 30.0, 3), Entry("gemm_kernel", 10.0, 2),
                    Entry("Optimizer.step#Adam.step", 90.0, 1, note=True), Entry("idle", 0.0, 1)]

    from zigp_tpu_torch.experiments.profile_predict import summarize

    s = summarize(Prof(), wall_ms=0.1)
    assert s["device_ms"] == pytest.approx(0.04) and s["kernel_calls"] == 5
    assert s["idle_share"] == pytest.approx(0.6)
    assert [r["name"] for r in s["top"]] == ["chol_inv_kernel", "gemm_kernel"] and s["top"][0]["calls"] == 3
    assert s["annotations"] == [{"name": "Optimizer.step#Adam.step", "device_ms": 0.09, "calls": 1}]

