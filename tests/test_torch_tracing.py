"""The program's spans (``utils.profiling.span``) on the CPU.

- With no ``torch.profiler`` session recording, ``span`` enters no
  profiler range and hands back one shared null context; with one
  recording, it enters one named ``zigp.<name>``.
- ``predict_batched`` at N = 2.5 chunks: one ``zigp.serve.call`` holding
  ``rows_in``, ``chunks`` (three ``chunk`` spans) and ``fields_out``,
  disjoint and in that order, as ``cpu_op`` events of the Chrome trace
  ``profiling.trace`` writes.
- ``fit_scanned`` over 4 blocks, a log point every 2: 4 ``zigp.train.block``
  spans, each with its ``fill`` and its block (``eager`` on the CPU); a
  ``sync`` for the first block, each log point and the final read; a
  ``callback`` span inside the block of each call of the callback.
- A ``KeyboardInterrupt`` raised in the callback closes every span.
- Without a session neither path enters a profiler range.
"""

import json

import numpy as np
import pytest
import torch

from zigp_tpu_torch.core.parameters import param
from zigp_tpu_torch.experiments.runners import predict_batched
from zigp_tpu_torch.training import DataSet, fit_scanned
from zigp_tpu_torch.utils import profiling, xprof

B, K = 8, 2


class Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = param(np.zeros((2, 1)))

    def loss(self, X, Y):
        return ((X @ self.w.value - Y) ** 2).mean()

    def predict(self, X):
        mean = X @ self.w.value
        return {"mean": mean, "var": torch.ones_like(mean)}


def _data(n=64):
    X = np.random.default_rng(0).normal(size=(n, 2))
    return X, X @ np.array([[1.0], [-2.0]])


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _spans(prof, prefix="zigp."):
    """(name, start, end, event) of the recorded spans named ``prefix*``, by start."""
    out = [(e.name, e.time_range.start, e.time_range.end, e) for e in prof.events() if e.name.startswith(prefix)]
    return sorted(out, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture
def entered(monkeypatch):
    """The names of the profiler ranges ``span`` entered while the test runs."""
    names = []
    real = profiling._range

    class Counting:
        def __init__(self, name):
            self.name, self.inner = name, real(name)

        def __enter__(self):
            names.append(self.name)
            return self.inner.__enter__()

        def __exit__(self, *exc):
            return self.inner.__exit__(*exc)

    monkeypatch.setattr(profiling, "_range", Counting)
    return names


def test_span_off_enters_no_record_function(entered):
    for _ in range(100):
        with profiling.span("train.block") as s:
            assert s is None
    assert entered == []
    assert profiling.span("a") is profiling.span("b")  # one shared null context
    with _profile():
        with profiling.span("train.block"):
            pass
    assert entered == ["zigp.train.block"]
    with profiling.span("train.block"):  # the session has ended
        pass
    assert entered == ["zigp.train.block"]


def test_predict_batched_spans(tmp_path):
    model = Linear()
    X, _ = _data(50)
    with profiling.trace(str(tmp_path)):
        out = predict_batched(model.predict, X, 20, device="cpu", dtype=torch.float64)
    assert sorted(out) == ["mean", "var"] and out["mean"].shape == (50, 1)
    (path,) = xprof.find_trace_files(str(tmp_path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if str(e.get("name", "")).startswith("zigp.")]
    assert events and all(e["cat"] == "cpu_op" and e["ph"] == "X" for e in events)
    spans = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events),
                   key=lambda s: (s[1], -s[2]))
    names = [s[0] for s in spans]
    assert names == ["zigp.serve.call", "zigp.serve.rows_in", "zigp.serve.chunks"] + ["zigp.serve.chunk"] * 3 + [
        "zigp.serve.fields_out"]
    call, rows_in, chunks, *chunk, fields_out = spans
    assert all(_inside(s, call) for s in spans[1:])
    assert rows_in[2] <= chunks[1] and chunks[2] <= fields_out[1]  # disjoint, in order
    assert all(_inside(c, chunks) for c in chunk)
    assert all(a[2] <= b[1] for a, b in zip(chunk, chunk[1:]))


def _fit(**kw):
    X, Y = _data()
    return fit_scanned(Linear(), DataSet(X, Y), num_iter=4 * K, batch_size=B, num_inner=K, log_every_blocks=2,
                       log_fn=lambda s: None, learning_rate=1e-2, **kw)


def test_fit_scanned_spans():
    called = []
    with _profile() as prof:
        res = _fit(callback=lambda step, model: called.append(step), callback_every=2 * K)
    assert called == [2 * K, 4 * K] and np.isfinite(res.final_loss)
    spans = _spans(prof)
    by = lambda name: [s for s in spans if s[0] == f"zigp.train.{name}"]
    blocks = by("block")
    assert len(blocks) == 4
    assert all(a[2] <= b[1] for a, b in zip(blocks, blocks[1:]))
    for part in ("fill", "eager"):  # no graph on the CPU: every block eager
        assert [sum(_inside(s, b) for s in by(part)) for b in blocks] == [1, 1, 1, 1]
    assert not by("replay") and not by("capture")
    # the first block's read, the log points of blocks 0 and 2, the final read
    syncs = by("sync")
    assert [sum(_inside(s, b) for s in syncs) for b in blocks] == [2, 0, 1, 0]
    assert len(syncs) == 4 and syncs[-1][1] >= blocks[-1][2]
    assert [sum(_inside(s, b) for s in by("log")) for b in blocks] == [1, 0, 1, 0]
    assert [sum(_inside(s, b) for s in by("callback")) for b in blocks] == [0, 1, 0, 1]


def test_keyboard_interrupt_in_the_callback_closes_every_span():
    def stop(step, model):
        if step == 2 * K:
            raise KeyboardInterrupt

    with _profile() as prof:
        res = _fit(callback=stop, callback_every=K)
        with torch.profiler.record_function("after"):
            pass
    assert res.interrupted and res.step_losses.shape == (2 * K,)
    spans = _spans(prof)
    (after,) = [e for e in prof.events() if e.name == "after"]
    assert after.cpu_parent is None  # no span left open around it
    assert all(e.time_range.end <= after.time_range.start for *_, e in spans)
    names = [s[0] for s in spans]
    assert names.count("zigp.train.block") == 2 and names.count("zigp.train.callback") == 2
    block, callback = [s for s in spans if s[0] == "zigp.train.block"][1], [
        s for s in spans if s[0] == "zigp.train.callback"][1]
    assert _inside(callback, block)  # the raising call's span closed, then its block's
    assert names[-1] == "zigp.train.sync"  # the losses read after the interrupt, outside any block
    assert not any(_inside(spans[-1], b) for b in spans if b[0] == "zigp.train.block")


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_the_paths_enter_no_record_function_without_a_session(entered, kind):
    model = Linear()
    X, _ = _data(50)
    run = (lambda: predict_batched(model.predict, X, 20, device="cpu", dtype=torch.float64)) if kind == "serve" else _fit
    run()
    assert entered == []
    with _profile():
        run()
    assert entered and all(n.startswith(f"zigp.{kind}.") for n in entered)
