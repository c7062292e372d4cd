"""The program's spans (``zigp.*``, ``cpu_op`` events) in the trace reader
and the readers of them, on hand-written Chrome traces.

- The existing fixture's events with ``zigp.*`` spans added read the same
  in every reader that was there and in the view's accessors, as without
  them; the idle gaps keep their lengths, and a gap inside a program span
  with no shorter host operation open is named by that span.
- Each new reader gives its hand-computed value; the three serving gaps sum
  to ``serve.device_gap_ms_per_call`` where the program's call is the
  harness's.
- A stretch without the program's spans gives None, never 0.
"""

import pytest

from portbench.harness import manifest as M
from portbench.harness.readings import Reading, read_metrics
from portbench.harness.spans import named, program_spans
from portbench.harness.trace import STRETCH, TraceView
from portbench.tests.test_bench_trace import EVENTS, ev

NEW = ("serve.rows_in_gap_ms_per_call", "serve.chunks_gap_ms_per_call", "serve.fields_out_gap_ms_per_call",
       "train.program_gap_us_per_block", "train.host_syncs_per_block", "train.host_syncs_per_block.small_grid")
U = "user_annotation"
P = "cpu_op"  # the program's spans


@pytest.fixture(scope="module")
def man():
    return M.load_manifest()


def _read(man, events, cell, **kw):
    c = M.Cell(man, cell)
    return read_metrics(Reading(view=TraceView(events), cell=c, **kw), c.per_layer)


PROGRAM_ON_FIXTURE = [
    ev("zigp.serve.call", P, 100.0, 50.0),
    ev("zigp.serve.rows_in", P, 100.0, 10.0),
    ev("zigp.serve.chunks", P, 110.0, 30.0),
    ev("zigp.serve.chunk", P, 110.0, 15.0),
    ev("zigp.serve.fields_out", P, 140.0, 10.0),
    ev("zigp.train.block", P, 150.0, 40.0),
    ev("zigp.train.fill", P, 150.0, 5.0),
    ev("zigp.train.replay", P, 155.0, 5.0),
    ev("zigp.train.sync", P, 160.0, 25.0),
    ev("zigp.train.callback", P, 185.0, 5.0),
    ev("zigp.train.block", P, 190.0, 30.0),  # past the stretch's end
]

KW = {"grid.serve": dict(census={"rbf_gram": {"launches_by_shape": {(2, 250, 4096, 1): 1}}}, calls=2, chunks=5,
                         rows=1000),
      "grid.train": dict(steps=2), "flagship.train": dict(steps=2), "flagship.train_mixed": dict(steps=2)}


@pytest.mark.parametrize("cell", sorted(KW))
def test_the_readers_that_were_there_read_the_same(man, cell):
    before = _read(man, EVENTS, cell, **KW[cell])
    after = _read(man, EVENTS + PROGRAM_ON_FIXTURE, cell, **KW[cell])
    assert before and not set(before) & set(NEW)
    assert {n: v for n, v in after.items() if n not in NEW} == before


def test_the_view_reads_the_same_with_the_program_spans():
    a, b = TraceView(EVENTS), TraceView(EVENTS + PROGRAM_ON_FIXTURE)
    assert b.top_ops(10) == a.top_ops(10)
    assert (b.spans, b.busy, b.device) == (a.spans, a.busy, a.device)
    assert [h for h in b.host if not h[2].startswith("zigp.")] == a.host
    assert (b.window_us, b.busy_us, b.kernels, b.family_us()) == (a.window_us, a.busy_us, a.kernels, a.family_us())
    # gaps 135..180, 110..120 and 185..195: the same lengths, now named by the innermost program span
    assert a.idle_gaps(10) == [["portbench.call", 45e-6], ["portbench.call/cudaGraphLaunch", 10e-6],
                               ["portbench.call", 10e-6]]
    assert b.idle_gaps(10) == [["portbench.call/zigp.serve.chunks", 45e-6],
                               ["portbench.call/zigp.serve.chunk", 10e-6],
                               ["portbench.call/zigp.train.callback", 10e-6]]
    assert program_spans(a) == [] and len(program_spans(b)) == 10  # the block past the end left out
    assert named(b, "serve.call") == [(100.0, 150.0)] and named(b, "call") == []


# Two calls of a serving stretch, each with the harness's span around the program's.
SERVE = [
    ev(STRETCH, U, 0.0, 1000.0),
    ev("zigp.serve.call", P, -50.0, 100.0),  # open when the profiler started: not counted
    ev("portbench.call", U, 100.0, 400.0),
    ev("zigp.serve.call", P, 100.0, 400.0),
    ev("zigp.serve.rows_in", P, 100.0, 100.0),
    ev("zigp.serve.chunks", P, 200.0, 200.0),
    ev("zigp.serve.chunk", P, 200.0, 100.0),
    ev("zigp.serve.chunk", P, 300.0, 100.0),
    ev("zigp.serve.fields_out", P, 400.0, 100.0),
    ev("portbench.call", U, 600.0, 300.0),
    ev("zigp.serve.call", P, 600.0, 300.0),
    ev("zigp.serve.rows_in", P, 600.0, 50.0),
    ev("zigp.serve.chunks", P, 650.0, 200.0),
    ev("zigp.serve.chunk", P, 650.0, 200.0),
    ev("zigp.serve.fields_out", P, 850.0, 50.0),
    ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 150.0, 50.0),
    ev("sm90_xmma_gemm_f32f32", "kernel", 220.0, 170.0),
    ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 420.0, 40.0),
    ev("sm90_xmma_gemm_f32f32", "kernel", 650.0, 190.0),
    ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 860.0, 40.0),
]


def test_the_serving_gaps(man):
    out = _read(man, SERVE, "grid.serve", calls=2, chunks=3, rows=12288)
    rows_in = ((150 - 100) + (650 - 600)) / 2 / 1e3
    chunks = ((220 - 200) + (400 - 390) + (850 - 840)) / 2 / 1e3
    fields_out = ((420 - 400) + (500 - 460) + (860 - 850)) / 2 / 1e3
    assert out["serve.rows_in_gap_ms_per_call"]["value"] == pytest.approx(rows_in)
    assert out["serve.chunks_gap_ms_per_call"]["value"] == pytest.approx(chunks)
    assert out["serve.fields_out_gap_ms_per_call"]["value"] == pytest.approx(fields_out)
    assert rows_in + chunks + fields_out == pytest.approx(out["serve.device_gap_ms_per_call"]["value"])
    assert {out[n]["unit"] for n in NEW[:3]} == {"ms"}


# Two whole blocks and the parts of a third, whose block span the profiler's stop cut.
TRAIN = [
    ev(STRETCH, U, 0.0, 1000.0),
    ev("zigp.train.callback", P, -100.0, 110.0),  # the profiler started inside it
    ev("zigp.train.block", P, 20.0, 230.0),
    ev("zigp.train.fill", P, 20.0, 10.0),
    ev("zigp.train.replay", P, 30.0, 10.0),
    ev("zigp.train.callback", P, 200.0, 50.0),
    ev("zigp.train.block", P, 260.0, 240.0),
    ev("zigp.train.fill", P, 260.0, 10.0),
    ev("zigp.train.replay", P, 270.0, 10.0),
    ev("zigp.train.sync", P, 280.0, 120.0),
    ev("zigp.train.log", P, 400.0, 10.0),
    ev("zigp.train.callback", P, 450.0, 50.0),
    ev("zigp.train.block", P, 510.0, 600.0),  # open when the profiler stopped
    ev("zigp.train.fill", P, 510.0, 10.0),
    ev("zigp.train.replay", P, 520.0, 10.0),
    ev("zigp.train.checkpoint", P, 530.0, 10.0),
    ev("zigp.train.eager", P, 540.0, 10.0),
    ev("cudaGraphLaunch", "cuda_runtime", 270.0, 10.0),
    ev("sm90_xmma_gemm_f32f32", "kernel", -20.0, 120.0),  # clipped to 0..100
    ev("sm90_xmma_gemm_f32f32", "kernel", 300.0, 150.0),
    ev("sm90_xmma_gemm_f32f32", "kernel", 545.0, 100.0),
]


@pytest.mark.parametrize("cell,syncs", [("grid.train", "train.host_syncs_per_block"),
                                        ("flagship.train", "train.host_syncs_per_block.small_grid"),
                                        ("flagship.train_mixed", "train.host_syncs_per_block.small_grid")])
def test_the_training_readings(man, cell, syncs):
    out = _read(man, TRAIN, cell, steps=4 * 50)  # 4 blocks of the mix's 50 steps
    assert out[syncs]["value"] == pytest.approx(1 / 4) and out[syncs]["unit"] == "syncs"
    if cell == "grid.train":
        # the union 20..40 (busy), 260..410 (busy 300..410), 510..550 (busy from 545); callbacks left out
        gap = 0.0 + (150.0 - 110.0) + (40.0 - 5.0)
        assert out["train.program_gap_us_per_block"]["value"] == pytest.approx(gap / 4)
    else:
        assert "train.program_gap_us_per_block" not in out  # the grid's alone (the profiler's launches)


@pytest.mark.parametrize("cell", sorted(KW))
def test_no_program_spans_no_reading(man, cell):
    for events in (EVENTS, [e for e in SERVE + TRAIN if not e["name"].startswith("zigp.")]):
        out = _read(man, events, cell, **KW[cell])
        assert not set(out) & set(NEW)
    c = M.Cell(man, cell)
    for name in NEW:
        if any(m["name"] == name for m in c.per_layer):
            r = Reading(view=TraceView(EVENTS), cell=c, **KW[cell])
            assert M.load_reader(name).read(r) is None
