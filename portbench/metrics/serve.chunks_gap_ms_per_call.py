"""Device idle inside the program's ``zigp.serve.chunks`` spans (the chunk
loop: stage, replay, copy into the result), over the stretch's calls, ms a
call."""

from portbench.harness.spans import serve_gap_ms_per_call


def read(r):
    return serve_gap_ms_per_call(r, "chunks")
