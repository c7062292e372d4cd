"""Device idle inside the program's ``zigp.serve.fields_out`` spans (the
result to the host, split into fields), over the stretch's calls, ms a
call."""

from portbench.harness.spans import serve_gap_ms_per_call


def read(r):
    return serve_gap_ms_per_call(r, "fields_out")
