"""Device idle inside the program's ``zigp.serve.rows_in`` spans (the rows
handed to the device), over the stretch's calls, ms a call."""

from portbench.harness.spans import serve_gap_ms_per_call


def read(r):
    return serve_gap_ms_per_call(r, "rows_in")
