"""Device idle inside the harness's span of each traced call (``portbench.call``: rows handed over to
the fields on the host), as a mean over the stretch's calls."""


def read(r):
    spans = r.view.spans_named("call")
    if not spans:
        return None
    return sum((b - a) - r.view.busy_in(a, b) for a, b in spans) / len(spans) / 1e3
