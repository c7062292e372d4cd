"""Device busy time (the union of its kernels, copies and sets) in the traced
cycle, a chunk of ``chunk`` rows."""


def read(r):
    if not r.chunks or r.view.busy_us <= 0:
        return None
    return r.view.busy_us / r.chunks
