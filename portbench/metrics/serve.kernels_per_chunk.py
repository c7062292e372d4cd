"""Device kernels in the traced cycle over its chunks of ``chunk`` rows."""


def read(r):
    if not r.chunks or not r.view.kernels:
        return None
    return r.view.kernels / r.chunks
