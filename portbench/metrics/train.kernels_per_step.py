"""Device kernels in the traced blocks over their optimizer steps."""


def read(r):
    if not r.steps or not r.view.kernels:
        return None
    return r.view.kernels / r.steps
