"""1 − the union of the device's activity over the traced stretch, in %."""


def read(r):
    return r.idle_share()
