"""``chol_inv.cu``'s share of its roofline over the traced blocks."""


def read(r):
    return r.roofline("chol_inv")
