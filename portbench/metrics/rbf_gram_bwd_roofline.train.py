"""The gram's gradient kernel's share of its roofline over the traced blocks."""


def read(r):
    return r.roofline("rbf_gram_bwd")
