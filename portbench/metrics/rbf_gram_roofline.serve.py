"""``rbf_gram.cu``'s share of its roofline over the traced cycle."""


def read(r):
    return r.roofline("rbf_gram")
