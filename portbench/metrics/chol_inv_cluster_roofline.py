"""``chol_inv_cluster.cu``'s share of its roofline over the traced blocks or serving cycle."""


def read(r):
    return r.roofline("chol_inv_cluster")
