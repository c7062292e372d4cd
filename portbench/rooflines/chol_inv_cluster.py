"""``chol_inv_cluster_kernel`` and ``chol_inv_pair_kernel``
(``csrc/chol_inv_cluster.cu``, the route above n = 238): (L, L⁻¹) of G
(n, n) SPD matrices, with the program's counter key (G, n)
(``chol_inv_blocked.launches_by_batch``). The bound is ``chol_inv``'s."""

NAMES = ("chol_inv_cluster_kernel", "chol_inv_pair_kernel")
COUNTER = ("chol_inv_blocked", "launches_by_batch")
PEAK = "f32"


def ops_bytes(key):
    G, n = key
    return float(G * 2 * n**3 / 3), float(4 * 3 * G * n * n)
