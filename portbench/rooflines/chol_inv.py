"""``chol_inv_kernel`` (``csrc/chol_inv.cu``): (L, L⁻¹) of G (n, n) SPD
matrices, with the program's counter key (G, n) (``launches_by_batch``).
Logical bytes: K read once, L and L⁻¹ written once. Logical operations:
the Cholesky factorization n³/3 and the triangular inverse n³/3 a matrix."""

NAMES = ("chol_inv_kernel",)
COUNTER = ("chol_inv", "launches_by_batch")
PEAK = "f32"


def ops_bytes(key):
    G, n = key
    return float(G * 2 * n**3 / 3), float(4 * 3 * G * n * n)
