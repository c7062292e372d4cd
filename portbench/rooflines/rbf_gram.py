"""``rbf_gram_kernel`` (``csrc/rbf_gram.cu``): the (G, N, M) RBF gram of
X (N, D) and Z (M, D) per kernel, launched with the program's counter key
(G, N, M, D). Logical bytes: X and Z read once, each kernel's D
lengthscales and variance, the gram written once. Logical operations: per
entry D differences, squares and scaled sums (3·D), the exponential's
argument and the variance's scale (3)."""

NAMES = ("rbf_gram_kernel",)
COUNTER = ("rbf_gram", "launches_by_shape")
PEAK = "f32"


def ops_bytes(key):
    G, N, M, D = key
    ops = G * N * M * (3 * D + 3)
    nbytes = 4 * (N * D + M * D + G * (D + 1) + G * N * M)
    return float(ops), float(nbytes)
