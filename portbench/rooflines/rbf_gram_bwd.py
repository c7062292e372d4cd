"""``rbf_gram_bwd_kernel`` (``csrc/rbf_gram.cu``): the gradient of one
(G, N, M) gram with respect to X, Z, the lengthscales and the variance,
with the program's counter key (G, N, M, D). Logical bytes: gK read once,
X, Z and the hyperparameters read once, dX, dZ, dℓ and dσ² written once (K
is recomputed, as PERF.md §6's bound counts it). Logical operations: the
gram's own 3·D + 3 an entry, then gK·K (1), its share of dσ² (1), and per
dimension the difference's products into dX, dZ and dℓ (4·D)."""

NAMES = ("rbf_gram_bwd_kernel",)
COUNTER = ("rbf_gram_bwd", "launches_by_shape")
PEAK = "f32"


def ops_bytes(key):
    G, N, M, D = key
    ops = G * N * M * (7 * D + 5)
    nbytes = 4 * (G * N * M + 2 * (N * D + M * D + G * (D + 1)))
    return float(ops), float(nbytes)
