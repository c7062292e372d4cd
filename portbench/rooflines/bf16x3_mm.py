"""``bf16x3_mm.cu`` (its tile, dot and short-k instances): the 3-pass bf16
product of G pairs (M, K)·(K, N), with the program's counter key
(G, M, N, K). Logical bytes: both operands read once and the product
written once, in float32. Logical operations: three passes of 2·M·N·K a
pair on the bf16 tensor cores."""

NAMES = ("bf16x3_tile_kernel", "bf16x3_dot_kernel", "bf16x3_short_k_kernel")
COUNTER = ("bf16x3_mm", "launches_by_shape")
PEAK = "bf16"


def ops_bytes(key):
    G, M, N, K = key
    return float(3 * 2 * G * M * N * K), float(4 * G * (M * K + K * N + M * N))
