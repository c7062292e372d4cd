"""The frozen count of the conditional's products a row (``harness.counts.serve_row_flops``) times
the traced rows, over the stretch's seconds, over the dense bf16 peak."""

from portbench.harness import peaks


def read(r):
    if not r.rows or r.window_s <= 0:
        return None
    return 100.0 * r.serve_flops() / r.window_s / peaks.BF16_FLOPS
