"""The frozen model-FLOP count of a step (``harness.counts.train_step_flops``) times the traced
steps, over the stretch's seconds, over the card's dense bf16 peak (989 TFLOP/s): the highest
rate any of the port's precision policies reaches, so the share cannot pass 100 %."""

from portbench.harness import peaks


def read(r):
    if not r.steps or r.window_s <= 0:
        return None
    return 100.0 * r.train_flops() / r.window_s / peaks.BF16_FLOPS
