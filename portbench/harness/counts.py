"""Frozen model-FLOP counts of the paired-GP factored conditional.

``train_step_flops`` is a copy of the program's
``experiments.measure.analytic_matmul_flops``: the logical matmul FLOPs of
one training step, forward and backward, of the two GPs (f and g). Per GP
forward V_p = L_p⁻¹Kmn_p and A_p = K_p⁻¹Kmn_p at 2·M_p²·B each (both
factors), plus the mean and c2 grid contractions at 2·Ms·Mt·B each;
reverse mode doubles every product, so the step is 3 × the forward. The KL,
the grams and the elementwise work are left out.

``serve_row_flops`` is the forward alone, a row: what one served row's
conditional costs in products, for the two GPs."""


def forward_flops_per_gp(batch: int, num_spatial: int, num_temporal: int) -> float:
    Ms, Mt, B = num_spatial, num_temporal, batch
    return 4.0 * B * (Ms * Ms + Mt * Mt) + 4.0 * B * Ms * Mt


def train_step_flops(batch: int, num_spatial: int, num_temporal: int) -> float:
    return 3.0 * 2.0 * forward_flops_per_gp(batch, num_spatial, num_temporal)


def serve_row_flops(num_spatial: int, num_temporal: int) -> float:
    return 2.0 * forward_flops_per_gp(1, num_spatial, num_temporal)
