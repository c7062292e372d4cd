"""Interleaved A/B of the solve-product precision policies on the card.

Counterpart of ``zigp_tpu/experiments/precision_ab.py``, on the
measurement convention of ``experiments.measure``: any subset of the
policies "highest", "high" and "mixed" (``ops.linalg.set_solve_precision``;
the 3-pass products are ``ops.cuda.bf16x3``'s kernel on the card) at the
flagship, the champion and the 105 × 250 grid, in round robin within one
process. Each pass sets its policy, then builds a fresh ``BlockStep``,
whose captured block keeps the policy it captured (JAX's freshly traced
step); "highest" is put back when the harness ends, whatever happens.

    python -m zigp_tpu_torch.experiments.precision_ab (--data PATH | --synthetic)
        [--configs flagship,champion] [--policies highest,mixed] [--blocks 8] [--inner 100] [--repeats 3]
        [--out PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

from . import measure

POLICIES = ("highest", "high", "mixed")


def run_precision_ab(configs=("flagship", "champion"), policies=("highest", "mixed"), num_inner: int = 100,
                     num_blocks: int = 8, repeats: int = 3, out=None, log_fn=print, build_kw=None):
    from ..ops import linalg

    for policy in policies:
        if policy not in POLICIES:
            raise SystemExit(f"error: unknown policy {policy!r}; choose from {', '.join(POLICIES)}")

    def measure_one(built, policy, *, num_inner, num_blocks):
        linalg.set_solve_precision(policy)  # before the step is built: its graph keeps it
        step, model, opt = measure.prepare_step(*built, num_inner=num_inner)
        return measure.measure_rate(step, model, opt, num_inner=num_inner, num_blocks=num_blocks)

    try:
        return measure.run_round_robin("interleaved solve-precision A/B (see ops.linalg.set_solve_precision)",
                                       configs, policies, measure_one, num_inner=num_inner, num_blocks=num_blocks,
                                       repeats=repeats, out=out, log_fn=log_fn, build_kw=build_kw)
    finally:
        linalg.set_solve_precision("highest")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs", type=str, default="flagship,champion")
    ap.add_argument("--policies", type=str, default="highest,mixed")
    ap.add_argument("--inner", type=int, default=100)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", type=str, default=None)
    measure.add_data_args(ap)
    args = ap.parse_args(argv)
    return run_precision_ab(configs=tuple(args.configs.split(",")), policies=tuple(args.policies.split(",")),
                            num_inner=args.inner, num_blocks=args.blocks, repeats=args.repeats, out=args.out,
                            build_kw=measure.build_kw_of(args))


if __name__ == "__main__":
    main()
