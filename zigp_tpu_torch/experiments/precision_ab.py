"""Interleaved A/B of the solve-product precision policies on the card.

Counterpart of ``zigp_tpu/experiments/precision_ab.py``, on the
measurement convention of ``experiments.measure``. The port has one
policy, ``highest`` (full float32 products: TF32 is off for every
contraction, ``core.config``); ``high`` and ``mixed`` are left unported on
purpose (their Hopper analog, TF32, is coarser than the TPU's 3-pass
products) and stop the run, "not ported", before any work. So the harness
measures ``highest`` alone, the baseline a later policy would be held to.

    python -m zigp_tpu_torch.experiments.precision_ab (--data PATH | --synthetic)
        [--configs flagship,champion] [--policies highest] [--blocks 8] [--inner 100] [--repeats 3]
        [--out PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

from . import measure

POLICIES = ("highest",)


def run_precision_ab(configs=("flagship", "champion"), policies=("highest",), num_inner: int = 100,
                     num_blocks: int = 8, repeats: int = 3, out=None, log_fn=print, build_kw=None):
    for policy in policies:
        measure.refuse_precision(policy)

    def measure_one(built, policy, *, num_inner, num_blocks):
        step, model, opt = measure.prepare_step(*built, num_inner=num_inner)
        return measure.measure_rate(step, model, opt, num_inner=num_inner, num_blocks=num_blocks)

    return measure.run_round_robin("interleaved solve-precision A/B (the port's policies: highest)", configs,
                                   policies, measure_one, num_inner=num_inner, num_blocks=num_blocks,
                                   repeats=repeats, out=out, log_fn=log_fn, build_kw=build_kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs", type=str, default="flagship,champion")
    ap.add_argument("--policies", type=str, default="highest")
    ap.add_argument("--inner", type=int, default=100)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", type=str, default=None)
    measure.add_data_args(ap)
    args = ap.parse_args(argv)
    policies = tuple(args.policies.split(","))
    for policy in policies:
        measure.refuse_precision(policy)
    run_precision_ab(configs=tuple(args.configs.split(",")), policies=policies, num_inner=args.inner,
                     num_blocks=args.blocks, repeats=args.repeats, out=args.out, build_kw=measure.build_kw_of(args))


if __name__ == "__main__":
    main()
