"""Interleaved A/B: joint training against the block-coordinate schedule.

Counterpart of ``zigp_tpu/experiments/alternating_ab.py``, on the
measurement convention of ``experiments.measure`` (a fresh copy of the
model a run, the warm-up blocks and the capture untimed, interleaved round
robin, medians). Variants: ``joint`` (the production device-sampler block)
and ``alt<K>`` (``training.alternating.make_alternating_block`` with
hyper_every K: the hyperparameters update once per K steps, the q-only
steps between take one factorization). Both draw the same rows for a block
(``training.scan.StagedBlocks``, "device").

    python -m zigp_tpu_torch.experiments.alternating_ab (--data PATH | --synthetic)
        [--configs flagship,scale] [--variants joint,alt10,alt50] [--out PATH] [--device cuda|cpu]

The variants run different update schedules, so their losses are not
comparable step for step; this harness measures throughput only.
"""

from __future__ import annotations

import argparse
import copy

from . import measure


def _prepare(built, variant: str, num_inner: int):
    from ..training import DataSet, StagedBlocks
    from ..training.alternating import init_alt_optimizers, make_alternating_block

    if variant == "joint":
        return measure.prepare_step(*built, num_inner=num_inner)
    if not variant.startswith("alt"):
        raise ValueError(f"unknown variant {variant!r}")
    k = int(variant[3:])
    model, arrays, batch, cfg = built
    model = copy.deepcopy(model)
    opt = init_alt_optimizers(model, learning_rate=cfg.indp_lr)
    block = make_alternating_block(model, opt, k)
    p = next(model.parameters())
    blocks = StagedBlocks(DataSet(*arrays), "device", batch, num_inner, device=p.device, dtype=p.dtype)
    return measure.BlockStep(blocks.fill, lambda: block(blocks.Xs, blocks.Ys), blocks.Xs), model, opt


def _measure_one(built, variant, *, num_inner, num_blocks):
    step, model, opt = _prepare(built, variant, num_inner)
    return measure.measure_rate(step, model, opt, num_inner=num_inner, num_blocks=num_blocks)


def run_alternating_ab(configs=("flagship", "scale"), variants=("joint", "alt10", "alt50"), num_inner: int = 100,
                       num_blocks: int = 100, repeats: int = 3, out=None, log_fn=print, build_kw=None):
    return measure.run_round_robin("alternating_ab", configs, variants, _measure_one, num_inner=num_inner,
                                   num_blocks=num_blocks, repeats=repeats, out=out, log_fn=log_fn, build_kw=build_kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs", type=str, default="flagship,scale")
    ap.add_argument("--variants", type=str, default="joint,alt10,alt50")
    ap.add_argument("--num-inner", type=int, default=100, dest="num_inner")
    ap.add_argument("--num-blocks", type=int, default=100, dest="num_blocks")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", type=str, default=None)
    measure.add_data_args(ap)
    args = ap.parse_args(argv)
    run_alternating_ab([c.strip() for c in args.configs.split(",") if c.strip()],
                       [v.strip() for v in args.variants.split(",") if v.strip()], num_inner=args.num_inner,
                       num_blocks=args.num_blocks, repeats=args.repeats, out=args.out,
                       build_kw=measure.build_kw_of(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
