"""Interleaved A/B of the device sampler's gather strategies on the card.

Counterpart of ``zigp_tpu/experiments/sampler_ab.py``. Three variants, each
a block of K steps captured once in a CUDA graph and replayed
(``measure.BlockStep``):

- ``staged``: the production sampler (``training.scan.StagedBlocks``,
  "device"): block b's K·B row indices drawn with one ``randint`` and
  gathered once, outside the graph, into the static (K, B, ·) block;
- ``perstep``: one ``randint`` and one gather a step, inside the captured
  block (the sampler the JAX package replaced). In a CUDA graph a random
  draw must come from the card's default generator, which torch registers
  with every capture and whose seed and offset a replay reads from the
  generator at replay time: the block seeds it with ``block_seed(0, b)``
  before each block, so its draws are a function of b. (A generator of
  one's own would have to be registered with the graph, which the port's
  ``CountedGraph`` does not do.) On the CPU a generator on the CPU is seeded
  the same way;
- ``fused``: ``staged`` with X and Y drawn by ONE gather of the
  concatenated [X|Y] (N, D + L), then split; the same indices and exact
  copies, so its losses equal ``staged``'s bit for bit.

``perstep`` draws another (equally valid) index stream than the other two:
its losses are comparable only with themselves.

    python -m zigp_tpu_torch.experiments.sampler_ab (--data PATH | --synthetic)
        [--configs flagship,champion] [--variants perstep,staged] [--blocks 8] [--inner 100]
        [--repeats 3] [--out PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from . import measure


def _make_perstep_gather_step(model, optimizer, arrays, batch: int, num_inner: int) -> measure.BlockStep:
    """One ``randint`` and one gather a step, inside the block."""
    from ..training import make_train_step
    from ..training.scan import block_seed

    p = next(model.parameters())
    X, Y = (torch.as_tensor(a, dtype=p.dtype).to(p.device) for a in arrays)
    N = X.shape[0]
    if p.is_cuda:
        gen = torch.cuda.default_generators[p.device.index if p.device.index is not None else
                                            torch.cuda.current_device()]
    else:
        gen = torch.Generator(device=p.device)
    step = make_train_step(optimizer)
    shape = torch.empty((num_inner, batch, X.shape[1]), device=p.device)  # tells the runner the device and K

    def body() -> torch.Tensor:
        out = []
        for _ in range(num_inner):
            idx = torch.randint(0, N, (batch,), device=p.device, generator=gen)
            out.append(step(model, X[idx], Y[idx]))
        return torch.stack(out)

    return measure.BlockStep(lambda b: gen.manual_seed(block_seed(0, b)), body, shape)


def _make_fused_gather_step(model, optimizer, arrays, batch: int, num_inner: int) -> measure.BlockStep:
    """``staged`` with one gather of [X|Y]."""
    from ..training import make_scan_train_step
    from ..training.scan import _draw, block_seed

    p = next(model.parameters())
    X, Y = (torch.as_tensor(a, dtype=p.dtype).to(p.device) for a in arrays)
    XY = torch.cat([X, Y.reshape(X.shape[0], -1)], dim=1)
    D, N = X.shape[1], X.shape[0]
    Xs = torch.empty((num_inner, batch, D), dtype=p.dtype, device=p.device)
    Ys = torch.empty((num_inner, batch, XY.shape[1] - D), dtype=p.dtype, device=p.device)
    gen = torch.Generator(device=p.device)

    def fill(b: int) -> None:
        rows = XY[_draw(gen, block_seed(0, b), N, num_inner * batch)].view(num_inner, batch, -1)
        Xs.copy_(rows[..., :D])
        Ys.copy_(rows[..., D:])

    body = make_scan_train_step(optimizer)
    return measure.BlockStep(fill, lambda: body(model, Xs, Ys), Xs)


_FACTORIES = {
    "staged": None,  # the production sampler (measure.prepare_step's default)
    "perstep": _make_perstep_gather_step,
    "fused": _make_fused_gather_step,
}


def run_sampler_ab(
    configs=("flagship", "champion"),
    variants=("perstep", "staged"),
    num_inner: int = 100,
    num_blocks: int = 8,
    repeats: int = 3,
    out=None,
    log_fn=print,
    build_kw=None,
):
    def measure_one(built, variant, *, num_inner, num_blocks):
        if variant not in _FACTORIES:
            raise ValueError(f"unknown variant {variant!r}")
        step, model, opt = measure.prepare_step(*built, step_factory=_FACTORIES[variant], num_inner=num_inner)
        return measure.measure_rate(step, model, opt, num_inner=num_inner, num_blocks=num_blocks)

    return measure.run_round_robin(
        "interleaved device-sampler gather A/B (staged block vs per-step gather vs fused [X|Y] gather)",
        configs, variants, measure_one, num_inner=num_inner, num_blocks=num_blocks, repeats=repeats, out=out,
        log_fn=log_fn, build_kw=build_kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs", type=str, default="flagship,champion")
    ap.add_argument("--variants", type=str, default="perstep,staged")
    ap.add_argument("--inner", type=int, default=100)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", type=str, default=None)
    measure.add_data_args(ap)
    args = ap.parse_args(argv)
    run_sampler_ab(configs=tuple(args.configs.split(",")), variants=tuple(args.variants.split(",")),
                   num_inner=args.inner, num_blocks=args.blocks, repeats=args.repeats, out=args.out,
                   build_kw=measure.build_kw_of(args))


if __name__ == "__main__":
    main()
