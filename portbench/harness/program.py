"""The program under test, the port ``zigp_tpu_torch``, reached only here.

The model is built through the port's public constructors from the
benchmark's inputs (``harness.data``): the grid's factors, the kernel
inits and the variational values, so the reference needs nothing that the
port derived. The kernels' launch counters (``ops.cuda.graphs``) are read
by name for the roofline census.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

import torch


def build_model(cfg: dict, state: dict, num_data: int, device: torch.device):
    """``KronOnOffSVGP`` of the configuration on ``device`` in float32:
    f and g on the state's grid, RBF factors (the ``rbf_gram`` kernel on the
    card), ``OnOffGaussian``, diagonal q; q_mu and q_sqrt set to the state's
    values after ``create`` (``Parameter.assign_``)."""
    from zigp_tpu_torch.likelihoods import OnOffGaussian
    from zigp_tpu_torch.models import KronOnOffSVGP
    from zigp_tpu_torch.ops.kernels import RBF

    use_kernel = device.type == "cuda"
    lr_k, lr_i = cfg["lr"]["kern"], cfg["lr"]["indp"]

    def kernels(gp):
        return [RBF.create(list(k["lengthscales"]), float(k["variance"]), lr=lr_k, use_kernel=use_kernel)
                for k in state[gp]["kernels"]]

    model = KronOnOffSVGP.create(
        kernels("f"), [Z.copy() for Z in state["f"]["Zs"]],
        kernels("g"), [Z.copy() for Z in state["g"]["Zs"]],
        OnOffGaussian.create(state["noise_variance"], lr=lr_k),
        num_data=num_data, jitter=cfg["jitter"], seed=0, lr=lr_i, q_mu_scale=cfg["q_mu_scale"],
        exact_owen_t=cfg["exact_owen_t"], whiten=cfg["whiten"], q_cov=cfg["q_cov"],
    )
    for gp in ("f", "g"):
        m = getattr(model, gp)
        m.q_mu.assign_(state[gp]["q_mu"])
        m.q_sqrt.assign_(state[gp]["q_sqrt"])
    return model.to(device=device, dtype=torch.float32)


def counters() -> Dict[str, Dict[str, Counter]]:
    """{kernel wrapper: {counter attribute: Counter}} of every launch
    counter of the port, copied."""
    from zigp_tpu_torch.ops.cuda import graphs

    out = {}
    for name, fn in graphs.counted_wrappers().items():
        out[name] = {attr: Counter(getattr(fn, attr)) for attr in graphs.COUNTER_ATTRS if hasattr(fn, attr)}
    return out


def counter_change(before: dict, after: dict) -> Dict[str, Dict[str, Counter]]:
    """What each counter gained from ``before`` to ``after``."""
    out = {}
    for name, attrs in after.items():
        out[name] = {attr: Counter({k: v - before[name][attr].get(k, 0) for k, v in c.items()
                                    if v != before[name][attr].get(k, 0)}) for attr, c in attrs.items()}
    return out


def solve_precision(policy: str):
    """The port's ``--solve-precision`` context (set before any model is built)."""
    from zigp_tpu_torch.experiments.measure import solve_precision as ctx

    return ctx(policy)

