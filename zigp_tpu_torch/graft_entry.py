"""Entry points for a compile-and-run check of the port.

Counterpart of the repository root's ``__graft_entry__.py``:

- ``entry()``: ``(fn, args)``, the flagship model's ELBO forward (the
  Kronecker zero-inflated on/off GP at the pptr production configuration:
  10 × 100 inducing grid a GP, batch 1000) on the card in float32, its
  grams by ``rbf_gram.cu`` and its factors by ``chol_inv.cu``;
  ``fn(*args)`` is the ELBO.
- ``dryrun_multichip(n)``: one data-parallel training step and the
  tensor-parallel predict and KL over n ranks of the port's ``parallel``
  layer, each rank a process spawned here: gloo ranks on the CPU
  (``device="cpu"``), or NCCL on n cards. Each rank's loss, KL and their
  agreement with the one-rank path are returned.

    python -m zigp_tpu_torch.graft_entry [--ranks 2] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import pickle
import tempfile
import traceback

import numpy as np
import torch

T_SPAN = (4.368, 5.447)


def _flagship(num_spatial=10, num_temporal=100, num_data=105_280, jitter=1e-5, seed=0, use_kernel=False):
    """The flagship on/off model in float64 on the CPU: the JAX entry's
    inits (realistic pptr coordinate ranges: lat 59.8–70.1, lon 20.0–31.0,
    time ÷ 1000 4.368–5.447)."""
    from .likelihoods import OnOffGaussian
    from .models import KronOnOffSVGP
    from .ops.kernels import RBF

    rng = np.random.RandomState(seed)
    Zsp = np.stack([59.8 + 10.3 * rng.rand(num_spatial), 20.0 + 11.0 * rng.rand(num_spatial)], 1)
    Zs = [Zsp, np.linspace(*T_SPAN, num_temporal)[:, None]]

    def kerns(v):
        return [RBF.create([8.0, 8.0], v, lr=1e-3, use_kernel=use_kernel),
                RBF.create([0.005], v, lr=1e-3, use_kernel=use_kernel)]

    return KronOnOffSVGP.create(kerns(20.0), Zs, kerns(10.0), [Z.copy() for Z in Zs],
                                OnOffGaussian.create(0.01, lr=1e-3), num_data=num_data, jitter=jitter, seed=seed,
                                lr=1e-3)


def _batch(B, seed=0):
    """(X, Y) float64 numpy: B pptr-shaped rows, 90 % of the targets zero."""
    rng = np.random.RandomState(seed + 100)
    X = np.stack([59.8 + 10.3 * rng.rand(B), 20.0 + 11.0 * rng.rand(B), 4.368 + 1.079 * rng.rand(B)], axis=1)
    Y = np.maximum(rng.randn(B, 1), 0.0)
    Y[rng.rand(B, 1) < 0.9] = 0.0
    return X, Y


def entry(device=None, dtype: torch.dtype = torch.float32):
    """(fn, (model, X, Y)): the flagship's ELBO forward at B = 1000 on
    ``device`` (``None`` is the CUDA card, with the gram kernel on)."""
    from .core.config import resolve_device

    device = resolve_device(device)
    model = _flagship(use_kernel=device.type == "cuda").to(device=device, dtype=dtype)
    X, Y = (torch.as_tensor(a, dtype=dtype).to(device) for a in _batch(1000))

    def fn(model, X, Y):
        with torch.no_grad():
            return model.elbo(X, Y)

    return fn, (model, X, Y)


def _rank(rank: int, world: int, store: str, device: str, out: str) -> None:
    """One rank of ``dryrun_multichip``: its results (or its traceback) in
    ``out/<rank>.pkl``."""
    from .parallel import make_mesh, make_sharded_train_step, replicate
    from .parallel.distributed import initialize, shutdown
    from .training import make_optimizer

    res = {}
    try:
        backend = "nccl" if device == "cuda" else "gloo"
        initialize(f"file://{store}", world, rank, backend=backend)
        dev = torch.device("cuda", rank) if device == "cuda" else torch.device("cpu")
        dtype = torch.float32 if device == "cuda" else torch.float64
        t = lambda a: torch.as_tensor(a, dtype=dtype).to(dev)

        # data parallelism: the full training step, the batch split over all ranks
        mesh = make_mesh(n_data=world, devices=[dev] * world if device == "cpu" else None)
        model = _flagship(4, 8, 1024, use_kernel=device == "cuda").to(device=dev, dtype=dtype)
        single = _flagship(4, 8, 1024, use_kernel=device == "cuda").to(device=dev, dtype=dtype)
        replicate(mesh, model)
        X, Y = (t(a) for a in _batch(8 * world))
        loss = float(make_sharded_train_step(make_optimizer(model, default_lr=1e-3), mesh)(model, X, Y))
        with torch.no_grad():
            ref = float(single.loss(X, Y))
        res["dp_loss"], res["dp_rel"] = loss, abs(loss - ref) / abs(ref)

        # tensor parallelism: the spatial rows of q partitioned over the model axis
        from .models import KronGP
        from .ops.kernels import RBF
        from .parallel.tp import tp_whitened_kron_predict_and_kl

        tp_mesh = make_mesh(n_data=1, n_model=world, devices=[dev] * world if device == "cpu" else None)
        rng = np.random.RandomState(0)
        gp = KronGP.create([RBF.create([1.0, 1.0], 1.0), RBF.create([0.3], 1.0)],
                           [rng.rand(2 * world, 2), rng.rand(8, 1)], jitter=1e-5, whiten=True).to(device=dev,
                                                                                                  dtype=dtype)
        Xp = t(rng.rand(16, 3))
        with torch.no_grad():
            mu, var, kl = tp_whitened_kron_predict_and_kl(tp_mesh, gp.kernels, [Z.value for Z in gp.Zs],
                                                          gp.q_mu.value, gp.q_sqrt.value, Xp, gp.input_masks,
                                                          jitter=gp.jitter)
            mu_ref, var_ref = gp.predict_f(Xp)
            kl_ref = float(gp.prior_kl())
        res["tp_kl"], res["tp_kl_rel"] = float(kl), abs(float(kl) - kl_ref) / abs(kl_ref)
        res["tp_mu_rel"] = float(torch.linalg.norm(mu - mu_ref) / torch.linalg.norm(mu_ref))
        res["tp_var_rel"] = float(torch.linalg.norm(var - var_ref) / torch.linalg.norm(var_ref))
        shutdown()
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        res = {"error": traceback.format_exc()}
    with open(os.path.join(out, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def dryrun_multichip(n_devices: int, *, device=None, log_fn=print) -> list:
    """One data-parallel step and the tensor-parallel predict and KL over
    ``n_devices`` spawned ranks (gloo on the CPU with ``device="cpu"``, NCCL
    on ``n_devices`` cards by default), each checked finite and against the
    one-rank path (1e-5 relative in float32 on the card, 1e-10 in float64 on
    the CPU). Returns every rank's results; raises on any failure."""
    import torch.multiprocessing as mp

    device = "cuda" if device is None else str(device)
    if device == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}): NCCL needs {n_devices} cards, this machine has "
                           f"{torch.cuda.device_count()}; pass device='cpu' for gloo ranks")
    tol = 1e-5 if device == "cuda" else 1e-10
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(n_devices, os.path.join(tmp, "store"), device, tmp), nprocs=n_devices, join=True)
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    for r, res in enumerate(ranks):
        if "error" in res:
            raise RuntimeError(f"dryrun_multichip({n_devices}) rank {r} failed:\n{res['error']}")
        bad = {k: v for k, v in res.items() if not np.isfinite(v) or (k.endswith("_rel") and not v <= tol)}
        if bad:
            raise AssertionError(f"dryrun_multichip({n_devices}) rank {r}: {bad} (tolerance {tol:.0e})")
    log_fn(f"dryrun_multichip({n_devices}) {device}: dp loss={ranks[0]['dp_loss']:.4f} "
           f"(one-rank rel {ranks[0]['dp_rel']:.2e}), tp kl={ranks[0]['tp_kl']:.4f} OK")
    return ranks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zigp_tpu_torch.graft_entry", description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, device=args.device)
    fn, fargs = entry(device=args.device)
    print("entry() ELBO:", float(fn(*fargs)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
