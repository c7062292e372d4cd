"""On-device numerics self-check: seconds on the card, after a driver,
CUDA or torch update.

Counterpart of ``zigp_tpu/experiments/selfcheck.py``. The kernels are
tested against their plain versions on the CPU; what runs on the card is
another artifact, and a numerics fault there would show only as drift in
quality. One command checks the production kernels on the card:

    python -m zigp_tpu_torch.experiments selfcheck        (or python -m zigp_tpu_torch.experiments.selfcheck)

Checks, each against an in-process float64 oracle (the JAX package's checks
and gates, with the gram's backward kernel added):

1. ``chol_inv`` at n = 100, one matrix: ``csrc/chol_inv.cu``;
2. ``chol_inv`` at n = 250, one matrix: ``csrc/chol_inv_cluster.cu``'s pair
   instance (``chol_inv_blocked``). For both, L and L⁻¹ of the same float32
   ``_spd_gram`` within max(3 × the card's torch.linalg.cholesky +
   solve_triangular error, 1e-5) of numpy float64;
3. ``rbf_gram``, 256 × 256, D = 3: within 1e-5 of the closed form; its
   backward kernel's dX, dZ, dℓ and dσ² within max(3 ×
   ``rbf_gram_bwd_plain``'s float32 error on the card, 1e-5) of float64;
4. the float32 ELBO of ``_small_model`` on the card (gram kernel on) within
   2e-2 of the CPU float32 ELBO and within 0.2 of the CPU float64 ELBO
   (torch holds both devices in one process: no oracle subprocess);
5. ten scanned steps with the kernels against the library route
   (``linalg.chol_inv_route`` forced to "library", the gram kernel off), on
   the same model and batches: final losses within 5e-3;
6. the tensor-parallel predict and KL on a one-rank ``Mesh`` against the
   single path, within 5e-4.

On the card every check's launches of ``chol_inv.cu``, the cluster kernel
and both gram kernels are counted (``ops.cuda.graphs.snapshot``) and must be
exactly what its shapes give; ``results["launches"]`` holds the total.
``--device cpu`` runs the plain versions (what the CPU tests run) and
expects no launch. Exit 0, or ``SystemExit`` naming the check that failed;
nothing is caught. ``--oracle-elbo`` prints the CPU float64 and float32 ELBOs
as the JAX package's oracle subprocess does.
"""

from __future__ import annotations

import argparse
import copy
import sys

import numpy as np
import torch

# pptr-like temporal knots: the span of time ÷ 1000; lengthscale 0.02 keeps
# off-diagonal mass in an n = 250 gram (the reference's 0.005 makes it
# nearly diagonal) and a moderate condition number.
_TSPAN = (4.368, 5.447)
LAUNCH_KEYS = ("chol_inv", "chol_inv_blocked", "rbf_gram", "rbf_gram_bwd")


def _spd_gram(n: int, ls: float = 0.02, var: float = 20.0, jitter: float = 1e-5) -> np.ndarray:
    """Float64 SPD matrix: the RBF gram of n temporal knots plus relative
    jitter (cast to float32 for the device)."""
    t = np.linspace(*_TSPAN, n)[:, None]
    d2 = (t - t.T) ** 2 / ls**2
    K = var * np.exp(-0.5 * d2)
    K += jitter * var * np.eye(n)
    return K


def _rel(a, b) -> float:
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check(log_fn, name, err, tol):
    status = "PASS" if err < tol else "FAIL"
    log_fn(f"selfcheck {name}: rel err {err:.3e} (tol {tol:.0e}) {status}")
    if err >= tol:
        raise SystemExit(f"selfcheck FAILED: {name} rel err {err:.3e} >= {tol:.0e}")


def _small_model(seed=0, n_t=16, ls_t=0.005, use_kernel: bool = False):
    """The JAX package's small KronOnOffSVGP (6 spatial × n_t temporal per
    GP), deterministic in numpy, in float64 on the CPU: spatial lengthscale
    8 gives the production regime's ill-conditioned spatial gram (cond ≈
    6e4); temporal 0.005 keeps the temporal factor near-diagonal. The scan
    A/B uses (n_t=100, ls_t=0.02), so the temporal factorization has real
    off-diagonal work. ``use_kernel``: grams by ``rbf_gram``."""
    from ..likelihoods import OnOffGaussian
    from ..models import KronOnOffSVGP
    from ..ops.kernels import RBF

    rng = np.random.RandomState(seed)
    Zsp = np.stack([59.8 + 10.3 * rng.rand(6), 20.0 + 11.0 * rng.rand(6)], 1)
    Zs = [Zsp, np.linspace(*_TSPAN, n_t)[:, None]]

    def kerns(v):
        return [RBF.create([8.0, 8.0], v, lr=1e-3, use_kernel=use_kernel),
                RBF.create([ls_t], v, lr=1e-3, use_kernel=use_kernel)]

    return KronOnOffSVGP.create(
        kerns(20.0), Zs, kerns(10.0), [Z.copy() for Z in Zs], OnOffGaussian.create(0.01, lr=1e-3),
        num_data=512, jitter=1e-5, seed=seed, lr=1e-3,
    )


def _elbo_batch(B=128, seed=0):
    rng = np.random.RandomState(seed + 1000)
    X = np.stack(
        [59.8 + 10.3 * rng.rand(B), 20.0 + 11.0 * rng.rand(B), _TSPAN[0] + (_TSPAN[1] - _TSPAN[0]) * rng.rand(B)],
        axis=1,
    )
    Y = np.maximum(rng.randn(B, 1), 0.0)
    Y[rng.rand(B, 1) < 0.9] = 0.0
    return X, Y


def _t(a, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)


def oracle_elbos() -> tuple:
    """(CPU float64 ELBO, CPU float32 ELBO) of ``_small_model`` on ``_elbo_batch``."""
    model = _small_model()
    X, Y = _elbo_batch()
    with torch.no_grad():
        v64 = float(model.elbo(_t(X, "cpu", torch.float64), _t(Y, "cpu", torch.float64)))
        m32 = copy.deepcopy(model).to(dtype=torch.float32)
        v32 = float(m32.elbo(_t(X, "cpu"), _t(Y, "cpu")))
    return v64, v32


def _oracle_elbo_main():
    v64, v32 = oracle_elbos()
    print(f"ORACLE_ELBO_F64 {v64!r}")
    print(f"ORACLE_ELBO_F32 {v32!r}")


def step_launches(model, *, training: bool) -> dict:
    """The kernels' launches in one loss evaluation of a Kronecker model on
    the card (with ``training``, its backward too): K_mm and K_mn of each RBF
    leaf whose gram kernel is on, each differentiated by one backward
    launch; one ``chol_inv`` a factor, ``chol_inv.cu`` to ``MAX_N``, the
    cluster kernel above. A stacked f/g pair shares each launch."""
    from ..ops.cuda.chol_inv import MAX_N
    from ..ops.kernels import flag_leaves

    gp = model.gp if hasattr(model, "gp") else (model.f if hasattr(model, "f") else model)
    sizes = [Z.shape[0] for Z in gp.Zs]
    grams = 2 * sum(flag_leaves(gp.kernel_flags()))
    return {"chol_inv": sum(n <= MAX_N for n in sizes), "chol_inv_blocked": sum(n > MAX_N for n in sizes),
            "rbf_gram": grams, "rbf_gram_bwd": grams if training else 0}


class _Launches:
    """The kernels' launches (``LAUNCH_KEYS``) made inside the block."""

    def __enter__(self):
        from ..ops.cuda import graphs

        self.before = graphs.snapshot()
        return self

    def __exit__(self, *exc):
        from ..ops.cuda import graphs

        by_fn = {fn: d for (fn, attr), d in graphs.change(self.before, graphs.snapshot()).items() if attr == "launches"}
        self.counts = {name: by_fn.get(fn, 0) for name, fn in graphs.counted_wrappers().items() if name in LAUNCH_KEYS}
        return False


def _check_launches(log_fn, name, got: dict, want: dict, device) -> None:
    want = {k: (want.get(k, 0) if device.type == "cuda" else 0) for k in LAUNCH_KEYS}
    log_fn(f"selfcheck {name} launches: {got} (expected {want})")
    if got != want:
        raise SystemExit(f"selfcheck FAILED: {name} launched {got}, expected {want}")


def run_selfcheck(log_fn=print, *, device=None) -> dict:
    """The checks of the module docstring on ``device`` (``None`` is the
    CUDA card); the JAX package's result keys, each check's launches, and
    ``launches``, their total."""
    from ..core.config import resolve_device
    from ..ops import linalg
    from ..ops.cuda import chol_inv as ci
    from ..ops.cuda import rbf_gram as rg

    device = resolve_device(device)
    on_card = device.type == "cuda"
    log_fn(f"selfcheck device: {device} ({torch.cuda.get_device_name(device) if on_card else 'cpu'}); "
           + ("the kernels" if on_card else "the kernels' plain versions"))
    results = {}
    total = dict.fromkeys(LAUNCH_KEYS, 0)

    def counted(name, launches, want):
        _check_launches(log_fn, name, launches.counts, want, device)
        for k, v in launches.counts.items():
            total[k] += v
        results[name]["launches"] = launches.counts

    # 1/2. The Cholesky-and-inverse kernels against numpy float64 (the same
    # float32 input both ways). The float64 gap of any float32 factorization
    # grows with the gram's conditioning, so the gate is relative to what
    # the card's library route reaches on the same matrix.
    for name, fn, n, key in (("chol_inv_pallas[n=100]", ci.chol_inv_cuda, 100, "chol_inv"),
                             ("chol_inv_blocked[n=250]", ci.chol_inv_blocked, 250, "chol_inv_blocked")):
        K32 = _spd_gram(n).astype(np.float32)
        L_ref = np.linalg.cholesky(K32.astype(np.float64))
        Linv_ref = np.linalg.inv(L_ref)
        K = _t(K32[None], device)
        with _Launches() as launches:
            L, Linv = fn(K)
            if on_card:
                torch.cuda.synchronize(device)
        Ll = torch.linalg.cholesky(K)
        Linvl = torch.linalg.solve_triangular(Ll, torch.eye(n, dtype=K.dtype, device=device)[None], upper=False)
        err_L, err_inv = _rel(torch.tril(L[0]), L_ref), _rel(torch.tril(Linv[0]), Linv_ref)
        lib_L, lib_inv = _rel(torch.tril(Ll[0]), L_ref), _rel(torch.tril(Linvl[0]), Linv_ref)
        log_fn(f"selfcheck {name}: the library f32 baseline on the device L {lib_L:.3e}, L^-1 {lib_inv:.3e}")
        _check(log_fn, f"{name} L", err_L, max(3.0 * lib_L, 1e-5))
        _check(log_fn, f"{name} L^-1", err_inv, max(3.0 * lib_inv, 1e-5))
        results[name] = {"err_L": err_L, "err_Linv": err_inv, "xla_err_L": lib_L, "xla_err_Linv": lib_inv}
        counted(name, launches, {key: 1})

    # 3. The gram against its closed form in float64, and its backward kernel
    # against float64 beside the plain backward's float32 error.
    rng = np.random.RandomState(3)
    Xg = rng.rand(256, 3).astype(np.float32)
    ls = np.array([0.7, 1.3, 0.4], np.float32)
    var = np.float32(2.5)
    gK = rng.randn(1, 256, 256).astype(np.float32)
    args32 = [_t(a, device) for a in (Xg, Xg.copy(), ls[None], np.array([var]))]
    with _Launches() as launches:
        G = rg.rbf_gram_cuda(*args32)
        grads = rg.rbf_gram_bwd_cuda(*args32, G, _t(gK, device), (True, True, True, True))
        if on_card:
            torch.cuda.synchronize(device)
    Xs = Xg.astype(np.float64) / ls.astype(np.float64)
    G_ref = float(var) * np.exp(-0.5 * ((Xs[:, None, :] - Xs[None, :, :]) ** 2).sum(-1))
    err_g = _rel(G[0], G_ref)
    _check(log_fn, "rbf_gram[256x256]", err_g, 1e-5)
    args64 = [a.detach().cpu().double() for a in args32]
    K64 = rg.rbf_gram_plain(*args64)
    want = rg.rbf_gram_bwd_plain(*args64, K64, torch.as_tensor(gK, dtype=torch.float64), (True,) * 4)
    plain = rg.rbf_gram_bwd_plain(*args32, rg.rbf_gram_plain(*args32), _t(gK, device), (True,) * 4)
    bwd = {}
    for what, g, p, w in zip(("dX", "dZ", "dell", "dvar"), grads, plain, want):
        err, err_plain = _rel(g, w), _rel(p, w)
        _check(log_fn, f"rbf_gram backward {what}", err, max(3.0 * err_plain, 1e-5))
        bwd[what] = {"err": err, "plain_err": err_plain}
    results["rbf_gram"] = {"err": err_g, "bwd": bwd}
    counted("rbf_gram", launches, {"rbf_gram": 1, "rbf_gram_bwd": 1})

    # 4. The card's float32 ELBO against the CPU's float32 and float64.
    # Float32 on two devices differs by reduction order, at most 2e-2 at
    # this conditioning (the check that caught the JAX package's bf16 fault,
    # 530 × off); the float32 to float64 gap is set by the conditioning
    # (gated at 0.2).
    X, Y = _elbo_batch()
    model = _small_model(use_kernel=on_card).to(device=device, dtype=torch.float32)
    with _Launches() as launches, torch.no_grad():
        elbo_dev = float(model.elbo(_t(X, device), _t(Y, device)))
    o64, o32 = oracle_elbos()
    err_b = abs(elbo_dev - o32) / max(abs(o32), 1e-30)
    err_p = abs(elbo_dev - o64) / max(abs(o64), 1e-30)
    log_fn(f"selfcheck elbo: device {elbo_dev:.2f} vs cpu-f32 {o32:.2f} vs cpu-f64 {o64:.2f}")
    _check(log_fn, "elbo device-f32 vs cpu-f32", err_b, 2e-2)
    _check(log_fn, "elbo device-f32 vs cpu-f64 (conditioning-bound)", err_p, 0.2)
    results["elbo"] = {"device": elbo_dev, "cpu_f32": o32, "cpu_f64": o64, "err_backend": err_b,
                       "err_precision": err_p}
    counted("elbo", launches, step_launches(model, training=False))

    # 5. Ten scanned steps with the kernels against the library route, the
    # same model and batches. Ten optimizer steps amplify last-bit
    # differences; a kernel fault is orders of magnitude larger: 5e-3.
    from ..training import make_optimizer, make_scan_train_step

    Xs10, Ys10 = zip(*[_elbo_batch(128, seed=100 + i) for i in range(10)])
    Xs10, Ys10 = _t(np.stack(Xs10), device), _t(np.stack(Ys10), device)

    def ten_steps(kernels: bool):
        m = _small_model(seed=7, n_t=100, ls_t=0.02, use_kernel=kernels and on_card)
        m = m.to(device=device, dtype=torch.float32)
        losses = make_scan_train_step(make_optimizer(m, default_lr=1e-3))(m, Xs10, Ys10)
        return losses.cpu().numpy(), m

    with _Launches() as launches:
        losses_kernels, m = ten_steps(True)
    route = linalg.chol_inv_route
    linalg.chol_inv_route = lambda n, dtype, device_type: "library"
    try:
        with _Launches() as lib_launches:
            losses_library, _ = ten_steps(False)
    finally:
        linalg.chol_inv_route = route
    if not (np.isfinite(losses_kernels).all() and np.isfinite(losses_library).all()):
        raise SystemExit(f"selfcheck FAILED: non-finite scan losses (kernels {losses_kernels[-1]}, library "
                         f"{losses_library[-1]})")
    err_s = abs(losses_kernels[-1] - losses_library[-1]) / max(abs(losses_library[-1]), 1e-30)
    log_fn(f"selfcheck scan A/B: kernels loss {losses_kernels[-1]:.6f} vs library {losses_library[-1]:.6f}")
    _check(log_fn, "scan kernels-vs-library", err_s, 5e-3)
    results["scan_ab"] = {"pallas": float(losses_kernels[-1]), "xla": float(losses_library[-1]), "err": err_s}
    counted("scan_ab", launches, {k: 10 * v for k, v in step_launches(m, training=True).items()})
    _check_launches(log_fn, "scan_ab library route", lib_launches.counts, {}, device)

    # 6. The tensor-parallel predict and KL on a one-rank mesh against the
    # single path (same float32 contractions: agreement is reduction order,
    # about 1e-6; a reduced-precision product is about 4e-3): 5e-4.
    from ..models import KronGP
    from ..ops.kernels import RBF
    from ..parallel import make_mesh
    from ..parallel.tp import tp_whitened_kron_predict_and_kl

    rng = np.random.RandomState(17)
    Zsp = np.stack([59.8 + 10.3 * rng.rand(8), 20.0 + 11.0 * rng.rand(8)], 1)
    gp = KronGP.create([RBF.create([8.0, 8.0], 20.0), RBF.create([0.02], 20.0)],
                       [Zsp, np.linspace(*_TSPAN, 64)[:, None]], jitter=1e-5, whiten=True, seed=17,
                       q_mu_init=rng.randn(8 * 64, 1)).to(device=device, dtype=torch.float32)
    Xtp = _t(_elbo_batch(256, seed=17)[0], device)
    mesh1 = make_mesh(n_data=1, n_model=1, devices=[device])
    with _Launches() as launches, torch.no_grad():
        mu_tp, var_tp, kl_tp = tp_whitened_kron_predict_and_kl(
            mesh1, gp.kernels, [Z.value for Z in gp.Zs], gp.q_mu.value, gp.q_sqrt.value, Xtp, gp.input_masks,
            jitter=gp.jitter)
        mu_ref, var_ref = gp.predict_f(Xtp)
        kl_ref = float(gp.prior_kl())
    err_mu, err_var = _rel(mu_tp, mu_ref), _rel(var_tp, var_ref)
    err_kl = abs(float(kl_tp) - kl_ref) / max(abs(kl_ref), 1e-30)
    log_fn(f"selfcheck tp-vs-single: mu {err_mu:.3e} var {err_var:.3e} kl {err_kl:.3e}")
    _check(log_fn, "tp predict mean", err_mu, 5e-4)
    _check(log_fn, "tp predict var", err_var, 5e-4)
    _check(log_fn, "tp kl", err_kl, 5e-4)
    results["tp"] = {"err_mu": err_mu, "err_var": err_var, "err_kl": err_kl}
    counted("tp", launches, step_launches(gp, training=False))

    results["launches"] = total
    log_fn(f"selfcheck launches: {total}")
    log_fn("selfcheck: ALL PASS")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zigp_tpu_torch.experiments.selfcheck", description=__doc__.split("\n")[0])
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--oracle-elbo", action="store_true", dest="oracle_elbo",
                    help="print the CPU float64 and float32 ELBOs of the small model and exit")
    args = ap.parse_args(argv)
    if args.oracle_elbo:
        _oracle_elbo_main()
        return 0
    run_selfcheck(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
