"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught, so any failure exits
non-zero):

1. The card's name and power limit, the torch and CUDA versions; build every
   CUDA source under ``zigp_tpu_torch/ops/cuda/csrc`` (one nvcc each, in
   parallel) and report the time.
2. The ``chol_inv`` kernel against a float64 numpy oracle and against its
   plain PyTorch version on the card, on RBF grams of time knots at
   n = 10, 32, 100, 105, 127, 128 and, through the blocked routine, at
   n = 200, 250, 512 (two matrices each). The kernel's relative error in L
   and in L⁻¹ must be at most max(3 × the error of torch.linalg.cholesky +
   solve_triangular on the same input, 1e-5), and its distance from the
   plain version at most the same bound. A non-PSD input must give NaN.
3. The serving path at full width on a seeded pptr-shaped set (105 stations
   × 1080 hours): the flagship (10 × 100 grid, diagonal q, unwhitened) and
   champion (32 × 200, Kronecker-factored q, whitened) configurations, built
   on the card in float32 with their variational and kernel raws moved off
   the init by seeded noise, predict 65,536 rows through ``predict_batched``.
   The outputs must be finite with gfvar ≥ 0, the kernel launch count must
   be what the grid gives for every chunk, and on the first 4096 rows the
   card's error against the same model run on the CPU in float64 must be at
   most max(3 × the CPU float32 run's error, 1e-5).
4. Times, beside the card's name and power limit: predict_batched points/s
   (median of 5 passes), and per ``chol_inv`` shape on the path the kernel's
   ms per call (CUDA events), the plain version's, and torch.linalg's.
5. The ``rbf_gram`` kernel against a float64 oracle and against its plain
   version on the card, at the training path's shapes: the pptr time column
   (t in [4.368, 5.447], lengthscale 0.005) and a 2-D station set
   (lengthscale 8), as K_mm (2, n, n) and K_mn (2, n, 1000) with the
   minibatch shared by the pair, O(1) coordinates in 3-D, and a covariate
   factor's K_mn in 5-D (the kernel's run-time-D instance). The forward's
   relative error must be at most max(1e-5, the plain version's own error),
   and the gradients of a seeded scalar loss through the kernel's autograd
   Function at most max(3 × those of autograd of the plain version, 1e-5),
   both against float64.
6. Training, flagship (10 × 100, B = 1000) at full width with the gram
   kernel on: 4 blocks of 50 steps through ``train_onoff_pptr`` with the
   device sampler. Losses finite and falling (last block's mean below the
   first's); rbf_gram launches 4 per step (K_mm and K_mn of both factors,
   the f/g pair in one launch) and chol_inv launches 2 per step; on one
   fixed batch the card's float32 loss and the gradient of every raw against
   the same model on the CPU in float64, each within max(3 × the CPU float32
   run's error, 1e-5); and 10 steps with both kernels against 10 steps with
   torch.linalg and the plain gram on the same batches, final losses within
   5e-3 relative.
7. Training, champion (32 × 200, whitened, Kronecker-factored q, B = 4000):
   one block of 50 steps, finite losses and the launch counts.
8. Times: steps/s of the flagship's scanned step with the gram kernel on and
   off (median of 3 timed passes of 4 blocks, in turns), of the 105 × 250
   scale grid at B = 8192 (2 timed blocks of 50), and per ``rbf_gram`` shape
   on the training paths the kernel's ms, the plain version's and the bound,
   each shape's kernel output within 1e-5 relative of the plain version's.
9. A ``kernels`` JSON line, then the card's name and power limit, then as the
   last line {"ok": true, "device": {...}}.

The script needs one CUDA device, the repository checkout around it, and
nvcc (``$CUDA_HOME/bin`` or ``PATH``).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside the
# tensor cores, for the lower bound on each kernel's time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

DEVICE = "cuda"
ROWS = 65_536
CHECK_ROWS = 4096
T_SPAN = (4.368, 5.447)  # the pptr time column, hours ÷ 1000


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def spd_grams(n: int) -> np.ndarray:
    """Two float32 RBF grams of n time knots over the pptr span, lengthscale
    0.02, variances 20 and 10 (the f/g pair), relative jitter 1e-5: the
    on-device selfcheck's matrices in ``zigp_tpu``."""
    t = np.linspace(*T_SPAN, n)[:, None]
    out = []
    for ls, var in ((0.02, 20.0), (0.02, 10.0)):
        K = var * np.exp(-0.5 * (t - t.T) ** 2 / ls**2) + 1e-5 * var * np.eye(n)
        out.append(K)
    return np.stack(out).astype(np.float32)


def library_chol_inv(K: torch.Tensor):
    L = torch.linalg.cholesky(K)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device).expand_as(K)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(n: int, G: int) -> tuple[float, str]:
    """Least time for (L, L⁻¹) of G n×n matrices: K read once, L and L⁻¹
    written once (3·G·n²·4 bytes), and n³/3 + n³/3 flops each for the
    factor and the triangular inverse, in f32 outside the tensor cores."""
    t_bytes = 3 * G * n * n * 4 / PEAK_BYTES_PER_S
    t_ops = G * 2 * n**3 / 3 / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_kernel_gate(ci):
    """Kernel (direct and blocked) vs the float64 oracle, vs torch.linalg, and
    vs the plain version, all on the card."""
    for n in (10, 32, 100, 105, 127, 128, 200, 250, 512):
        K32 = spd_grams(n)
        Kd = torch.as_tensor(K32, device=DEVICE)
        with torch.inference_mode():
            L, Linv = ci.chol_inv_cuda(Kd) if n <= ci.MAX_N else ci.chol_inv_blocked(Kd)
            Lp, Linvp = ci.chol_inv_plain(Kd)
            Ll, Linvl = library_chol_inv(Kd)
        torch.cuda.synchronize()
        L_ref = np.linalg.cholesky(K32.astype(np.float64))
        Linv_ref = np.linalg.inv(L_ref)
        if not (torch.all(torch.triu(L, 1) == 0) and torch.all(torch.triu(Linv, 1) == 0)):
            raise AssertionError(f"chol_inv n={n}: nonzero upper triangle")
        for part, ref, kern, plain, lib in (
            ("L", L_ref, L, Lp, Ll),
            ("Linv", Linv_ref, Linv, Linvp, Linvl),
        ):
            kern, plain, lib = kern.cpu().numpy(), plain.cpu().numpy(), np.tril(lib.cpu().numpy())
            err, lib, plain_err = rel(kern, ref), rel(lib, ref), rel(plain, ref)
            dist = rel(kern, plain)
            tol = max(3.0 * lib, 1e-5)
            # kernel and plain version each stay within their own error of
            # the oracle, so their distance is held to the sum of the bounds
            tol_plain = tol + plain_err
            log(f"gate chol_inv n={n:3d} {part:4s}: kernel {err:.3e}  library {lib:.3e}  plain {plain_err:.3e}  "
                f"kernel-vs-plain {dist:.3e}  (tol {tol:.3e}, {tol_plain:.3e})")
            if not (err <= tol and dist <= tol_plain):
                raise AssertionError(f"chol_inv n={n} {part}: kernel {err:.3e} (tol {tol:.3e}), "
                                     f"vs plain {dist:.3e} (tol {tol_plain:.3e})")

    K = np.eye(12, dtype=np.float32)[None].repeat(2, 0)
    K[:, 7, 7] = -1.0
    with torch.inference_mode():
        L, Linv = ci.chol_inv_cuda(torch.as_tensor(K, device=DEVICE))
    L, Linv = L.cpu(), Linv.cpu()
    if not (torch.isnan(L[:, 7:, 7:]).any() and torch.isnan(Linv[:, 7:, :]).any()):
        raise AssertionError("chol_inv kernel: a non-PSD input did not give NaN")
    if not torch.equal(L[:, :7, :7], torch.eye(7).expand(2, 7, 7)):
        raise AssertionError("chol_inv kernel: rows before the failing pivot changed")
    log("gate chol_inv non-PSD input (K[7,7] = -1): NaN from the failing pivot on")


def perturbed(model, seed: int):
    """Seeded noise on the variational and kernel raws, so the model is not at
    its init (the port's own dump/load of JAX-path-keyed raws)."""
    from zigp_tpu_torch.io.convert import dump_arrays, load_jax_arrays

    rng = np.random.RandomState(seed)
    arrays = dump_arrays(model)
    for k, a in arrays.items():
        if ".q_mu" in k:
            arrays[k] = a + 0.5 * rng.randn(*a.shape)
        elif ".q_sqrt_factors" in k:
            arrays[k] = a + 0.05 * rng.randn(*a.shape)
        elif ".q_sqrt" in k:
            arrays[k] = a + 0.2 * rng.randn(*a.shape)
        elif ".kernels" in k:
            arrays[k] = a + 0.1 * rng.randn(*a.shape)
    load_jax_arrays(model, arrays)
    return model


def phase_serving(ci, name, cfg, split, batch):
    """Build on the card, drive predict_batched once with the launch counts
    zeroed just before, check outputs, counts and the f32 gap to CPU f64."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.experiments.runners import predict_batched

    t0 = time.perf_counter()
    model = perturbed(build_onoff_pptr(cfg, split, device=DEVICE, dtype=torch.float32), seed=1)
    log(f"{name}: grid {cfg.grid.num_spatial}x{cfg.grid.num_temporal}, built in {time.perf_counter() - t0:.1f} s")
    X = np.asarray(split.Xtrain[:ROWS])
    chunks = math.ceil(X.shape[0] / batch)
    sizes = [Z.shape[0] for Z in model.f.Zs]
    per_chunk = sum(1 if n <= ci.MAX_N else len(ci.block_offsets(n)) - 1 for n in sizes)

    ci.chol_inv_cuda.launches = 0
    ci.chol_inv_cuda.launches_by_n.clear()
    out = predict_batched(model.predict, X, batch=batch, device=DEVICE)
    launches = ci.chol_inv_cuda.launches
    by_n = dict(ci.chol_inv_cuda.launches_by_n)
    log(f"{name}: {X.shape[0]} rows in {chunks} chunks of {batch}: chol_inv launches {launches} "
        f"(expected {chunks} x {per_chunk}), by n {by_n}")
    if launches != chunks * per_chunk or launches == 0:
        raise AssertionError(f"{name}: {launches} chol_inv launches, expected {chunks * per_chunk}")
    for k, v in out.items():
        if v.shape[0] != X.shape[0] or not np.isfinite(v).all():
            raise AssertionError(f"{name}: {k} has shape {v.shape} or non-finite values")
    if (out["gfvar"] < 0).any():
        raise AssertionError(f"{name}: negative gfvar")

    Xc = X[:CHECK_ROWS]
    ref = {}
    for dt in (torch.float64, torch.float32):
        cpu = copy.deepcopy(model).to(device="cpu", dtype=dt)
        ref[dt] = predict_batched(cpu.predict, Xc, batch=CHECK_ROWS, device="cpu", dtype=dt)
    for k in ("gfmean", "gfvar", "fmean", "gmean"):
        e_card = rel(out[k][:CHECK_ROWS], ref[torch.float64][k])
        e_cpu = rel(ref[torch.float32][k], ref[torch.float64][k])
        tol = max(3.0 * e_cpu, 1e-5)
        log(f"{name}: {k:6s} card f32 vs cpu f64 {e_card:.3e}, cpu f32 vs cpu f64 {e_cpu:.3e} (tol {tol:.3e}); "
            f"card f32 vs cpu f32 {rel(out[k][:CHECK_ROWS], ref[torch.float32][k]):.3e}")
        if not e_card <= tol:
            raise AssertionError(f"{name}: {k} card error {e_card:.3e} > {tol:.3e}")
    return model, X, by_n


def time_predict(name, model, X, batch, card):
    from zigp_tpu_torch.experiments.runners import predict_batched

    predict_batched(model.predict, X, batch=batch, device=DEVICE)  # warm-up
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        predict_batched(model.predict, X, batch=batch, device=DEVICE)  # ends in a host copy: synchronised
        times.append(time.perf_counter() - t0)
    pts = X.shape[0] / float(np.median(times))
    log(f"time {name}: predict_batched {X.shape[0]} rows at batch {batch}: {pts:.1f} points/s "
        f"(median of 5; {card})")
    return pts


def time_chol_inv(ci, n, G=2):
    """ms per call of the kernel path, the plain version and torch.linalg at
    one shape, and the kernel's largest difference from the plain version."""
    K = torch.as_tensor(spd_grams(n)[:G], device=DEVICE)
    kern = ci.chol_inv_cuda if n <= ci.MAX_N else ci.chol_inv_blocked
    with torch.inference_mode():
        ms = cuda_ms(lambda: kern(K), reps=200)
        plain_ms = cuda_ms(lambda: ci.chol_inv_plain(K), reps=5, warmup=1)
        lib_ms = cuda_ms(lambda: library_chol_inv(K), reps=200)
        (L, Li), (Lp, Lip) = kern(K), ci.chol_inv_plain(K)
        err = max(float((L - Lp).abs().max()), float((Li - Lip).abs().max()))
    return ms, plain_ms, lib_ms, err


# --- the rbf_gram kernel and the training path ---------------------------------

GRAM_SOURCE = "zigp_tpu_torch/ops/cuda/csrc/rbf_gram.cu"
GRAM_REPLACES = "zigp_tpu/ops/pallas/rbf_gram.py:79"


def zero_counts() -> None:
    from zigp_tpu_torch.ops.cuda import chol_inv as ci
    from zigp_tpu_torch.ops.cuda import rbf_gram as rg

    rg.rbf_gram_cuda.launches = 0
    rg.rbf_gram_cuda.launches_by_shape.clear()
    ci.chol_inv_cuda.launches = 0
    ci.chol_inv_cuda.launches_by_n.clear()


def read_counts() -> dict:
    from zigp_tpu_torch.ops.cuda import chol_inv as ci
    from zigp_tpu_torch.ops.cuda import rbf_gram as rg

    return {"rbf_gram": rg.rbf_gram_cuda.launches, "rbf_gram_by_shape": dict(rg.rbf_gram_cuda.launches_by_shape),
            "chol_inv": ci.chol_inv_cuda.launches, "chol_inv_by_n": dict(ci.chol_inv_cuda.launches_by_n)}


def per_step_launches(model) -> tuple[int, int]:
    """(rbf_gram, chol_inv) kernel launches of one training step of the
    stacked f/g pair: K_mm and K_mn per factor; one chol_inv per factor, or
    one per diagonal block of the blocked routine."""
    from zigp_tpu_torch.ops.cuda import chol_inv as ci

    sizes = [Z.shape[0] for Z in model.f.Zs]
    chol = sum(1 if n <= ci.MAX_N else len(ci.block_offsets(n)) - 1 for n in sizes)
    return 2 * len(sizes), chol


def gram_cases():
    """The rbf_gram gate's inputs (f32-representable float64): name, X
    (G or 1, N, D), Z (M, D) shared by the pair or None for K(X, X), ell
    (G, D), var (G,)."""
    rng = np.random.RandomState(7)
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)
    t_knots = np.repeat(np.linspace(*T_SPAN, 100)[None, :, None], 2, 0)
    t_batch = T_SPAN[0] + (T_SPAN[1] - T_SPAN[0]) * rng.rand(1000, 1)
    box = lambda n: np.stack([rng.uniform(59.8, 70.1, n), rng.uniform(20.0, 31.0, n)], 1)
    s_knots = np.stack([box(10), box(10)])
    var = np.array([20.0, 10.0])
    cases = [
        ("time column K_mm, ell 0.005", t_knots, None, np.full((2, 1), 0.005), var),
        ("time column K_mn, ell 0.005", t_knots, t_batch, np.full((2, 1), 0.005), var),
        ("stations K_mm, ell 8", s_knots, None, np.full((2, 2), 8.0), var),
        ("stations K_mn, ell 8", s_knots, box(1000), np.full((2, 2), 8.0), var),
        ("O(1) 3-D K(X, X)", rng.rand(1, 256, 3), None, np.array([[0.7, 1.3, 0.4]]), np.array([2.5])),
        ("covariates K_mn, O(1) 5-D", rng.randn(2, 8, 5), rng.randn(1000, 5), 0.6 + rng.rand(2, 5), var),
    ]
    return [(n, f32(X), None if Z is None else f32(Z), f32(ell), f32(var)) for n, X, Z, ell, var in cases]


def gram_and_grads(fn, X, Z, ell, var, cot, device, dtype):
    """K and the gradients of sum(K ⊙ cot) in X, ell and var (Z, when
    given, is data), as float64 numpy."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    Xt, lt, vt = (t(a).requires_grad_(True) for a in (X, ell, var))
    K = fn(Xt, Xt if Z is None else t(Z), lt, vt)
    torch.sum(K * t(cot)).backward()
    out = lambda a: a.detach().cpu().double().numpy()
    return out(K), [out(Xt.grad), out(lt.grad), out(vt.grad)]


def phase_gram_gate(rg):
    """rbf_gram's forward and its Function's gradients against a float64
    oracle (autograd of the plain version on the CPU) and against the plain
    version in float32 on the card."""
    for name, X, Z, ell, var in gram_cases():
        N, M = X.shape[1], (X if Z is None else Z[None]).shape[1]
        cot = np.random.RandomState(N + M).randn(ell.shape[0], N, M)
        K64, g64 = gram_and_grads(rg.rbf_gram_plain, X, Z, ell, var, cot, "cpu", torch.float64)
        Kk, gk = gram_and_grads(rg.rbf_gram, X, Z, ell, var, cot, DEVICE, torch.float32)
        Kp, gp = gram_and_grads(rg.rbf_gram_plain, X, Z, ell, var, cot, DEVICE, torch.float32)
        err, plain_err = rel(Kk, K64), rel(Kp, K64)
        tol = max(plain_err, 1e-5)
        log(f"gate rbf_gram {name} {tuple(Kk.shape)}: K kernel {err:.3e}  plain {plain_err:.3e}  (tol {tol:.3e}); "
            f"kernel-vs-plain max abs {np.abs(Kk - Kp).max():.3e}")
        if not err <= tol:
            raise AssertionError(f"rbf_gram {name}: forward error {err:.3e} > {tol:.3e}")
        for part, a, b, ref in zip(("dX", "dell", "dvar"), gk, gp, g64):
            e, e_plain = rel(a, ref), rel(b, ref)
            tol = max(3.0 * e_plain, 1e-5)
            log(f"gate rbf_gram {name} {part:4s}: Function {e:.3e}  autograd of plain {e_plain:.3e}  (tol {tol:.3e})")
            if not e <= tol:
                raise AssertionError(f"rbf_gram {name} {part}: gradient error {e:.3e} > {tol:.3e}")


def loss_and_grads(model, X, Y):
    """The loss and every trainable raw's gradient on one batch, float64 numpy."""
    t = lambda a: torch.as_tensor(a, dtype=next(model.parameters()).dtype).to(next(model.parameters()).device)
    model.zero_grad(set_to_none=True)
    loss = model.loss(t(X), t(Y))
    loss.backward()
    grads = {n: p.grad.detach().cpu().double().numpy() for n, p in model.named_parameters() if p.requires_grad}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def check_f32_against_cpu_f64(name, model, X, Y):
    """Card f32 loss and gradients vs the same model on the CPU in f64, each
    within max(3 × the CPU f32 run's error, 1e-5)."""
    card = loss_and_grads(model, X, Y)
    cpu64, cpu32 = (loss_and_grads(copy.deepcopy(model).to(device="cpu", dtype=dt), X, Y)
                    for dt in (torch.float64, torch.float32))
    rows = [("loss", abs(card[0] - cpu64[0]) / abs(cpu64[0]), abs(cpu32[0] - cpu64[0]) / abs(cpu64[0]))]
    rows += [(f"d {n}", rel(card[1][n], cpu64[1][n]), rel(cpu32[1][n], cpu64[1][n])) for n in cpu64[1]]
    worst = 0.0
    for what, e_card, e_cpu in rows:
        tol = max(3.0 * e_cpu, 1e-5)
        worst = max(worst, e_card / tol)
        log(f"{name}: {what:32s} card f32 vs cpu f64 {e_card:.3e}, cpu f32 vs cpu f64 {e_cpu:.3e} (tol {tol:.3e})")
        if not e_card <= tol:
            raise AssertionError(f"{name}: {what} card error {e_card:.3e} > {tol:.3e}")
    log(f"{name}: loss and {len(rows) - 1} gradients within bound (largest share of its tolerance {worst:.2f})")


def phase_train(name, cfg, split, *, check=False):
    """Train ``cfg`` on the card with the gram kernel on, through the
    training entry, with the launch counts zeroed just before and read just
    after; check losses and counts."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.experiments.runners import train_onoff_pptr

    model = build_onoff_pptr(cfg, split, device=DEVICE, use_kernel=True)
    per_step = per_step_launches(model)
    zero_counts()
    t0 = time.perf_counter()
    res = train_onoff_pptr(cfg, split, model=model, log_fn=lambda s: log(f"{name} train: {s}"))
    torch.cuda.synchronize()
    counts = read_counts()
    wall = time.perf_counter() - t0
    steps = res.step_losses.numel()
    blocks = res.step_losses.double().reshape(-1, cfg.scan_inner).mean(1).tolist()
    log(f"{name} train: {steps} steps at B={cfg.batch_size} in {wall:.1f} s (build of the kernels excluded); "
        f"block mean losses {[f'{b:.6g}' for b in blocks]}; launches rbf_gram {counts['rbf_gram']} "
        f"(expected {steps} x {per_step[0]}), chol_inv {counts['chol_inv']} (expected {steps} x {per_step[1]}); "
        f"by shape {counts['rbf_gram_by_shape']}, by n {counts['chol_inv_by_n']}")
    if not torch.isfinite(res.step_losses).all():
        raise AssertionError(f"{name}: non-finite training loss")
    if (counts["rbf_gram"], counts["chol_inv"]) != (steps * per_step[0], steps * per_step[1]):
        raise AssertionError(f"{name}: launches {counts['rbf_gram']}, {counts['chol_inv']}, expected "
                             f"{steps * per_step[0]}, {steps * per_step[1]}")
    if check:
        if not blocks[-1] < blocks[0]:
            raise AssertionError(f"{name}: the last block's mean loss {blocks[-1]} is not below the first's {blocks[0]}")
        check_f32_against_cpu_f64(name, model, split.Xtrain[:cfg.batch_size], split.Ytrain[:cfg.batch_size])
    return model, counts


def set_gram_kernel(model, on: bool) -> None:
    for gp in (model.f, model.g):
        for k in gp.kernels:
            k.use_kernel = on


def phase_ab(cfg, split):
    """10 steps with both kernels against 10 steps with torch.linalg's
    Cholesky and triangular solve and the plain gram (the JAX selfcheck's
    Pallas-vs-XLA A/B), from the same model on the same batches."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.ops import linalg
    from zigp_tpu_torch.training import DataSet, make_optimizer, make_scan_train_step, stage_batches

    base = build_onoff_pptr(cfg, split, device=DEVICE, use_kernel=True)
    Xs, Ys = stage_batches(DataSet(split.Xtrain, split.Ytrain, seed=3), cfg.batch_size, 10,
                           device=DEVICE, dtype=torch.float32)
    out = {}
    route = linalg.chol_inv_route
    for kernels in (True, False):
        m = copy.deepcopy(base)
        set_gram_kernel(m, kernels)
        if not kernels:
            linalg.chol_inv_route = lambda n, dtype, device_type: "library"
        try:
            zero_counts()
            losses = make_scan_train_step(make_optimizer(m, default_lr=cfg.indp_lr))(m, Xs, Ys).cpu().numpy()
            counts = read_counts()
        finally:
            linalg.chol_inv_route = route
        out[kernels] = losses
        log(f"A/B {'kernels' if kernels else 'library'}: losses {losses[0]:.6f} .. {losses[-1]:.6f}, "
            f"launches rbf_gram {counts['rbf_gram']}, chol_inv {counts['chol_inv']}")
        if (counts["rbf_gram"] > 0) != kernels or (counts["chol_inv"] > 0) != kernels:
            raise AssertionError(f"A/B: the {'kernel' if kernels else 'library'} run launched {counts}")
    if not (np.isfinite(out[True]).all() and np.isfinite(out[False]).all()):
        raise AssertionError("A/B: non-finite losses")
    err = abs(out[True][-1] - out[False][-1]) / abs(out[False][-1])
    log(f"A/B: final loss kernels {out[True][-1]:.6f} vs library {out[False][-1]:.6f}: relative {err:.3e} (tol 5e-3)")
    if not err <= 5e-3:
        raise AssertionError(f"A/B: final losses differ by {err:.3e}")


def device_step(model, split, batch):
    from zigp_tpu_torch.training import make_device_sampling_scan_step, make_optimizer

    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
    return make_device_sampling_scan_step(make_optimizer(model), t(split.Xtrain), t(split.Ytrain), batch)


def timed_blocks(step, model, first_block, blocks, inner=50) -> float:
    """steps/s of ``blocks`` device-sampled blocks, host clock around work
    that ends in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(blocks):
        step(model, first_block + b, inner)
    torch.cuda.synchronize()
    return blocks * inner / (time.perf_counter() - t0)


def time_training(split, card):
    """Flagship steps/s with the gram kernel on and off (median of 3 passes
    of 4 blocks, in turns), and the 105 × 250 scale grid at B = 8192 (2
    blocks, launch counts read around them)."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.experiments.configs import KronGridConfig, OnOffPptrConfig

    cfg = OnOffPptrConfig()
    runs = {}
    for on in (True, False):
        m = build_onoff_pptr(cfg, split, device=DEVICE, use_kernel=on)
        step = device_step(m, split, cfg.batch_size)
        timed_blocks(step, m, 0, 1)  # warm-up
        runs[on] = (m, step, [])
    for rep in range(3):
        for on in ((True, False) if rep % 2 == 0 else (False, True)):
            m, step, rates = runs[on]
            rates.append(timed_blocks(step, m, 1 + 4 * rep, 4))
    rate = {on: float(np.median(r[2])) for on, r in runs.items()}
    log(f"time flagship training, scanned step (device sampler, B={cfg.batch_size}): gram kernel on "
        f"{rate[True]:.1f} steps/s {[round(r, 1) for r in runs[True][2]]}, off {rate[False]:.1f} steps/s "
        f"{[round(r, 1) for r in runs[False][2]]} (median of 3 passes of 200 steps; {card})")

    scfg = OnOffPptrConfig(grid=KronGridConfig(num_spatial=105, num_temporal=250), batch_size=8192)
    m = build_onoff_pptr(scfg, split, device=DEVICE, use_kernel=True)
    step = device_step(m, split, scfg.batch_size)
    timed_blocks(step, m, 0, 1)  # warm-up
    zero_counts()
    scale_rate = timed_blocks(step, m, 1, 2)
    counts = read_counts()
    log(f"time scale training 105x250, B=8192, gram kernel on: {scale_rate:.1f} steps/s (2 blocks of 50); "
        f"launches rbf_gram {counts['rbf_gram']}, chol_inv {counts['chol_inv']}; {card}")
    return {"flagship_kernel_on": rate[True], "flagship_kernel_off": rate[False], "scale_105x250_b8192": scale_rate}, counts


def gram_bound_ms(G, N, M, D, shared: bool) -> tuple[float, str]:
    """Least time of a (G, N, M) gram: X, Z, ell and var read once, K written
    once; 3D + 3 f32 operations per entry (D differences, squares and
    scaled sums, the scale by −½, the exponential and σ²)."""
    z_elems = M * D if shared else 0  # K(X, X) reads X only
    t_bytes = 4 * (G * N * D + z_elems + G * D + G + G * N * M) / PEAK_BYTES_PER_S
    t_ops = G * N * M * (3 * D + 3) / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


GRAM_VS_PLAIN_TOL = 1e-5  # relative Frobenius distance, as tests/test_torch_cuda.py


def gram_rows(rg, path_counts: dict, card) -> list:
    """One kernels-line row per rbf_gram shape launched on each training
    path: the kernel's ms per call (CUDA events), the plain version's, the
    bound, and the kernel's largest difference from the plain version. The
    kernel's output must be within GRAM_VS_PLAIN_TOL relative of the plain
    version's at every shape."""
    rows = []
    for path, counts in path_counts.items():
        for (G, N, M, D), launches in sorted(counts["rbf_gram_by_shape"].items()):
            shared = N != M  # K_mn shares the minibatch; K_mm is K(Z, Z)
            rng = np.random.RandomState(N * M)
            X = torch.as_tensor(T_SPAN[0] + rng.rand(G, N, D), dtype=torch.float32, device=DEVICE)
            Z = torch.as_tensor(T_SPAN[0] + rng.rand(M, D), dtype=torch.float32, device=DEVICE) if shared else X
            ell = torch.full((G, D), 0.05, device=DEVICE)
            var = torch.tensor([20.0, 10.0][:G], device=DEVICE)
            with torch.inference_mode():
                ms = cuda_ms(lambda: rg.rbf_gram_cuda(X, Z, ell, var), reps=200)
                plain_ms = cuda_ms(lambda: rg.rbf_gram_plain(X, Z, ell, var), reps=50)
                K, Kp = rg.rbf_gram_cuda(X, Z, ell, var), rg.rbf_gram_plain(X, Z, ell, var)
                err = float((K - Kp).abs().max())
                dist = rel(K.cpu().numpy(), Kp.cpu().numpy())
            b_ms, b_by = gram_bound_ms(G, N, M, D, shared)
            kname = f"rbf_gram ({G},{N},{M}) D={D} {'K_mn' if shared else 'K_mm'} ({path})"
            log(f"time {kname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), "
                f"launches {launches}, max |kernel - plain| {err:.3e}, relative {dist:.3e} "
                f"(tol {GRAM_VS_PLAIN_TOL:.0e}); {card}")
            if not dist <= GRAM_VS_PLAIN_TOL:
                raise AssertionError(f"{kname}: kernel vs plain {dist:.3e} > {GRAM_VS_PLAIN_TOL:.0e}")
            rows.append({
                "name": kname, "route": "cuda", "source": GRAM_SOURCE, "replaces": GRAM_REPLACES,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            })
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from zigp_tpu_torch.experiments.configs import OnOffPptrConfig, best_onoff_config
    from zigp_tpu_torch.io.datasets import synthetic_pptr
    from zigp_tpu_torch.ops.cuda import _build
    from zigp_tpu_torch.ops.cuda import chol_inv as ci
    from zigp_tpu_torch.ops.cuda import rbf_gram as rg

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for lib in sorted(libs):
        for line in _build.build_log(lib).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"ptxas {lib}: {line.strip()}")

    phase_kernel_gate(ci)
    phase_gram_gate(rg)

    t0 = time.perf_counter()
    split = synthetic_pptr(105, 1080, seed=0)
    log(f"data: synthetic pptr-shaped split, train {split.Xtrain.shape}, test {split.Xtest.shape}, "
        f"zeros {np.mean(split.Ytrain == 0):.3f} ({time.perf_counter() - t0:.1f} s)")

    runs = {}
    for name, cfg, batch in (("flagship", OnOffPptrConfig(), 4096), ("champion", best_onoff_config(), 16384)):
        runs[name] = (*phase_serving(ci, name, cfg, split, batch), batch)

    train_cfg = dataclasses.replace(OnOffPptrConfig(), num_iter=200, scan_inner=50, sampler="device", log_every=50)
    train_counts = {"flagship train": phase_train("flagship", train_cfg, split, check=True)[1]}
    phase_ab(train_cfg, split)
    champ_cfg = dataclasses.replace(best_onoff_config(), num_iter=50, scan_inner=50, log_every=50)
    train_counts["champion train"] = phase_train("champion", champ_cfg, split)[1]

    pts = {name: time_predict(name, m, X, batch, card) for name, (m, X, _, batch) in runs.items()}
    steps_per_s, train_counts["scale train, 2 timed blocks"] = time_training(split, card)

    kernels = []
    for name, (model, _, by_n, _) in runs.items():
        for n in (Z.shape[0] for Z in model.f.Zs):
            if n <= ci.MAX_N:
                launches = by_n.get(n, 0)
                kname = f"chol_inv n={n} G=2 ({name})"
                replaces, source = "zigp_tpu/ops/pallas/chol_inv.py:339", "zigp_tpu_torch/ops/cuda/csrc/chol_inv.cu"
            else:  # the blocked routine: its kernel launches are its diagonal blocks'
                offs = ci.block_offsets(n)
                blocks = [b - a for a, b in zip(offs[:-1], offs[1:])]
                launches = sum(by_n.get(b, 0) for b in set(blocks))
                kname = f"chol_inv_blocked n={n} G=2, blocks {blocks} ({name})"
                replaces, source = "zigp_tpu/ops/pallas/chol_inv.py:387", "zigp_tpu_torch/ops/cuda/chol_inv.py"
            if launches == 0:
                raise AssertionError(f"{kname}: not launched on the main path")
            ms, plain_ms, lib_ms, err = time_chol_inv(ci, n)
            b_ms, b_by = bound_ms(n, 2)
            log(f"time {kname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.linalg {lib_ms:.4f} ms, "
                f"bound {b_ms:.6f} ms ({b_by}), max |kernel - plain| {err:.3e}; {card}")
            kernels.append({
                "name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            })

    kernels += gram_rows(rg, train_counts, card)

    log(f"serving points/s: {json.dumps(pts)}; training steps/s: {json.dumps(steps_per_s)}; "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
