"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

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
5. A ``kernels`` JSON line, then the card's name and power limit, then as the
   last line {"ok": true, "device": {...}}.

The script needs one CUDA device, the repository checkout around it, and
nvcc (``$CUDA_HOME/bin`` or ``PATH``).
"""

from __future__ import annotations

import copy
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from zigp_tpu_torch.experiments.configs import OnOffPptrConfig, best_onoff_config
    from zigp_tpu_torch.io.datasets import synthetic_pptr
    from zigp_tpu_torch.ops.cuda import _build
    from zigp_tpu_torch.ops.cuda import chol_inv as ci

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log("chol_inv").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"ptxas: {line.strip()}")

    phase_kernel_gate(ci)

    t0 = time.perf_counter()
    split = synthetic_pptr(105, 1080, seed=0)
    log(f"data: synthetic pptr-shaped split, train {split.Xtrain.shape}, test {split.Xtest.shape}, "
        f"zeros {np.mean(split.Ytrain == 0):.3f} ({time.perf_counter() - t0:.1f} s)")

    runs = {}
    for name, cfg, batch in (("flagship", OnOffPptrConfig(), 4096), ("champion", best_onoff_config(), 16384)):
        runs[name] = (*phase_serving(ci, name, cfg, split, batch), batch)

    pts = {name: time_predict(name, m, X, batch, card) for name, (m, X, _, batch) in runs.items()}

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

    log(f"serving points/s: {json.dumps(pts)}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
