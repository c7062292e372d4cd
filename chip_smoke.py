"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases, in the order they run (each raises on failure; nothing is caught,
so any failure exits non-zero):

1. The card's name and power limit, the torch and CUDA versions; build every
   CUDA source under ``zigp_tpu_torch/ops/cuda/csrc`` (one nvcc each, in
   parallel) and report the time.
2. The ``chol_inv`` kernels against a float64 numpy oracle and against
   their plain PyTorch version at the kernels' width on the card, on RBF
   grams of time knots: ``chol_inv.cu`` at n = 1, 10, 31, 32, 33, 100, 105,
   127, 128, 200 and ``MAX_N`` (238); the thread-block-cluster kernel
   ``chol_inv_cluster.cu`` (through ``chol_inv_blocked``: its pair instance
   to n = 320, its row instance above) at ``MAX_N`` + 1, 240, 250, 300, 512
   and on both sides of the change of instance (two matrices each), where
   the direct wrapper must refuse.
   The kernel's relative error in L and in L⁻¹ must be at most max(3 × the
   error of torch.linalg.cholesky + solve_triangular on the same input,
   1e-5), and its distance from the plain version at most the same bound
   plus the plain version's own error. A non-PSD input must give NaN from
   the failing pivot on and leave the rows before it unchanged (for the
   cluster kernel with the failing pivot in the first, a middle and the
   last CTA's rows of the row instance's plan).
3. The ``rbf_gram`` kernel against a float64 oracle and against its plain
   version on the card, at the training path's shapes: the pptr time column
   (t in [4.368, 5.447], lengthscale 0.005) and a 2-D station set
   (lengthscale 8), as K_mm (2, n, n) and K_mn (2, n, 1000) with the
   minibatch shared by the pair, O(1) coordinates in 3-D, and a covariate
   factor's K_mn in 5-D (the kernel's run-time-D instance). The forward's
   relative error must be at most max(1e-5, the plain version's own error),
   and the gradients of a seeded scalar loss through the kernel's autograd
   Function at most max(3 × those of autograd of the plain version, 1e-5),
   both against float64.
4. The JAX package's A/B alternatives to ``chol_inv``, each against a float64
   oracle and its plain version on the card (the rule of phase 2, with
   torch.linalg.cholesky or the one torch.einsum as the library): the L-only
   ``chol.cu`` at n = 1, 10, 31, 32, 33, 100, 105, 128, 200, 240, 250, its
   shared-memory limit (337) and one past it (the in-place global-memory
   instance) through ``small_cholesky_cuda`` (one matrix),
   ``batched_small_cholesky_cuda`` (the pair) and ``chol_cuda`` at 2, 4 and
   8 columns a step (all at the kernel's own width), and NaN on a non-PSD
   input; ``kron_mv.cu`` at (2; 10, 100), (2; 105, 250), (2; 6, 9), the
   ragged (1; 1, 1), (3; 1, 5) and (1; 33, 70), the cluster's reach (2; 128,
   40) and one row past it (2; 129, 40, the global instance), both
   orientations, in the plan's instance and, within the cluster's reach,
   in the global instance too; the
   plain ``tri_inv_dc`` (n = 10, 100, 105, 250) and
   ``tri_inv_newton`` (n = 10, 100) against float64 within max(3 × the larger
   of solve_triangular's and their own CPU f32 error, 1e-5), an overflow
   where the CPU run overflows, and Newton's f32 overflow on the n = 256
   factor of ``tests/test_pallas.py`` where tri_inv_dc is finite.
5. The serving path at full width on a seeded pptr-shaped set (105 stations
   × 1080 hours): the flagship (10 × 100 grid, diagonal q, unwhitened) and
   champion (32 × 200, Kronecker-factored q, whitened) configurations, built
   on the card in float32 with their variational and kernel raws moved off
   the init by seeded noise, predict 65,536 rows through ``predict_batched``.
   The outputs must be finite with gfvar ≥ 0, the kernel launch counts must
   be one launch per factor and chunk (``chol_inv.cu`` to n = 238, the
   cluster kernel above), and on the first 4096 rows the
   card's error against the same model run on the CPU in float64 must be at
   most max(3 × the CPU float32 run's error, 1e-5).
6. The serving A/B: predict_batched over 65,536 rows at batch 4096 with the
   unwhitened mean's (⊗K_p⁻¹) q_mu through ``kron_mv_2`` (two launches a
   chunk, counted exactly), on the flagship and on the 105 × 250 grid (whose
   production run is checked as phase 5 first); finite, gfvar ≥ 0, and the
   first 4096 rows within max(3 × the CPU f32 run's error, 1e-5) of CPU f64.
7. Training, flagship (10 × 100, B = 1000) at full width with the gram
   kernel on: 4 blocks of 50 steps through ``train_onoff_pptr`` with the
   device sampler, so through ``fit_scanned``'s CUDA graph: the first block
   eager on a side stream (the capture's warm-up), the block captured once
   and replayed for the other three, each replay counted as the launches its
   capture made. Losses finite and falling (last block's mean below the
   first's); rbf_gram launches 4 per step (K_mm and K_mn of both factors,
   the f/g pair in one launch) and chol_inv launches 2 per step; on one
   fixed batch the card's float32 loss and the gradient of every raw against
   the same model on the CPU in float64, each within max(3 × the CPU float32
   run's error, 1e-5); and 10 steps with both kernels against 10 steps with
   torch.linalg and the plain gram on the same batches, final losses within
   5e-3 relative; the same A/B on the 105 × 250 grid at B = 8192 (the
   cluster kernel once a step), launches counted exactly, and there 10
   steps with the row instance forced against 10 with the package's pair
   instance (5e-3).
8. The training A/B: ``chol_inv_stacked`` on the flagship's factor pair
   equal to per-factor ``chol_inv`` (1e-6) and both plain inverses on those
   factors (the rule of phase 4); then 10 steps from the same model on the
   same batches with chol_inv's forward patched to chol+dc (``chol_cuda``
   at rank 4, ``tri_inv_dc``), chol+newton (``tri_inv_newton``),
   small_cholesky+solve (``batched_small_cholesky_cuda``, torch.linalg's
   triangular solve), and that route once more on the unpaired model
   (``small_cholesky_cuda`` on each GP's factors): final losses within 5e-3
   relative of production's, chol.cu launched once per factorization (2 a
   step, 4 unpaired) and chol_inv.cu not at all.
9. Training, champion (32 × 200, whitened, Kronecker-factored q, B = 4000)
   and the 105 × 250 grid at B = 8192 (device sampler), each through
   ``train_onoff_pptr``: two blocks of 50 steps (one eager, one replay),
   finite losses and exact launch counts (the kernels line's training
   launches). Then, for the flagship, the champion and the 105 × 250
   grid at B = 8192, 10 steps by one replay of the captured block against 10
   eager steps from the same state on the same batches: the largest
   relative loss difference at most 1e-4 (reported, with whether the bits
   are equal), launches exact. Then ``train_onoff_pptr`` on the flagship
   with a workdir, stopped by Ctrl-C after 2 of 4 blocks and resumed: equal
   to the uninterrupted run within 1e-4 (losses and raws).
10. Times, beside the card's name and power limit: points/s of
   predict_batched (every chunk one replay of the model's chunk graph,
   captured by its first call) against the same chunks launched eagerly,
   median of 5 passes each, in turns, the graphed predictions within the
   serving gate's tolerance of the eager ones; steps/s of blocks of 50
   eager against one replay each (flagship with the gram kernel on and
   off, champion, scale; median of 3 passes, in turns) with each graph's
   capture and instantiate times and pool size; steps/s of eager blocks
   with each A/B route against production's (median of 3 passes of 2
   blocks, in turns); the 105 × 250 serving pass with the production
   Kronecker solve and with the kron_mv_2 route, each on its own copy of
   the model (median of 5, in turns); both tiled
   Cholesky kernels at every panel width they are built for, at n = 100 and
   200, and (L, L⁻¹) at n = 200 by the direct kernel, the blocked routine
   and torch.linalg (the line ``MAX_N`` rests on), and the plain inverses;
   ``kron_mv.cu`` in both its instances (cluster, global) at (2; 105, 250)
   and (2; 10, 100); and per kernel shape on the paths the kernel's ms per call
   with the host (CUDA events around 200 calls), its device ms (the 200
   calls captured once in a CUDA graph, the replay timed with CUDA events),
   the plain version's (for kron_mv_2 also its device ms), the library's
   and the bound, each rbf_gram shape's output within 1e-5 relative of the
   plain version's.
11. A ``kernels`` JSON line (the kron_mv_2 rows with the serving path's
   launches by the instance the library ran), then the card's name and power limit,
   then as the last line {"ok": true, "device": {...}}.

The script needs one CUDA device, the repository checkout around it, and
nvcc (``$CUDA_HOME/bin`` or ``PATH``).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
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
AB_STEPS = 10  # steps of each training A/B
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
    """ms per call of ``reps`` calls issued back to back, CUDA events around
    them: the device's time or the host's, whichever is longer."""
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


def graph_ms(fn, reps: int = 200) -> float:
    """Device ms per call without the host: ``reps`` calls captured once in a
    CUDA graph after a warm-up on a side stream, and one replay of the graph
    (after a first, untimed one) timed with CUDA events. The launch of each
    graph node, about a microsecond, is still inside."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    stop.synchronize()
    del graph
    return start.elapsed_time(stop) / reps


def bound_ms(n: int, G: int) -> tuple[float, str]:
    """Least time for (L, L⁻¹) of G n×n matrices: K read once, L and L⁻¹
    written once (3·G·n²·4 bytes), and n³/3 + n³/3 flops each for the
    factor and the triangular inverse, in f32 outside the tensor cores."""
    t_bytes = 3 * G * n * n * 4 / PEAK_BYTES_PER_S
    t_ops = G * 2 * n**3 / 3 / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nan_check(what, L, Linv, p) -> None:
    """NaN from the failing pivot p on, the rows before it unchanged."""
    L = L.cpu()
    bad = not torch.isnan(L[..., p:, p:]).any() or (Linv is not None and not torch.isnan(Linv.cpu()[..., p:, :]).any())
    if bad:
        raise AssertionError(f"{what}: a non-PSD input did not give NaN")
    eye = torch.eye(p).expand(*L.shape[:-2], p, p)
    if not (torch.equal(L[..., :p, :p], eye) and (Linv is None or torch.equal(Linv.cpu()[..., :p, :p], eye))):
        raise AssertionError(f"{what}: rows before the failing pivot changed")


def non_psd(n: int, p: int) -> np.ndarray:
    K = np.eye(n, dtype=np.float32)[None].repeat(2, 0)
    K[:, p, p] = -1.0
    return K


NON_PSD = ((12, 7), (40, 37))  # (n, failing pivot): in the first or second block, and in a later one


def cluster_gate_sizes(ci) -> list[int]:
    """The n chol_inv_blocked is gated at: MAX_N + 1, 240, 250, 300, 512,
    and both sides of each n where its route or ``plan``'s cluster size
    changes."""
    key = lambda n: ci.blocked_route(n)
    edges = [n for a in range(ci.MAX_N + 1, ci.BLOCKED_MAX_N) if key(a) != key(a + 1) for n in (a, a + 1)]
    return sorted({ci.MAX_N + 1, 240, 250, 300, ci.BLOCKED_MAX_N, *edges})


NON_PSD_CLUSTER = (250, 400, 512)  # one n per cluster size: 2, 4, 8


def route_name(ci, n) -> str:
    """chol_inv_blocked's route at n, as the logs name it."""
    return "pair" if ci.blocked_route(n) == "pair" else f"rows C={ci.plan(n).C}"


def phase_kernel_gate(ci):
    """Both chol_inv kernels (chol_inv.cu to MAX_N, the cluster kernel
    above) vs the float64 oracle, vs torch.linalg, and vs the plain version
    at their width, all on the card; the direct wrapper refuses MAX_N + 1;
    NaN on non-PSD input."""
    max_n = ci.kernel_max_n()
    log(f"gate chol_inv: chol_inv.cu takes n <= {max_n} on this device, the package routes n <= {ci.MAX_N} to it "
        f"at {ci.NB} columns a step, chol_inv_blocked above (routes "
        f"{ {n: route_name(ci, n) for n in cluster_gate_sizes(ci)} })")
    if ci.MAX_N > max_n:
        raise AssertionError(f"chol_inv: MAX_N {ci.MAX_N} above the device's {max_n}")
    for n in (1, 10, 31, 32, 33, 100, 105, 127, 128, 200, ci.MAX_N, *cluster_gate_sizes(ci)):
        K32 = spd_grams(n)
        Kd = torch.as_tensor(K32, device=DEVICE)
        direct = n <= ci.MAX_N
        with torch.inference_mode():
            L, Linv = ci.chol_inv_cuda(Kd) if direct else ci.chol_inv_blocked(Kd)
            Lp, Linvp = ci.chol_inv_plain(Kd, ci.NB)
            Ll, Linvl = library_chol_inv(Kd)
        torch.cuda.synchronize()
        if not direct:
            try:
                ci.chol_inv_cuda(Kd)
            except ValueError:
                pass
            else:
                raise AssertionError(f"chol_inv_cuda took n={n} > MAX_N")
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
            what = "chol_inv" if direct else f"chol_inv_blocked {route_name(ci, n)}"
            log(f"gate {what} n={n:3d} {part:4s}: kernel {err:.3e}  library "
                f"{lib:.3e}  plain {plain_err:.3e}  kernel-vs-plain {dist:.3e}  (tol {tol:.3e}, {tol_plain:.3e})")
            if not (err <= tol and dist <= tol_plain):
                raise AssertionError(f"{what} n={n} {part}: kernel {err:.3e} (tol {tol:.3e}), "
                                     f"vs plain {dist:.3e} (tol {tol_plain:.3e})")

    for n, p in NON_PSD:
        with torch.inference_mode():
            L, Linv = ci.chol_inv_cuda(torch.as_tensor(non_psd(n, p), device=DEVICE))
        nan_check(f"chol_inv kernel n={n}", L, Linv, p)
    log(f"gate chol_inv non-PSD input (n, K[p,p] = -1) {NON_PSD}: NaN from the failing pivot on, rows before it "
        f"unchanged")
    pivots = []
    for n in NON_PSD_CLUSTER:
        plan = ci.plan(n)
        for rank in (0, plan.C // 2, plan.C - 1):  # the first, a middle and the last CTA
            rows = plan.rows(rank)
            p = rows[len(rows) // 2]
            with torch.inference_mode():
                L, Linv = ci.chol_inv_blocked(torch.as_tensor(non_psd(n, p), device=DEVICE))
            nan_check(f"chol_inv_blocked n={n} {route_name(ci, n)}, pivot {p} in rank {rank} of C={plan.C}", L, Linv, p)
            pivots.append((n, plan.C, rank, p))
    log(f"gate chol_inv_blocked non-PSD input (n, C, rank, p) {pivots}, routes "
        f"{ {n: route_name(ci, n) for n in NON_PSD_CLUSTER} }: NaN from the failing pivot on, rows before it unchanged")


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
    per_chunk = {"chol_inv": sum(n <= ci.MAX_N for n in sizes),
                 "chol_inv_blocked": sum(n > ci.MAX_N for n in sizes)}

    zero_counts()
    out = predict_batched(model.predict, X, batch=batch, device=DEVICE)
    counts = read_counts()
    by_n = {**counts["chol_inv_by_n"], **counts["chol_inv_blocked_by_n"]}
    log(f"{name}: {X.shape[0]} rows in {chunks} chunks of {batch}: chol_inv.cu launches {counts['chol_inv']}, "
        f"chol_inv_cluster.cu launches {counts['chol_inv_blocked']} (expected {chunks} x {per_chunk}), by n {by_n}")
    for key, k in per_chunk.items():
        if counts[key] != chunks * k:
            raise AssertionError(f"{name}: {counts[key]} {key} launches, expected {chunks * k}")
    if sum(counts[key] for key in per_chunk) == 0:
        raise AssertionError(f"{name}: no chol_inv kernel launched")
    for k, v in out.items():
        if v.shape[0] != X.shape[0] or not np.isfinite(v).all():
            raise AssertionError(f"{name}: {k} has shape {v.shape} or non-finite values")
    if (out["gfvar"] < 0).any():
        raise AssertionError(f"{name}: negative gfvar")

    Xc = X[:CHECK_ROWS]
    ref = {}  # the same model on the CPU, in float64 and float32, on the first rows
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
    return model, X, by_n, ref


def time_predict(name, model, X, batch, card, ref):
    """predict_batched points/s (every chunk one replay of the graph the
    model's first call captured) against the same chunks launched eagerly
    (``predict_chunks_eager``, the path before the graph): median of 5
    passes each, in turns, each ending in the one copy to the host. The
    graphed predictions must be within the serving gate's tolerance of the
    eager ones."""
    from zigp_tpu_torch.experiments.profile_predict import predict_chunks_eager
    from zigp_tpu_torch.experiments.runners import predict_batched

    paths = {"eager": lambda: predict_chunks_eager(model.predict, X, batch), "graphed": lambda: predict_batched(
        model.predict, X, batch=batch, device=DEVICE)}
    with torch.inference_mode():
        out = {path: fn() for path, fn in paths.items()}  # warm-up
        times = {path: [] for path in paths}
        for rep in range(5):
            for path in (paths if rep % 2 == 0 else list(paths)[::-1]):
                t0 = time.perf_counter()
                paths[path]()
                times[path].append(time.perf_counter() - t0)
    for k in ("gfmean", "gfvar", "fmean", "gmean"):
        tol = max(3.0 * rel(ref[torch.float32][k], ref[torch.float64][k]), 1e-5)
        d = rel(out["graphed"][k], out["eager"][k])
        log(f"{name}: {k:6s} graphed vs eager predict {d:.3e} (tol {tol:.3e})")
        if not d <= tol:
            raise AssertionError(f"{name}: graphed {k} differs from eager by {d:.3e} > {tol:.3e}")
    pts = {path: X.shape[0] / float(np.median(t)) for path, t in times.items()}
    log(f"time {name}: predict {X.shape[0]} rows at batch {batch}: eager {pts['eager']:.1f} points/s "
        f"{[round(X.shape[0] / t) for t in times['eager']]}, graphed (predict_batched) {pts['graphed']:.1f} points/s "
        f"{[round(X.shape[0] / t) for t in times['graphed']]} (median of 5, in turns; {card})")
    return pts


def time_chol_inv(ci, n, G=2):
    """ms per call of the kernel path (host included), its device ms (CUDA
    graph), the plain version's and torch.linalg's ms at one shape, and the
    kernel's largest difference from the plain version at the kernel's
    width (chol_inv.cu, n <= MAX_N)."""
    K = torch.as_tensor(spd_grams(n)[:G], device=DEVICE)
    kern = ci.chol_inv_cuda
    plain = lambda: ci.chol_inv_plain(K, ci.NB)
    with torch.inference_mode():
        ms = cuda_ms(lambda: kern(K), reps=200)
        device_ms = graph_ms(lambda: kern(K))
        plain_ms = cuda_ms(plain, reps=5, warmup=1)
        lib_ms = cuda_ms(lambda: library_chol_inv(K), reps=200)
        (L, Li), (Lp, Lip) = kern(K), plain()
        err = max(float((L - Lp).abs().max()), float((Li - Lip).abs().max()))
    return ms, device_ms, plain_ms, lib_ms, err


CLUSTER_SOURCE = "zigp_tpu_torch/ops/cuda/csrc/chol_inv_cluster.cu"
CLUSTER_REPLACES = "zigp_tpu/ops/pallas/chol_inv.py:387"


# --- the rbf_gram kernel and the training path ---------------------------------

GRAM_SOURCE = "zigp_tpu_torch/ops/cuda/csrc/rbf_gram.cu"
GRAM_REPLACES = "zigp_tpu/ops/pallas/rbf_gram.py:79"


def zero_counts() -> None:
    from zigp_tpu_torch.ops.cuda.graphs import counted_wrappers

    for fn in counted_wrappers().values():
        fn.launches = 0
        getattr(fn, "launches_by_shape", getattr(fn, "launches_by_n", None)).clear()
        if hasattr(fn, "launches_by_instance"):
            fn.launches_by_instance.clear()


def read_counts() -> dict:
    """{name: launches, name_by_shape: {shape: launches}} for every wrapper;
    the chol_inv wrappers' by-shape keys are ``chol_inv_by_n`` and
    ``chol_inv_blocked_by_n`` (the cluster kernel), and kron_mv_2 also has
    ``kron_mv_2_by_instance`` ({(G, Ma, Mb, transpose, instance): launches})."""
    from zigp_tpu_torch.ops.cuda.graphs import counted_wrappers

    out = {}
    for name, fn in counted_wrappers().items():
        out[name] = fn.launches
        by = getattr(fn, "launches_by_shape", None)
        out[f"{name}_by_n" if by is None else f"{name}_by_shape"] = dict(by if by is not None else fn.launches_by_n)
        if hasattr(fn, "launches_by_instance"):
            out[f"{name}_by_instance"] = dict(fn.launches_by_instance)
    return out


def per_step_launches(model) -> tuple[int, int, int]:
    """(rbf_gram, chol_inv.cu, chol_inv_cluster.cu) launches of one training
    step of the stacked f/g pair: K_mm and K_mn per factor; one chol_inv
    launch per factor, chol_inv.cu to MAX_N and the cluster kernel above."""
    from zigp_tpu_torch.ops.cuda import chol_inv as ci

    sizes = [Z.shape[0] for Z in model.f.Zs]
    return 2 * len(sizes), sum(n <= ci.MAX_N for n in sizes), sum(n > ci.MAX_N for n in sizes)


LAUNCH_KEYS = ("rbf_gram", "chol_inv", "chol_inv_blocked")  # per_step_launches' order


def check_launches(name, counts, steps, per_step) -> None:
    """Exactly ``steps`` × ``per_step`` launches of each kernel of the step."""
    got = tuple(counts[k] for k in LAUNCH_KEYS)
    want = tuple(steps * k for k in per_step)
    if got != want:
        raise AssertionError(f"{name}: launches {dict(zip(LAUNCH_KEYS, got))}, expected {dict(zip(LAUNCH_KEYS, want))}")


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
        f"block mean losses {[f'{b:.6g}' for b in blocks]}; launches rbf_gram {counts['rbf_gram']}, chol_inv.cu "
        f"{counts['chol_inv']}, chol_inv_cluster.cu {counts['chol_inv_blocked']} (expected {steps} x {per_step}); "
        f"by shape {counts['rbf_gram_by_shape']}, by n {counts['chol_inv_by_n']} {counts['chol_inv_blocked_by_n']}")
    if not torch.isfinite(res.step_losses).all():
        raise AssertionError(f"{name}: non-finite training loss")
    check_launches(name, counts, steps, per_step)
    if check:
        if not blocks[-1] < blocks[0]:
            raise AssertionError(f"{name}: the last block's mean loss {blocks[-1]} is not below the first's {blocks[0]}")
        check_f32_against_cpu_f64(name, model, split.Xtrain[:cfg.batch_size], split.Ytrain[:cfg.batch_size])
    return model, counts


def set_gram_kernel(model, on: bool) -> None:
    for gp in (model.f, model.g):
        for k in gp.kernels:
            k.use_kernel = on


def phase_ab(cfg, split, name="flagship"):
    """10 steps with both kernels against 10 steps with torch.linalg's
    Cholesky and triangular solve and the plain gram (the JAX selfcheck's
    Pallas-vs-XLA A/B), from the same model on the same batches; the
    kernels' launches counted exactly, the library run's none."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.ops import linalg
    from zigp_tpu_torch.training import DataSet, make_optimizer, make_scan_train_step, stage_batches

    base = build_onoff_pptr(cfg, split, device=DEVICE, use_kernel=True)
    per_step = per_step_launches(base)
    Xs, Ys = stage_batches(DataSet(split.Xtrain, split.Ytrain, seed=3), cfg.batch_size, AB_STEPS,
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
        log(f"A/B {name} {'kernels' if kernels else 'library'}: losses {losses[0]:.6f} .. {losses[-1]:.6f}, "
            f"launches rbf_gram {counts['rbf_gram']}, chol_inv.cu {counts['chol_inv']}, chol_inv_cluster.cu "
            f"{counts['chol_inv_blocked']}")
        check_launches(f"A/B {name} {'kernels' if kernels else 'library'}", counts, AB_STEPS if kernels else 0,
                       per_step)
    if not (np.isfinite(out[True]).all() and np.isfinite(out[False]).all()):
        raise AssertionError(f"A/B {name}: non-finite losses")
    err = abs(out[True][-1] - out[False][-1]) / abs(out[False][-1])
    log(f"A/B {name}: final loss kernels {out[True][-1]:.6f} vs library {out[False][-1]:.6f}: relative {err:.3e} "
        f"(tol 5e-3)")
    if not err <= 5e-3:
        raise AssertionError(f"A/B {name}: final losses differ by {err:.3e}")


def scale_train_cfg():
    """The 105 × 250 grid (the JAX bench's scale probe) at B = 8192."""
    from zigp_tpu_torch.experiments.configs import KronGridConfig, OnOffPptrConfig

    return OnOffPptrConfig(grid=KronGridConfig(num_spatial=105, num_temporal=250), batch_size=8192)


def phase_ab_cluster(split):
    """Where the package runs the scale grid's n = 250 by the cluster
    kernel's pair instance, 10 steps of the 105 × 250 grid at B = 8192 with
    chol_inv_blocked forced to the row instance, against 10 with the
    package's, from the same model on the same batches: final losses within
    5e-3 relative, each run's launches exact. Returns the row instance's
    launches by n, or {} where the package already runs it."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.ops.cuda import chol_inv as ci
    from zigp_tpu_torch.training import DataSet, make_optimizer, make_scan_train_step, stage_batches

    cfg = scale_train_cfg()
    base = build_onoff_pptr(cfg, split, device=DEVICE, use_kernel=True)
    sizes = [n for n in (Z.shape[0] for Z in base.f.Zs) if n > ci.MAX_N]
    if all(ci.blocked_route(n) == "cluster" for n in sizes):
        return {}
    Xs, Ys = stage_batches(DataSet(split.Xtrain, split.Ytrain, seed=3), cfg.batch_size, AB_STEPS,
                           device=DEVICE, dtype=torch.float32)
    route = ci.blocked_route
    out, counts = {}, {}
    for name in ("package", "rows"):
        m = copy.deepcopy(base)
        if name == "rows":
            ci.blocked_route = lambda n: "cluster"
        try:
            zero_counts()
            losses = make_scan_train_step(make_optimizer(m, default_lr=cfg.indp_lr))(m, Xs, Ys).cpu().numpy()
            counts[name] = read_counts()
            want = AB_STEPS * len(sizes)
        finally:
            ci.blocked_route = route
        got = counts[name]["chol_inv_blocked"]
        log(f"A/B scale 105x250 chol_inv_blocked {name}: losses {losses[0]:.6f} .. {losses[-1]:.6f}, launches "
            f"{got} (expected {want}), by n {counts[name]['chol_inv_blocked_by_n']}")
        if got != want or not np.isfinite(losses).all():
            raise AssertionError(f"A/B chol_inv_blocked {name}: launches {got} (expected {want}) or non-finite losses")
        out[name] = losses
    err = abs(out["rows"][-1] - out["package"][-1]) / abs(out["package"][-1])
    log(f"A/B scale 105x250 chol_inv_blocked: final loss row instance {out['rows'][-1]:.6f} vs package "
        f"{out['package'][-1]:.6f}: relative {err:.3e} (tol 5e-3)")
    if not err <= 5e-3:
        raise AssertionError(f"A/B chol_inv_blocked instances: final losses differ by {err:.3e}")
    return counts["rows"]["chol_inv_blocked_by_n"]


def blocked_rows(ci, blocked: dict, rows_ab: dict, card) -> list:
    """The kernels-line rows of the cluster kernel at each n > MAX_N: by the
    package's instance on the main path (``blocked``: its launches in scale
    serving and training), and by the row instance from the scale A/B
    (``rows_ab``) where the package runs the pair instance. Each: ms per
    call with the host, device ms (CUDA graph), the plain version's ms
    (chol_inv_plain at the kernel's width), torch.linalg's, the bound and the
    largest difference from the plain version."""
    entries = [(n, ci.blocked_route(n), k, "scale 105x250 serving and training") for n, k in blocked.items()]
    entries += [(n, "cluster", k, "scale 105x250 training A/B, the row instance forced") for n, k in rows_ab.items()]
    rows = []
    for n, instance, launches, path in sorted(entries):
        K = torch.as_tensor(spd_grams(n), device=DEVICE)
        kern = (lambda: ci.launch_chol_inv_pair(K)) if instance == "pair" else (lambda: ci.launch_chol_inv_cluster(K))
        plain = lambda: ci.chol_inv_plain(K, ci.NB)
        with torch.inference_mode():
            ms, device_ms = cuda_ms(kern, reps=200), graph_ms(kern)
            plain_ms = cuda_ms(plain, reps=3, warmup=1)
            lib_ms = cuda_ms(lambda: library_chol_inv(K), reps=200)
            err = max(float((a - b).abs().max()) for a, b in zip(kern(), plain()))
        b_ms, b_by = bound_ms(n, 2)
        label = "pair" if instance == "pair" else f"rows C={ci.plan(n).C}"
        kname = f"chol_inv_cluster {label} n={n} G=2 ({path})"
        log(f"time {kname}: kernel {ms:.4f} ms, device {device_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.linalg "
            f"{lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), launches {launches}, max |kernel - plain| {err:.3e}; "
            f"{card}")
        if launches == 0:
            raise AssertionError(f"{kname}: not launched on its path")
        rows.append({"name": kname, "route": "cuda", "source": CLUSTER_SOURCE, "replaces": CLUSTER_REPLACES,
                     "launches": launches, "max_abs_err": err, "ms": ms, "device_ms": device_ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    return rows


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
    path: the kernel's ms per call (CUDA events, host included), its device
    ms (CUDA graph), the plain version's ms, the bound, and the kernel's
    largest difference from the plain version. The
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
                device_ms = graph_ms(lambda: rg.rbf_gram_cuda(X, Z, ell, var))
                plain_ms = cuda_ms(lambda: rg.rbf_gram_plain(X, Z, ell, var), reps=50)
                K, Kp = rg.rbf_gram_cuda(X, Z, ell, var), rg.rbf_gram_plain(X, Z, ell, var)
                err = float((K - Kp).abs().max())
                dist = rel(K.cpu().numpy(), Kp.cpu().numpy())
            b_ms, b_by = gram_bound_ms(G, N, M, D, shared)
            kname = f"rbf_gram ({G},{N},{M}) D={D} {'K_mn' if shared else 'K_mm'} ({path})"
            log(f"time {kname}: kernel {ms:.4f} ms, device {device_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {b_ms:.6f} ms ({b_by}), "
                f"launches {launches}, max |kernel - plain| {err:.3e}, relative {dist:.3e} "
                f"(tol {GRAM_VS_PLAIN_TOL:.0e}); {card}")
            if not dist <= GRAM_VS_PLAIN_TOL:
                raise AssertionError(f"{kname}: kernel vs plain {dist:.3e} > {GRAM_VS_PLAIN_TOL:.0e}")
            rows.append({
                "name": kname, "route": "cuda", "source": GRAM_SOURCE, "replaces": GRAM_REPLACES,
                "launches": launches, "max_abs_err": err, "ms": ms, "device_ms": device_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            })
    return rows


# --- the JAX package's A/B alternatives: chol.cu, kron_mv.cu, the plain inverses -

CHOL_SOURCE = "zigp_tpu_torch/ops/cuda/csrc/chol.cu"
KRON_SOURCE = "zigp_tpu_torch/ops/cuda/csrc/kron_mv.cu"
REPLACES = {
    "small_cholesky": "zigp_tpu/ops/pallas/cholesky.py:52",
    "batched_small_cholesky": "zigp_tpu/ops/pallas/cholesky.py:65",
    "chol": "zigp_tpu/ops/pallas/chol_inv.py:193",
    "kron_mv_2": "zigp_tpu/ops/pallas/kron_matvec.py:32",
}
AB_RANK = 4  # chol_pallas's default columns per step


def route_chol_dc(K):
    """chol_inv's forward as L from chol.cu (chol_cuda at rank 4) and L⁻¹ by
    tri_inv_dc: the JAX record's overflow-safe solve-free variant."""
    from zigp_tpu_torch.ops.cuda import chol_inv as ci

    L = ci.chol_cuda(K.contiguous(), rank=AB_RANK)
    return L, ci.tri_inv_dc(L)


def route_chol_newton(K):
    """L from chol.cu (chol_cuda at rank 4), L⁻¹ by tri_inv_newton."""
    from zigp_tpu_torch.ops.cuda import chol_inv as ci

    L = ci.chol_cuda(K.contiguous(), rank=AB_RANK)
    return L, ci.tri_inv_newton(L)


def route_small_cholesky_solve(K):
    """L from the one-column kernel (small_cholesky on a single matrix,
    batched_small_cholesky on a stack), L⁻¹ by torch.linalg's triangular
    solve: what the fused kernel superseded."""
    from zigp_tpu_torch.ops.cuda import cholesky as sc

    n = K.shape[-1]
    Kc = K.contiguous()
    if Kc.numel() == n * n:
        L = sc.small_cholesky_cuda(Kc.reshape(n, n)).reshape(K.shape)
    else:
        L = sc.batched_small_cholesky_cuda(Kc.reshape(-1, n, n)).reshape(K.shape)
    eye = torch.eye(n, dtype=K.dtype, device=K.device).expand_as(L)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


TRAIN_ROUTES = {"chol+dc": route_chol_dc, "chol+newton": route_chol_newton,
                "small_cholesky+solve": route_small_cholesky_solve}


def kron_linv_solve_kron_mv(Linvs, b):
    """(⊗K_p⁻¹) b of a two-factor grid as two kron_mv_2 launches: (L_a⁻¹ ⊗
    L_b⁻¹) b, then (L_a⁻ᵀ ⊗ L_b⁻ᵀ) of that, the kernel reading the factors
    transposed."""
    from zigp_tpu_torch.ops.cuda.kron_matvec import kron_mv_2_cuda

    if len(Linvs) != 2:
        raise ValueError(f"kron_mv_2 takes two factors, the grid has {len(Linvs)}")
    La, Lb = (Li.contiguous() for Li in Linvs)
    return kron_mv_2_cuda(La, Lb, kron_mv_2_cuda(La, Lb, b.contiguous()), transpose=True)


def chol_bound_ms(n: int, G: int) -> tuple[float, str]:
    """Least time for L of G n×n matrices: K read and L written once
    (2·G·n²·4 bytes), n³/3 flops each, f32 outside the tensor cores."""
    t_bytes = 2 * G * n * n * 4 / PEAK_BYTES_PER_S
    t_ops = G * n**3 / 3 / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kron_bound_ms(G: int, Ma: int, Mb: int) -> tuple[float, str]:
    """Least time for G products (A ⊗ B) x: A, B, x read and y written once,
    2·Ma·Mb·(Ma + Mb) flops each."""
    t_bytes = G * (Ma * Ma + Mb * Mb + 2 * Ma * Mb) * 4 / PEAK_BYTES_PER_S
    t_ops = 2 * G * Ma * Mb * (Ma + Mb) / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_kernel(what, kern, plain, ref, lib_err) -> None:
    """The kernel within max(3 × the library's f32 error, 1e-5) of the float64
    oracle, and within that bound plus the plain version's own error of the
    plain version (each stays within its own error of the oracle)."""
    kern, plain = np.asarray(kern.cpu(), np.float64), np.asarray(plain.cpu(), np.float64)
    err, plain_err, dist = rel(kern, ref), rel(plain, ref), rel(kern, plain)
    tol = max(3.0 * lib_err, 1e-5)
    log(f"gate {what}: kernel {err:.3e}  library {lib_err:.3e}  plain {plain_err:.3e}  kernel-vs-plain {dist:.3e}  "
        f"(tol {tol:.3e}, {tol + plain_err:.3e})")
    if not (err <= tol and dist <= tol + plain_err):
        raise AssertionError(f"{what}: kernel {err:.3e} (tol {tol:.3e}), vs plain {dist:.3e} "
                             f"(tol {tol + plain_err:.3e})")


def phase_chol_gate():
    """chol.cu through its three wrappers (one matrix, the pair, and
    chol_cuda at 2, 4 and 8 columns a step, all of which run the kernel at
    its own width) against a float64 oracle and its plain version on the
    card, up to and past the shared-memory limit, and NaN on a non-PSD
    input."""
    from zigp_tpu_torch.ops.cuda import chol_inv as ci
    from zigp_tpu_torch.ops.cuda import cholesky as sc

    limit = sc.shared_max_n()
    log(f"gate chol: {sc.NB} columns a step; the shared-memory instance takes n <= {limit}, the in-place global "
        f"one above")
    routes = [("small_cholesky", 1, lambda K: sc.small_cholesky_cuda(K[0])[None], True),
              ("batched_small_cholesky", 1, sc.batched_small_cholesky_cuda, False)]
    routes += [(f"chol rank {r}", r, lambda K, r=r: ci.chol_cuda(K, rank=r), False) for r in (2, 4, 8)]
    for n in (1, 10, 31, 32, 33, 100, 105, 128, 200, 240, 250, limit, limit + 1):
        K32 = spd_grams(n)
        ref = np.linalg.cholesky(K32.astype(np.float64))
        for what, rank, fn, single in routes:
            Kd = torch.as_tensor(K32[:1] if single else K32, device=DEVICE)
            with torch.inference_mode():
                L, Lp, Ll = fn(Kd), sc.chol_plain(Kd, sc.NB), torch.linalg.cholesky(Kd)
            torch.cuda.synchronize()
            if not torch.all(torch.triu(L, 1) == 0):
                raise AssertionError(f"{what} n={n}: nonzero upper triangle")
            r = ref[:1] if single else ref
            check_kernel(f"{what} n={n:3d}", L, Lp, r, rel(Ll.cpu().numpy(), r))

    for n, p in NON_PSD:
        K = non_psd(n, p)
        for what, rank, fn, single in routes:
            with torch.inference_mode():
                L = fn(torch.as_tensor(K[:1] if single else K, device=DEVICE))
            nan_check(f"{what} n={n}", L, None, p)
    log(f"gate chol non-PSD input (n, K[p,p] = -1) {NON_PSD}, every route: NaN from the failing pivot on, rows "
        f"before it unchanged")


KRON_SPECS = {False: "gia,gjb,gab->gij", True: "gai,gbj,gab->gij"}  # Y = A X Bᵀ, or Aᵀ X B


def kron_inputs(G, Ma, Mb):
    """Seeded non-symmetric factors of different sizes and a vector, float32."""
    rng = np.random.RandomState(Ma * Mb)
    return [rng.randn(*shape).astype(np.float32) for shape in ((G, Ma, Ma), (G, Mb, Mb), (G, Ma * Mb))]


def phase_kron_gate():
    """kron_mv.cu against a float64 oracle and its plain version on the card,
    both orientations: at the serving route's shapes, a non-square grid, the
    ragged edges (Ma = 1, Mb below a tile), the cluster's reach (Ma = 8 TM)
    and one row past it, in the plan's instance (the global one past the
    reach) and, within the reach, in the global instance too."""
    from zigp_tpu_torch.ops.cuda import kron_matvec as km

    edge = km.MAX_CLUSTER * km.TM
    for G, Ma, Mb in ((2, 10, 100), (2, 105, 250), (2, 6, 9), (1, 1, 1), (3, 1, 5), (1, 33, 70), (2, edge, 40),
                      (2, edge + 1, 40)):
        A, B, x = kron_inputs(G, Ma, Mb)
        Ad, Bd, xd = (torch.as_tensor(a, device=DEVICE) for a in (A, B, x))
        instances = [None] + (["global"] if km.plan(G, Ma, Mb).instance == "cluster" else [])
        for trans, spec in KRON_SPECS.items():
            ref = np.einsum(spec, A.astype(np.float64), B.astype(np.float64),
                            x.astype(np.float64).reshape(G, Ma, Mb)).reshape(G, -1)
            with torch.inference_mode():
                yp = km.kron_mv_2_plain(Ad, Bd, xd, transpose=trans)
                yl = torch.einsum(spec, Ad, Bd, xd.reshape(G, Ma, Mb)).reshape(G, -1)
            for instance in instances:
                p = km.plan(G, Ma, Mb, instance)
                with torch.inference_mode():
                    y = km.launch_kron_mv(Ad, Bd, xd, trans, instance)
                torch.cuda.synchronize()
                check_kernel(f"kron_mv_2 ({G}; {Ma}, {Mb}) {'transposed' if trans else 'plain'}, {p.name}, grid "
                             f"{p.grid}", y, yp, ref, rel(yl.cpu().numpy(), ref))


def gate_inverse(name, fn, what, L32) -> None:
    """One plain inverse on the card against float64: within max(3 × the
    larger of solve_triangular's f32 error on the card and the same routine's
    f32 error on the CPU, 1e-5). Both routines multiply computed
    sub-inverses, so on dense grams their f32 error is cond-limited and
    exceeds the solve's by up to 170 × on the CPU too: the CPU run is the
    routine's own yardstick, and the log shows both. Where the CPU run
    overflows float32 (Newton's documented limit), the card must too."""
    ref = np.linalg.inv(L32.astype(np.float64))
    Ld = torch.as_tensor(L32, device=DEVICE)
    n = L32.shape[-1]
    with torch.inference_mode():
        X = fn(Ld).cpu().numpy()
        Xl = torch.linalg.solve_triangular(Ld, torch.eye(n, device=DEVICE).expand_as(Ld), upper=False)
        X_cpu = fn(torch.as_tensor(L32)).numpy()
    if not np.isfinite(X_cpu).all():
        log(f"gate {name} {what}: overflows float32 on the CPU (the algorithm's limit); on the card finite "
            f"{bool(np.isfinite(X).all())} (expected False)")
        if np.isfinite(X).all():
            raise AssertionError(f"{name} {what}: finite on the card where the CPU run overflows")
        return
    err, cpu_err, lib_err = rel(X, ref), rel(X_cpu, ref), rel(Xl.cpu().numpy(), ref)
    tol = max(3.0 * max(lib_err, cpu_err), 1e-5)
    log(f"gate {name} {what}: card {err:.3e}  cpu {cpu_err:.3e}  solve_triangular {lib_err:.3e}  (tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"{name} {what}: error {err:.3e} > {tol:.3e}")


def phase_tri_inv_gate():
    """tri_inv_dc at n = 10, 100, 105, 250 and tri_inv_newton at n = 10, 100
    on the kernel gate's grams (``gate_inverse``), then Newton's documented
    f32 overflow on the n = 256 factor of ``tests/test_pallas.py``, where
    tri_inv_dc stays finite and within 1e-3."""
    from zigp_tpu_torch.ops.cuda import chol_inv as ci

    for name, fn, ns in (("tri_inv_dc", ci.tri_inv_dc, (10, 100, 105, 250)),
                         ("tri_inv_newton", ci.tri_inv_newton, (10, 100))):
        for n in ns:
            gate_inverse(name, fn, f"n={n:3d}", np.linalg.cholesky(spd_grams(n).astype(np.float64)).astype(np.float32))

    n = 256
    t = np.linspace(0, 1, n)[:, None]
    K = 20.0 * np.exp(-0.5 * (t - t.T) ** 2 / 0.1**2) + (1e-5 + 2e-4 * 20.0) * np.eye(n)
    L32 = np.linalg.cholesky(K).astype(np.float32)
    ref = np.linalg.inv(L32.astype(np.float64))
    Ld = torch.as_tensor(L32, device=DEVICE)
    with torch.inference_mode():
        Xn, Xd = ci.tri_inv_newton(Ld).cpu().numpy(), ci.tri_inv_dc(Ld).cpu().numpy()
    err_d = float(np.abs(Xd - ref).max() / np.abs(ref).max())
    log(f"gate n=256 dense temporal factor: tri_inv_newton finite {bool(np.isfinite(Xn).all())} "
        f"(expected False), tri_inv_dc finite {bool(np.isfinite(Xd).all())}, max error {err_d:.3e} (tol 1e-3)")
    if np.isfinite(Xn).all():
        raise AssertionError("tri_inv_newton: the n = 256 factor did not overflow float32")
    if not (np.isfinite(Xd).all() and err_d < 1e-3):
        raise AssertionError(f"tri_inv_dc: the n = 256 factor gave max error {err_d:.3e}")


def phase_train_routes(cfg, split):
    """chol_inv_stacked on the flagship's factor pair, then 10 steps of the
    flagship for each of the three L-only routes of chol_inv's forward,
    against 10 with the production kernels, from the same model on the same
    batches; and the one-column route once more on the unpaired model, where
    each GP's factor is a single matrix (small_cholesky). Returns each
    route's launch counts."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.models.kron import _stack
    from zigp_tpu_torch.ops import linalg
    from zigp_tpu_torch.ops.cuda import cholesky as sc
    from zigp_tpu_torch.ops.cuda import chol_inv as ci
    from zigp_tpu_torch.training import DataSet, make_optimizer, make_scan_train_step, stage_batches

    base = build_onoff_pptr(cfg, split, device=DEVICE, use_kernel=True)
    with torch.inference_mode():
        grams = base.f._gram_factors(_stack([base.f.values(), base.g.values()]))
        for K, (L, Li) in zip(grams, linalg.chol_inv_stacked(grams)):
            L0, Li0 = linalg.chol_inv(K)
            e = max(rel(L.cpu(), L0.cpu()), rel(Li.cpu(), Li0.cpu()))
            log(f"gate chol_inv_stacked {tuple(K.shape)} of the flagship pair vs chol_inv: {e:.3e} (tol 1e-6)")
            if not e <= 1e-6:
                raise AssertionError(f"chol_inv_stacked {tuple(K.shape)}: {e:.3e} from chol_inv")
            L32 = np.linalg.cholesky(K.cpu().double().numpy()).astype(np.float32)
            for name in ("tri_inv_dc", "tri_inv_newton"):
                gate_inverse(name, getattr(ci, name), f"flagship factor {tuple(K.shape)}", L32)

    Xs, Ys = stage_batches(DataSet(split.Xtrain, split.Ytrain, seed=3), cfg.batch_size, AB_STEPS,
                           device=DEVICE, dtype=torch.float32)
    forward = linalg._chol_inv_forward
    runs = [("production", None, True), *((n, r, True) for n, r in TRAIN_ROUTES.items()),
            ("small_cholesky+solve unpaired", route_small_cholesky_solve, False)]
    out, all_counts = {}, {}
    for name, route, paired in runs:
        m = copy.deepcopy(base)
        m.pair_gps = paired
        if route is not None:
            linalg._chol_inv_forward = route
        try:
            zero_counts()
            losses = make_scan_train_step(make_optimizer(m, default_lr=cfg.indp_lr))(m, Xs, Ys).cpu().numpy()
            counts = read_counts()
        finally:
            linalg._chol_inv_forward = forward
        chol = counts["chol"] + counts["small_cholesky"] + counts["batched_small_cholesky"]
        per_step = 2 if paired else 4  # one factorization per factor, of the pair or of each GP
        log(f"train A/B {name}: losses {losses[0]:.6f} .. {losses[-1]:.6f}; launches chol.cu {chol} "
            f"(chol {counts['chol']}, small_cholesky {counts['small_cholesky']}, batched "
            f"{counts['batched_small_cholesky']}), chol_inv.cu {counts['chol_inv']}, rbf_gram {counts['rbf_gram']}")
        expected = (0, AB_STEPS * per_step) if route is None else (AB_STEPS * per_step, 0)
        if (chol, counts["chol_inv"]) != expected:
            raise AssertionError(f"train A/B {name}: chol.cu {chol}, chol_inv.cu {counts['chol_inv']} launches, "
                                 f"expected {expected}")
        if name == "chol+newton" and not np.isfinite(losses).all():
            # The documented limit of the algorithm, if the plain version
            # overflows in f32 on the CPU on the same factors too.
            plain = [ci.tri_inv_newton(sc.chol_plain(K.cpu(), AB_RANK)) for K in grams]
            if all(torch.isfinite(X).all() for X in plain):
                raise AssertionError("train A/B chol+newton: non-finite on the card, finite in the plain version")
            log("train A/B chol+newton: overflows float32, as its plain version does on the CPU (the algorithm's limit)")
            all_counts[name] = counts
            continue
        if not np.isfinite(losses).all():
            raise AssertionError(f"train A/B {name}: non-finite losses")
        out[name] = losses
        all_counts[name] = counts
        if route is not None:
            err = abs(losses[-1] - out["production"][-1]) / abs(out["production"][-1])
            log(f"train A/B {name}: final loss {losses[-1]:.6f} vs production {out['production'][-1]:.6f}: "
                f"relative {err:.3e} (tol 5e-3)")
            if not err <= 5e-3:
                raise AssertionError(f"train A/B {name}: final losses differ by {err:.3e}")
    return all_counts


def phase_serving_kron_mv(name, model, X, batch, ref):
    """predict_batched with the unwhitened mean's (⊗K_p⁻¹) q_mu through
    kron_mv_2 (two launches a chunk), against the CPU float64 run on the first
    rows, and beside the production route on the card."""
    from zigp_tpu_torch.experiments.runners import predict_batched
    from zigp_tpu_torch.ops import linalg

    chunks = math.ceil(X.shape[0] / batch)
    prod = predict_batched(model.predict, X, batch=batch, device=DEVICE)
    routed = copy.deepcopy(model)  # its own chunk graph, captured with the route
    solve = linalg.kron_linv_solve
    linalg.kron_linv_solve = kron_linv_solve_kron_mv
    try:
        zero_counts()
        out = predict_batched(routed.predict, X, batch=batch, device=DEVICE)
        counts = read_counts()
    finally:
        linalg.kron_linv_solve = solve
    log(f"serving A/B {name}: {X.shape[0]} rows in {chunks} chunks of {batch}: kron_mv_2 launches "
        f"{counts['kron_mv_2']} (expected {2 * chunks}), by shape {counts['kron_mv_2_by_shape']}")
    if counts["kron_mv_2"] != 2 * chunks:
        raise AssertionError(f"serving A/B {name}: {counts['kron_mv_2']} kron_mv_2 launches, expected {2 * chunks}")
    for k, v in out.items():
        if v.shape[0] != X.shape[0] or not np.isfinite(v).all():
            raise AssertionError(f"serving A/B {name}: {k} has shape {v.shape} or non-finite values")
    if (out["gfvar"] < 0).any():
        raise AssertionError(f"serving A/B {name}: negative gfvar")
    for k in ("gfmean", "gfvar", "fmean", "gmean"):
        e_card = rel(out[k][:CHECK_ROWS], ref[torch.float64][k])
        e_cpu = rel(ref[torch.float32][k], ref[torch.float64][k])
        tol = max(3.0 * e_cpu, 1e-5)
        log(f"serving A/B {name}: {k:6s} card f32 (kron_mv_2) vs cpu f64 {e_card:.3e}, cpu f32 vs cpu f64 "
            f"{e_cpu:.3e} (tol {tol:.3e}); vs the card's production route {rel(out[k], prod[k]):.3e}")
        if not e_card <= tol:
            raise AssertionError(f"serving A/B {name}: {k} card error {e_card:.3e} > {tol:.3e}")
    return counts


def sum_by_shape(counts_list, key) -> dict:
    total = {}
    for counts in counts_list:
        for shape, k in counts[key].items():
            total[shape] = total.get(shape, 0) + k
    return total


def ab_rows(route_counts: dict, serve_counts: dict, card) -> list:
    """One kernels-line row per chol.cu and kron_mv.cu shape launched on the
    A/B paths: ms per call (CUDA events, host included), device ms (CUDA
    graph), the plain version's ms (chol_plain at the kernel's width), the
    library's (torch.linalg.cholesky; the one torch.einsum), the bound, and
    the largest difference from the plain version."""
    from zigp_tpu_torch.ops.cuda import chol_inv as ci
    from zigp_tpu_torch.ops.cuda import cholesky as sc
    from zigp_tpu_torch.ops.cuda import kron_matvec as km

    rows = []
    chol_wrappers = {
        "small_cholesky": (lambda shape: (1, shape, 1), lambda K, r: sc.small_cholesky_cuda(K[0])[None]),
        "batched_small_cholesky": (lambda shape: (*shape, 1), lambda K, r: sc.batched_small_cholesky_cuda(K)),
        "chol": (lambda shape: shape, lambda K, r: ci.chol_cuda(K, rank=r)),
    }
    for wrapper, (unpack, call) in chol_wrappers.items():
        key = f"{wrapper}_by_shape"
        for shape, launches in sorted(sum_by_shape(route_counts.values(), key).items()):
            paths = [name for name, c in route_counts.items() if shape in c[key]]
            G, n, rank = unpack(shape)
            K = torch.as_tensor(spd_grams(n)[:G], device=DEVICE)
            with torch.inference_mode():
                ms = cuda_ms(lambda: call(K, rank), reps=200)
                device_ms = graph_ms(lambda: call(K, rank))
                plain_ms = cuda_ms(lambda: sc.chol_plain(K, sc.NB), reps=5, warmup=1)
                lib_ms = cuda_ms(lambda: torch.linalg.cholesky(K), reps=200)
                err = float((call(K, rank) - sc.chol_plain(K, sc.NB)).abs().max())
            b_ms, b_by = chol_bound_ms(n, G)
            kname = (f"{wrapper} ({G},{n},{n}){f' rank {rank}' if wrapper == 'chol' else ''}, kernel at {sc.NB} "
                     f"columns a step (train A/B: {', '.join(paths)})")
            log(f"time {kname}: kernel {ms:.4f} ms, device {device_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"torch.linalg.cholesky {lib_ms:.4f} ms, "
                f"bound {b_ms:.6f} ms ({b_by}), launches {launches}, max |kernel - plain| {err:.3e}; {card}")
            rows.append({"name": kname, "route": "cuda", "source": CHOL_SOURCE, "replaces": REPLACES[wrapper],
                         "launches": launches, "max_abs_err": err, "ms": ms, "device_ms": device_ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})

    for (G, Ma, Mb, trans), launches in sorted(sum_by_shape(serve_counts.values(), "kron_mv_2_by_shape").items()):
        paths = [name for name, c in serve_counts.items() if (G, Ma, Mb, trans) in c["kron_mv_2_by_shape"]]
        by_instance = {}  # this shape's launches on its paths, by the instance the library ran
        for (*shape, instance), k in sum_by_shape(serve_counts.values(), "kron_mv_2_by_instance").items():
            if tuple(shape) == (G, Ma, Mb, trans):
                by_instance[instance] = by_instance.get(instance, 0) + k
        if by_instance != {km.plan(G, Ma, Mb).name: launches}:
            raise AssertionError(f"kron_mv_2 ({G}; {Ma}, {Mb}): {launches} launches, by instance {by_instance} "
                                 f"(expected all {km.plan(G, Ma, Mb).name})")
        A, B, x = (torch.as_tensor(a, device=DEVICE) for a in kron_inputs(G, Ma, Mb))
        x = x[..., None]  # (G, N, 1), as the serving path passes q_mu
        spec = KRON_SPECS[trans]
        plain = lambda: km.kron_mv_2_plain(A, B, x, transpose=trans)
        with torch.inference_mode():
            ms = cuda_ms(lambda: km.kron_mv_2_cuda(A, B, x, transpose=trans), reps=200)
            device_ms = graph_ms(lambda: km.kron_mv_2_cuda(A, B, x, transpose=trans))
            plain_ms = cuda_ms(plain, reps=200)
            plain_device_ms = graph_ms(plain)
            lib_ms = cuda_ms(lambda: torch.einsum(spec, A, B, x.reshape(G, Ma, Mb)), reps=200)
            err = float((km.kron_mv_2_cuda(A, B, x, transpose=trans) - plain()).abs().max())
        b_ms, b_by = kron_bound_ms(G, Ma, Mb)
        kname = f"kron_mv_2 ({G}; {Ma}, {Mb}){' transposed' if trans else ''} (serving A/B: {', '.join(paths)})"
        log(f"time {kname}: kernel {ms:.4f} ms, device {device_ms:.4f} ms, plain {plain_ms:.4f} ms, plain device "
            f"{plain_device_ms:.4f} ms, torch.einsum {lib_ms:.4f} ms, "
            f"bound {b_ms:.6f} ms ({b_by}), launches {launches} {by_instance}, max |kernel - plain| {err:.3e}; {card}")
        rows.append({"name": kname, "route": "cuda", "source": KRON_SOURCE, "replaces": REPLACES["kron_mv_2"],
                     "launches": launches, "launches_by_instance": by_instance, "max_abs_err": err, "ms": ms,
                     "device_ms": device_ms, "plain_ms": plain_ms, "plain_device_ms": plain_device_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    return rows


def time_kron_instances(card) -> None:
    """kron_mv.cu in both instances the library builds (the 16 × 16 tile,
    the cluster and the global instance), both orientations, at the serving
    route's shapes: ms per call with the host and device ms (CUDA graph).
    Runs after every count has been read; the other tiles are swept by
    ``experiments/kron_phases.py``."""
    from zigp_tpu_torch.ops.cuda import kron_matvec as km

    for G, Ma, Mb in ((2, 105, 250), (2, 10, 100)):
        A, B, x = (torch.as_tensor(a, device=DEVICE) for a in kron_inputs(G, Ma, Mb))
        out = {}
        with torch.inference_mode():
            for instance in ("cluster", "global"):
                for trans in (False, True):
                    fn = lambda: km.launch_kron_mv(A, B, x, trans, instance)
                    name = f"{km.plan(G, Ma, Mb, instance).name}{' T' if trans else ''}"
                    out[name] = (round(cuda_ms(fn, reps=200), 5), round(graph_ms(fn), 5))
        log(f"time kron_mv instances ({G}; {Ma}, {Mb}), (ms, device ms): {json.dumps(out)}; {card}")


def time_serving_kron_mv(model, X, batch, card) -> dict:
    """predict_batched points/s on one model with the production Kronecker
    solve and with the kron_mv_2 route: median of 5 passes each, in turns
    (production, route, route, production, ...)."""
    from zigp_tpu_torch.experiments.runners import predict_batched
    from zigp_tpu_torch.ops import linalg

    solve = linalg.kron_linv_solve
    routes = {"production": solve, "kron_mv_2": kron_linv_solve_kron_mv}
    # each route on its own model: the chunk graph its first call captures holds the route
    models = {"production": model, "kron_mv_2": copy.deepcopy(model)}
    times = {name: [] for name in routes}

    def run(name):
        linalg.kron_linv_solve = routes[name]
        try:
            t0 = time.perf_counter()
            predict_batched(models[name].predict, X, batch=batch, device=DEVICE)  # ends in a host copy: synchronised
            return time.perf_counter() - t0
        finally:
            linalg.kron_linv_solve = solve

    for name in routes:
        run(name)  # warm-up
    for rep in range(5):
        for name in (routes if rep % 2 == 0 else list(routes)[::-1]):
            times[name].append(run(name))
    pts = {name: X.shape[0] / float(np.median(t)) for name, t in times.items()}
    log(f"time serving 105x250, predict_batched {X.shape[0]} rows at batch {batch}, the mean's Kronecker solve: "
        + ", ".join(f"{n} {pts[n]:.1f} points/s {[round(X.shape[0] / t) for t in times[n]]}" for n in routes)
        + f" (median of 5, in turns; {card})")
    return pts


def time_panel_widths(card) -> None:
    """Both tiled kernels at every panel width they are built for, on the
    pair at n = 100 and 200 (chol.cu also on one matrix at n = 100): ms per
    call with the host, and device ms (CUDA graph); then the line MAX_N rests
    on, (L, L⁻¹) at n = 200 by the direct kernel, by the cluster kernel's
    pair instance, by the torch blocked routine and by torch.linalg; then the
    plain inverses at n = 100."""
    from zigp_tpu_torch.ops.cuda import chol_inv as ci
    from zigp_tpu_torch.ops.cuda import cholesky as sc

    for G, n in ((2, 100), (2, 200), (1, 100)):
        K = torch.as_tensor(spd_grams(n)[:G], device=DEVICE)
        out = {}
        with torch.inference_mode():
            for nb in sc.NBS:
                calls = {"chol.cu": lambda: sc.launch_chol(K, "sweep", nb)}
                if G == 2:
                    calls["chol_inv.cu"] = lambda: ci.launch_chol_inv(K, "sweep", nb)
                for name, fn in calls.items():
                    out.setdefault(name, {})[nb] = (round(cuda_ms(fn, reps=200), 5), round(graph_ms(fn), 5))
        log(f"time panel widths ({G},{n},{n}), nb: (ms, device ms): {json.dumps(out)}; {card}")

    K = torch.as_tensor(spd_grams(200), device=DEVICE)
    with torch.inference_mode():
        direct = lambda: ci.launch_chol_inv(K, "sweep")
        pair = lambda: ci.launch_chol_inv_pair(K)
        routine = lambda: ci.chol_inv_blocked_plain(K)
        line = {"direct chol_inv.cu": (cuda_ms(direct, reps=200), graph_ms(direct)),
                "cluster kernel, pair": (cuda_ms(pair, reps=200), graph_ms(pair)),
                "torch blocked routine": (cuda_ms(routine, reps=200), graph_ms(routine)),
                "torch.linalg": (cuda_ms(lambda: library_chol_inv(K), reps=200), None)}
    log(f"time (L, L⁻¹) (2,200,200), (ms, device ms): {json.dumps(line)}; MAX_N {ci.MAX_N}; {card}")

    K = torch.as_tensor(spd_grams(100), device=DEVICE)
    with torch.inference_mode():
        L = sc.launch_chol(K, "sweep")
        inv = {f.__name__: cuda_ms(lambda: f(L), reps=50) for f in (ci.tri_inv_dc, ci.tri_inv_newton)}
    log(f"time plain inverses (2,100,100): {json.dumps({k: round(v, 5) for k, v in inv.items()})} ms; {card}")


def time_blocked_routes(card) -> dict:
    """The cluster kernel at (2, 250, 250) and (2, 512, 512): its pair
    instance where it reaches and its row instance at every cluster size
    that fits, beside the torch blocked routine they replaced (which
    launches chol_inv.cu on its diagonal blocks) and torch.linalg: ms per
    call with the host (CUDA events around 200 calls) and device ms (CUDA
    graph), in turns (routine, instances, instances reversed, routine).
    Every instance's output must be the same bits as the package's: each
    entry takes the same operations whichever CTA computes it. Runs after
    every count has been read; returns the line."""
    from zigp_tpu_torch.ops.cuda import chol_inv as ci

    out = {}
    for n in (250, 512):
        K = torch.as_tensor(spd_grams(n), device=DEVICE)
        sizes = [C for C in ci.CLUSTER_SIZES if ci._cluster_bytes(n, C)[1] <= ci.SMEM_BYTES]
        calls = {f"rows C={C}": (lambda C=C: ci.launch_chol_inv_cluster(K, C)) for C in sizes}
        if ci.blocked_route(n) == "pair":
            calls["pair"] = lambda: ci.launch_chol_inv_pair(K)
        calls["torch routine"] = lambda: ci.chol_inv_blocked_plain(K)
        times = {name: [] for name in calls}
        order = ["torch routine", *(name for name in calls if name != "torch routine")]
        with torch.inference_mode():
            for names in (order, order[::-1]):
                for name in names:
                    times[name].append((cuda_ms(calls[name], reps=200), graph_ms(calls[name])))
            lib_ms = cuda_ms(lambda: library_chol_inv(K), reps=200)
            ref = ci.chol_inv_blocked(K)
            for name in order[1:]:
                L, Linv = calls[name]()
                if not (torch.equal(L, ref[0]) and torch.equal(Linv, ref[1])):
                    raise AssertionError(f"chol_inv_blocked n={n}: {name} differs from the package's instance")
        row = {name: [round(min(m for m, _ in t), 5), round(min(d for _, d in t), 5)] for name, t in times.items()}
        row["torch.linalg"] = [round(lib_ms, 5), None]
        row["package"] = route_name(ci, n)
        out[f"(2,{n},{n})"] = row
    log(f"time chol_inv_blocked instances, (ms, device ms), best of 2 in turns, every instance the same bits: "
        f"{json.dumps(out)}; {card}")
    return out


def eager_blocks(model, split, batch, inner=50):
    """``run(first_block, blocks) -> steps/s`` of eager blocks of ``inner``
    device-sampled steps (``StagedBlocks`` + ``make_scan_train_step``; the
    A/B routes stay eager), host clock around work that ends in a
    synchronise."""
    from zigp_tpu_torch.training import DataSet, StagedBlocks, make_optimizer, make_scan_train_step

    st = StagedBlocks(DataSet(split.Xtrain, split.Ytrain), "device", batch, inner, device=DEVICE,
                      dtype=torch.float32)
    step = make_scan_train_step(make_optimizer(model))

    def run(first_block, blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in range(blocks):
            st.fill(first_block + b)
            step(model, st.Xs, st.Ys)
        torch.cuda.synchronize()
        return blocks * inner / (time.perf_counter() - t0)

    return run


def time_train_routes(split, card) -> dict:
    """Flagship steps/s of eager blocks with each route of chol_inv's
    forward against production's eager block: median of 3 passes of 2
    blocks of 50, in turns."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.experiments.configs import OnOffPptrConfig
    from zigp_tpu_torch.ops import linalg

    cfg = OnOffPptrConfig()
    base = build_onoff_pptr(cfg, split, device=DEVICE, use_kernel=True)
    forward = linalg._chol_inv_forward
    runs = {}
    for name, route in {"production": None, **TRAIN_ROUTES}.items():
        runs[name] = (eager_blocks(copy.deepcopy(base), split, cfg.batch_size), route, [])

    def run(name, first_block, blocks):
        blocks_of, route, _ = runs[name]
        if route is not None:
            linalg._chol_inv_forward = route
        try:
            return blocks_of(first_block, blocks)
        finally:
            linalg._chol_inv_forward = forward

    for name in runs:
        run(name, 0, 1)  # warm-up
    order = list(runs)
    for rep in range(3):
        for name in order if rep % 2 == 0 else order[::-1]:
            runs[name][2].append(run(name, 1 + 2 * rep, 2))
    rate = {name: float(np.median(r[2])) for name, r in runs.items()}
    log("time flagship training by chol_inv forward route, eager blocks (device sampler, B=1000, median of 3 "
        "passes of 100 steps, in turns): "
        + ", ".join(f"{n} {rate[n]:.1f} steps/s {[round(v, 1) for v in runs[n][2]]}" for n in runs) + f"; {card}")
    return rate


# --- the block and the chunk as CUDA graphs, and the production loop ---------

GRAPH_TOL = 1e-4  # graphed vs eager training losses, relative; equal bits are expected


def train_cfgs() -> dict:
    """The three training configurations at full width: flagship, champion,
    and the 105 × 250 scale grid at B = 8192."""
    from zigp_tpu_torch.experiments.configs import OnOffPptrConfig, best_onoff_config

    return {"flagship": OnOffPptrConfig(), "champion": best_onoff_config(), "scale 105x250 B=8192": scale_train_cfg()}


def optimizer_for(model, cfg):
    from zigp_tpu_torch.training import cosine_adam, make_optimizer

    return make_optimizer(model, default_lr=cfg.indp_lr,
                          schedule=cosine_adam(cfg.num_iter) if cfg.lr_schedule == "cosine" else None)


def phase_graph_ab(name, cfg, split) -> float:
    """From one model, a warm-up block of 10 eager steps on a side stream on
    each of two copies, then 10 steps by one replay of the captured block
    against 10 eager steps on the same batches: the largest relative
    difference of the 10 losses within GRAPH_TOL, each run's launches
    exact (the replay's counted from its capture)."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import DataSet, make_graphed_scan_step, make_scan_train_step, stage_batches

    base = build_onoff_pptr(cfg, split, device=DEVICE, use_kernel=True)
    per_step = per_step_launches(base)
    ds = DataSet(split.Xtrain, split.Ytrain, seed=3)
    warm, timed = (stage_batches(ds, cfg.batch_size, AB_STEPS, device=DEVICE, dtype=torch.float32) for _ in range(2))
    out = {}
    for path in ("eager", "graphed"):
        m = copy.deepcopy(base)
        opt = optimizer_for(m, cfg)
        Xs, Ys = (t.clone() for t in warm)
        on_side_stream(lambda: make_scan_train_step(opt)(m, Xs, Ys))
        if path == "graphed":
            step = make_graphed_scan_step(opt, m, Xs, Ys)
            Xs.copy_(timed[0])
            Ys.copy_(timed[1])
            zero_counts()
            losses = step()
        else:
            zero_counts()
            losses = make_scan_train_step(opt)(m, *timed)
        torch.cuda.synchronize()
        check_launches(f"graph A/B {name} {path}", read_counts(), AB_STEPS, per_step)
        out[path] = losses.cpu().double().numpy()
        if not np.isfinite(out[path]).all():
            raise AssertionError(f"graph A/B {name} {path}: non-finite losses")
    err = float(np.max(np.abs(out["graphed"] - out["eager"]) / np.abs(out["eager"])))
    log(f"graph A/B {name}: {AB_STEPS} steps by one replay vs eager, losses {out['graphed'][0]:.6f} .. "
        f"{out['graphed'][-1]:.6f}; largest relative loss difference {err:.3e} (tol {GRAPH_TOL:.0e}), equal bits "
        f"{bool(np.array_equal(out['graphed'], out['eager']))}; launches exact")
    if not err <= GRAPH_TOL:
        raise AssertionError(f"graph A/B {name}: graphed and eager losses differ by {err:.3e}")
    return err


def phase_resume(split) -> None:
    """train_onoff_pptr on the flagship (4 blocks of 50, device sampler,
    checkpoints every 50) straight through, and with a workdir stopped by
    Ctrl-C from the monitor callback after block 2, then resumed: the
    resumed run's losses and raws equal to the uninterrupted run's within
    GRAPH_TOL (the resumed run warms up eagerly where the straight one
    replays; equal bits are expected)."""
    import tempfile

    from zigp_tpu_torch.experiments.configs import OnOffPptrConfig
    from zigp_tpu_torch.experiments.runners import train_onoff_pptr

    cfg = dataclasses.replace(OnOffPptrConfig(), num_iter=200, scan_inner=50, sampler="device", log_every=50,
                              ckpt_every=50, monitor_every=50)
    quiet = lambda s: None
    full = train_onoff_pptr(cfg, split, use_kernel=True, log_fn=quiet)

    def stop(step, model):
        if step == 100:
            raise KeyboardInterrupt

    with tempfile.TemporaryDirectory() as wd:
        first = train_onoff_pptr(cfg, split, use_kernel=True, log_fn=quiet, workdir=wd, monitor_cb=stop)
        ckpts = sorted(os.listdir(os.path.join(wd, "ckpt_onoff")))
        logs = []
        resumed = train_onoff_pptr(cfg, split, use_kernel=True, log_fn=logs.append, workdir=wd, resume=True)
        records = sum(1 for _ in open(os.path.join(wd, "metrics_onoff.jsonl")))
    if not (first.interrupted and ckpts == ["step_0000000000", "step_0000000050", "step_0000000100"]):
        raise AssertionError(f"resume: the first run was not interrupted at step 100 ({first.interrupted}, {ckpts})")
    if "resumed from checkpoint at step 100" not in logs:
        raise AssertionError(f"resume: {logs}")
    a, b = resumed.step_losses.double().numpy(), full.step_losses[100:].double().numpy()
    loss_err = float(np.max(np.abs(a - b) / np.abs(b)))
    raw_err = max(rel(p.detach().cpu(), q.detach().cpu()) for p, q in zip(resumed.model.parameters(),
                                                                           full.model.parameters()))
    log(f"resume flagship: interrupted at step 100 (checkpoints {ckpts}, {records} metric records), resumed to 200: "
        f"largest relative loss difference from the uninterrupted run {loss_err:.3e}, raws {raw_err:.3e} (tol "
        f"{GRAPH_TOL:.0e}), equal bits {bool(np.array_equal(a, b))}")
    if not (np.isfinite(a).all() and loss_err <= GRAPH_TOL and raw_err <= GRAPH_TOL):
        raise AssertionError(f"resume: the resumed run left the uninterrupted one ({loss_err:.3e}, {raw_err:.3e})")


def time_graphed_training(split, card) -> dict:
    """Steps/s of blocks of 50 device-sampled steps, eager against one
    replay of the captured block, from one warm-up block each (on a side
    stream): median of 3 passes each, in turns (flagship 4 blocks a pass,
    with the gram kernel on and off; champion and scale 2, kernel on), host
    clock around work that ends in a synchronise; with each graph's capture
    and instantiate times and pool."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import DataSet, make_graphed_scan_step, make_scan_train_step
    from zigp_tpu_torch.training.scan import StagedBlocks

    inner = 50
    out = {}
    cases = [(name, cfg, True) for name, cfg in train_cfgs().items()]
    cases.insert(1, ("flagship, gram kernel off", train_cfgs()["flagship"], False))
    for name, cfg, use_kernel in cases:
        blocks = 4 if name.startswith("flagship") else 2
        runs = {}
        for path in ("eager", "graphed"):
            m = build_onoff_pptr(cfg, split, device=DEVICE, use_kernel=use_kernel)
            opt = optimizer_for(m, cfg)
            st = StagedBlocks(DataSet(split.Xtrain, split.Ytrain), "device", cfg.batch_size, inner, device=DEVICE,
                              dtype=torch.float32)
            eager = make_scan_train_step(opt)
            st.fill(0)
            on_side_stream(lambda: eager(m, st.Xs, st.Ys))
            run = make_graphed_scan_step(opt, m, st.Xs, st.Ys) if path == "graphed" else (
                lambda eager=eager, m=m, st=st: eager(m, st.Xs, st.Ys))
            runs[path] = (st, run, [])

        def timed(path, first):
            st, run, _ = runs[path]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in range(blocks):
                st.fill(first + b)
                losses = run()
            torch.cuda.synchronize()
            if not torch.isfinite(losses).all():
                raise AssertionError(f"time {name} {path}: non-finite losses")
            return blocks * inner / (time.perf_counter() - t0)

        for rep in range(3):
            for path in (("eager", "graphed") if rep % 2 == 0 else ("graphed", "eager")):
                runs[path][2].append(timed(path, 1 + blocks * rep))
        rate = {path: float(np.median(r[2])) for path, r in runs.items()}
        g = runs["graphed"][1].graph
        log(f"time training {name}, B={cfg.batch_size}, blocks of {inner} (device sampler, gram kernel "
            f"{'on' if use_kernel else 'off'}): eager "
            f"{rate['eager']:.1f} steps/s {[round(v, 1) for v in runs['eager'][2]]}, graphed {rate['graphed']:.1f} "
            f"steps/s {[round(v, 1) for v in runs['graphed'][2]]} (median of 3 passes of {blocks * inner} steps, in "
            f"turns); block graph: {g.describe()}; {card}")
        out[name] = {**rate, "capture_ms": g.capture_ms, "instantiate_ms": g.instantiate_ms,
                     "pool_mib": g.pool_bytes / 2**20}
        del runs
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from zigp_tpu_torch.experiments.configs import KronGridConfig, OnOffPptrConfig, best_onoff_config
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
    phase_chol_gate()
    phase_kron_gate()
    phase_tri_inv_gate()

    t0 = time.perf_counter()
    split = synthetic_pptr(105, 1080, seed=0)
    log(f"data: synthetic pptr-shaped split, train {split.Xtrain.shape}, test {split.Xtest.shape}, "
        f"zeros {np.mean(split.Ytrain == 0):.3f} ({time.perf_counter() - t0:.1f} s)")

    runs = {}
    for name, cfg, batch in (("flagship", OnOffPptrConfig(), 4096), ("champion", best_onoff_config(), 16384)):
        runs[name] = (*phase_serving(ci, name, cfg, split, batch), batch)
    # the unwhitened mean's Kronecker solve through kron_mv_2, on the flagship
    # and on the 105 x 250 grid
    model, X, _, ref, _ = runs["flagship"]
    serve_counts = {"flagship": phase_serving_kron_mv("flagship", model, X, 4096, ref)}
    scale_cfg = OnOffPptrConfig(grid=KronGridConfig(num_spatial=105, num_temporal=250))
    scale_model, scale_X, scale_by_n, ref = phase_serving(ci, "scale 105x250", scale_cfg, split, 4096)
    serve_counts["scale 105x250"] = phase_serving_kron_mv("scale 105x250", scale_model, scale_X, 4096, ref)
    scale_sizes = [Z.shape[0] for Z in scale_model.f.Zs]
    del ref

    train_cfg = dataclasses.replace(OnOffPptrConfig(), num_iter=200, scan_inner=50, sampler="device", log_every=50)
    train_counts = {"flagship train": phase_train("flagship", train_cfg, split, check=True)[1]}
    phase_ab(train_cfg, split)
    phase_ab(scale_train_cfg(), split, "scale 105x250 B=8192")
    cluster_ab_counts = phase_ab_cluster(split)
    route_counts = phase_train_routes(train_cfg, split)
    champ_cfg = dataclasses.replace(best_onoff_config(), num_iter=100, scan_inner=50, log_every=50)
    train_counts["champion train"] = phase_train("champion", champ_cfg, split)[1]
    scale_train = dataclasses.replace(scale_train_cfg(), num_iter=100, scan_inner=50, sampler="device", log_every=50)
    train_counts["scale train"] = phase_train("scale 105x250 B=8192", scale_train, split)[1]
    graph_ab = {name: phase_graph_ab(name, cfg, split) for name, cfg in train_cfgs().items()}
    phase_resume(split)

    pts = {name: time_predict(name, m, X, batch, card, ref) for name, (m, X, _, ref, batch) in runs.items()}
    pts["scale 105x250 by solve route"] = time_serving_kron_mv(scale_model, scale_X, 4096, card)
    del scale_model, scale_X
    graphed_rates = time_graphed_training(split, card)
    route_rates = time_train_routes(split, card)
    time_panel_widths(card)
    time_blocked_routes(card)
    time_kron_instances(card)

    kernels = []
    serving = {name: ([Z.shape[0] for Z in model.f.Zs], by_n) for name, (model, _, by_n, _, _) in runs.items()}
    serving["scale 105x250"] = (scale_sizes, scale_by_n)
    scale_train = train_counts["scale train"]["chol_inv_blocked_by_n"]
    for name, (sizes, by_n) in serving.items():
        for n in sizes:
            if n > ci.MAX_N:  # chol_inv_blocked's route: its rows below
                continue
            launches = by_n.get(n, 0)
            kname = f"chol_inv n={n} G=2 ({name})"
            if launches == 0:
                raise AssertionError(f"{kname}: not launched on the main path")
            ms, device_ms, plain_ms, lib_ms, err = time_chol_inv(ci, n)
            b_ms, b_by = bound_ms(n, 2)
            log(f"time {kname}: kernel {ms:.4f} ms, device {device_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"torch.linalg {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), launches {launches}, "
                f"max |kernel - plain| {err:.3e}; {card}")
            kernels.append({
                "name": kname, "route": "cuda", "source": "zigp_tpu_torch/ops/cuda/csrc/chol_inv.cu",
                "replaces": "zigp_tpu/ops/pallas/chol_inv.py:339", "launches": launches, "max_abs_err": err, "ms": ms,
                "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            })
    blocked = {n: by_n.get(n, 0) + scale_train.get(n, 0) for sizes, by_n in serving.values() for n in sizes
               if n > ci.MAX_N}
    kernels += blocked_rows(ci, blocked, cluster_ab_counts, card)

    kernels += gram_rows(rg, train_counts, card)
    kernels += ab_rows(route_counts, serve_counts, card)

    log(f"serving points/s: {json.dumps(pts)}; training steps/s, eager vs graphed: {json.dumps(graphed_rates)}; "
        f"graph A/B largest relative loss differences {json.dumps(graph_ab)}; "
        f"by chol_inv forward route: {json.dumps(route_rates)}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
