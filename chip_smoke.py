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
10. The other model families at full width on the same split, the JAX
   package's ``preset_configs("best")``: ``tuned_svgp_config()`` (32 × 200,
   whitened, Gaussian, B = 500), ``tuned_classifier_config()`` (32 × 200,
   whitened, plug-in Bernoulli, B = 1000, the gram kernel on) and
   ``HurdleJointConfig()`` (10 × 100, f and g stacked, LogNormal head,
   B = 1000). Each built on the card in float32 with its raws moved off the
   init; its loss and gradients on one batch against CPU float64 (the gate
   of phase 7); two blocks of 50 steps through ``runners._fit_auto`` with
   the configuration's sampler (one eager, one replay), finite losses and
   exact launches (``chol_inv.cu`` 2 a step: G = 1 for the single GP, the
   stacked pair for the hurdle; the classifier's ``rbf_gram`` 4 a step);
   10 graphed steps against 10 eager (1e-4); 65,536 rows served through
   ``predict_batched`` by the family's method (``predict_latent``,
   ``predict_class``, ``predict``), one launch per factor and chunk, the
   first 4096 rows within the serving gate of CPU float64, and a second call
   that captures no new graph.
11. The other trainers at full width, through ``train_onoff_pptr``
   with the gram kernel off: README's block-coordinate recipe on the
   flagship (device sampler, ``hyper_every`` 50, ``kern_lr`` 2e-2, 2 blocks
   of 200), the 105 × 250 grid at B = 8192 with ``hyper_every`` 50 (2 blocks
   of 50), natural gradients after 50 Adam warm-up steps: ``kron_joint``
   (q_cov kron, whitened, device sampler, 4 blocks of 50), the diagonal
   family (2 blocks) and ``kron_joint`` with ``hyper_every`` 50 (2 blocks).
   Each: finite losses, the steps the budget gives, and every
   ``chol_inv.cu`` and cluster-kernel launch by n exact (in each group's
   hyper step and its factor state, four a joint natural step, none in a
   q-only step's loss). Then for each, 10 graphed steps (``hyper_every``
   cut to 5: two groups) against 10 eager (1e-4, launches exact), the
   eager run's q-only steps watched: every hyper raw the same bits, no
   ``chol_inv`` launch in their loss. Then the joint natural step on the
   trained ``kron_joint`` model (f and g stacked, ``chol_inv.cu``) against
   CPU float64 for each p within max(3 × CPU float32's error, 1e-5), and a
   step forced out of the positive-definite cone kept to the bit on the
   card and on the CPU.
12. One fold of the protocol end to end in one workdir: ``run_classifier``
   (at its own 5000 steps), ``run_svgp``, ``run_hurdle`` (LogNormal head),
   ``run_zero_inflated``, ``run_hurdle_joint`` and ``run_onoff`` at 100
   steps, on the split's rows with targets from a seeded rain field
   (``rain_split``: the split's own wet hours are random, so a classifier
   calls no row "on" and the two-stage hurdle has nothing to train on).
   Every metric, prediction and loss finite, every result pickle written.
13. Times, beside the card's name and power limit: points/s of
   predict_batched (every chunk one replay of the model's chunk graph,
   captured by its first call) against the same chunks launched eagerly,
   median of 5 passes each, in turns, the graphed predictions within the
   serving gate's tolerance of the eager ones; steps/s of blocks of 50
   eager against one replay each (flagship with the gram kernel on and
   off, champion, scale; median of 3 passes of one block, in turns) with
   each graph's capture and instantiate times and pool size; steps/s of
   eager blocks of 20 steps with each A/B route against production's
   (median of 3 passes, in turns); the other trainers' steps/s, graphed
   blocks of 50 in turns (median of 3 passes of one block): on the
   flagship joint Adam, ``hyper_every`` 50 and natgrad diagonal, joint Adam
   and natgrad ``kron_joint`` on the whitened Kronecker-q twin, and on the
   105 × 250 grid joint Adam against ``hyper_every`` 50, each graph's
   capture and instantiate times; the 105 × 250 serving pass with the production
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
   plain version's; each family's steps/s eager against graphed (median of
   3 passes of 50 steps, in turns) and its serving points/s (graphed,
   median of 5), and the fold protocol's wall time.
14. The batched member stack (``training.batched``, ``experiments.
   cv_batched``, ``experiments.ensemble``) on the synthetic set's five CV
   folds (``make_cv_splits``: five equal train sizes). After phase 11: the
   vmap rule's one ``chol_inv`` launch against per-member launches, bit for
   bit (``chol_inv.cu`` at n = 100, batches 10 and 80, and 200; the cluster
   kernel at n = 250, batches 10 and 50); the flagship F = 5 stack's losses
   and stacked gradients at perturbed raws within max(3 × CPU f32's error,
   1e-5) of the stack on the CPU in float64; each member of a 50-step
   flagship F = 5 stack against its own graphed sequential
   ``fit_scanned(sampler="device", sampler_seed=f)``, losses and raws within
   max(3 × the gap between that sequential run and the same run on the CPU
   in float32, 1e-4); each stack path (flagship F = 5, champion F = 5, the
   flagship ensemble 5 × 4, ``hyper_every`` 50 F = 5, natgrad ``kron_joint``
   F = 5, the 105 × 250 grid at B = 8192 F = 5) through
   ``fit_batched_scanned`` or ``fit_natgrad_batched``, two blocks of 50:
   every ``chol_inv.cu`` and cluster-kernel launch by n exactly a single
   member's run's, at batch 2 × the members. In phase 13's times: each path's
   steps/s against the single model, graphed blocks of 50 in turns (median
   of 3), as stack steps/s and fold-steps/s; ``predict_batched_stacked``
   over 5 × 65,536 rows (one launch per factor and chunk for the five
   members, each member within the serving gate of CPU float64; points/s,
   median of 5). After phase 12: the batched studies on the five folds of the
   rain field, each test set cut to 500 rows (``study_folds``: the host's
   scoring of an on/off mixture grows with the square of its components):
   ``run_cv_batched`` of all six variants (the fold
   protocol's configurations and steps, the gram kernel on),
   ``run_cv_batched(["onoff"], ensemble=2)`` and ``run_ensemble("onoff",
   size=4)`` on fold 1: every aggregate finite, training and scoring walls
   apart.
15. The command line (``zigp_tpu_torch.experiments.cli.main``, in process)
   on ``rain_split``'s rows written as a pptr pickle (``save_pptr``), fold
   1, each configuration in its own workdir, the gram kernel on (the CLI's
   rule on the card): ``onoff`` with the reference preset (the flagship),
   the best preset (the champion) and ``--grid 105x250 --batch 8192``, and
   ``classifier --preset best``, 100 steps each (two blocks of 50);
   ``predict --samples 256`` on the flagship: y_samples (256, N, 1) finite,
   its sample mean summed over the rows within 5 standard errors of the
   sampler's mean Φ(z)·fmean and of gfmean (whose gate is clipped); ``export`` of each, loaded by ``load_predictor``
   and served on 65,536 rows in one call: one ``chol_inv.cu`` launch per
   factor (the cluster kernel for n = 250) and K_mm and K_mn of each factor
   by ``rbf_gram.cu``, counted by shape for the call, every field within
   the phase-5 serving gate of the restored model on the CPU in float64 and
   within 1e-5 of each field's largest value of its ``predict_batched``, a
   second call on 10,000 rows with the same launches and rows (a symbolic
   batch), and points/s against ``predict_batched``'s graphed path (median
   of 5, in turns); ``cv --split forecast --covariates --origins 2`` of
   the classifier and the joint hurdle at 200 steps: every aggregate finite,
   ``rbf_gram.cu`` launched at D = 5 (the exogenous factor), the wall
   time.
16. The kernel zoo on the Kronecker path and the toy (``phase_zoo``,
   ``phase_toy``), the gram kernel on: the flagship with a ``periodic*rbf``
   temporal factor on both GPs (period 0.001, the zoo setting of
   RESULTS.md) through ``train_onoff_pptr``, two blocks of 50 with exact
   launches (``rbf_gram.cu`` for K_mm and K_mn of each RBF leaf), the
   trained model's f32 loss and gradients against CPU float64 (phase 7's
   gate), 10 graphed steps against 10 eager, 65,536 rows served through
   ``predict_batched`` under phase 5's gate, then exported and served once
   (every field within 1e-5 of ``predict_batched``); the 105 × 250 grid at
   B = 8192 with a ``matern32`` temporal factor (the cluster kernel factors
   its n = 250 gram), two blocks of 50 with exact launches; each path's
   graphed steps/s against its RBF twin's (median of 3, in turns) and the
   flagship's serving points/s against its twin's (median of 5). The toy on
   a seeded synthetic ``toydata.mat``: the CPU float64 run of the command
   line (``toy --cpu-x64``) started in its own process before the zoo; on
   the card in float64 the initial ELBO and every gradient within 1e-10 of
   CPU float64 and the ELBO at the first 50 L-BFGS iterates within 1e-6 of
   the |ELBO| where they end; ``toy --dtype float64`` through
   ``ZIGP_DATA_DIR`` and the float32 run, TOY_MAXITER iterations each, with
   the CPU's: final ELBO, iterations, evaluations, wall time.
17. The parallel layer (``zigp_tpu_torch.parallel``; ``phase_parallel``).
   The flagship through ``train_onoff_pptr`` with ``mesh_data=1`` on a
   one-rank NCCL process group in process (a FileStore in a temporary
   directory), 150 steps: the warm-up block, then two replays with the
   gradient's and the losses' all-reduces inside the graph; losses and raws
   bit-identical to the no-mesh graphed run, ``chol_inv.cu`` and
   ``rbf_gram.cu`` launches per step equal to its; steps/s against no mesh
   (median of 3, in turns). Two gloo ranks on ``cuda:0``, spawned (NCCL
   refuses two ranks on one GPU, and gloo's collectives cannot be
   captured, so these blocks run eagerly): the flagship data parallel 2
   (the first step's loss and gradient within 1e-5 relative of the
   one-rank card run; the gap after 100 steps and the steps/s reported),
   tensor parallel 1 × 2 (each rank's bytes of the row-sharded raws' owned
   copies and of their two moments half of one rank's; the first step
   within 1e-5), and the member mesh over the flagship F = 5 stack, padded
   to 6, graphed on each rank (each member's raws after two blocks within
   max(3 × the one-rank stack's distance from the members' sequential
   runs, 1e-4) of the one-rank stack, phase 14's stack gate; each rank's
   launches one member's steps':
   one folded launch a factor; fold-steps/s against the one-rank stack),
   every rank's launches counted exactly. Beside them (started first: its
   host scoring overlaps them) ``python -m torch.distributed.run
   --standalone --nproc-per-node 1 -m zigp_tpu_torch.experiments onoff
   --mesh-data 1 --iters 100`` with a workdir on the rain field's pickle:
   exit 0, rank 0's results written and finite. Every process started is
   stopped and every process group made is destroyed.
18. A ``kernels`` JSON line (with the families' ``chol_inv.cu`` rows at G = 1
   and the hurdle's pair, the classifier's ``rbf_gram`` rows at G = 1, and
   the other trainers' ``chol_inv.cu`` and cluster-kernel rows with their
   launches) (the kron_mv_2 rows with the serving path's
   launches by the instance the library ran; the stack's ``chol_inv.cu`` and
   cluster-kernel rows at each batch (G, n) its paths launched, and its
   ``rbf_gram`` rows; the command line's ``chol_inv.cu`` and cluster-kernel
   rows at each (G, n) of the exported programs' served calls and of its
   training, export and forecast runs, and its ``rbf_gram`` rows of the
   served calls and at D = 5; the zoo paths' ``chol_inv.cu``, cluster-kernel
   and ``rbf_gram`` rows; the parallel layer's ``chol_inv.cu`` and
   ``rbf_gram.cu`` rows at each rank's shapes with rank 0's launches), then
   the card's name and power limit,
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
import shutil
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


def phase_serving(ci, name, cfg, split, batch, use_kernel=False):
    """Build on the card (the gram kernel on with ``use_kernel``), drive
    predict_batched once with the launch counts zeroed just before, check
    outputs, counts and the f32 gap to CPU f64."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.experiments.runners import predict_batched

    t0 = time.perf_counter()
    model = perturbed(build_onoff_pptr(cfg, split, device=DEVICE, dtype=torch.float32, use_kernel=use_kernel), seed=1)
    log(f"{name}: grid {cfg.grid.num_spatial}x{cfg.grid.num_temporal}, built in {time.perf_counter() - t0:.1f} s")
    X = np.asarray(split.Xtrain[:ROWS])
    chunks = math.ceil(X.shape[0] / batch)
    sizes = [Z.shape[0] for Z in model.f.Zs]
    per_chunk = {"chol_inv": sum(n <= ci.MAX_N for n in sizes),
                 "chol_inv_blocked": sum(n > ci.MAX_N for n in sizes), "rbf_gram": per_step_launches(model)[0]}

    zero_counts()
    out = predict_batched(model.predict, X, batch=batch, device=DEVICE)
    counts = read_counts()
    by_n = {**counts["chol_inv_by_n"], **counts["chol_inv_blocked_by_n"]}
    log(f"{name}: {X.shape[0]} rows in {chunks} chunks of {batch}: chol_inv.cu launches {counts['chol_inv']}, "
        f"chol_inv_cluster.cu launches {counts['chol_inv_blocked']}, rbf_gram launches {counts['rbf_gram']} (expected "
        f"{chunks} x {per_chunk}), by n {by_n}")
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
        for attr in ("launches_by_instance", "launches_by_batch"):
            if hasattr(fn, attr):
                getattr(fn, attr).clear()


def read_counts() -> dict:
    """{name: launches, name_by_shape: {shape: launches}} for every wrapper;
    the chol_inv wrappers' by-shape keys are ``chol_inv_by_n`` and
    ``chol_inv_blocked_by_n`` (the cluster kernel), both also by batch
    (``chol_inv_by_batch``, ``chol_inv_blocked_by_batch``: {(G, n):
    launches}), and kron_mv_2 also has ``kron_mv_2_by_instance`` ({(G, Ma,
    Mb, transpose, instance): launches})."""
    from zigp_tpu_torch.ops.cuda.graphs import counted_wrappers

    out = {}
    for name, fn in counted_wrappers().items():
        out[name] = fn.launches
        by = getattr(fn, "launches_by_shape", None)
        out[f"{name}_by_n" if by is None else f"{name}_by_shape"] = dict(by if by is not None else fn.launches_by_n)
        for attr in ("instance", "batch"):
            if hasattr(fn, f"launches_by_{attr}"):
                out[f"{name}_by_{attr}"] = dict(getattr(fn, f"launches_by_{attr}"))
    return out


def first_gp(model):
    """The GP whose grams a step factors: a KronSVGP's one GP, or f of a
    stacked pair (g's grams share its launches)."""
    return model.gp if hasattr(model, "gp") else model.f


def per_step_launches(model) -> tuple[int, int, int]:
    """(rbf_gram, chol_inv.cu, chol_inv_cluster.cu) launches of one training
    step or serving chunk, a stacked f/g pair or a single GP alike: K_mm and
    K_mn per RBF leaf whose gram kernel is on (a factor's kernel alone, or
    inside a composite of the zoo); one chol_inv launch per factor,
    chol_inv.cu to MAX_N and the cluster kernel above."""
    from zigp_tpu_torch.ops.cuda import chol_inv as ci
    from zigp_tpu_torch.ops.kernels import flag_leaves

    gp = first_gp(model)
    sizes = [Z.shape[0] for Z in gp.Zs]
    return (2 * sum(flag_leaves(gp.kernel_flags())), sum(n <= ci.MAX_N for n in sizes),
            sum(n > ci.MAX_N for n in sizes))


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
    rows = [("loss", abs(card[0] - cpu64[0]) / abs(cpu64[0]), abs(cpu32[0] - cpu64[0]) / abs(cpu64[0]),
             abs(card[0] - cpu32[0]) / abs(cpu32[0]))]
    rows += [(f"d {n}", rel(card[1][n], cpu64[1][n]), rel(cpu32[1][n], cpu64[1][n]), rel(card[1][n], cpu32[1][n]))
             for n in cpu64[1]]
    worst = 0.0
    for what, e_card, e_cpu, e_32 in rows:
        tol = max(3.0 * e_cpu, 1e-5)
        worst = max(worst, e_card / tol)
        log(f"{name}: {what:32s} card f32 vs cpu f64 {e_card:.3e}, cpu f32 vs cpu f64 {e_cpu:.3e} (tol {tol:.3e}); "
            f"card f32 vs cpu f32 {e_32:.3e}")
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
    """The gram-kernel flag of every RBF leaf of the model's kernels."""
    from zigp_tpu_torch.ops.kernels import SquaredExponential

    for k in model.modules():
        if isinstance(k, SquaredExponential):
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


def blocked_rows(ci, blocked: dict, rows_ab: dict, card, path: str = "scale 105x250 serving and training") -> list:
    """The kernels-line rows of the cluster kernel at each n > MAX_N: by the
    package's instance on the main path (``blocked``: its launches in scale
    serving and training), and by the row instance from the scale A/B
    (``rows_ab``) where the package runs the pair instance. Each: ms per
    call with the host, device ms (CUDA graph), the plain version's ms
    (chol_inv_plain at the kernel's width), torch.linalg's, the bound and the
    largest difference from the plain version."""
    entries = [(n, ci.blocked_route(n), k, path) for n, k in blocked.items()]
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


def gram_bound_ms(G, N, M, D, shared: bool, per_kernel: bool = False) -> tuple[float, str]:
    """Least time of a (G, N, M) gram: X, Z, ell and var read once, K written
    once; 3D + 3 f32 operations per entry (D differences, squares and
    scaled sums, the scale by −½, the exponential and σ²). Z is one (M, D)
    block shared by the G kernels, or with ``per_kernel`` one a kernel."""
    z_elems = M * D if shared else G * M * D if per_kernel else 0  # K(X, X) reads X only
    t_bytes = 4 * (G * N * D + z_elems + G * D + G + G * N * M) / PEAK_BYTES_PER_S
    t_ops = G * N * M * (3 * D + 3) / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


GRAM_VS_PLAIN_TOL = 1e-5  # relative Frobenius distance, as tests/test_torch_cuda.py


def gram_rows(rg, path_counts: dict, card, stacked: bool = False) -> list:
    """One kernels-line row per rbf_gram shape launched on each training
    path: the kernel's ms per call (CUDA events, host included), its device
    ms (CUDA graph), the plain version's ms, the bound, and the kernel's
    largest difference from the plain version. The
    kernel's output must be within GRAM_VS_PLAIN_TOL relative of the plain
    version's at every shape. On a member stack's paths (``stacked``) each
    member's minibatch is expanded to its kernels, so K_mn's Z is one block
    a kernel there."""
    rows = []
    for path, counts in path_counts.items():
        for (G, N, M, D), launches in sorted(counts["rbf_gram_by_shape"].items()):
            shared = N != M  # K_mn shares the minibatch; K_mm is K(Z, Z)
            rng = np.random.RandomState(N * M)
            X = torch.as_tensor(T_SPAN[0] + rng.rand(G, N, D), dtype=torch.float32, device=DEVICE)
            Z = torch.as_tensor(T_SPAN[0] + rng.rand(*((G,) if stacked else ()), M, D), dtype=torch.float32,
                                device=DEVICE) if shared else X
            ell = torch.full((G, D), 0.05, device=DEVICE)
            var = torch.tensor(np.resize([20.0, 10.0], G), dtype=torch.float32, device=DEVICE)
            with torch.inference_mode():
                ms = cuda_ms(lambda: rg.rbf_gram_cuda(X, Z, ell, var), reps=200)
                device_ms = graph_ms(lambda: rg.rbf_gram_cuda(X, Z, ell, var))
                plain_ms = cuda_ms(lambda: rg.rbf_gram_plain(X, Z, ell, var), reps=50)
                K, Kp = rg.rbf_gram_cuda(X, Z, ell, var), rg.rbf_gram_plain(X, Z, ell, var)
                err = float((K - Kp).abs().max())
                dist = rel(K.cpu().numpy(), Kp.cpu().numpy())
            b_ms, b_by = gram_bound_ms(G, N, M, D, shared and not stacked, per_kernel=shared and stacked)
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
    forward = linalg.chol_inv_forward
    runs = [("production", None, True), *((n, r, True) for n, r in TRAIN_ROUTES.items()),
            ("small_cholesky+solve unpaired", route_small_cholesky_solve, False)]
    out, all_counts = {}, {}
    for name, route, paired in runs:
        m = copy.deepcopy(base)
        m.pair_gps = paired
        if route is not None:
            linalg.chol_inv_forward = route
        try:
            zero_counts()
            losses = make_scan_train_step(make_optimizer(m, default_lr=cfg.indp_lr))(m, Xs, Ys).cpu().numpy()
            counts = read_counts()
        finally:
            linalg.chol_inv_forward = forward
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


ROUTE_STEPS = 20  # steps of each eager route-timing block: short, for the script's time limit


def time_train_routes(split, card) -> dict:
    """Flagship steps/s of eager blocks with each route of chol_inv's
    forward against production's eager block: median of 3 passes of one
    block of ROUTE_STEPS, in turns."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.experiments.configs import OnOffPptrConfig
    from zigp_tpu_torch.ops import linalg

    cfg = OnOffPptrConfig()
    base = build_onoff_pptr(cfg, split, device=DEVICE, use_kernel=True)
    forward = linalg.chol_inv_forward
    runs = {}
    for name, route in {"production": None, **TRAIN_ROUTES}.items():
        runs[name] = (eager_blocks(copy.deepcopy(base), split, cfg.batch_size, ROUTE_STEPS), route, [])

    def run(name, first_block, blocks):
        blocks_of, route, _ = runs[name]
        if route is not None:
            linalg.chol_inv_forward = route
        try:
            return blocks_of(first_block, blocks)
        finally:
            linalg.chol_inv_forward = forward

    for name in runs:
        run(name, 0, 1)  # warm-up
    order = list(runs)
    for rep in range(3):
        for name in order if rep % 2 == 0 else order[::-1]:
            runs[name][2].append(run(name, 1 + rep, 1))
    rate = {name: float(np.median(r[2])) for name, r in runs.items()}
    log(f"time flagship training by chol_inv forward route, eager blocks (device sampler, B=1000, median of 3 "
        f"passes of {ROUTE_STEPS} steps, in turns): "
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
    """The runners' Adam for ``cfg``: the on/off config's ``indp_lr``, the
    families' ``lr``."""
    from zigp_tpu_torch.training import cosine_adam, make_optimizer

    lr = cfg.indp_lr if hasattr(cfg, "indp_lr") else cfg.lr
    return make_optimizer(model, default_lr=lr, schedule=cosine_adam(cfg.num_iter) if cfg.lr_schedule == "cosine"
                          else None)


def phase_graph_ab(name, cfg, split, base=None, Y=None) -> float:
    """From one model (``base``, by default the on/off model of ``cfg`` with
    the gram kernel on), a warm-up block of 10 eager steps on a side stream
    on each of two copies, then 10 steps by one replay of the captured block
    against 10 eager steps on the same batches (targets ``Y``, by default
    the split's): the largest relative difference of the 10 losses within
    GRAPH_TOL, each run's launches exact (the replay's counted from its
    capture)."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import DataSet, make_graphed_scan_step, make_scan_train_step, stage_batches

    if base is None:
        base = build_onoff_pptr(cfg, split, device=DEVICE, use_kernel=True)
    per_step = per_step_launches(base)
    ds = DataSet(split.Xtrain, split.Ytrain if Y is None else Y, seed=3)
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


def time_blocks(name, make_model, cfg, X, Y, blocks, card, note) -> dict:
    """Steps/s of blocks of 50 device-sampled steps of ``make_model()`` on
    (X, Y), eager against one replay of the captured block, from one warm-up
    block each (on a side stream): median of 3 passes of ``blocks`` blocks
    each, in turns, host clock around work that ends in a synchronise; with
    the graph's capture and instantiate times and pool."""
    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import DataSet, make_graphed_scan_step, make_scan_train_step
    from zigp_tpu_torch.training.scan import StagedBlocks

    inner = 50
    runs = {}
    for path in ("eager", "graphed"):
        m = make_model()
        opt = optimizer_for(m, cfg)
        st = StagedBlocks(DataSet(X, Y), "device", cfg.batch_size, inner, device=DEVICE, dtype=torch.float32)
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
    log(f"time training {name}, B={cfg.batch_size}, blocks of {inner} (device sampler, {note}): eager "
        f"{rate['eager']:.1f} steps/s {[round(v, 1) for v in runs['eager'][2]]}, graphed {rate['graphed']:.1f} "
        f"steps/s {[round(v, 1) for v in runs['graphed'][2]]} (median of 3 passes of {blocks * inner} steps, in "
        f"turns); block graph: {g.describe()}; {card}")
    return {**rate, "capture_ms": g.capture_ms, "instantiate_ms": g.instantiate_ms, "pool_mib": g.pool_bytes / 2**20}


def time_graphed_training(split, card) -> dict:
    """``time_blocks`` of the on/off configurations, 1 block a pass (for the
    script's time limit): the flagship with the gram kernel on and off,
    champion and scale with it on."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr

    cases = [(name, cfg, True) for name, cfg in train_cfgs().items()]
    cases.insert(1, ("flagship, gram kernel off", train_cfgs()["flagship"], False))
    return {
        name: time_blocks(name, lambda cfg=cfg, k=use_kernel: build_onoff_pptr(cfg, split, device=DEVICE, use_kernel=k),
                          cfg, split.Xtrain, split.Ytrain, 1, card,
                          f"gram kernel {'on' if use_kernel else 'off'}")
        for name, cfg, use_kernel in cases
    }


# --- the other model families: Kronecker SVGP, the classifier, the joint hurdle ---

# name: (its preset_configs("best") key, the gram kernel on, the serving method)
FAMILIES = {
    "svgp": ("svgp", False, "predict_latent"),
    "classifier": ("classifier", True, "predict_class"),
    "hurdlej": ("hurdlej", False, "predict"),
}
FAMILY_STEPS = 100  # two blocks of 50: one eager, one replay


def family_cfg(name):
    """The family's configuration of the JAX package's ``preset_configs("best")``
    (tuned_svgp_config, tuned_classifier_config, HurdleJointConfig), cut to
    two blocks of 50 steps."""
    from zigp_tpu_torch.experiments.configs import preset_configs

    return dataclasses.replace(preset_configs("best")[FAMILIES[name][0]], num_iter=FAMILY_STEPS, scan_inner=50,
                               log_every=50)


def build_family(name, cfg, split):
    from zigp_tpu_torch.experiments import builders

    build = {"svgp": builders.build_svgp_pptr, "classifier": builders.build_classifier_pptr,
             "hurdlej": builders.build_hurdle_joint_pptr}[name]
    return build(cfg, split, device=DEVICE, dtype=torch.float32, use_kernel=FAMILIES[name][1])


def family_targets(name, Y):
    """The targets the family trains on: the classifier's binarized."""
    from zigp_tpu_torch.experiments.builders import binarize_targets

    return binarize_targets(Y) if name == "classifier" else Y


def check_serving_against_cpu(name, model, method, out, X):
    """The first CHECK_ROWS rows of every field within max(3 × the CPU f32
    run's error, 1e-5) of the same model on the CPU in float64."""
    from zigp_tpu_torch.experiments.runners import predict_batched

    ref = {}
    for dt in (torch.float64, torch.float32):
        cpu = copy.deepcopy(model).to(device="cpu", dtype=dt)
        ref[dt] = predict_batched(getattr(cpu, method), X[:CHECK_ROWS], batch=CHECK_ROWS, device="cpu", dtype=dt)
    for k in ref[torch.float64]:
        e_card = rel(out[k][:CHECK_ROWS], ref[torch.float64][k])
        e_cpu = rel(ref[torch.float32][k], ref[torch.float64][k])
        tol = max(3.0 * e_cpu, 1e-5)
        log(f"{name}: {k:6s} card f32 vs cpu f64 {e_card:.3e}, cpu f32 vs cpu f64 {e_cpu:.3e} (tol {tol:.3e}); "
            f"card f32 vs cpu f32 {rel(out[k][:CHECK_ROWS], ref[torch.float32][k]):.3e}")
        if not e_card <= tol:
            raise AssertionError(f"{name}: {k} card error {e_card:.3e} > {tol:.3e}")


def phase_family(name, split) -> dict:
    """One family at full width on the card in float32: its model with the
    raws moved off the init; the loss and gradients on one batch against CPU
    float64; two blocks of 50 steps through ``_fit_auto`` with the
    configuration's sampler (one eager, one replay), finite losses and exact
    launches; 10 graphed steps against 10 eager (GRAPH_TOL); 65,536 rows
    served through ``predict_batched`` (one launch per factor and chunk, the
    first rows within the serving gate of CPU float64), and a second call
    that captures no new graph. Returns the model, its training launches,
    its serving launches and its serving rows."""
    from zigp_tpu_torch.experiments.runners import _CHUNK_GRAPHS, _fit_auto, predict_batched
    from zigp_tpu_torch.training import DataSet

    cfg = family_cfg(name)
    method = FAMILIES[name][2]
    Y = family_targets(name, split.Ytrain)
    t0 = time.perf_counter()
    model = perturbed(build_family(name, cfg, split), seed=2)
    sizes = [Z.shape[0] for Z in first_gp(model).Zs]
    per_step = per_step_launches(model)
    G = 2 if name == "hurdlej" else 1
    if name == "hurdlej" and not model._pairable():
        raise AssertionError("hurdlej: f and g do not run as one stacked pass")
    log(f"family {name}: {type(model).__name__}, factors {sizes}, G={G}, B={cfg.batch_size}, sampler {cfg.sampler}, "
        f"whiten {cfg.whiten}, likelihood {type(getattr(model, 'likelihood', getattr(model, 'amount_likelihood', None))).__name__}, "
        f"gram kernel {'on' if FAMILIES[name][1] else 'off'}; built in {time.perf_counter() - t0:.1f} s")
    check_f32_against_cpu_f64(f"family {name}", model, split.Xtrain[:cfg.batch_size], Y[:cfg.batch_size])

    zero_counts()
    res = _fit_auto(model, DataSet(split.Xtrain, Y), cfg, learning_rate=cfg.lr, kind=name,
                    log_fn=lambda s: log(f"family {name} train: {s}"))
    torch.cuda.synchronize()
    train_counts = read_counts()
    steps = res.step_losses.numel()
    log(f"family {name} train: {steps} steps through _fit_auto, block mean losses "
        f"{[f'{b:.6g}' for b in res.step_losses.double().reshape(-1, 50).mean(1).tolist()]}; launches rbf_gram "
        f"{train_counts['rbf_gram']} {train_counts['rbf_gram_by_shape']}, chol_inv.cu {train_counts['chol_inv']} "
        f"{train_counts['chol_inv_by_n']} (expected {steps} x {per_step})")
    if steps != FAMILY_STEPS or not torch.isfinite(res.step_losses).all():
        raise AssertionError(f"family {name}: {steps} steps, finite {bool(torch.isfinite(res.step_losses).all())}")
    check_launches(f"family {name} train", train_counts, steps, per_step)

    phase_graph_ab(f"family {name}", cfg, split, base=model, Y=Y)

    X = np.asarray(split.Xtrain[:ROWS])
    batch, chunks = 4096, math.ceil(ROWS / 4096)
    serve_counts = []
    for call in range(2):
        graphs_before = dict(_CHUNK_GRAPHS.get(model, {}))
        zero_counts()
        out = predict_batched(getattr(model, method), X, batch=batch, device=DEVICE)
        torch.cuda.synchronize()
        serve_counts.append(read_counts())
        check_launches(f"family {name} serving call {call + 1}", serve_counts[-1], chunks, per_step)
        graphs = _CHUNK_GRAPHS.get(model, {})
        new = [k for k in graphs if graphs_before.get(k) is not graphs[k]]
        log(f"family {name} serving call {call + 1}: {X.shape[0]} rows by {method} in {chunks} chunks of {batch}: "
            f"launches chol_inv.cu {serve_counts[-1]['chol_inv']}, rbf_gram {serve_counts[-1]['rbf_gram']} "
            f"(expected {chunks} x {per_step}); graphs captured {len(new)}")
        if len(new) != (1 if call == 0 else 0):
            raise AssertionError(f"family {name}: serving call {call + 1} captured {len(new)} graphs")
        for k, v in out.items():
            if v.shape[0] != X.shape[0] or not np.isfinite(v).all():
                raise AssertionError(f"family {name}: {k} has shape {v.shape} or non-finite values")
    check_serving_against_cpu(f"family {name}", model, method, out, X)
    return {"model": model, "train": train_counts, "serve": serve_counts[0], "X": X, "method": method}


def time_family_serving(name, model, method, X, card) -> float:
    """Points/s of predict_batched at batch 4096 (every chunk one replay of
    the model's chunk graph): median of 5 warm passes."""
    from zigp_tpu_torch.experiments.runners import predict_batched

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        predict_batched(getattr(model, method), X, batch=4096, device=DEVICE)
        times.append(time.perf_counter() - t0)
    pts = X.shape[0] / float(np.median(times))
    log(f"time family {name}: serve {X.shape[0]} rows by {method} at batch 4096, graphed {pts:.1f} points/s "
        f"{[round(X.shape[0] / t) for t in times]} (median of 5); {card}")
    return pts


def rain_split(split, seed: int = 1):
    """The split's rows with targets from a seeded rain field moving over
    the station box: z = sin 2π(lat/10 + h/72) + cos 2π(lon/11 − h/100) (h in
    hours), wet where z exceeds its 89.8 % quantile (the real set's dry
    share), amounts exponential(1). The split's own targets are wet at
    random, with nothing for a classifier to call "on"; the fold protocol's
    two-stage hurdle trains on what its classifier calls "on"."""
    from zigp_tpu_torch.io.datasets import PPTR_ZERO_FRAC, Split

    def field(X):
        lat, lon, hour = X[:, 0], X[:, 1], X[:, 2] * 1000.0
        return np.sin(2 * np.pi * (lat / 10.0 + hour / 72.0)) + np.cos(2 * np.pi * (lon / 11.0 - hour / 100.0))

    zt, ze = field(split.Xtrain), field(split.Xtest)
    q = np.quantile(np.concatenate([zt, ze]), PPTR_ZERO_FRAC)
    rng = np.random.RandomState(seed)
    wet = lambda z: np.where(z > q, rng.exponential(1.0, z.shape), 0.0)[:, None]
    return Split(split.Xtrain, wet(zt), split.Xtest, wet(ze))


def non_finite(results, path="") -> list:
    """The entries of a runner's results (metrics, predictions, indices,
    losses; not the model) that are not finite."""
    bad = []
    for k, v in results.items():
        if k == "model":
            continue
        if isinstance(v, dict):
            bad += non_finite(v, f"{path}{k}.")
        elif not np.isfinite(np.asarray(v, dtype=np.float64)).all():
            bad.append(f"{path}{k}")
    return bad


FOLD_CLASSIFIER_STEPS = 5000  # tuned_classifier_config's own num_iter


def phase_fold_protocol(split, card) -> float:
    """One fold of the experiment's protocol end to end on the card, every
    variant in one shared workdir: run_classifier, run_svgp, run_hurdle
    (LogNormal head), run_zero_inflated, run_hurdle_joint and run_onoff, the
    ``preset_configs("best")`` configurations at num_iter 100 (scan_inner 50),
    the classifier at its own FOLD_CLASSIFIER_STEPS, on ``rain_split(split)``.
    Every metric, prediction and loss finite, each variant's result pickle
    written. Returns the wall time in seconds."""
    import tempfile

    from zigp_tpu_torch.experiments import runners
    from zigp_tpu_torch.experiments.configs import preset_configs

    best = preset_configs("best")
    short = lambda cfg, **kw: dataclasses.replace(cfg, num_iter=100, scan_inner=50, log_every=50, **kw)
    data = rain_split(split)
    quiet = lambda s: None
    t0 = time.perf_counter()
    res, walls = {}, {}
    with tempfile.TemporaryDirectory() as wd:
        kw = dict(workdir=wd, log_fn=quiet)
        runs = {
            "classifier": lambda: runners.run_classifier(
                data, dataclasses.replace(best["classifier"], num_iter=FOLD_CLASSIFIER_STEPS, log_every=1000),
                use_kernel=True, **kw),
            "svgp": lambda: runners.run_svgp(data, short(best["svgp"]), **kw),
            "hurdle": lambda: runners.run_hurdle(data, res["classifier"], short(best["svgp"], likelihood="lognormal"),
                                                 **kw),
            "zi": lambda: runners.run_zero_inflated(data, res["classifier"], res["svgp"], **kw),
            "hurdlej": lambda: runners.run_hurdle_joint(data, short(best["hurdlej"]), **kw),
            "onoff": lambda: runners.run_onoff(data, short(best["onoff"]), **kw),
        }
        for variant, run in runs.items():
            t1 = time.perf_counter()
            res[variant] = run()
            torch.cuda.synchronize()
            walls[variant] = round(time.perf_counter() - t1, 1)
        wall = time.perf_counter() - t0
        pickles = sorted(f for f in os.listdir(wd) if f.startswith("results_"))
    want = sorted(f"results_{v}.pickle" for v in ("scgp", "svgp", "hurdle", "zi", "hurdlej", "onoff"))
    on = res["hurdle"]
    log(f"fold protocol on the rain field (wet {np.mean(data.Ytrain > 0):.3f}): classifier test auc "
        f"{res['classifier']['test_auc']:.4f} after {FOLD_CLASSIFIER_STEPS} steps, 'on' {len(on['train_pred_on_idx'])} "
        f"train / {len(on['test_pred_on_idx'])} test rows; test rmse svgp {res['svgp']['test_rmse']:.4f}, hurdle "
        f"{on['test_hurdle_comb_rmse']:.4f} (nlpd {on['test_hurdle_nlpd']:.4f}, crps {on['test_crps']:.4f}), zi "
        f"{res['zi']['test_zi_prob_reg_rmse']:.4f}, hurdlej {res['hurdlej']['test_hurdle_comb_rmse']:.4f} (gate auc "
        f"{res['hurdlej']['test_gate_auc']:.4f}), onoff {res['onoff']['test_rmse']:.4f} (crps "
        f"{res['onoff']['test_crps']:.4f}); pickles {pickles}; wall {wall:.1f} s, by runner {walls} (training, "
        f"serving and the host's float64 scoring); {card}")
    bad = {v: non_finite(r) for v, r in res.items() if non_finite(r)}
    if bad or pickles != want:
        raise AssertionError(f"fold protocol: non-finite {bad}, pickles {pickles} (expected {want})")
    return wall


# --- the other trainers: the block-coordinate schedule and natural gradients ---

TRAINER_AB_EVERY = 5  # the graphed-vs-eager A/B of a grouped block: two groups in AB_STEPS


def trainer_cfgs() -> dict:
    """The other trainers' configurations at full width, cut in depth:
    README's block-coordinate recipe on the flagship (device sampler,
    hyper_every 50, kern_lr 2e-2, blocks of 200: two blocks), the 105 × 250
    grid at B = 8192 with hyper_every 50 (two blocks of 50), and the natural
    gradients with 50 Adam warm-up steps: the kron_joint recipe (q_cov kron,
    whitened, device sampler, then 4 blocks of 50), the diagonal family (the
    flagship default, host sampler, 2 blocks) and kron_joint with
    hyper_every 50 (2 blocks)."""
    from zigp_tpu_torch.experiments.configs import OnOffPptrConfig

    base = OnOffPptrConfig()
    ng = dict(optimizer="natgrad", natgrad_adam_warmup=50, scan_inner=50, log_every=50)
    joint = dict(q_cov="kron", whiten=True, natgrad_kron_joint=True, sampler="device")
    rep = dataclasses.replace
    return {
        "alternating flagship": rep(base, sampler="device", hyper_every=50, kern_lr=2e-2, scan_inner=200,
                                    num_iter=400, log_every=200),
        "alternating scale 105x250 B=8192": rep(scale_train_cfg(), sampler="device", hyper_every=50, scan_inner=50,
                                                num_iter=100, log_every=50),
        "natgrad kron_joint": rep(base, num_iter=250, **ng, **joint),
        "natgrad diag": rep(base, num_iter=150, **ng),
        "natgrad kron_joint hyper_every 50": rep(base, num_iter=150, hyper_every=50, **ng, **joint),
    }


def natural_kind(cfg) -> str:
    if cfg.optimizer != "natgrad":
        return ""
    return "joint" if cfg.natgrad_kron_joint and cfg.q_cov == "kron" else cfg.q_cov


def trainer_launches(sizes, steps, *, hyper_every=0, natural="", start=0) -> dict:
    """{n: factorizations} of ``steps`` steps of a trainer on a stacked f/g
    pair with factors ``sizes`` (one chol_inv launch each): a full step's
    loss factors every factor once; with ``hyper_every`` each group's first
    step is full, its factor state factors every factor once, and the other
    steps' losses take that state; the joint natural step (``natural``
    "joint", KL budget on) factors factor (start + i) mod P four times at
    step i (Σ_p, two map-backs, Σ′); the diagonal and mean steps none."""
    out = {n: 0 for n in sizes}
    for i in range(steps):
        full = not hyper_every or i % hyper_every == 0
        for n in sizes:
            out[n] += int(full) + int(full and bool(hyper_every))
        if natural == "joint":
            out[sizes[(start + i) % len(sizes)]] += 4
    return out


def by_kernel(by_n: dict) -> dict:
    """{(wrapper, n): launches}: chol_inv.cu to MAX_N, the cluster kernel above."""
    from zigp_tpu_torch.ops.cuda import chol_inv as ci

    return {("chol_inv" if n <= ci.MAX_N else "chol_inv_blocked", n): k for n, k in by_n.items() if k}


def counted_by_kernel(counts) -> dict:
    return {**{("chol_inv", n): k for n, k in counts["chol_inv_by_n"].items()},
            **{("chol_inv_blocked", n): k for n, k in counts["chol_inv_blocked_by_n"].items()}}


def expected_run_launches(cfg, sizes) -> tuple[int, dict]:
    """(steps in the result, {(wrapper, n): launches}) of one run of ``cfg``
    through ``train_onoff_pptr``: the natural phase after its Adam warm-up
    (``fit_natgrad_scanned``'s budget rules), or the alternating run."""
    if cfg.optimizer != "natgrad":
        return cfg.num_iter, by_kernel(trainer_launches(sizes, cfg.num_iter, hyper_every=cfg.hyper_every))
    warm = min(cfg.natgrad_adam_warmup, cfg.num_iter // 2)
    inner = max(1, min(cfg.scan_inner, cfg.num_iter - warm))
    steps = -(-(cfg.num_iter - warm) // inner) * inner
    warm_steps = -(-warm // min(inner, warm)) * min(inner, warm) if warm else 0
    want = trainer_launches(sizes, steps, hyper_every=cfg.hyper_every, natural=natural_kind(cfg))
    for n in sizes:
        want[n] += warm_steps  # the Adam warm-up's loss, one factorization a factor
    return steps, by_kernel(want)


def phase_trainer(name, cfg, split) -> dict:
    """Train ``cfg`` on the card through ``train_onoff_pptr`` (gram kernel
    off, both packages' default), the counts zeroed just before and read just
    after: finite losses, the steps the budget gives, and every chol_inv.cu
    and cluster-kernel launch by n as ``expected_run_launches`` counts them
    (none in a q-only step's loss). Returns its model and counts."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.experiments.runners import train_onoff_pptr

    model = build_onoff_pptr(cfg, split, device=DEVICE)
    sizes = [Z.shape[0] for Z in model.f.Zs]
    steps, want = expected_run_launches(cfg, sizes)
    lines = []
    zero_counts()
    t0 = time.perf_counter()
    res = train_onoff_pptr(cfg, split, model=model, log_fn=lambda s: (lines.append(s), log(f"{name}: {s}")))
    torch.cuda.synchronize()
    counts = read_counts()
    wall = time.perf_counter() - t0
    got = counted_by_kernel(counts)
    losses = res.step_losses
    blocks = losses.double().reshape(-1, cfg.scan_inner).mean(1).tolist()
    log(f"{name}: {losses.numel()} steps at B={cfg.batch_size} in {wall:.1f} s, block mean losses "
        f"{[f'{b:.6g}' for b in blocks]}; launches {got} (expected {want}); graphs "
        f"{[s.split(': ', 1)[1] for s in lines if 'graph' in s]}")
    if losses.numel() != steps or not torch.isfinite(losses).all():
        raise AssertionError(f"{name}: {losses.numel()} steps (expected {steps}), finite "
                             f"{bool(torch.isfinite(losses).all())}")
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want}")
    return {"model": model, "counts": counts}


def trainer_body(cfg, model, hyper_every):
    """(block body ``(Xs, Ys) -> losses``, its per-q-step watch point) for
    ``cfg``'s trainer on ``model``: the alternating block with its pair of
    optimizers, or the natural-gradient trainer's block at the γ of the
    ramp's first steps (a static float32 buffer); the joint Adam block for
    an Adam config without ``hyper_every``."""
    from zigp_tpu_torch.training import (
        NaturalGradientTrainer,
        init_alt_optimizers,
        make_alternating_block,
        make_scan_train_step,
    )

    if cfg.optimizer == "natgrad":
        tr = NaturalGradientTrainer(model, gamma=cfg.natgrad_gamma, adam_lr=cfg.indp_lr,
                                    gamma_warmup=cfg.natgrad_warmup, kron_joint=cfg.natgrad_kron_joint,
                                    kl_cap=cfg.natgrad_kl_cap)
        gammas = {}

        def body(Xs, Ys):
            K = Xs.shape[0]
            if K not in gammas:
                gammas[K] = torch.from_numpy(tr.gamma_at(np.arange(K))).to(DEVICE)
            return tr.block(Xs, Ys, gammas[K], 0, hyper_every)

        return body, tr
    if hyper_every:
        opt = init_alt_optimizers(model, learning_rate=cfg.indp_lr)
        block = make_alternating_block(model, opt, hyper_every)
        return block, opt
    train = make_scan_train_step(optimizer_for(model, cfg))
    return (lambda Xs, Ys: train(model, Xs, Ys)), None


def phase_trainer_ab(name, cfg, split, base) -> float:
    """From ``base``, 10 steps by one replay of the captured block against
    10 eager steps from the same state on the same batches (after a warm-up
    block of 10 on a side stream on each copy), with ``hyper_every`` cut to
    TRAINER_AB_EVERY (two groups): losses within GRAPH_TOL, launches exact
    on both paths; in the eager run every hyper raw is the same bits across
    the q-only steps of a group, and a q-only step's loss launches no
    chol_inv (its joint natural step its four)."""
    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import DataSet, capture_block, partition_model, stage_batches

    every = TRAINER_AB_EVERY if cfg.hyper_every else 0
    sizes = [Z.shape[0] for Z in base.f.Zs]
    want = by_kernel(trainer_launches(sizes, AB_STEPS, hyper_every=every, natural=natural_kind(cfg)))
    ds = DataSet(split.Xtrain, split.Ytrain, seed=3)
    warm, timed = (stage_batches(ds, cfg.batch_size, AB_STEPS, device=DEVICE, dtype=torch.float32) for _ in range(2))
    out, watched = {}, []
    for path in ("eager", "graphed"):
        m = copy.deepcopy(base)
        body, owner = trainer_body(cfg, m, every)
        Xs, Ys = (t.clone() for t in warm)
        on_side_stream(lambda: body(Xs, Ys))
        if path == "graphed":
            step = capture_block(lambda: body(Xs, Ys))
            Xs.copy_(timed[0])
            Ys.copy_(timed[1])
            zero_counts()
            losses = step()
        else:
            if every:  # watch each q-only step: its launches and the hyper raws
                _, h = partition_model(m)
                natural = owner if cfg.optimizer == "natgrad" else None
                hyper = [r for _, r in h if r.requires_grad] if natural is None else [
                    r for r in m.parameters() if r.requires_grad and all(r is not p for p in natural.natural.params)]
                target = (natural, "q_only_step") if natural is not None else (owner.q, "step")
                inner = getattr(*target)

                def watch(*a, inner=inner, hyper=hyper, **kw):
                    before = read_counts()["chol_inv"] + read_counts()["chol_inv_blocked"]
                    out_ = inner(*a, **kw)
                    watched.append((before, [r.detach().clone() for r in hyper]))
                    return out_

                setattr(*target, watch)
            zero_counts()
            losses = body(*timed)
        torch.cuda.synchronize()
        got = counted_by_kernel(read_counts())
        if got != want:
            raise AssertionError(f"trainer A/B {name} {path}: launches {got}, expected {want}")
        out[path] = losses.cpu().double().numpy()
        if not np.isfinite(out[path]).all():
            raise AssertionError(f"trainer A/B {name} {path}: non-finite losses")
    err = float(np.max(np.abs(out["graphed"] - out["eager"]) / np.abs(out["eager"])))
    note = ""
    if every:
        # watched: after each q-only step (the alternating schedule's q.step
        # or the natural q_only_step); the AB_STEPS steps make two groups
        q_per_group = every - 1
        natural_launches = 4 if natural_kind(cfg) == "joint" else 0
        for g in range(AB_STEPS // every):
            group = watched[g * q_per_group:(g + 1) * q_per_group]
            for (c0, h0), (c1, h1) in zip(group, group[1:]):
                if cfg.optimizer != "natgrad" and c1 != c0:
                    raise AssertionError(f"trainer A/B {name}: a q-only step launched chol_inv {c1 - c0} times")
                if cfg.optimizer == "natgrad" and c1 - c0 != natural_launches:
                    raise AssertionError(f"trainer A/B {name}: a q-only step launched chol_inv {c1 - c0} times, "
                                         f"expected its natural step's {natural_launches}")
                if not all(torch.equal(a, b) for a, b in zip(h0, h1)):
                    raise AssertionError(f"trainer A/B {name}: a q-only step moved a hyper raw")
        note = (f"; q-only steps: hyper raws the same bits, chol_inv launches "
                f"{'none' if cfg.optimizer != 'natgrad' else f'{natural_launches} (the natural step) each'}")
    log(f"trainer A/B {name}: {AB_STEPS} steps{f' (hyper_every {every})' if every else ''} by one replay vs eager, "
        f"losses {out['graphed'][0]:.6f} .. {out['graphed'][-1]:.6f}; largest relative loss difference {err:.3e} "
        f"(tol {GRAPH_TOL:.0e}), equal bits {bool(np.array_equal(out['graphed'], out['eager']))}; launches exact "
        f"{want}{note}")
    if not err <= GRAPH_TOL:
        raise AssertionError(f"trainer A/B {name}: graphed and eager losses differ by {err:.3e}")
    return err


def natural_inputs(model, X, Y, device, dtype):
    """The kron_joint step's inputs on the flagship pair at its state: the
    stacked (m, C_q, ∂L/∂m, ∂L/∂C_q) of f and g from one batch, computed on
    the card in float32 and moved to ``device`` and ``dtype``."""
    from zigp_tpu_torch.training import NaturalGradientTrainer

    tr = NaturalGradientTrainer(model, kron_joint=True)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32).to(DEVICE)
    tr.adam.zero_grad()
    tr.natural.zero_()
    model.loss(t(X), t(Y)).backward()
    gps = (model.f, model.g)
    mv = lambda ts: torch.stack([x.detach() for x in ts]).to(device=device, dtype=dtype)
    P = len(model.f.Zs)
    return (mv(gp.q_mu.raw for gp in gps), [mv(torch.tril(gp.q_sqrt_factors[q].raw) for gp in gps) for q in range(P)],
            mv(gp.q_mu.raw.grad for gp in gps), [mv(gp.q_sqrt_factors[q].raw.grad for gp in gps) for q in range(P)])


def phase_natural_step(model, cfg, split) -> None:
    """The joint natural step (``natgrad_update_block_kron``, f and g
    stacked, every factorization through chol_inv.cu) on the card in float32
    against the same step on the CPU in float64, on the same (m, C_p,
    gradients) from the trained kron_joint model, for each p: each output
    within max(3 × the CPU float32 run's error, 1e-5), 4 launches a step.
    Then a step forced out of the positive-definite cone (γ past the point
    where A + (2γ/M_rest)·D has a negative eigenvalue, KL budget off) keeps
    the previous (m, C_p) to the bit on the card, as on the CPU."""
    from zigp_tpu_torch.ops import linalg
    from zigp_tpu_torch.training import natgrad_update_block_kron

    X, Y = split.Xtrain[:cfg.batch_size], split.Ytrain[:cfg.batch_size]
    ins = {dt: natural_inputs(model, X, Y, dev, dt) for dev, dt in (("cpu", torch.float64), ("cpu", torch.float32))}
    ins["card"] = natural_inputs(model, X, Y, DEVICE, torch.float32)
    gamma = torch.tensor(cfg.natgrad_gamma, dtype=torch.float32)
    kw = dict(max_mean_step=10.0, kl_cap=cfg.natgrad_kl_cap)
    sizes = [C.shape[-1] for C in ins["card"][1]]
    for p in range(len(sizes)):
        outs = {}
        for key, (m, Cs, gm, gC) in ins.items():
            if key == "card":
                zero_counts()
            outs[key] = natgrad_update_block_kron(m, Cs, p, gm, gC[p], gamma.to(m.device), **kw)
            if key == "card":
                torch.cuda.synchronize()
                launches = read_counts()["chol_inv_by_n"]
                if launches != {sizes[p]: 4}:
                    raise AssertionError(f"natural step p={p}: chol_inv launches {launches}, expected {{{sizes[p]}: 4}}")
        for i, what in enumerate(("m", f"C_{p}")):
            e_card = rel(outs["card"][i].cpu(), outs[torch.float64][i])
            e_cpu = rel(outs[torch.float32][i], outs[torch.float64][i])
            tol = max(3.0 * e_cpu, 1e-5)
            log(f"natural step p={p} (n={sizes[p]}, G=2): {what:4s} card f32 vs cpu f64 {e_card:.3e}, cpu f32 vs cpu "
                f"f64 {e_cpu:.3e} (tol {tol:.3e}); chol_inv.cu launches 4")
            if not e_card <= tol:
                raise AssertionError(f"natural step p={p}: {what} card error {e_card:.3e} > {tol:.3e}")
    # out of the cone: pick γ from the float64 step so the raw update is indefinite
    m, Cs, gm, gC = ins[torch.float64]
    p = len(sizes) - 1
    Sig = Cs[p] @ Cs[p].transpose(-1, -2)
    L, Li = linalg.chol_inv_forward(Sig)
    d = torch.sign(torch.diagonal(Cs[p], dim1=-2, dim2=-1))
    D = linalg.chol_vjp(L, Li, torch.tril(gC[p]) * d[..., None, :])
    D = 0.5 * (D + D.transpose(-1, -2))
    A = Li.transpose(-1, -2) @ Li
    Mrest = math.prod(sizes) // sizes[p]
    # D is linear in the gradient: flip it where D has no negative eigenvalue
    flip = torch.where(torch.linalg.eigvalsh(D)[..., 0] < 0, 1.0, -1.0).to(torch.float64)
    lam_D, lam_A = torch.linalg.eigvalsh(D * flip[:, None, None])[..., 0], torch.linalg.eigvalsh(A)[..., -1]
    if not (lam_D < 0).all():
        raise AssertionError(f"non-PD step: D has no eigenvalue of either sign ({lam_D})")
    big = float((100 * lam_A * Mrest / (2 * -lam_D)).max())
    for key, (m, Cs, gm, gC) in ins.items():
        if key == torch.float32:
            continue
        new_m, new_C = natgrad_update_block_kron(m, Cs, p, gm, gC[p] * flip.to(gC[p])[:, None, None],
                                                 torch.tensor(big, dtype=torch.float32).to(m.device),
                                                 max_mean_step=10.0, kl_cap=None)
        if not (torch.equal(new_m, m) and torch.equal(new_C, Cs[p])):
            raise AssertionError(f"non-PD step on {key}: the previous (m, C_{p}) was not kept")
    log(f"natural step out of the cone (p={p}, γ={big:.3e}, KL budget off): the previous (m, C_{p}) kept to the bit "
        f"on the card and on the CPU")


def time_trainer_paths(name, cases, X, Y, card, blocks=1, inner=50) -> dict:
    """Steps/s of each case's blocks of ``inner`` device-sampled steps, one
    replay of its captured block each (a warm-up block on a side stream
    first), in turns: median of 3 passes of ``blocks`` blocks, host clock
    around work that ends in a synchronise; each graph's capture and
    instantiate times and pool."""
    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import DataSet, capture_block
    from zigp_tpu_torch.training.scan import StagedBlocks

    runs = {}
    for label, (cfg, make_model, every) in cases.items():
        m = make_model()
        st = StagedBlocks(DataSet(X, Y), "device", cfg.batch_size, inner, device=DEVICE, dtype=torch.float32)
        body, _ = trainer_body(cfg, m, every)
        st.fill(0)
        on_side_stream(lambda: body(st.Xs, st.Ys))
        runs[label] = (st, capture_block(lambda body=body, st=st: body(st.Xs, st.Ys)), [])
    labels = list(runs)
    for rep in range(3):
        for label in (labels if rep % 2 == 0 else labels[::-1]):
            st, step, rates = runs[label]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in range(blocks):
                st.fill(1 + blocks * rep + b)
                losses = step()
            torch.cuda.synchronize()
            rates.append(blocks * inner / (time.perf_counter() - t0))
            if not torch.isfinite(losses).all():
                raise AssertionError(f"time {name} {label}: non-finite losses")
    out = {}
    for label, (_, step, rates) in runs.items():
        g = step.graph
        out[label] = {"steps_per_s": float(np.median(rates)), "capture_ms": g.capture_ms,
                      "instantiate_ms": g.instantiate_ms, "pool_mib": g.pool_bytes / 2**20}
        log(f"time {name}: {label}: {out[label]['steps_per_s']:.1f} steps/s {[round(v, 1) for v in rates]} (graphed "
            f"blocks of {inner}, median of 3 passes of {blocks * inner} steps, in turns); block graph: {g.describe()}; "
            f"{card}")
    return out


def time_trainers(split, card) -> dict:
    """On the flagship (B = 1000), in turns: joint Adam, hyper_every 50 and
    the diagonal natural gradients on the flagship default, joint Adam and
    kron_joint on its whitened Kronecker-q twin; on the 105 × 250 grid
    (B = 8192) joint Adam against hyper_every 50."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr

    cfgs = trainer_cfgs()
    build = lambda cfg: (lambda: build_onoff_pptr(cfg, split, device=DEVICE))
    adam = lambda cfg: dataclasses.replace(cfg, optimizer="adam", hyper_every=0)
    X, Y = split.Xtrain, split.Ytrain
    alt, scale = cfgs["alternating flagship"], cfgs["alternating scale 105x250 B=8192"]
    ng_diag, ng_joint = cfgs["natgrad diag"], cfgs["natgrad kron_joint"]
    return {
        "flagship": time_trainer_paths("the trainers, flagship B=1000", {
            "joint Adam, diagonal q": (adam(alt), build(alt), 0), "hyper_every 50": (alt, build(alt), 50),
            "natgrad diagonal": (ng_diag, build(ng_diag), 0),
            "joint Adam, kron q whitened": (adam(ng_joint), build(ng_joint), 0),
            "natgrad kron_joint": (ng_joint, build(ng_joint), 0)}, X, Y, card),
        "scale": time_trainer_paths("joint vs hyper_every 50, 105x250 B=8192", {
            "joint Adam": (adam(scale), build(scale), 0), "hyper_every 50": (scale, build(scale), 50)}, X, Y, card),
    }


def trainer_rows(ci, trainers: dict, card) -> list:
    """The kernels-line rows of the other trainers' paths: chol_inv.cu at
    each (2, n, n) and the cluster kernel at each n > MAX_N, with their
    launches on those paths (the runs of ``phase_trainer``)."""
    by_shape = {}
    for name, run in trainers.items():
        for (kernel, n), k in counted_by_kernel(run["counts"]).items():
            by_shape.setdefault((kernel, n), {})[name] = k
    rows = []
    for (kernel, n), paths in sorted(by_shape.items()):
        launches = sum(paths.values())
        where = ", ".join(f"{name} {k}" for name, k in paths.items())
        if kernel == "chol_inv_blocked":
            rows += blocked_rows(ci, {n: launches}, {}, card, f"trainers: {where}")
            continue
        ms, device_ms, plain_ms, lib_ms, err = time_chol_inv(ci, n, 2)
        b_ms, b_by = bound_ms(n, 2)
        kname = f"chol_inv n={n} G=2 (trainers: {where})"
        log(f"time {kname}: kernel {ms:.4f} ms, device {device_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.linalg "
            f"{lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), launches {launches}, max |kernel - plain| {err:.3e}; "
            f"{card}")
        rows.append({
            "name": kname, "route": "cuda", "source": "zigp_tpu_torch/ops/cuda/csrc/chol_inv.cu",
            "replaces": "zigp_tpu/ops/pallas/chol_inv.py:339", "launches": launches, "max_abs_err": err, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })
    return rows


def family_rows(ci, rg, families: dict, card) -> list:
    """The kernels-line rows of the families' paths: chol_inv.cu at each
    (G, n, n) with its training and serving launches on those paths, and
    rbf_gram at each training shape of the classifier."""
    by_shape = {}  # (G, n): {family: (training, serving) launches}
    for name, fam in families.items():
        G = 2 if name == "hurdlej" else 1
        for n, train in fam["train"]["chol_inv_by_n"].items():
            by_shape.setdefault((G, n), {})[name] = (train, fam["serve"]["chol_inv_by_n"].get(n, 0))
    rows = []
    for (G, n), paths in sorted(by_shape.items()):
        launches = sum(t + s for t, s in paths.values())
        ms, device_ms, plain_ms, lib_ms, err = time_chol_inv(ci, n, G)
        b_ms, b_by = bound_ms(n, G)
        where = ", ".join(f"{name} training {t}, serving {s}" for name, (t, s) in paths.items())
        kname = f"chol_inv n={n} G={G} (families: {where})"
        log(f"time {kname}: kernel {ms:.4f} ms, device {device_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.linalg "
            f"{lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), launches {launches}, max |kernel - plain| {err:.3e}; "
            f"{card}")
        rows.append({
            "name": kname, "route": "cuda", "source": "zigp_tpu_torch/ops/cuda/csrc/chol_inv.cu",
            "replaces": "zigp_tpu/ops/pallas/chol_inv.py:339", "launches": launches, "max_abs_err": err, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })
    rows += gram_rows(rg, {f"family {name} training": fam["train"] for name, fam in families.items()
                           if fam["train"]["rbf_gram"]}, card)
    return rows


# --- the batched member stack: CV folds and ensemble members as one stack ----

STACK_F = 5  # the protocol's five folds
STACK_GATE_STEPS = 50  # the member gate: two blocks of 25, one eager, one replay
STACK_INNER = 50  # the timed and the counted blocks
STUDY_TEST_ROWS = 500  # the batched studies' test rows a fold (their training sets are the folds' own)
BATCH_GATE = ((100, 10), (100, 80), (200, 10), (250, 10), (250, 50))  # (n, F·G) of the folded-launch gate


def cv_folds(split):
    """``make_cv_splits`` of the synthetic set (its time column is already
    ÷ 1000): five folds of equal train size, as the pptr protocol's."""
    from zigp_tpu_torch.io.datasets import make_cv_splits

    folds = make_cv_splits(split, time_scale=1.0)
    if len(folds) != STACK_F or len({f.Xtrain.shape[0] for f in folds}) != 1:
        raise AssertionError(f"cv folds: {[f.Xtrain.shape for f in folds]}")
    return folds


def batched_grams(n: int, G: int) -> np.ndarray:
    """G float32 SPD grams of n time knots: ``spd_grams``' pair repeated,
    each copy scaled by its own factor."""
    base = spd_grams(n)
    return np.stack([base[g % 2] * np.float32(1.0 + 0.01 * (g // 2)) for g in range(G)])


def phase_stack_chol_gate(ci):
    """The vmap rule's one launch of (F·G, n, n) against one launch per
    member, bit for bit: ``chol_inv.cu`` at n = 100 (batches 10 and 80, the
    natural step's largest stack 4·F·E) and 200, the cluster kernel at
    n = 250 (batches 10 and 50)."""
    from zigp_tpu_torch.ops import linalg

    for n, batch in BATCH_GATE:
        K = torch.as_tensor(batched_grams(n, batch), device=DEVICE).reshape(batch // 2, 2, n, n)
        wrapper = ci.chol_inv_cuda if n <= ci.MAX_N else ci.chol_inv_blocked
        with torch.inference_mode():
            before = wrapper.launches
            L, Linv = torch.func.vmap(linalg.chol_inv)(K)
            torch.cuda.synchronize()
            folded = wrapper.launches - before
            same = all(torch.equal(a, b) for f in range(K.shape[0])
                       for a, b in zip((L[f], Linv[f]), linalg.chol_inv(K[f])))
        log(f"gate stacked chol_inv n={n}: {K.shape[0]} members x 2 in {folded} launch of {wrapper.__name__}, "
            f"bit-identical to {K.shape[0]} per-member launches: {same}")
        if folded != 1 or not same or not torch.isfinite(L).all():
            raise AssertionError(f"stacked chol_inv n={n}: {folded} launches, equal bits {same}")


_BUILT = {}  # (config, fold rows, E, gram kernel, perturbation): the members built once


def stack_members(cfg, folds, E=1, use_kernel=False, perturb=None):
    """F×E models of ``cfg`` on the card (member f·E + e on fold f with seed
    cfg.seed + e), their sampler seeds and training sets: fresh copies of
    the members built at the first call."""
    from zigp_tpu_torch.experiments.builders import build_onoff_pptr

    key = (repr(cfg), folds[0].Xtrain.shape[0], E, use_kernel, perturb)
    if key in _BUILT:
        models, seeds, datas = _BUILT[key]
        return [copy.deepcopy(m) for m in models], list(seeds), list(datas)
    models, seeds, datas = [], [], []
    for f, fold in enumerate(folds):
        for e in range(E):
            m = build_onoff_pptr(dataclasses.replace(cfg, seed=cfg.seed + e), fold, device=DEVICE,
                                 use_kernel=use_kernel)
            models.append(m if perturb is None else perturbed(m, perturb + f * E + e))
            seeds.append(cfg.seed + e)
            datas.append((fold.Xtrain, fold.Ytrain))
    _BUILT[key] = ([copy.deepcopy(m) for m in models], seeds, datas)
    return models, list(seeds), list(datas)


def stack_loss_and_grads(stack, X, Y):
    """Each member's loss and every trainable raw's gradient (stacked) of the
    members' summed loss on one batch each, float64 numpy."""
    from zigp_tpu_torch.training.batched import stacked_loss

    p0 = next(stack.parameters())
    t = lambda a: torch.as_tensor(a, dtype=p0.dtype).to(p0.device)
    stack.zero_grad(set_to_none=True)
    losses = stacked_loss(stack, t(X), t(Y))
    losses.sum().backward()
    grads = {n: p.grad.detach().cpu().double().numpy() for n, p in stack.named_parameters() if p.requires_grad}
    stack.zero_grad(set_to_none=True)
    return losses.detach().cpu().double().numpy(), grads


def phase_stack_f32_gate(folds):
    """The flagship F = 5 stack at perturbed raws: every member's loss and
    every stacked gradient on the card against the stack on the CPU in
    float64, each within max(3 × the CPU float32 stack's error, 1e-5)."""
    from zigp_tpu_torch.experiments.configs import OnOffPptrConfig
    from zigp_tpu_torch.training import stack_models

    cfg = OnOffPptrConfig()
    models, _, _ = stack_members(cfg, folds, perturb=11)
    stack = stack_models(models)
    B = cfg.batch_size
    X = np.stack([f.Xtrain[:B] for f in folds])
    Y = np.stack([f.Ytrain[:B] for f in folds])
    card = stack_loss_and_grads(stack, X, Y)
    cpu64, cpu32 = (stack_loss_and_grads(copy.deepcopy(stack).to(device="cpu", dtype=dt), X, Y)
                    for dt in (torch.float64, torch.float32))
    rows = [(f"loss of member {f}", abs(card[0][f] - cpu64[0][f]) / abs(cpu64[0][f]),
             abs(cpu32[0][f] - cpu64[0][f]) / abs(cpu64[0][f]), abs(card[0][f] - cpu32[0][f]) / abs(cpu32[0][f]))
            for f in range(STACK_F)]
    rows += [(f"d {n}", rel(card[1][n], cpu64[1][n]), rel(cpu32[1][n], cpu64[1][n]), rel(card[1][n], cpu32[1][n]))
             for n in cpu64[1]]
    worst = 0.0
    for what, e_card, e_cpu, e_32 in rows:
        tol = max(3.0 * e_cpu, 1e-5)
        worst = max(worst, e_card / tol)
        log(f"gate stack flagship F={STACK_F}: {what:34s} card f32 vs cpu f64 {e_card:.3e}, cpu f32 vs cpu f64 "
            f"{e_cpu:.3e} (tol {tol:.3e}); card f32 vs cpu f32 {e_32:.3e}")
        if not e_card <= tol:
            raise AssertionError(f"stack f32 gate: {what} card error {e_card:.3e} > {tol:.3e}")
    log(f"gate stack flagship F={STACK_F}: {STACK_F} losses and {len(rows) - STACK_F} stacked gradients within bound "
        f"(largest share of its tolerance {worst:.2f})")


def cpu_f32_run(model, cfg, fold, seed, steps, inner):
    """The member's sequential run repeated on the CPU in float32 on the rows
    the card's device sampler draws for it: (losses at the block ends, raws)."""
    from zigp_tpu_torch.training import DataSet, make_scan_train_step
    from zigp_tpu_torch.training.scan import StagedBlocks

    m = copy.deepcopy(model).to(device="cpu", dtype=torch.float32)
    train = make_scan_train_step(optimizer_for(m, cfg))
    st = StagedBlocks(DataSet(fold.Xtrain, fold.Ytrain), "device", cfg.batch_size, inner, device=DEVICE,
                      dtype=torch.float32, sampler_seed=seed)
    losses = []
    for b in range(steps // inner):
        st.fill(b)
        losses.append(float(train(m, st.Xs.cpu(), st.Ys.cpu())[-1]))
    return np.array(losses), [p.detach().double().numpy() for p in m.parameters()]


def phase_stack_members(folds) -> dict:
    """Each member of a 50-step flagship F = 5 stack (``fit_batched_scanned``,
    two blocks of 25: one eager, one replay; counts zeroed just before and
    read just after) against its own graphed sequential
    ``fit_scanned(sampler="device", sampler_seed=f)``: the losses at the
    block ends and every raw. The two differ only in the order of
    summation (a batched product against F single ones), as the card's
    sequential run and the same run on the CPU in float32 do: each is held
    to max(3 × that CPU f32 gap, 1e-4), the graph A/B's floor."""
    from zigp_tpu_torch.experiments.configs import OnOffPptrConfig
    from zigp_tpu_torch.training import DataSet, fit_batched_scanned, fit_scanned

    cfg = OnOffPptrConfig()
    inner = STACK_GATE_STEPS // 2
    models, seeds, datas = stack_members(cfg, folds)
    seeds = list(range(STACK_F))
    starts = [copy.deepcopy(m) for m in models]
    kw = dict(num_iter=STACK_GATE_STEPS, batch_size=cfg.batch_size, num_inner=inner, learning_rate=cfg.indp_lr,
              log_every_blocks=1, log_fn=lambda s: None)
    zero_counts()
    res = fit_batched_scanned(models, datas, seeds=seeds, **kw)
    torch.cuda.synchronize()
    counts = read_counts()
    gaps = {"stack": ([], []), "cpu f32": ([], [])}
    for f in range(STACK_F):
        seq = fit_scanned(copy.deepcopy(starts[f]), DataSet(*datas[f]), sampler="device", sampler_seed=f, **kw)
        seq_losses = np.array(seq.losses)
        seq_raws = [p.detach().cpu().double().numpy() for p in seq.model.parameters()]
        cpu_losses, cpu_raws = cpu_f32_run(starts[f], cfg, folds[f], f, STACK_GATE_STEPS, inner)
        for path, losses, raws in (("stack", np.array(res[f].losses),
                                    [p.detach().cpu().double().numpy() for p in res[f].model.parameters()]),
                                   ("cpu f32", cpu_losses, cpu_raws)):
            gaps[path][0].append(float(np.max(np.abs(losses - seq_losses) / np.abs(seq_losses))))
            gaps[path][1].append(max(rel(a, b) for a, b in zip(raws, seq_raws)))
    worst = {path: (max(l), max(r)) for path, (l, r) in gaps.items()}
    tol = tuple(max(3.0 * e, 1e-4) for e in worst["cpu f32"])
    log(f"gate stack members: {STACK_F} members of a {STACK_GATE_STEPS}-step flagship stack against their graphed "
        f"sequential runs: losses {['%.3e' % v for v in gaps['stack'][0]]}, raws "
        f"{['%.3e' % v for v in gaps['stack'][1]]}; the sequential runs repeated on the CPU in float32: losses "
        f"{['%.3e' % v for v in gaps['cpu f32'][0]]}, raws {['%.3e' % v for v in gaps['cpu f32'][1]]} "
        f"(tolerance losses {tol[0]:.3e}, raws {tol[1]:.3e}); launches {counted_by_kernel(counts)}, by batch "
        f"{counts['chol_inv_by_batch']}")
    if not (worst["stack"][0] <= tol[0] and worst["stack"][1] <= tol[1]):
        raise AssertionError(f"stack members left their sequential runs: {worst['stack']} > {tol}")
    return counts


def stack_cases() -> dict:
    """The timed and counted stack paths: name: (config, E, hyper_every,
    the gram kernel on). Blocks of STACK_INNER; the natural gradients after
    their Adam warm-up of 50 steps."""
    from zigp_tpu_torch.experiments.configs import OnOffPptrConfig, best_onoff_config

    flagship = OnOffPptrConfig()
    trainers = trainer_cfgs()
    return {
        "flagship F=5": (flagship, 1, 0, True),
        "champion F=5": (best_onoff_config(), 1, 0, True),
        "flagship ensemble 5x4": (flagship, 4, 0, True),
        "hyper_every 50 F=5": (dataclasses.replace(trainers["alternating flagship"], scan_inner=STACK_INNER), 1, 50,
                               False),
        "natgrad kron_joint F=5": (dataclasses.replace(trainers["natgrad kron_joint"], num_iter=150), 1, 0, False),
        "scale 105x250 B=8192 F=5": (scale_train_cfg(), 1, 0, True),
    }


def stack_body(cfg, stack, hyper_every):
    """``trainer_body`` on a member stack: the stacked Adam, alternating or
    natural-gradient block at the γ of the ramp's first steps."""
    from zigp_tpu_torch.training import (
        StackedNaturalGradientTrainer,
        cosine_adam,
        init_alt_optimizers,
        make_batched_alternating_step,
        make_batched_block,
        make_optimizer,
    )

    if cfg.optimizer == "natgrad":
        tr = StackedNaturalGradientTrainer(stack, gamma=cfg.natgrad_gamma, adam_lr=cfg.indp_lr,
                                           gamma_warmup=cfg.natgrad_warmup, kron_joint=cfg.natgrad_kron_joint,
                                           kl_cap=cfg.natgrad_kl_cap)
        gammas = torch.from_numpy(tr.gamma_at(np.arange(STACK_INNER))).to(DEVICE)
        return lambda Xs, Ys: tr.block(Xs, Ys, gammas, 0, hyper_every)
    if hyper_every:
        return make_batched_alternating_step(stack, init_alt_optimizers(stack, learning_rate=cfg.indp_lr),
                                             hyper_every)
    schedule = cosine_adam(cfg.num_iter) if cfg.lr_schedule == "cosine" else None
    return make_batched_block(stack, make_optimizer(stack, default_lr=cfg.indp_lr, schedule=schedule))


def phase_stack_paths(folds) -> dict:
    """Each stack path through its entry point (``fit_batched_scanned`` or
    ``fit_natgrad_batched``, two blocks of 50 after any warm-up: one eager,
    one replay), the counts zeroed just before and read just after: finite
    losses, and every ``chol_inv.cu`` and cluster-kernel launch by n exactly
    a single member's run's (``per_step_launches``, ``expected_run_launches``):
    the count does not grow with the members, whose matrices go in one
    launch of F·E·2."""
    from zigp_tpu_torch.training import fit_batched_scanned, fit_natgrad_batched

    out = {}
    for name, (cfg, E, hyper_every, use_kernel) in stack_cases().items():
        models, seeds, datas = stack_members(cfg, folds, E, use_kernel)
        sizes = [Z.shape[0] for Z in models[0].f.Zs]
        members = len(models)
        lines = []
        zero_counts()
        t0 = time.perf_counter()
        if cfg.optimizer == "natgrad":
            res = fit_natgrad_batched(
                models, datas, num_iter=cfg.num_iter, batch_size=cfg.batch_size, num_inner=STACK_INNER,
                gamma=cfg.natgrad_gamma, gamma_warmup=cfg.natgrad_warmup, adam_warmup=cfg.natgrad_adam_warmup,
                kron_joint=cfg.natgrad_kron_joint, kl_cap=cfg.natgrad_kl_cap, adam_lr=cfg.indp_lr, seeds=seeds,
                log_every_blocks=1, log_fn=lines.append)
            steps, want = expected_run_launches(dataclasses.replace(cfg, scan_inner=STACK_INNER), sizes)
        else:
            steps = 2 * STACK_INNER
            res = fit_batched_scanned(models, datas, num_iter=steps, batch_size=cfg.batch_size,
                                      num_inner=STACK_INNER, learning_rate=cfg.indp_lr, seeds=seeds,
                                      hyper_every=hyper_every, log_every_blocks=1, log_fn=lines.append)
            want = by_kernel(trainer_launches(sizes, steps, hyper_every=hyper_every))
        torch.cuda.synchronize()
        counts = read_counts()
        wall = time.perf_counter() - t0
        got = counted_by_kernel(counts)
        batches = {G for G, _ in (*counts["chol_inv_by_batch"], *counts["chol_inv_blocked_by_batch"])}
        log(f"stack {name}: {members} members, {steps} steps at B={cfg.batch_size} in {wall:.1f} s; launches {got} "
            f"(a single member's run: {want}), batches {sorted(batches)}; gram kernel "
            f"{'on' if use_kernel else 'off'}, rbf_gram {counts['rbf_gram_by_shape']}; "
            f"{[s for s in lines if 'graph' in s or 'losses' in s][-2:]}")
        finals = np.array([r.final_loss for r in res])
        if not np.isfinite(finals).all() or len(res) != members:
            raise AssertionError(f"stack {name}: final losses {finals}")
        if got != want or batches != {2 * members}:
            raise AssertionError(f"stack {name}: launches {got} (expected {want}), batches {batches}")
        out[name] = counts
    return out


def phase_stack_serving(folds, card) -> tuple:
    """``predict_batched_stacked`` of the flagship F = 5 stack (perturbed
    raws) over 5 × 65,536 rows at batch 4096, the counts zeroed just before
    and read just after: one ``chol_inv.cu`` launch per factor and chunk for
    all five members, finite outputs with gfvar ≥ 0, each member's first
    4096 rows within max(3 × CPU f32's error, 1e-5) of that member on the
    CPU in float64 (phase 5's gate). Then points/s, every chunk one replay of
    the stack's chunk graph, median of 5. Returns (points/s, the counts)."""
    from zigp_tpu_torch.experiments.configs import OnOffPptrConfig
    from zigp_tpu_torch.experiments.cv_batched import _onoff_predict
    from zigp_tpu_torch.experiments.runners import predict_batched
    from zigp_tpu_torch.training import predict_batched_stacked, stack_models, unstack_model

    batch = 4096
    models, _, _ = stack_members(OnOffPptrConfig(), folds, perturb=21)
    stack = stack_models(models)
    Xs = np.stack([np.resize(f.Xtest, (ROWS, 3)) for f in folds])
    chunks = math.ceil(ROWS / batch)
    zero_counts()
    out = predict_batched_stacked(_onoff_predict, stack, Xs, batch)
    counts = read_counts()
    if counts["chol_inv_by_batch"] != {(2 * STACK_F, Z.shape[0]): chunks for Z in models[0].f.Zs}:
        raise AssertionError(f"stack serving: launches {counts['chol_inv_by_batch']}")
    for f in range(STACK_F):
        if not all(np.isfinite(v).all() and v.shape[0] == ROWS for v in out[f].values()) or (out[f]["gfvar"] < 0).any():
            raise AssertionError(f"stack serving: member {f} non-finite or negative gfvar")
        member = unstack_model(stack, f)
        for k in ("gfmean", "gfvar", "fmean", "gmean"):
            ref = {dt: predict_batched(copy.deepcopy(member).to(device="cpu", dtype=dt).predict, Xs[f, :CHECK_ROWS],
                                       batch=CHECK_ROWS, device="cpu", dtype=dt)[k] for dt in (torch.float64,
                                                                                           torch.float32)}
            e_card, e_cpu = rel(out[f][k][:CHECK_ROWS], ref[torch.float64]), rel(ref[torch.float32],
                                                                               ref[torch.float64])
            if not e_card <= max(3.0 * e_cpu, 1e-5):
                raise AssertionError(f"stack serving member {f} {k}: card {e_card:.3e}, cpu f32 {e_cpu:.3e}")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_batched_stacked(_onoff_predict, stack, Xs, batch)
        times.append(time.perf_counter() - t0)
    pts = STACK_F * ROWS / float(np.median(times))
    log(f"stack serving flagship F={STACK_F}: {STACK_F} x {ROWS} rows in {chunks} chunks of {STACK_F} x {batch}: "
        f"chol_inv.cu launches {counts['chol_inv_by_batch']}, members within the serving gate of CPU f64; "
        f"{pts:.1f} points/s {[round(STACK_F * ROWS / t) for t in times]} (graphed, median of 5); {card}")
    return pts, counts


def time_stack_paths(folds, card) -> dict:
    """Steps/s of each stack path against the single model (member 0 alone,
    its fold and seed), graphed blocks of 50 device-sampled steps, in turns:
    median of 3 passes of one block each, after a warm-up block on a side
    stream and the capture; host clock around work that ends in a
    synchronise. Fold-steps/s = members × the stack's steps/s."""
    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import DataSet, StackedBlocks, capture_block, stack_models
    from zigp_tpu_torch.training.scan import StagedBlocks

    out = {}
    for name, (cfg, E, hyper_every, use_kernel) in stack_cases().items():
        models, seeds, datas = stack_members(cfg, folds, E, use_kernel)
        single = copy.deepcopy(models[0])
        stack = stack_models(models)
        st1 = StagedBlocks(DataSet(*datas[0]), "device", cfg.batch_size, STACK_INNER, device=DEVICE,
                           dtype=torch.float32, sampler_seed=seeds[0])
        stF = StackedBlocks(datas, cfg.batch_size, STACK_INNER, seeds=seeds, device=DEVICE, dtype=torch.float32)
        runs = {}
        for path, body, st in (("single", trainer_body(cfg, single, hyper_every)[0], st1),
                               ("stack", stack_body(cfg, stack, hyper_every), stF)):
            st.fill(0)
            on_side_stream(lambda body=body, st=st: body(st.Xs, st.Ys))
            runs[path] = (st, capture_block(lambda body=body, st=st: body(st.Xs, st.Ys)), [])
        for rep in range(3):
            for path in (("single", "stack") if rep % 2 == 0 else ("stack", "single")):
                st, step, rates = runs[path]
                st.fill(1 + rep)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses = step()
                torch.cuda.synchronize()
                rates.append(STACK_INNER / (time.perf_counter() - t0))
                if not torch.isfinite(losses).all():
                    raise AssertionError(f"time stack {name} {path}: non-finite losses")
        members = len(models)
        single_rate, stack_rate = (float(np.median(runs[p][2])) for p in ("single", "stack"))
        g = runs["stack"][1].graph
        out[name] = {"members": members, "single_steps_per_s": single_rate, "stack_steps_per_s": stack_rate,
                     "fold_steps_per_s": members * stack_rate, "fold_steps_ratio": members * stack_rate / single_rate,
                     "stack_ms_per_step": 1e3 / stack_rate, "single_ms_per_step": 1e3 / single_rate,
                     "capture_ms": g.capture_ms, "instantiate_ms": g.instantiate_ms, "pool_mib": g.pool_bytes / 2**20}
        log(f"time stack {name}, B={cfg.batch_size}, blocks of {STACK_INNER}: single {single_rate:.1f} steps/s "
            f"{[round(v, 1) for v in runs['single'][2]]}, stack of {members} {stack_rate:.1f} steps/s "
            f"{[round(v, 1) for v in runs['stack'][2]]} = {members * stack_rate:.1f} fold-steps/s, "
            f"{members * stack_rate / single_rate:.2f} x the single model (median of 3, in turns); stack graph: "
            f"{g.describe()}; {card}")
    return out


def study_folds(split):
    """The five CV folds of ``rain_split(split)`` with every test set cut to
    its first ``STUDY_TEST_ROWS`` rows: the training sets are the
    protocol's, and the host's float64 scoring, which grows with the test
    rows (an on/off mixture's CRPS with the square of its components),
    stays within the script's time."""
    from zigp_tpu_torch.io.datasets import Split

    return [Split(f.Xtrain, f.Ytrain, f.Xtest[:STUDY_TEST_ROWS], f.Ytest[:STUDY_TEST_ROWS])
            for f in cv_folds(rain_split(split))]


def undefined_ok(results, Ytest) -> list:
    """The non-finite entries of a runner's results, less the exceedance AUCs
    of thresholds the test rows never (or always) exceed, which are
    undefined."""
    y = np.asarray(Ytest).reshape(-1)
    skip = {f"test_exceedance.{tau}.auc" for tau in results.get("test_exceedance", {})
            if (y > float(tau)).all() or not (y > float(tau)).any()}
    return [k for k in non_finite({k: v for k, v in results.items() if k not in ("models", "pred_test")})
            if k not in skip]


def phase_stack_studies(split, card) -> dict:
    """The batched studies end to end on ``study_folds``' five folds, in one
    workdir, the counts zeroed just before and read just after:
    ``run_cv_batched`` of all six variants (``preset_configs("best")`` at
    100 steps, the classifier at its FOLD_CLASSIFIER_STEPS; the gram kernel
    on), ``run_cv_batched(["onoff"], ensemble=2)`` and
    ``run_ensemble("onoff", size=4)`` on fold 1. Every aggregate finite,
    every ensemble result finite (an exceedance AUC with one class aside),
    ``cv_summary.json`` written; training and scoring walls apart (the
    studies' log lines)."""
    import tempfile

    from zigp_tpu_torch.experiments.configs import preset_configs
    from zigp_tpu_torch.experiments.cv_batched import run_cv_batched
    from zigp_tpu_torch.experiments.ensemble import run_ensemble

    best = preset_configs("best")
    short = lambda cfg: dataclasses.replace(cfg, num_iter=100, scan_inner=50, log_every=50)
    cfgs = dict(onoff_cfg=short(best["onoff"]), svgp_cfg=short(best["svgp"]), hurdlej_cfg=short(best["hurdlej"]),
                clf_cfg=dataclasses.replace(best["classifier"], num_iter=FOLD_CLASSIFIER_STEPS, log_every=1000))
    folds = study_folds(split)
    lines = []
    walls = {}
    zero_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        summary = run_cv_batched(["onoff", "svgp", "classifier", "hurdle", "hurdlej", "zi"], splits=folds,
                                 workdir=wd, log_fn=lines.append, use_kernel=True, **cfgs)
        walls["run_cv_batched six variants"] = time.perf_counter() - t0
        written = os.path.exists(os.path.join(wd, "cv_summary.json"))
        t1 = time.perf_counter()
        mixed = run_cv_batched(["onoff"], splits=folds, onoff_cfg=cfgs["onoff_cfg"], ensemble=2, log_fn=lines.append)
        walls["run_cv_batched onoff ensemble=2"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        ens = run_ensemble(folds[0], "onoff", cfgs["onoff_cfg"], size=4, workdir=wd, log_fn=lines.append)
        walls["run_ensemble onoff size 4"] = time.perf_counter() - t1
    torch.cuda.synchronize()
    counts = read_counts()
    stage = lambda word: {line.split("]")[0] + "]": float(line.rsplit(" in ", 1)[1].split()[0]) for line in lines
                          if word in line and line.startswith("[")}
    trained, scored = stage("trained in"), stage("scored in")
    bad = {m: [k for k, a in per.items() if not np.isfinite(a["mean"])] for m, per in (*summary.items(),
                                                                                      *mixed.items())}
    bad = {m: v for m, v in bad.items() if v}
    bad_ens = undefined_ok(ens, folds[0].Ytest)
    log(f"stack studies on the rain field's five folds ({folds[0].Xtrain.shape[0]} train rows a fold, the first "
        f"{folds[0].Xtest.shape[0]} of its test rows; wet {np.mean(folds[0].Ytrain > 0):.3f}): onoff rmse {summary['onoff']['test_rmse']['mean']:.4f}, crps "
        f"{summary['onoff']['test_crps']['mean']:.4f}; svgp rmse {summary['svgp']['test_rmse']['mean']:.4f}; "
        f"classifier auc {summary['classifier']['test_auc']['mean']:.4f}; hurdle rmse "
        f"{summary['hurdle']['test_rmse']['mean']:.4f}; hurdlej rmse {summary['hurdlej']['test_rmse']['mean']:.4f}; "
        f"zi rmse {summary['zi']['test_rmse_prob']['mean']:.4f}; onoff x2 rmse "
        f"{mixed['onoff']['test_rmse']['mean']:.4f}; ensemble of 4 rmse {ens['test_rmse']:.4f} (members "
        f"{[round(v, 4) for v in ens['member_test_rmse']]}); walls {json.dumps({k: round(v, 1) for k, v in walls.items()})}"
        f", training {json.dumps(trained)}, serving and scoring {json.dumps(scored)}; summary written {written}; "
        f"chol_inv launches by batch {counts['chol_inv_by_batch']}; {card}")
    if bad or bad_ens or not written:
        raise AssertionError(f"stack studies: non-finite {bad}, ensemble {bad_ens}, summary written {written}")
    return {"counts": counts, "walls": walls, "trained": trained, "scored": scored}


# --- the command line on the card: training, predict, export, the forecast protocol ---

CLI_RUNS = {  # name: the training command's own flags (the predict and export commands repeat them)
    "flagship": ("onoff", ["--preset", "reference"]),
    "champion": ("onoff", ["--preset", "best"]),
    "scale 105x250": ("onoff", ["--grid", "105x250", "--batch", "8192"]),
    "classifier": ("classifier", ["--preset", "best"]),
}
CLI_STEPS = 100  # two blocks of 50: one eager, one replay
CLI_SAMPLES = 256
CLI_SECOND_ROWS = 10_000  # the second served call's rows: another batch through the same program
CLI_FORECAST_STEPS = 200
# The classifier (one GP) and the joint hurdle (a stacked pair): the second
# origin's window runs to the end of the range (56,700 test rows in all),
# where the on/off model's exact gated CRPS would take the host about 75 s.
CLI_FORECAST = ["cv", "--models", "classifier,hurdlej", "--split", "forecast", "--covariates", "--origins", "2",
                "--iters", str(CLI_FORECAST_STEPS), "--scan-inner", "50"]


def cli_config(name):
    """The model config ``cli.main`` builds from a CLI_RUNS entry's flags."""
    from zigp_tpu_torch.experiments.cli import _parse_grid
    from zigp_tpu_torch.experiments.configs import preset_configs

    kind, flags = CLI_RUNS[name]
    opts = dict(zip(flags[::2], flags[1::2]))
    cfg = preset_configs(opts.get("--preset", "reference"))[kind]
    kw = {"grid": _parse_grid(opts["--grid"])} if "--grid" in opts else {}
    if "--batch" in opts:
        kw["batch_size"] = int(opts["--batch"])
    return dataclasses.replace(cfg, **kw)


def served_fields(kind, out) -> dict:
    """An artifact's fields as ``predict_batched``'s methods name them: the
    classifier's pair ``p`` is (pfmean, pfvar)."""
    out = dict(out)
    if kind == "classifier":
        p = out.pop("p")
        out.update(pfmean=p[0], pfvar=p[1])
    return out


def cli_live(kind, model, X) -> dict:
    """The restored model's predictions on the card, ``predict_batched``'s
    graphed path: the on/off model's ``predict``, the classifier's
    ``predict_latent`` and ``predict_class``."""
    from zigp_tpu_torch.experiments.runners import predict_batched

    methods = [model.predict] if kind == "onoff" else [model.predict_latent, model.predict_class]
    out = {}
    for m in methods:
        out.update(predict_batched(m, X, batch=4096, device=DEVICE))
    return out


def check_artifact(name, kind, model, served, X) -> dict:
    """One artifact against the restored model: served once on all rows with
    the counts zeroed just before (one launch per factor of chol_inv.cu, or
    of the cluster kernel above MAX_N, and K_mm and K_mn of every RBF leaf by
    rbf_gram.cu), finite; every field within the serving gate of the same
    model on the CPU in float64 on the first CHECK_ROWS rows, and within
    1e-5 of each field's largest value of ``predict_batched``'s on all rows;
    a second call on CLI_SECOND_ROWS rows with the same launches and the same
    rows. Returns the served call's counts."""
    from zigp_tpu_torch.io.export import _predict_dict_fn
    from zigp_tpu_torch.ops.cuda import chol_inv as ci

    sizes = [Z.shape[0] for Z in first_gp(model).Zs]
    want = {"chol_inv_by_n": {n: 1 for n in sizes if n <= ci.MAX_N},
            "chol_inv_blocked_by_n": {n: 1 for n in sizes if n > ci.MAX_N}, "rbf_gram": per_step_launches(model)[0]}
    calls = []
    for rows in (X, X[:CLI_SECOND_ROWS]):
        zero_counts()
        out = served_fields(kind, served(rows))
        torch.cuda.synchronize()
        calls.append((out, read_counts()))
    for out, counts in calls:
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"exported {name}: launches a call {got}, expected {want}")
        bad = [k for k, v in out.items() if not np.isfinite(v).all()]
        if bad:
            raise AssertionError(f"exported {name}: non-finite {bad}")
    (out, counts), (second, _) = calls
    Xc = X[:CHECK_ROWS]
    ref = {}
    for dt in (torch.float64, torch.float32):
        cpu = copy.deepcopy(model).to(device="cpu", dtype=dt)
        with torch.no_grad():
            ref[dt] = served_fields(kind, {k: (torch.stack(v) if isinstance(v, tuple) else v).numpy() for k, v in
                                           _predict_dict_fn(cpu, kind)(torch.as_tensor(Xc, dtype=dt)).items()})
    live = cli_live(kind, model, X)
    for k in out:
        e_card = rel(out[k][:CHECK_ROWS], ref[torch.float64][k])
        e_cpu = rel(ref[torch.float32][k], ref[torch.float64][k])
        tol = max(3.0 * e_cpu, 1e-5)
        scale = float(np.abs(live[k]).max())
        d_live = float(np.abs(out[k] - live[k]).max()) / scale
        d_second = float(np.abs(second[k] - out[k][:CLI_SECOND_ROWS]).max()) / scale
        log(f"exported {name}: {k:6s} card f32 vs cpu f64 {e_card:.3e}, cpu f32 vs cpu f64 {e_cpu:.3e} (tol "
            f"{tol:.3e}); vs predict_batched {d_live:.3e} of the field's largest value (tol 1e-5); second call at "
            f"{CLI_SECOND_ROWS} rows {d_second:.3e} (bits equal {bool((second[k] == out[k][:CLI_SECOND_ROWS]).all())})")
        if not (e_card <= tol and d_live <= 1e-5 and d_second <= 1e-5):
            raise AssertionError(f"exported {name}: {k} off (cpu f64 {e_card:.3e}, predict_batched {d_live:.3e}, "
                                 f"second call {d_second:.3e})")
    log(f"exported {name}: {X.shape[0]} rows in one call: chol_inv.cu by n {counts['chol_inv_by_n']}, "
        f"chol_inv_cluster.cu by n {counts['chol_inv_blocked_by_n']}, rbf_gram {counts['rbf_gram_by_shape']}; "
        f"the call at {CLI_SECOND_ROWS} rows the same launches")
    return counts


def time_artifact(name, kind, model, served, X, card) -> dict:
    """Points/s of one served call on all rows against ``predict_batched``'s
    graphed path on the same rows (both ending in the copy to the host),
    median of 5, in turns."""
    paths = {"artifact": lambda: served(X), "predict_batched": lambda: cli_live(kind, model, X)}
    for fn in paths.values():
        fn()
    times = {path: [] for path in paths}
    for rep in range(5):
        for path in (paths if rep % 2 == 0 else list(paths)[::-1]):
            t0 = time.perf_counter()
            paths[path]()
            times[path].append(time.perf_counter() - t0)
    pts = {path: X.shape[0] / float(np.median(t)) for path, t in times.items()}
    log(f"time exported {name}: {X.shape[0]} rows, artifact {pts['artifact']:.1f} points/s "
        f"{[round(X.shape[0] / t) for t in times['artifact']]}, predict_batched graphed "
        f"{pts['predict_batched']:.1f} points/s {[round(X.shape[0] / t) for t in times['predict_batched']]} "
        f"(median of 5, in turns; {card})")
    return pts


def phase_cli(split, card) -> dict:
    """The port's command line in process (``cli.main``) on the card, on
    ``rain_split(split)`` written as a pptr pickle (``save_pptr``), fold 1
    of its KFold protocol, each configuration in a workdir of its own:
    ``onoff`` with the reference preset (the flagship), the best preset (the
    champion) and ``--grid 105x250 --batch 8192``, and ``classifier
    --preset best``, CLI_STEPS steps each (the gram kernel on: the CLI's
    rule on the card); ``predict --samples 256`` on the flagship (y_samples
    (256, N, 1) finite, its sample mean summed over the rows within 5
    standard errors of the sampler's mean and of gfmean); ``export`` of each, loaded and
    served (``check_artifact``), timed against ``predict_batched``; then
    ``cv --split forecast --covariates --origins 2`` of the classifier and
    the joint hurdle at CLI_FORECAST_STEPS steps (every aggregate finite,
    ``rbf_gram.cu`` launched at D = 5 on the exogenous factor). The counts
    are zeroed before the trainings and read after the forecast run; each
    served call is counted on its own. Returns the counts, the served calls'
    counts, the points/s and the walls."""
    import argparse
    import contextlib
    import io
    import pickle
    import tempfile

    from zigp_tpu_torch.experiments import cli, runners
    from zigp_tpu_torch.io.datasets import save_pptr
    from zigp_tpu_torch.io.export import load_predictor

    quiet = lambda s: None
    walls, served_counts, pts = {}, {}, {}
    X = np.asarray(split.Xtrain[:ROWS])
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = save_pptr(rain_split(split), os.path.join(tmp, "pptr.pickle"))
        fold = cli._load_fold(argparse.Namespace(data=data, fold=1))
        wd = lambda name: os.path.join(tmp, name.replace(" ", "_"))
        logs = io.StringIO()  # the CLI logs to stdout: kept out of the script's output

        def run(name, argv):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(logs):
                rc = cli.main(argv + ["--data", data])
            torch.cuda.synchronize()
            walls[name] = round(time.perf_counter() - t0, 1)
            if rc != 0:
                raise AssertionError(f"cli {name}: exit code {rc}")

        zero_counts()
        for name, (kind, flags) in CLI_RUNS.items():
            run(f"{kind} {name}", [kind, *flags, "--workdir", wd(name), "--iters", str(CLI_STEPS), "--scan-inner",
                                   "50"])
        run("predict flagship", ["predict", "--model", "onoff", *CLI_RUNS["flagship"][1], "--samples",
                                 str(CLI_SAMPLES), "--workdir", wd("flagship")])
        for name, (kind, flags) in CLI_RUNS.items():
            run(f"export {name}", ["export", "--model", kind, *flags, "--workdir", wd(name)])
        t0 = time.perf_counter()
        run("cv forecast", [*CLI_FORECAST, "--workdir", wd("forecast")])
        forecast_wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = read_counts()
        with open(os.path.join(wd("flagship"), "1", "predictions_onoff.pickle"), "rb") as f:
            preds = pickle.load(f)
        with open(os.path.join(wd("forecast"), "cv_summary.json")) as f:
            summary = json.load(f)

        # the predictive samples: E[y*] = Φ(z)·fmean, pgmean = Φ̃(z) the clipped gate
        y, p = preds["y_samples"], preds["pred_test"]
        N = fold.Xtest.shape[0]
        if y.shape != (CLI_SAMPLES, N, 1) or not np.isfinite(y).all():
            raise AssertionError(f"predict: y_samples {y.shape}, expected ({CLI_SAMPLES}, {N}, 1), finite")
        se = np.sqrt(np.sum(y.var(0, ddof=1)) / CLI_SAMPLES)
        mean = (p["pgmean"] - 1e-3) / (1 - 2e-3) * p["fmean"]
        z = float(np.sum(y.mean(0) - mean) / se)
        z_clipped = float(np.sum(y.mean(0) - p["gfmean"]) / se)
        log(f"cli predict --samples {CLI_SAMPLES}: y_samples {y.shape}, finite; sum over rows of (sample mean - "
            f"Φ(z)·fmean) = {z:.2f} standard errors, against gfmean (the clipped gate Φ̃ = Φ·(1 − 2e-3) + 1e-3) "
            f"{z_clipped:.2f} (gate 5 each)")
        if not (abs(z) <= 5 and abs(z_clipped) <= 5):
            raise AssertionError(f"predict: sample mean {z:.2f} standard errors off the sampler's mean, "
                                 f"{z_clipped:.2f} off gfmean")

        for name, (kind, _) in CLI_RUNS.items():
            served = load_predictor(os.path.join(wd(name), "1", f"export_{kind}.zigp"))
            model, step, _ = runners._restore_model(fold, kind, cli_config(name), os.path.join(wd(name), "1"), quiet,
                                                    use_kernel=True)
            served_counts[name] = check_artifact(name, kind, model, served, X)
            pts[name] = time_artifact(name, kind, model, served, X, card)
            del served, model

    bad = {m: [k for k, a in per.items() if not np.isfinite(a["mean"])] for m, per in summary.items()}
    bad = {m: v for m, v in bad.items() if v}
    d5 = {shape: k for shape, k in counts["rbf_gram_by_shape"].items() if shape[3] == 5}
    log(f"cli cv --split forecast --covariates --origins 2 (classifier, hurdlej; {CLI_FORECAST_STEPS} steps): "
        f"classifier auc {summary['classifier']['test_auc']['mean']:.4f}; hurdlej rmse "
        f"{summary['hurdlej']['test_rmse']['mean']:.4f}, crps {summary['hurdlej']['test_crps']['mean']:.4f}; "
        f"rbf_gram at D = 5 {d5}; wall {forecast_wall:.1f} s; {card}")
    if bad or not d5:
        raise AssertionError(f"cli forecast: non-finite aggregates {bad}, rbf_gram launches at D = 5 {d5}")
    wall = time.perf_counter() - t_start
    log(f"cli phase: walls {json.dumps(walls)}, total {wall:.1f} s; launches chol_inv.cu by (G, n) "
        f"{counts['chol_inv_by_batch']}, cluster {counts['chol_inv_blocked_by_batch']}; {card}")
    return {"counts": counts, "served": served_counts, "pts": pts, "walls": walls, "wall": wall}


def cli_rows(ci, rg, res: dict, card) -> list:
    """The kernels-line rows of the CLI phase's paths: ``chol_inv.cu`` and
    the cluster kernel at each (G, n) of the exported programs' served calls
    and of the forecast run; ``rbf_gram`` at each shape of the served calls,
    and at D = 5 (the exogenous factor) of the forecast run."""
    served = {f"exported {name}": counts for name, counts in res["served"].items()}
    rows = stacked_chol_rows(ci, {**served, "cli training, export and forecast": res["counts"]}, card,
                             label="cli", min_G=1)
    d5 = {k: v for k, v in res["counts"]["rbf_gram_by_shape"].items() if k[3] == 5}
    rows += gram_rows(rg, {**served, "cli forecast D=5": {"rbf_gram_by_shape": d5}}, card)
    return rows


CHOL_INV_SOURCE = "zigp_tpu_torch/ops/cuda/csrc/chol_inv.cu"
CHOL_INV_REPLACES = "zigp_tpu/ops/pallas/chol_inv.py:339"


def stacked_chol_rows(ci, path_counts: dict, card, label: str = "stack", min_G: int = 3) -> list:
    """The kernels-line rows of ``chol_inv.cu`` and the cluster kernel at each
    batch (G, n) with G >= ``min_G`` launched on the paths (the stack's:
    G <= 2 are the single models' rows), with the launches of each path: ms
    per call with the host, device ms (CUDA graph), the plain version's ms,
    torch.linalg's, the bound, the largest difference from the plain
    version."""
    shapes = {}
    for path, counts in path_counts.items():
        for key, kernel in (("chol_inv_by_batch", "chol_inv"), ("chol_inv_blocked_by_batch", "chol_inv_blocked")):
            for (G, n), k in counts[key].items():
                if G >= min_G:
                    shapes.setdefault((kernel, G, n), {})[path] = k
    rows = []
    for (kernel, G, n), paths in sorted(shapes.items()):
        K = torch.as_tensor(batched_grams(n, G), device=DEVICE)
        if kernel == "chol_inv":
            kern, source, replaces, name = (lambda: ci.chol_inv_cuda(K)), CHOL_INV_SOURCE, CHOL_INV_REPLACES, "chol_inv"
        else:
            kern, source, replaces = (lambda: ci.chol_inv_blocked(K)), CLUSTER_SOURCE, CLUSTER_REPLACES
            name = f"chol_inv_cluster {ci.blocked_route(n)}"
        plain = lambda: ci.chol_inv_plain(K, ci.NB)
        with torch.inference_mode():
            ms, device_ms = cuda_ms(kern, reps=200), graph_ms(kern)
            plain_ms = cuda_ms(plain, reps=3, warmup=1)
            lib_ms = cuda_ms(lambda: library_chol_inv(K), reps=200)
            err = max(float((a - b).abs().max()) for a, b in zip(kern(), plain()))
        b_ms, b_by = bound_ms(n, G)
        launches = sum(paths.values())
        where = ", ".join(f"{p} {k}" for p, k in paths.items())
        kname = f"{name} n={n} G={G} ({label}: {where})"
        log(f"time {kname}: kernel {ms:.4f} ms, device {device_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.linalg "
            f"{lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), launches {launches}, max |kernel - plain| {err:.3e}; "
            f"{card}")
        rows.append({"name": kname, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
                     "max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms})
    return rows


# --- phase 16: the kernel zoo on the Kronecker path, and the toy -----------------

ZOO_PERIOD = 0.001  # --kernel-period of the zoo setting that wins on the reference's protocol (RESULTS.md:299-315)
ZOO_STEPS = 100  # two blocks of 50: one eager, one replay
TOY_GATE_ITERS = 50
# L-BFGS iterations of each full toy run, for the script's time: the default
# 8000 (about 5,000 to convergence on the synthetic set) takes about 90 s on
# an H100 in float64, at about 14 ms an evaluation
TOY_MAXITER = 1000
TOY_TIMEOUT = 300  # seconds for each toy run of the command line


def zoo_cfg(base, family, **kw):
    """``base`` with both GPs' temporal factors of ``family`` (a zoo name or
    spec; the period ZOO_PERIOD where it has a periodic atom), the command
    line's ``--kernel-temporal FAMILY [--kernel-period P]``."""
    period = (ZOO_PERIOD,) if "periodic" in family else ()
    zoo = lambda ki: dataclasses.replace(ki, family=family, period=period)
    return dataclasses.replace(base, fk_temporal=zoo(base.fk_temporal), gk_temporal=zoo(base.gk_temporal), **kw)


def graphed_block(cfg, model, X, Y):
    """A block of 50 device-sampled steps of ``model`` captured after one
    eager warm-up block on a side stream: (staged blocks, the block)."""
    from zigp_tpu_torch.ops.cuda.graphs import on_side_stream
    from zigp_tpu_torch.training import DataSet, make_graphed_scan_step, make_scan_train_step
    from zigp_tpu_torch.training.scan import StagedBlocks

    opt = optimizer_for(model, cfg)
    st = StagedBlocks(DataSet(X, Y), "device", cfg.batch_size, 50, device=DEVICE, dtype=torch.float32)
    st.fill(0)
    on_side_stream(lambda: make_scan_train_step(opt)(model, st.Xs, st.Ys))
    return st, make_graphed_scan_step(opt, model, st.Xs, st.Ys)


def time_twins(name, cases: dict, split, card) -> dict:
    """Steps/s of each case's graphed block of 50 (cases: {label: (cfg,
    model)}), one replay a pass, median of 3 passes in turns, host clock
    around work that ends in a synchronise."""
    runs = {label: graphed_block(cfg, model, split.Xtrain, split.Ytrain) for label, (cfg, model) in cases.items()}
    rates = {label: [] for label in cases}
    for rep in range(3):
        for label in (list(cases) if rep % 2 == 0 else list(cases)[::-1]):
            st, block = runs[label]
            st.fill(1 + rep)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = block()
            torch.cuda.synchronize()
            rates[label].append(50 / (time.perf_counter() - t0))
            if not torch.isfinite(losses).all():
                raise AssertionError(f"time {name} {label}: non-finite losses")
    med = {label: float(np.median(r)) for label, r in rates.items()}
    log(f"time training {name}: " + ", ".join(
        f"{label} {med[label]:.1f} steps/s {[round(v, 1) for v in rates[label]]} (block graph: "
        f"{runs[label][1].graph.describe()})" for label in cases) + f" (graphed blocks of 50, median of 3, in turns; "
        f"{card})")
    return med


def time_serving_twins(name, models: dict, X, card) -> dict:
    """predict_batched points/s of each model (its kept chunk graph, batch
    4096), median of 5 passes in turns."""
    from zigp_tpu_torch.experiments.runners import predict_batched

    paths = {label: (lambda m=m: predict_batched(m.predict, X, batch=4096, device=DEVICE)) for label, m in
             models.items()}
    times = {label: [] for label in paths}
    with torch.inference_mode():
        for fn in paths.values():
            fn()
        for rep in range(5):
            for label in (list(paths) if rep % 2 == 0 else list(paths)[::-1]):
                t0 = time.perf_counter()
                paths[label]()
                times[label].append(time.perf_counter() - t0)
    pts = {label: X.shape[0] / float(np.median(t)) for label, t in times.items()}
    log(f"time serving {name}: " + ", ".join(f"{label} {v:.1f} points/s" for label, v in pts.items())
        + f" ({X.shape[0]} rows at batch 4096, median of 5, in turns; {card})")
    return pts


def phase_zoo(ci, split, card) -> dict:
    """The kernel zoo on the Kronecker path at full width, the gram kernel
    on: the flagship with a ``periodic*rbf`` temporal factor (period 0.001)
    trained through ``train_onoff_pptr`` (two blocks of 50, launches per step
    exact, the trained model's f32 loss and gradients against CPU f64), 10
    graphed steps against 10 eager, 65,536 rows served through
    ``predict_batched`` under the serving gate, exported and served once
    (every field within 1e-5 of ``predict_batched``), and its steps/s and
    points/s against the RBF flagship; the 105 × 250 grid at B = 8192 with a
    ``matern32`` temporal factor (the cluster kernel factors its n = 250
    gram), two blocks of 50 with exact launches, steps/s against the RBF
    grid. Returns the counts by path and the rates."""
    import tempfile

    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.experiments.configs import OnOffPptrConfig
    from zigp_tpu_torch.io.export import export_predictor, load_predictor

    flag = OnOffPptrConfig()
    zoo = zoo_cfg(flag, "periodic*rbf")
    train = dict(num_iter=ZOO_STEPS, scan_inner=50, sampler="device", log_every=50)
    counts = {"zoo flagship train": phase_train("flagship periodic*rbf", zoo_cfg(flag, "periodic*rbf", **train),
                                                split, check=True)[1]}
    graph_err = phase_graph_ab("flagship periodic*rbf", zoo, split)
    model, X, by_n, _ = phase_serving(ci, "flagship periodic*rbf", zoo, split, 4096, use_kernel=True)
    serve = {"chol_inv_by_n": by_n}
    with tempfile.TemporaryDirectory() as d:
        path = export_predictor(model, "onoff", X.shape[1], os.path.join(d, "zoo.zigp"))
        counts["zoo flagship exported"] = check_artifact("flagship periodic*rbf", "onoff", model,
                                                         load_predictor(path), X)
    rbf_twin = perturbed(build_onoff_pptr(flag, split, device=DEVICE, use_kernel=True), seed=1)
    rates = {"serving": time_serving_twins("flagship", {"periodic*rbf": model, "rbf": rbf_twin}, X, card)}
    del model, rbf_twin

    make = lambda cfg: (cfg, build_onoff_pptr(cfg, split, device=DEVICE, use_kernel=True))
    rates["flagship"] = time_twins("flagship", {"periodic*rbf": make(zoo), "rbf": make(flag)}, split, card)
    grid = scale_train_cfg()
    counts["zoo grid train"] = phase_train("scale 105x250 B=8192 matern32", zoo_cfg(grid, "matern32", **train),
                                           split)[1]
    rates["grid"] = time_twins("scale 105x250 B=8192", {"matern32": make(zoo_cfg(grid, "matern32")),
                                                        "rbf": make(grid)}, split, card)
    for k, (a, b) in {"flagship": ("periodic*rbf", "rbf"), "grid": ("matern32", "rbf"),
                      "serving": ("periodic*rbf", "rbf")}.items():
        rates[k]["ratio"] = rates[k][a] / rates[k][b]
    log(f"zoo: steps/s and points/s against the RBF twins {json.dumps(rates)}; graph A/B {graph_err:.3e}; {card}")
    return {"counts": counts, "serve": serve, "rates": rates}


def zoo_rows(ci, rg, zoo: dict, card) -> list:
    """The kernels-line rows of the zoo paths: ``chol_inv.cu`` at each n
    the zoo flagship launched it (training, serving, the exported call) and
    the grid's n = 105, the cluster kernel at the grid's n = 250, and
    ``rbf_gram`` at every shape the zoo training launched."""
    counts = zoo["counts"]
    by_n = {}
    for c in [*counts.values(), zoo["serve"]]:
        for n, k in c["chol_inv_by_n"].items():
            by_n[n] = by_n.get(n, 0) + k
    rows = []
    for n, launches in sorted(by_n.items()):
        ms, device_ms, plain_ms, lib_ms, err = time_chol_inv(ci, n)
        b_ms, b_by = bound_ms(n, 2)
        kname = f"chol_inv n={n} G=2 (zoo: flagship periodic*rbf, 105x250 matern32)"
        log(f"time {kname}: kernel {ms:.4f} ms, device {device_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.linalg "
            f"{lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), launches {launches}, max |kernel - plain| {err:.3e}; "
            f"{card}")
        rows.append({"name": kname, "route": "cuda", "source": CHOL_INV_SOURCE, "replaces": CHOL_INV_REPLACES,
                     "launches": launches, "max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    rows += blocked_rows(ci, counts["zoo grid train"]["chol_inv_blocked_by_n"], {}, card,
                         path="zoo 105x250 matern32 training")
    rows += gram_rows(rg, {name: c for name, c in counts.items() if name.endswith("train")}, card)
    return rows


def toy_cli(args, data_dir, **popen):
    """``python -m zigp_tpu_torch.experiments toy ARGS`` from the checkout,
    reading ``toydata.mat`` from ``data_dir`` (``ZIGP_DATA_DIR``)."""
    env = {**os.environ, "ZIGP_DATA_DIR": data_dir, "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, "-m", "zigp_tpu_torch.experiments", "toy", *args],
                            cwd=os.path.dirname(os.path.abspath(__file__)), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, **popen)


def toy_report(proc, what, t0) -> dict:
    """The toy run's output read to its end: initial and final ELBO, L-BFGS
    iterations and evaluations, the optimizer's and the run's seconds."""
    try:
        out, _ = proc.communicate(timeout=TOY_TIMEOUT)
    finally:
        proc.kill()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"toy {what}: exit {proc.returncode}: {out[-2000:]}")
    lines = {line.split(":")[0]: line for line in out.splitlines() if ":" in line}
    rep = {
        "initial_elbo": float(lines["initial ELBO"].split(":")[1]),
        "elbo": float(lines["final ELBO"].split(":")[1].split()[0]),
        "nit": int(lines["L-BFGS-B"].split()[1]),
        "nfev": int(lines["L-BFGS-B"].split()[3]),
        "optimizer_s": float(lines["final ELBO"].rsplit("optimizer", 1)[1].split()[0]),
        "wall_s": wall,
    }
    rep["ms_per_evaluation"] = 1e3 * rep["optimizer_s"] / rep["nfev"]
    if not (np.isfinite(rep["elbo"]) and rep["elbo"] > rep["initial_elbo"]):
        raise AssertionError(f"toy {what}: final ELBO {rep['elbo']} not above the initial {rep['initial_elbo']}")
    log(f"toy {what}: {json.dumps(rep)}")
    return rep


def toy_loss_and_grads(model, X, Y):
    raws = [p for _, p in model.named_parameters()]
    loss = model.loss(X, Y)
    grads = torch.autograd.grad(loss, raws)
    return float(loss.detach()), torch.cat([g.reshape(-1) for g in grads]).double().cpu().numpy()


def elbo_path(model, X, Y, xs) -> np.ndarray:
    """The ELBO at each of L-BFGS's iterates ``xs`` (flat raws in the
    model's parameter order, as ``scipy_optimize`` flattens them)."""
    raws = [p for _, p in model.named_parameters()]
    out = []
    with torch.no_grad():
        for x in xs:
            flat = torch.as_tensor(x, dtype=raws[0].dtype, device=raws[0].device)
            for p, part in zip(raws, torch.split(flat, [p.numel() for p in raws])):
                p.copy_(part.reshape(p.shape))
            out.append(float(model.elbo(X, Y)))
    return np.array(out)


def start_toy_reference():
    """A seeded synthetic toy-shaped set (``synthetic_toydata``) written as
    ``toydata.mat`` to a new directory, and the CPU float64 reference run of
    the command line on it (``toy --cpu-x64``, TOY_MAXITER iterations, one
    thread) started in a
    process of its own: (directory, process, start time)."""
    import tempfile

    from zigp_tpu_torch.io.datasets import save_toydata, synthetic_toydata

    d = tempfile.mkdtemp(prefix="zigp_toy_")
    save_toydata(*synthetic_toydata(seed=0), os.path.join(d, "toydata.mat"))
    return d, toy_cli(["--cpu-x64", "--maxiter", str(TOY_MAXITER)], d), time.perf_counter()


def phase_toy(card, data_dir, cpu_run, t_cpu) -> dict:
    """The toy workflow on ``data_dir``'s ``toydata.mat`` (``start_toy_
    reference``, whose CPU float64 run ``cpu_run`` is read last): on the
    card in float64 the initial ELBO and every raw's gradient within
    1e-10 relative of CPU float64, and the ELBO at each of the first
    TOY_GATE_ITERS L-BFGS iterates within 1e-6 of the |ELBO| where they end
    (the path crosses 0 on its way up); then ``python -m
    zigp_tpu_torch.experiments toy --dtype float64 --maxiter TOY_MAXITER``
    on the card through ``ZIGP_DATA_DIR``, and the float32 run in process;
    final ELBO, iterations, evaluations and wall time of each."""
    from zigp_tpu_torch.experiments.configs import ToyOnOffConfig
    from zigp_tpu_torch.experiments.toy import build_toy_model, run_toy
    from zigp_tpu_torch.io import datasets
    from zigp_tpu_torch.training import scipy_optimize

    x, y, _ = datasets.load_toydata(os.path.join(data_dir, "toydata.mat"))
    runs = {}
    for dev in (DEVICE, "cpu"):
        m, _, _ = build_toy_model(None, x, y, device=dev, dtype=torch.float64)
        X, Y = (torch.as_tensor(a, device=dev) for a in (x, y))
        loss, grad = toy_loss_and_grads(m, X, Y)
        xs = []
        _, res = scipy_optimize(m, lambda mm: mm.loss(X, Y), maxiter=TOY_GATE_ITERS,
                                options={"maxcor": ToyOnOffConfig().lbfgs_maxcor},
                                callback=lambda xk: xs.append(np.array(xk)))
        runs[dev] = (loss, grad, elbo_path(m, X, Y, xs), res.nit)
    (l_card, g_card, e_card, nit_card), (l_cpu, g_cpu, e_cpu, nit_cpu) = runs[DEVICE], runs["cpu"]
    e_loss = abs(l_card - l_cpu) / abs(l_cpu)
    e_grad = rel(g_card, g_cpu)
    n = min(len(e_card), len(e_cpu))
    # The ELBO crosses 0 on the way up (near iterate 35 on this set), where a
    # per-iterate relative gap is meaningless: each iterate's gap is taken
    # relative to the ELBO where the prefix ends.
    gaps = np.abs(e_card[:n] - e_cpu[:n])
    e_path = float(np.max(gaps) / abs(e_cpu[n - 1]))
    log(f"toy gate (card f64 vs cpu f64): initial loss {e_loss:.3e}, gradient {e_grad:.3e} (tol 1e-10); ELBO at "
        f"the first {n} L-BFGS iterates: largest gap {np.max(gaps):.3e} at iterate {int(np.argmax(gaps)) + 1}, "
        f"{e_path:.3e} of the last iterate's |ELBO| (tol 1e-6), per iterate relative {np.max(gaps / np.abs(e_cpu[:n])):.3e} "
        f"at most (at ELBO {e_cpu[int(np.argmax(gaps / np.abs(e_cpu[:n])))]:.4f}); iterations {nit_card} and "
        f"{nit_cpu}, ELBO after them {e_card[n - 1]:.6f} and {e_cpu[n - 1]:.6f}")
    if not (e_loss <= 1e-10 and e_grad <= 1e-10 and e_path <= 1e-6 and n == TOY_GATE_ITERS):
        raise AssertionError(f"toy gate: card f64 off CPU f64 (loss {e_loss:.3e}, gradient {e_grad:.3e}, iterates "
                             f"{e_path:.3e} over {n})")
    t0 = time.perf_counter()
    report = {"card f64": toy_report(toy_cli(["--dtype", "float64", "--maxiter", str(TOY_MAXITER)], data_dir),
                                     "card f64 (command line)", t0)}
    t0 = time.perf_counter()
    data_dir_was, datasets.DEFAULT_DATA_DIR = datasets.DEFAULT_DATA_DIR, data_dir  # as ZIGP_DATA_DIR sets it
    try:
        f32 = run_toy(ToyOnOffConfig(maxiter=TOY_MAXITER), device=DEVICE, dtype=torch.float32,
                      log_fn=lambda s: None)
    finally:
        datasets.DEFAULT_DATA_DIR = data_dir_was
    res = f32["result"]
    report["card f32"] = {"initial_elbo": f32["initial_elbo"], "elbo": f32["elbo"], "nit": res.nit, "nfev": res.nfev,
                          "optimizer_s": f32["seconds"], "wall_s": time.perf_counter() - t0,
                          "ms_per_evaluation": 1e3 * f32["seconds"] / res.nfev}
    log(f"toy card f32 (in process): {json.dumps(report['card f32'])}")
    report["cpu f64"] = toy_report(cpu_run, "cpu f64 (command line, one thread, from phase 16's start)", t_cpu)
    log(f"toy: {json.dumps(report)}; {card}")
    return report


# --- phase 17: the parallel layer: a one-rank NCCL mesh, two gloo ranks on the card, torchrun ------

PAR_INNER = 50
PAR_NCCL_STEPS = 150  # one eager warm-up block, then two replays with the all-reduce inside the graph
PAR_GLOO_STEPS = 100  # two blocks of 50 on each gloo rank
PAR_GATE = 1e-5  # the first step's loss and gradient against the one-rank card run, relative
PAR_MEMBER_GATE = 1e-4  # the floor of the member mesh's gate against the one-rank stack (phase 14's stack gate's)
PAR_TIMEOUT = 600  # seconds for the spawned gloo ranks and for the torchrun launch


def par_cfg(steps, **kw):
    """The flagship on the device sampler in blocks of PAR_INNER."""
    from zigp_tpu_torch.experiments.configs import OnOffPptrConfig

    return dataclasses.replace(OnOffPptrConfig(), num_iter=steps, scan_inner=PAR_INNER, sampler="device",
                               log_every=PAR_INNER, **kw)


def phase_nccl_mesh(split, card) -> dict:
    """The flagship through ``train_onoff_pptr`` with ``mesh_data=1`` on a
    one-rank NCCL process group (a FileStore in a temporary directory),
    against the same run with no mesh, each from a copy of one model:
    PAR_NCCL_STEPS steps, every block after the warm-up one replay with the
    gradient's and the losses' all-reduces captured in it. Gates: losses
    and raws bit-identical (a one-rank all-reduce leaves its buffer as it
    was, and the loss share is the loss over 1), the ``rbf_gram.cu`` and
    ``chol_inv.cu`` launches per step the no-mesh run's, exactly. Time:
    steps/s of the two replays (``FitResult.steps_per_sec``), median of 3
    runs each, in turns. The process group is destroyed at the end."""
    import tempfile

    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.experiments.runners import train_onoff_pptr
    from zigp_tpu_torch.parallel.distributed import initialize, shutdown

    base = build_onoff_pptr(par_cfg(PAR_NCCL_STEPS), split, device=DEVICE, use_kernel=True)
    per_step = per_step_launches(base)
    runs = {"plain": [], "mesh": []}
    with tempfile.TemporaryDirectory() as tmp:
        if not initialize(f"file://{os.path.join(tmp, 'store')}", 1, 0, backend="nccl"):
            raise AssertionError("nccl mesh: the process group did not start")
        try:
            for rep in range(3):
                for path in (("plain", "mesh") if rep % 2 == 0 else ("mesh", "plain")):
                    logs = []
                    cfg = par_cfg(PAR_NCCL_STEPS, mesh_data=1 if path == "mesh" else 0)
                    zero_counts()
                    res = train_onoff_pptr(cfg, split, model=copy.deepcopy(base), log_fn=logs.append)
                    torch.cuda.synchronize()
                    runs[path].append((res, read_counts(), logs))
        finally:
            shutdown()
    (mesh, mesh_counts, mesh_logs), (plain, plain_counts, _) = runs["mesh"][0], runs["plain"][0]
    if "mesh: 1-way data parallel" not in mesh_logs or not any(f"block graph of {PAR_INNER} steps" in line
                                                               for line in mesh_logs):
        raise AssertionError(f"nccl mesh: not a graphed mesh run: {mesh_logs}")
    for path, (res, counts, _) in (("mesh", runs["mesh"][0]), ("no mesh", runs["plain"][0])):
        check_launches(f"nccl mesh, {path}", counts, res.step_losses.numel(), per_step)
    same_raws = all(torch.equal(a, b) for a, b in zip(mesh.model.parameters(), plain.model.parameters()))
    if not (torch.equal(mesh.step_losses, plain.step_losses) and same_raws):
        raise AssertionError(f"nccl mesh: the one-rank mesh left the no-mesh run: losses "
                             f"{rel(mesh.step_losses.numpy(), plain.step_losses.numpy()):.3e}")
    rates = {path: [r[0].steps_per_sec for r in rs] for path, rs in runs.items()}
    rate = {path: float(np.median(v)) for path, v in rates.items()}
    log(f"nccl mesh: the flagship through train_onoff_pptr, mesh_data=1 on a one-rank NCCL group, "
        f"{PAR_NCCL_STEPS} steps (blocks of {PAR_INNER}, two replays with the all-reduces in the graph): losses and "
        f"raws bit-identical to the no-mesh graphed run; launches {counted_by_kernel(mesh_counts)} = the no-mesh "
        f"run's; steps/s of the replays {rate['mesh']:.1f} {[round(v, 1) for v in rates['mesh']]} against "
        f"{rate['plain']:.1f} {[round(v, 1) for v in rates['plain']]} with no mesh ({rate['mesh'] / rate['plain']:.3f}"
        f"x; median of 3 runs each, in turns); {card}")
    return {"steps_per_s": rate, "counts": mesh_counts}


def first_step(model, X, Y, mesh=None, tp=False):
    """One step's loss and gradient (every trainable raw's, in the model's
    order, as a vector) from ``model`` on the batch (X, Y): on a mesh this
    rank's share on its rows, the gradient summed over the data group (and
    under ``tp`` the optimizer placed first). Returns (loss, gradient,
    optimizer)."""
    from zigp_tpu_torch.parallel import replicate, tp_place
    from zigp_tpu_torch.parallel.mesh import row_block
    from zigp_tpu_torch.parallel.step import reduce_gradients, sharded_loss
    from zigp_tpu_torch.training import make_optimizer

    opt = make_optimizer(model, default_lr=1e-2)
    loss = lambda m, X, Y: m.loss(X, Y)  # noqa: E731
    if mesh is not None:
        if tp:
            opt = tp_place(mesh, model, opt)
        else:
            replicate(mesh, model)
        rows = row_block(mesh, X.shape[0])
        X, Y, loss = X[rows], Y[rows], sharded_loss(None, mesh)
    opt.zero_grad()
    value = loss(model, X, Y)
    value.backward()
    value = value.detach()
    if mesh is not None:
        reduce_gradients(opt, mesh)
        mesh.all_reduce_data(value)
    grad = torch.cat([p.grad.reshape(-1) for p in model.parameters() if p.requires_grad])
    return float(value), grad.double().cpu().numpy(), opt


def parallel_rank(rank, world, store, job, out):
    """One of the gloo ranks on ``cuda:0`` (spawned): the data-parallel and
    the tensor-parallel flagship (the first step's loss and gradient, the
    row-sharded state's bytes, PAR_GLOO_STEPS steps through
    ``train_onoff_pptr``, eager: gloo's collectives cannot be captured) and
    the member mesh (``fit_batched_scanned`` of the F = 5 stack, graphed on
    each rank), each run's launches counted on this rank; the findings
    pickled to ``out/par.{rank}.pkl``, or the traceback."""
    import datetime
    import pickle
    import traceback

    from zigp_tpu_torch.experiments.runners import train_onoff_pptr
    from zigp_tpu_torch.parallel import initialize_distributed, make_mesh
    from zigp_tpu_torch.parallel.distributed import shutdown
    from zigp_tpu_torch.training import fit_batched_scanned

    device = torch.device(job["device"])
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    res = {}
    initialize_distributed(f"file://{store}", world, rank, backend="gloo",
                           timeout=datetime.timedelta(seconds=PAR_TIMEOUT))
    try:
        devices = [device] * world
        model = lambda: copy.deepcopy(job["flagship"]).to(device)  # noqa: E731
        X, Y = (torch.as_tensor(a, device=device) for a in job["batch"])
        for name, shape, kw in (("dp", (world, 1), {"mesh_data": world}), ("tp", (1, world), {"mesh_model": world})):
            loss, grad, opt = first_step(model(), X, Y, make_mesh(*shape, devices=devices), tp=name == "tp")
            zero_counts()
            fit = train_onoff_pptr(par_cfg(PAR_GLOO_STEPS, **kw), job["split"], model=model(), log_fn=lambda s: None)
            sync()
            res[name] = {"loss": loss, "grad": grad, "counts": read_counts(), "losses": fit.step_losses.numpy(),
                         "raws": [p.detach().double().cpu().numpy() for p in fit.model.parameters()],
                         "steps_per_s": fit.steps_per_sec,
                         "owned_bytes": fit.optimizer.owned_bytes() if name == "tp" else None}
        members = [m.to(device) for m in copy.deepcopy(job["members"])]
        zero_counts()
        torch.distributed.barrier()  # both ranks' runs start together: the wall below is the mesh's
        t0 = time.perf_counter()
        fits = fit_batched_scanned(members, job["folds"], num_iter=PAR_GLOO_STEPS, batch_size=job["batch_size"],
                                   num_inner=PAR_INNER, learning_rate=job["lr"], seeds=list(range(len(members))),
                                   log_every_blocks=1, log_fn=lambda s: None, mesh=make_mesh(world, 1, devices=devices))
        sync()
        res["members"] = {"counts": read_counts(), "wall": time.perf_counter() - t0,
                          "steps_per_s": fits[3 * rank].steps_per_sec,  # one of its own
                          "raws": [[p.detach().double().cpu().numpy() for p in f.model.parameters()] for f in fits]}
    except Exception:
        res = {"error": traceback.format_exc()}
    finally:
        shutdown()
    with open(os.path.join(out, f"par.{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def phase_gloo_ranks(split, folds, card) -> dict:
    """Two gloo ranks on the one card (``devices=["cuda:0", "cuda:0"]``,
    spawned; ``parallel_rank``) against the one-rank card runs from the same
    models: the data-parallel flagship (gate: the first step's loss and
    gradient within PAR_GATE; report: the gap after PAR_GLOO_STEPS steps and
    the steps/s); the tensor-parallel flagship, 1 × 2 (gates: each rank's
    bytes of the row-sharded raws' owned copies and of their two moments
    half of the full state's, the first step within PAR_GATE); the member
    mesh over the flagship F = 5 stack, padded to 6 (gates: each member's
    raws within max(3 × the one-rank stack's largest distance from the
    members' own sequential runs, PAR_MEMBER_GATE) of the one-rank stack's
    (phase 14's stack gate, the same kind of difference: the same steps
    batched otherwise), each rank's
    ``chol_inv.cu`` and ``rbf_gram.cu`` launches those of one member's
    steps: one folded launch a factor; report: fold-steps/s against the
    one-rank stack). Every rank's launches of each run are one member's
    steps' or the single model's, exactly. Returns the kernels line's
    per-rank counts by path."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    from zigp_tpu_torch.experiments.builders import build_onoff_pptr
    from zigp_tpu_torch.experiments.runners import train_onoff_pptr
    from zigp_tpu_torch.training import DataSet, fit_batched_scanned, fit_scanned

    cfg = par_cfg(PAR_GLOO_STEPS)
    flagship = build_onoff_pptr(cfg, split, device=DEVICE, use_kernel=True)
    per_step = per_step_launches(flagship)
    members, _, datas = stack_members(cfg, folds, use_kernel=True)
    B = cfg.batch_size
    batch = (np.asarray(split.Xtrain[:B], dtype=np.float32), np.asarray(split.Ytrain[:B], dtype=np.float32))
    X, Y = (torch.as_tensor(a, device=DEVICE) for a in batch)
    one_loss, one_grad, _ = first_step(copy.deepcopy(flagship), X, Y)
    one = train_onoff_pptr(cfg, split, model=copy.deepcopy(flagship), log_fn=lambda s: None)
    one_raws = [p.detach().double().cpu().numpy() for p in one.model.parameters()]
    kw = dict(num_iter=PAR_GLOO_STEPS, batch_size=B, num_inner=PAR_INNER, learning_rate=cfg.indp_lr,
              log_every_blocks=1, log_fn=lambda s: None)
    stack_members_ = [copy.deepcopy(m) for m in members]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stack = fit_batched_scanned(stack_members_, datas, seeds=list(range(len(members))), **kw)
    torch.cuda.synchronize()
    stack_wall = time.perf_counter() - t0
    raws_of = lambda model: [p.detach().double().cpu().numpy() for p in model.parameters()]  # noqa: E731
    stack_raws = [raws_of(f.model) for f in stack]
    # phase 14's yardstick: how far the one-rank stack is from each member's
    # own sequential run (the same steps, batched otherwise)
    seq_gaps = [max(rel(a, b) for a, b in zip(stack_raws[f], raws_of(fit_scanned(
        copy.deepcopy(m), DataSet(*datas[f]), sampler="device", sampler_seed=f, **kw).model)))
        for f, m in enumerate(members)]
    member_tol = max(3.0 * max(seq_gaps), PAR_MEMBER_GATE)
    torch.cuda.synchronize()
    job = {"device": "cuda:0" if DEVICE == "cuda" else DEVICE, "flagship": copy.deepcopy(flagship).cpu(),
           "batch": batch, "split": split,
           "members": [copy.deepcopy(m).cpu() for m in members], "folds": datas, "batch_size": B, "lr": cfg.indp_lr}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.spawn(parallel_rank, args=(2, os.path.join(tmp, "store"), job, tmp), nprocs=2, join=False)
        deadline = time.perf_counter() + PAR_TIMEOUT
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError("gloo ranks: no end within the time limit")
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"par.{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    for r, res in enumerate(ranks):
        if "error" in res:
            raise AssertionError(f"gloo rank {r} failed:\n{res['error']}")
    out = {}
    for name in ("dp", "tp"):
        for r, res in enumerate(ranks):
            got = res[name]
            dl, dg = abs(got["loss"] - one_loss) / abs(one_loss), rel(got["grad"], one_grad)
            if not (dl <= PAR_GATE and dg <= PAR_GATE):
                raise AssertionError(f"gloo {name} rank {r}: first step loss {dl:.3e}, gradient {dg:.3e} > {PAR_GATE}")
            check_launches(f"gloo {name} rank {r}", got["counts"], PAR_GLOO_STEPS, per_step)
            out[f"{name} rank {r}"] = got["counts"]
        got = ranks[0][name]
        drift = (abs(float(got["losses"][-1]) - float(one.step_losses[-1])) / abs(float(one.step_losses[-1])),
                 max(rel(a, b) for a, b in zip(got["raws"], one_raws)))
        note = ""
        if name == "tp":
            full = {n: 3 * p.numel() * p.element_size() for n, p in flagship.named_parameters()}
            for r, res in enumerate(ranks):
                owned = res["tp"]["owned_bytes"]
                if not owned or any(2 * b != full[n] for n, b in owned.items()):
                    raise AssertionError(f"gloo tp rank {r}: owned bytes {owned}, full {full}")
            note = (f"; row-sharded state per rank (owned rows + two moments) "
                    f"{ {n: b for n, b in ranks[0]['tp']['owned_bytes'].items()} } bytes, half of one rank's")
        log(f"gloo {name}: the flagship on 2 ranks on {DEVICE}, first step loss and gradient within {PAR_GATE:.0e} of "
            f"the one-rank card run (rank 0: loss {abs(ranks[0][name]['loss'] - one_loss) / abs(one_loss):.3e}, "
            f"gradient {rel(ranks[0][name]['grad'], one_grad):.3e}); after {PAR_GLOO_STEPS} eager steps: loss gap "
            f"{drift[0]:.3e}, raws {drift[1]:.3e} (f32: the batch sums in another order; reported, not gated); "
            f"{ranks[0][name]['steps_per_s']:.1f} and {ranks[1][name]['steps_per_s']:.1f} steps/s on the two ranks; "
            f"launches per rank {counted_by_kernel(ranks[0][name]['counts'])}{note}; {card}")
    member_per_step = per_step_launches(members[0])
    for r, res in enumerate(ranks):
        check_launches(f"gloo member mesh rank {r}", res["members"]["counts"], PAR_GLOO_STEPS, member_per_step)
        out[f"member mesh rank {r}"] = res["members"]["counts"]
    gaps = [max(rel(a, b) for a, b in zip(got, want)) for got, want in zip(ranks[0]["members"]["raws"], stack_raws)]
    if not (len(gaps) == len(members) and max(gaps) <= member_tol):
        raise AssertionError(f"gloo member mesh: members against the one-rank stack {gaps} > {member_tol}")
    rates = [res["members"]["steps_per_s"] for res in ranks]
    fold_rate, one_fold_rate = len(members) * min(rates), len(members) * stack[0].steps_per_sec
    run_rate = len(members) * PAR_GLOO_STEPS / max(res["members"]["wall"] for res in ranks)
    one_run_rate = len(members) * PAR_GLOO_STEPS / stack_wall
    log(f"gloo member mesh: the flagship F = {len(members)} stack over 2 ranks (3 members each, one pad), graphed: "
        f"members' raws against the one-rank stack {['%.3e' % g for g in gaps]} (gate {member_tol:.3e}: 3 x the "
        f"one-rank stack's largest distance from the members' sequential runs {['%.3e' % g for g in seq_gaps]}, "
        f"at least {PAR_MEMBER_GATE:.0e}); "
        f"launches per rank {counted_by_kernel(ranks[0]['members']['counts'])}, by batch "
        f"{ranks[0]['members']['counts']['chol_inv_by_batch']} (one member's steps: one folded launch a factor); "
        f"replays' stack steps/s by rank {[round(v, 1) for v in rates]}: {fold_rate:.1f} fold-steps/s (the slower "
        f"rank's) against {one_fold_rate:.1f} for the one-rank stack ({fold_rate / one_fold_rate:.3f}x); whole runs "
        f"(warm-up, capture, {PAR_GLOO_STEPS} steps, the gather; both ranks started together) "
        f"{run_rate:.1f} fold-steps/s against {one_run_rate:.1f} ({run_rate / one_run_rate:.3f}x); spawn to end "
        f"{wall:.1f} s; {card}")
    return out


def start_torchrun(split, tmp):
    """Start ``python -m torch.distributed.run --standalone --nproc-per-node
    1 -m zigp_tpu_torch.experiments onoff --mesh-data 1`` for 100 steps with
    a workdir under ``tmp``, on ``rain_split(split)`` written there as a
    pptr pickle: (process, workdir, start time)."""
    from zigp_tpu_torch.io.datasets import save_pptr

    data = save_pptr(rain_split(split), os.path.join(tmp, "pptr.pickle"))
    wd = os.path.join(tmp, "runs")
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1", "-m",
            "zigp_tpu_torch.experiments", "onoff", "--mesh-data", "1", "--sampler", "device", "--iters", "100",
            "--device", DEVICE, "--data", data, "--workdir", wd]
    proc = subprocess.Popen(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                            env={**os.environ, "OMP_NUM_THREADS": "1"}, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, wd, time.perf_counter()


def finish_torchrun(proc, wd, t0, card) -> float:
    """Wait for ``start_torchrun``'s launch: it exits 0, rank 0 (the one
    rank) has written the results, finite, and its log says the mesh
    trained. Returns its wall time."""
    import pickle

    out, _ = proc.communicate(timeout=PAR_TIMEOUT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun onoff --mesh-data 1: exit {proc.returncode}\n{out[-4000:]}")
    with open(os.path.join(wd, "1", "results_onoff.pickle"), "rb") as f:
        results = pickle.load(f)
    with open(os.path.join(wd, "1", "modelsumm_onoff.log")) as f:
        summary = f.read()
    bad = non_finite({k: v for k, v in results.items() if k != "model"})
    if bad or "mesh: 1-way data parallel" not in summary or not results["losses"]:
        raise AssertionError(f"torchrun onoff --mesh-data 1: non-finite {bad}, or no mesh in its log")
    log(f"torchrun: onoff --mesh-data 1 --iters 100 under torch.distributed.run (one rank, NCCL) exited 0 in "
        f"{wall:.1f} s (beside the phase's other paths: its host scoring overlaps them); results written by "
        f"rank 0: test rmse {results['test_rmse']:.4f}, mae {results['test_mae']:.4f}, steps/s "
        f"{results['steps_per_sec']:.1f}; {card}")
    return wall


def phase_parallel(split, card) -> dict:
    """Phase 17: the torchrun launch started first (its data loading and
    host scoring take most of its wall), then the one-rank NCCL mesh and
    the two gloo ranks on the card, then the launch's check; every process
    started here is stopped and every process group destroyed."""
    import tempfile

    import torch.distributed as dist

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        proc, wd, t_run = start_torchrun(split, tmp)
        try:
            nccl = phase_nccl_mesh(split, card)
            t1 = time.perf_counter()
            counts = phase_gloo_ranks(split, cv_folds(split), card)
            t2 = time.perf_counter()
            wall = finish_torchrun(proc, wd, t_run, card)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if dist.is_initialized():
        raise AssertionError("phase 17 left a process group behind")
    log(f"phase 17: nccl mesh {t1 - t0:.1f} s, gloo ranks {t2 - t1:.1f} s, torchrun's end "
        f"{time.perf_counter() - t2:.1f} s more")
    return {"nccl": nccl, "counts": counts, "torchrun_s": wall}


def parallel_rows(ci, rg, par: dict, card) -> list:
    """The kernels-line rows of ``chol_inv.cu`` and ``rbf_gram.cu`` at the
    gloo ranks' shapes (each rank's B / 2 rows, the member mesh's folded
    batch), with rank 0's launches."""
    counts = {path: c for path, c in par["counts"].items() if path.endswith("rank 0")}
    rows = stacked_chol_rows(ci, counts, card, label="parallel, per rank", min_G=1)
    rows += gram_rows(rg, {f"parallel {p}": c for p, c in counts.items() if not p.startswith("member")}, card)
    rows += gram_rows(rg, {f"parallel {p}": c for p, c in counts.items() if p.startswith("member")}, card,
                      stacked=True)
    return rows


def memoize_inducing_init() -> None:
    """Memoize the builders' ``kron_inducing_init`` for this script: a pure
    function of the training rows, the grid and the seed (it seeds numpy
    itself), whose scipy kmeans (twenty restarts) takes 1–2 s of host time
    on a 90,720-row fold. The script builds the same fold's grid dozens of
    times; every build gets a fresh copy of the same arrays."""
    import hashlib

    from zigp_tpu_torch.experiments import builders

    init, memo = builders.kron_inducing_init, {}

    def memoized(Xtrain, *args, **kw):
        X = np.ascontiguousarray(Xtrain)
        key = (hashlib.blake2b(X.view(np.uint8), digest_size=16).hexdigest(), X.shape, X.dtype.str, args,
               tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = init(X, *args, **kw)
        return [np.array(Z) for Z in memo[key]]

    builders.kron_inducing_init = memoized


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
    mark = lambda what: log(f"elapsed {time.perf_counter() - t_start:.1f} s: {what} done")
    memoize_inducing_init()
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
    mark("kernel gates")

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
    mark("serving phases")

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
    mark("training phases")
    families = {name: phase_family(name, split) for name in FAMILIES}
    mark("family phases")
    trainers = {name: phase_trainer(name, cfg, split) for name, cfg in trainer_cfgs().items()}
    trainer_ab = {name: phase_trainer_ab(name, cfg, split, trainers[name]["model"])
                  for name, cfg in trainer_cfgs().items()}
    phase_natural_step(trainers["natgrad kron_joint"]["model"], trainer_cfgs()["natgrad kron_joint"], split)
    mark("other trainers' phases")
    folds = cv_folds(split)
    phase_stack_chol_gate(ci)
    phase_stack_f32_gate(folds)
    mark("member stack gates")
    stack_counts = {"member gate": phase_stack_members(folds)}
    mark("member stack against the sequential runs")
    stack_counts.update(phase_stack_paths(folds))
    mark("member stack paths")

    pts = {name: time_predict(name, m, X, batch, card, ref) for name, (m, X, _, ref, batch) in runs.items()}
    pts["scale 105x250 by solve route"] = time_serving_kron_mv(scale_model, scale_X, 4096, card)
    del scale_model, scale_X
    graphed_rates = time_graphed_training(split, card)
    route_rates = time_train_routes(split, card)
    time_panel_widths(card)
    time_blocked_routes(card)
    time_kron_instances(card)
    mark("on/off times")
    for name, fam in families.items():
        cfg = family_cfg(name)
        graphed_rates[f"family {name}"] = time_blocks(
            f"family {name}", lambda m=fam["model"]: copy.deepcopy(m), cfg, split.Xtrain,
            family_targets(name, split.Ytrain), 1, card, f"gram kernel {'on' if FAMILIES[name][1] else 'off'}")
        pts[f"family {name}"] = time_family_serving(name, fam["model"], fam["method"], fam["X"], card)
    mark("family times")
    trainer_rates = time_trainers(split, card)
    mark("other trainers' times")
    stack_rates = time_stack_paths(folds, card)
    pts["stack flagship F=5"], stack_counts["serving"] = phase_stack_serving(folds, card)
    mark("member stack times")
    fold_wall = phase_fold_protocol(split, card)
    mark("fold protocol")
    studies = phase_stack_studies(split, card)
    stack_counts["studies"] = studies["counts"]
    mark("the stack's studies")
    cli_res = phase_cli(split, card)
    mark("the command line")
    toy_dir, toy_cpu, t_toy = start_toy_reference()
    try:
        zoo = phase_zoo(ci, split, card)
        mark("the kernel zoo")
        toy = phase_toy(card, toy_dir, toy_cpu, t_toy)
        mark("the toy")
    finally:
        toy_cpu.kill()
        toy_cpu.wait()
        shutil.rmtree(toy_dir, ignore_errors=True)

    par = phase_parallel(split, card)
    mark("the parallel layer")

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
    kernels += family_rows(ci, rg, families, card)
    kernels += trainer_rows(ci, trainers, card)
    kernels += stacked_chol_rows(ci, stack_counts, card)
    kernels += gram_rows(rg, {f"stack {name}": counts for name, counts in stack_counts.items() if counts["rbf_gram"]},
                         card, stacked=True)
    kernels += cli_rows(ci, rg, cli_res, card)
    kernels += zoo_rows(ci, rg, zoo, card)
    kernels += parallel_rows(ci, rg, par, card)

    log(f"serving points/s: {json.dumps(pts)}; training steps/s, eager vs graphed: {json.dumps(graphed_rates)}; "
        f"graph A/B largest relative loss differences {json.dumps(graph_ab)}; "
        f"by chol_inv forward route: {json.dumps(route_rates)}; other trainers' steps/s {json.dumps(trainer_rates)}, "
        f"graph A/B {json.dumps(trainer_ab)}; fold protocol {fold_wall:.1f} s; "
        f"member stacks {json.dumps(stack_rates)}; the stack's studies {json.dumps(studies['walls'])}; "
        f"the command line's artifacts points/s {json.dumps(cli_res['pts'])}, walls {json.dumps(cli_res['walls'])}; "
        f"the zoo against the RBF twins {json.dumps(zoo['rates'])}; the toy {json.dumps(toy)}; "
        f"the one-rank NCCL mesh against no mesh {json.dumps(par['nccl']['steps_per_s'])}, torchrun "
        f"{par['torchrun_s']:.1f} s; "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
