"""Natural-gradient training of the Gaussian variational parameters.

Counterpart of ``zigp_tpu/training/natgrad.py:62-1057``: the three natural
steps (``natgrad_update_diag`` for q = N(m, diag s²), ``_mean_kron`` for the
mean under S = ⊗_p C_p C_pᵀ, ``_block_kron`` for the exact joint step on
(m, Σ_p) of one Kronecker factor), the γ schedule, the trainer (a natural
step on every GP's variational raws, one Adam at ``adam_lr`` on every other
trainable raw) and the production loop ``fit_natgrad_scanned``. The
formulas and safeguards are the JAX package's; the JAX docstrings derive
them.

Where the port differs in mechanism:

- The steps run batched over a leading dimension G. The trainer stacks the
  f and g GPs of a pair (G = 2) where their shapes match, so each
  factorization of the joint step is one ``chol_inv`` launch for both. On a
  member stack (``training.batched``) every raw carries the members' dim
  too, and the joint step's batch is the pair's GPs times the members: one
  launch for 2F matrices, every KL budget per matrix, so per member.
- Every Cholesky of the joint step (chol Σ_p with its inverse, chol A′ with
  its inverse, chol Σ′) is ``ops.linalg.chol_inv_forward``: on the card
  ``chol_inv.cu`` (n ≤ 238) or the cluster kernel, L⁻¹ in the same launch,
  NaN from the failing pivot where a matrix is not positive definite, as
  the safeguards need; the library route gives NaN too. The Cholesky
  pullback is ``ops.linalg.chol_vjp`` (matmuls with that L⁻¹). The KL
  refinement's ``lax.cond`` computes both candidates and selects.
- The gradients of the variational raws sit in a buffer of their own,
  untouched by the Adam's ``zero_nans``, so the natural step sees a NaN
  where the JAX step does and its fallbacks fire.
- A block of K steps is one CUDA-graph replay on the card
  (``training.scan.BlockRunner``). γ is a static (K,) device buffer copied
  before each replay; the factor p of the joint step at a block's step k is
  (first step + k) mod P, fixed in the graph, so a graph is captured for
  each residue of the block's first natural step mod P (one, when K and the
  warm-up are multiples of P). γ is computed on the host in float32, as the
  JAX package computes it even under x64 (libm's ``powf``, XLA's CPU pow),
  and enters the step as a float32 scalar, so the products of γ with
  constants round in float32 as they do in the JAX step.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
import time
from typing import Optional

import numpy as np
import torch

from ..io.convert import jax_key
from ..ops import linalg
from .loop import FitResult, block_for_interrupt, save_final
from .optim import GradBuffer, GroupedAdam


def _mT(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


def _sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last two dims, kept: one value per stacked matrix."""
    return torch.sum(x, dim=(-2, -1), keepdim=True)


def _all(x: torch.Tensor) -> torch.Tensor:
    return torch.all(torch.all(x, dim=-1, keepdim=True), dim=-2, keepdim=True)


def _chol(K: torch.Tensor):
    """(L, L⁻¹) of K read symmetrically (``jnp.linalg.cholesky`` symmetrizes
    its input), NaN where K is not positive definite."""
    return linalg.chol_inv_forward(0.5 * (K + _mT(K)))


def natgrad_update_diag(q_mu, q_sqrt, dL_dmu, dL_dsqrt, lr, *, max_var_growth: float = 10.0,
                        max_mean_step: float = 0.0):
    """One natural-gradient step on (m, s) of N(m, diag(s²)) from the loss
    gradients in the constrained m and s; returns (m, s). The per-step
    variance growth is capped at ``max_var_growth``×, the mean move at
    ``max_mean_step`` current σ (when > 0); non-finite entries keep their
    previous values. Elementwise, any leading dims."""
    s2 = torch.square(q_sqrt)
    dL_dS = dL_dsqrt / (2.0 * q_sqrt)
    theta1 = q_mu / s2
    theta2 = -0.5 / s2
    theta1_new = theta1 - lr * (dL_dmu - 2.0 * dL_dS * q_mu)
    theta2_new = torch.clamp(theta2 - lr * dL_dS, max=-1e-12)  # precision stays negative
    s2_new = torch.clamp(-0.5 / theta2_new, s2 / max_var_growth, s2 * max_var_growth)
    m_new = s2_new * theta1_new
    if max_mean_step:
        cap = max_mean_step * q_sqrt
        m_new = torch.clamp(m_new, q_mu - cap, q_mu + cap)
    m_new = torch.where(torch.isfinite(m_new), m_new, q_mu)
    s2_new = torch.where(torch.isfinite(s2_new), s2_new, s2)
    return m_new, torch.sqrt(s2_new)


def natgrad_update_mean_kron(q_mu, C_factors, dL_dmu, lr, *, max_mean_step: float = 0.0,
                             kl_cap: Optional[float] = None):
    """The exact natural step on the mean of N(m, S), S = ⊗_p C_p C_pᵀ fixed:
    m ← m − γ S ∇_m L, one factored Kronecker matvec. ``kl_cap`` rescales
    the step to at most that many nats of KL(q′‖q); ``max_mean_step`` caps
    the move in marginal σ; non-finite entries keep their previous values.
    q_mu, dL_dmu (..., M, 1), C_factors[p] (..., M_p, M_p)."""
    Cs = [torch.tril(C) for C in C_factors]
    step = linalg._apply_factor_mats([C @ _mT(C) for C in Cs], dL_dmu)
    scale = lr
    if kl_cap is not None:
        kl = 0.5 * lr * lr * _sum(dL_dmu * step)
        kl = torch.where(torch.isfinite(kl), torch.clamp(kl, min=1e-30), math.inf)
        scale = lr * torch.clamp(torch.sqrt(kl_cap / kl), max=1.0)
    m_new = q_mu - scale * step
    if max_mean_step:
        sigma = torch.sqrt(linalg.kron_diag([torch.sum(torch.square(C), dim=-1) for C in Cs]))[..., None]
        cap = max_mean_step * sigma
        m_new = torch.clamp(m_new, q_mu - cap, q_mu + cap)
    return torch.where(torch.isfinite(m_new), m_new, q_mu)


def natgrad_update_block_kron(q_mu, C_factors, p: int, dL_dmu, dL_dCp, lr, *, max_mean_step: float = 0.0,
                              max_var_growth: float = 10.0, kl_cap: Optional[float] = None):
    """The exact joint natural step on (m, Σ_p) of N(m, ⊗_q Σ_q), Σ_q =
    C_q C_qᵀ, the other factors held (``zigp_tpu/training/natgrad.py:
    158-362``, which derives it): the Cholesky pullback D = ∂L/∂Σ_p at the
    current Σ_p, the mean in exact delta form, the KL budget ``kl_cap`` in
    two passes (a quadratic pre-scale, then the exact factored KL), and the
    safeguards (positive definite, finite, marginal-variance growth within
    ``max_var_growth``×, else the previous (m, C_p)). Returns (m, C_p).

    Batched over a leading dim G: q_mu, dL_dmu (G, M, 1) or (M, 1),
    C_factors[q] (G, M_q, M_q) or (M_q, M_q), dL_dCp like C_factors[p]; ``lr``
    (γ) a float or a tensor (0-d or (G, 1, 1))."""
    if q_mu.ndim == 2:
        m, C = natgrad_update_block_kron(q_mu[None], [C[None] for C in C_factors], p, dL_dmu[None], dL_dCp[None],
                                         lr, max_mean_step=max_mean_step, max_var_growth=max_var_growth,
                                         kl_cap=kl_cap)
        return m[0], C[0]
    G = q_mu.shape[0]
    sizes = [C.shape[-1] for C in C_factors]
    M = math.prod(sizes)
    Mp = sizes[p]
    Mrest = M // Mp
    Cs = [torch.tril(C) for C in C_factors]
    Cp = Cs[p]

    def inv_from_tril(C):
        Ci = torch.linalg.solve_triangular(C, torch.eye(C.shape[-1], dtype=C.dtype, device=C.device).expand_as(C),
                                           upper=False)
        return _mT(Ci) @ Ci

    Rinv = [inv_from_tril(C) for q, C in enumerate(Cs) if q != p]
    Rmats = [C @ _mT(C) for q, C in enumerate(Cs) if q != p]

    def apply_R(mats, X):  # (⊗ mats) applied to the rows of X (G, Mp, Mrest)
        return _mT(linalg._apply_factor_mats(mats, _mT(X))) if mats else X

    def perm(v):  # (G, M, 1) -> (G, Mp, Mrest), factor p's index leading
        return torch.movedim(v.reshape(G, *sizes), 1 + p, 1).reshape(G, Mp, Mrest)

    def unperm(U):
        t = U.reshape(G, Mp, *[s for q, s in enumerate(sizes) if q != p])
        return torch.movedim(t, 1, 1 + p).reshape(G, M, 1)

    Mu = perm(q_mu)
    Sigma_p = Cp @ _mT(Cp)
    Lp, Cpi = _chol(Sigma_p)  # the canonical Cholesky of Σ_p and its inverse
    A = _mT(Cpi) @ Cpi
    MuRinv = apply_R(Rinv, Mu)

    # The model's C_p may have sign-flipped columns against the canonical
    # Cholesky; the loss sees C_p only through Σ_p, so flip the cotangent.
    d = torch.sign(linalg.masked_diag(Cp))
    d = torch.where(d == 0, torch.ones_like(d), d)
    Gbar = torch.tril(dL_dCp) * d[..., None, :]
    D = linalg.chol_vjp(Lp, Cpi, Gbar)
    D = 0.5 * (D + _mT(D))
    g1 = perm(dL_dmu) - (2.0 / Mrest) * (D @ MuRinv)
    step_dir = (2.0 / Mrest) * (D @ Mu) + apply_R(Rmats, g1)

    def map_back(gam):
        La, Lai = _chol(A + (2.0 * gam / Mrest) * D)
        Sigma_new = _mT(Lai) @ Lai
        return La, Sigma_new, Mu - gam * (Sigma_new @ step_dir)

    if kl_cap is not None:
        # (1) quadratic pre-scale, before A′ is ever factored
        SpD = Sigma_p @ D
        kl_cov_q = (lr * lr / Mrest) * _sum(SpD * _mT(SpD))
        dm0 = lr * (Sigma_p @ step_dir)
        kl_mean_q = 0.5 * _sum(dm0 * (A @ apply_R(Rinv, dm0)))
        kl_q = torch.clamp(kl_cov_q + kl_mean_q, min=1e-30)
        kl_q = torch.where(torch.isfinite(kl_q), kl_q, math.inf)
        lr = lr * torch.clamp(torch.sqrt(kl_cap / kl_q), max=1.0)

    La, Sigma_new, Mu_new = map_back(lr)

    if kl_cap is not None:
        # (2) the exact factored KL of the candidate; where it is over the
        # budget, map back once more at γ·√(cap/KL)
        dU = Mu_new - Mu
        quad = _sum(dU * (A @ apply_R(Rinv, dU)))
        logdet_old = -2.0 * torch.sum(torch.log(linalg.masked_diag(Cpi)), dim=-1)[..., None, None]
        logdet_new = -2.0 * torch.sum(torch.log(linalg.masked_diag(La)), dim=-1)[..., None, None]
        tr = _sum(A * Sigma_new)
        kl = 0.5 * (Mrest * tr - M + quad + Mrest * (logdet_old - logdet_new))
        kl = torch.where(torch.isfinite(kl), torch.clamp(kl, min=1e-30), math.inf)
        rescale = torch.clamp(torch.sqrt(kl_cap / kl), max=1.0)
        La2, Sigma2, Mu2 = map_back(lr * rescale)
        again = rescale < 1.0
        La = torch.where(again, La2, La)
        Sigma_new = torch.where(again, Sigma2, Sigma_new)
        Mu_new = torch.where(again, Mu2, Mu_new)

    Cp_new = _chol(Sigma_new)[0]
    m_new = unperm(Mu_new)

    growth = linalg.masked_diag(Sigma_new) / torch.clamp(linalg.masked_diag(Sigma_p), min=1e-30)
    ok = (
        _all(torch.isfinite(La))
        & _all(torch.isfinite(Cp_new))
        & _all(torch.isfinite(m_new))
        & torch.all(growth < max_var_growth, dim=-1)[..., None, None]
        & torch.all(growth > 1.0 / max_var_growth, dim=-1)[..., None, None]
    )
    if max_mean_step:
        diags = [linalg.masked_diag(Sigma_new) if q == p else torch.sum(torch.square(C), dim=-1)
                 for q, C in enumerate(Cs)]
        cap = max_mean_step * torch.sqrt(linalg.kron_diag(diags))[..., None]
        m_new = torch.clamp(m_new, q_mu - cap, q_mu + cap)
    return torch.where(ok, m_new, q_mu), torch.where(ok, Cp_new, Cp)


_POWF = None


def _powf(x: float, y: float) -> float:
    """The C library's float32 pow: the one XLA's CPU backend calls."""
    global _POWF
    if _POWF is None:
        fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
        fn.argtypes = [ctypes.c_float, ctypes.c_float]
        fn.restype = ctypes.c_float
        _POWF = fn
    return _POWF(x, y)


def gamma_schedule(step, *, gamma: float, warmup: int, gamma_init: float = 1e-4) -> np.ndarray:
    """The log-linear γ ramp from ``gamma_init`` to ``gamma`` over ``warmup``
    steps, then constant, at each of ``step`` (an int or an array): float32,
    the JAX package's values bit for bit."""
    step = np.asarray(step)
    if warmup <= 0:
        return np.full(step.shape, gamma, dtype=np.float32)
    frac = np.clip(step.astype(np.float32) / np.float32(warmup), np.float32(0.0), np.float32(1.0))
    base = np.float32(gamma / gamma_init)
    ramp = np.array([_powf(base, f) for f in frac.ravel()], dtype=np.float32).reshape(frac.shape)
    return np.float32(gamma_init) * ramp


def _is_variational(path: str, kron_joint: bool) -> bool:
    """Whether the natural step owns the raw at JAX path ``path`` (the JAX
    trainer's name rule): the covariance factors only in the joint mode."""
    if "q_sqrt_factors" in path:
        return kron_joint
    return any(k in path for k in ("q_mu", "q_sqrt", "u_fm", "u_gm", "u_fs_sqrt", "u_gs_sqrt"))


class NaturalGradientTrainer:
    """A natural step on every ``KronGP``'s variational raws, Adam at
    ``adam_lr`` on every other trainable raw (one group: the JAX trainer's
    ``optax.adam(adam_lr)``, which no per-parameter lr touches), bound to
    ``model``, whose raws it updates in place.

    The family of each GP's step: the joint block step on (q_mu, one factor
    of q_sqrt_factors) when ``kron_joint`` and the model has factored
    covariances, the mean step with the factors under Adam when it has them
    and not ``kron_joint``, the diagonal step on (q_mu, q_sqrt) otherwise.
    ``kl_cap`` None or ≤ 0 disables the KL budget. ``mesh``: data parallel
    (``parallel.step``): the loss is this rank's share of the minibatch's,
    and both gradient buffers are summed over the data group before the
    updates, which then run identically on every rank."""

    def __init__(self, model, *, gamma: float = 0.1, adam_lr: float = 1e-3, gamma_warmup: int = 0,
                 gamma_init: float = 1e-4, max_mean_step: float = 10.0, kron_joint: bool = False,
                 kl_cap: Optional[float] = 10.0, mesh=None):
        from ..models.kron import KronGP

        self.model = model
        self.mesh = mesh
        self.gps = [m for m in model.modules() if isinstance(m, KronGP)]
        self._kron_cov = any(gp.q_sqrt_factors is not None for gp in self.gps)
        self.kron_joint = bool(kron_joint) and self._kron_cov
        self.gamma = float(gamma)
        self.gamma_warmup = int(gamma_warmup)
        self.gamma_init = float(gamma_init)
        self.max_mean_step = float(max_mean_step)
        self.kl_cap = float(kl_cap) if kl_cap is not None and kl_cap > 0 else None

        trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        natural = [(n, p) for n, p in trainable if _is_variational(jax_key(n), self.kron_joint)]
        taken = {n for n, _ in natural}
        self.adam = GroupedAdam([{"label": "adam", "lr": float(adam_lr),
                                  "params": [(n, p) for n, p in trainable if n not in taken]}])
        self.natural = GradBuffer([p for _, p in natural])
        # the joint step's units: GPs stacked where their factor shapes match
        self.units = []
        if self.kron_joint:
            for gp in self.gps:
                for unit in self.units:
                    if unit[0].factor_sizes == gp.factor_sizes:
                        unit.append(gp)
                        break
                else:
                    self.units.append([gp])
        # the factor p of the step at index i is i mod P: a block's graph
        # depends on its first index mod the lcm of the units' P
        self.period = math.lcm(*(len(u[0].factor_sizes) for u in self.units)) if self.units else 1

    def gamma_at(self, step) -> np.ndarray:
        return gamma_schedule(step, gamma=self.gamma, warmup=self.gamma_warmup, gamma_init=self.gamma_init)

    def natural_step(self, gamma, step: int = 0) -> None:
        """The natural step of every GP, in place, from the gradients in its
        raws' ``.grad`` (this trainer's buffer). ``gamma`` a float or a 0-d
        tensor; ``step`` picks the factor of the joint step."""
        with torch.no_grad():
            if self.kron_joint:
                for unit in self.units:
                    self._joint_step(unit, gamma, step % len(unit[0].factor_sizes))
                return
            for gp in self.gps:
                m = gp.q_mu.raw
                if gp.q_sqrt_factors is not None:  # the step takes the lower triangles of the raws
                    m.copy_(natgrad_update_mean_kron(m, [C.raw for C in gp.q_sqrt_factors], m.grad, gamma,
                                                     max_mean_step=self.max_mean_step, kl_cap=self.kl_cap))
                    continue
                sq = gp.q_sqrt
                ds = sq.raw.grad / torch.clamp(torch.sigmoid(sq.raw), min=1e-12)  # through softplus
                m_new, s_new = natgrad_update_diag(m, sq.value, m.grad, ds, gamma, max_mean_step=self.max_mean_step)
                m.copy_(m_new)
                sq.raw.copy_(sq.bijector.inverse_tensor(s_new))

    def _joint_step(self, unit, gamma, p: int) -> None:
        # one batch of every GP of the unit: (U·F, ·) on a stack of F members
        stack = lambda ts: (lambda t: t.reshape(-1, *t.shape[-2:]))(torch.stack(list(ts)))
        m_new, Cp_new = natgrad_update_block_kron(
            stack(gp.q_mu.raw for gp in unit),
            [stack(torch.tril(gp.q_sqrt_factors[q].raw) for gp in unit) for q in range(len(unit[0].factor_sizes))],
            p,
            stack(gp.q_mu.raw.grad for gp in unit),
            stack(gp.q_sqrt_factors[p].raw.grad for gp in unit),
            gamma, max_mean_step=self.max_mean_step, kl_cap=self.kl_cap,
        )
        m_new = m_new.reshape(len(unit), *unit[0].q_mu.raw.shape)
        Cp_new = Cp_new.reshape(len(unit), *unit[0].q_sqrt_factors[p].raw.shape)
        for i, gp in enumerate(unit):
            gp.q_mu.raw.copy_(m_new[i])
            for q, C in enumerate(gp.q_sqrt_factors):
                C.raw.copy_(Cp_new[i] if q == p else torch.tril(C.raw))  # the JAX step writes back C.value

    def _loss(self, X, Y, factor_state=None) -> torch.Tensor:
        """The loss a step differentiates: the model's, or on a member
        stack one per member (``training.batched``), whose sum is
        differentiated."""
        return self.model.loss(X, Y) if factor_state is None else self.model.loss(X, Y, factor_state=factor_state)

    def _share(self, X, Y, factor_state=None) -> torch.Tensor:
        value = self._loss(X, Y, factor_state)
        return value if self.mesh is None else value / self.mesh.shape["data"]

    def _reduce(self, *buffers) -> None:
        if self.mesh is not None:
            for buf in buffers:
                self.mesh.all_reduce_data(buf.flat)

    def _factor_state(self):
        return self.model.factor_state()

    def full_step(self, X, Y, gamma, step: int = 0) -> torch.Tensor:
        """One step: the loss's gradients, Adam on its raws, then the natural
        step (which reads the factors after Adam, as the JAX step does)."""
        self.adam.zero_grad()
        self.natural.zero_()
        loss = self._share(X, Y)
        (loss.sum() if loss.ndim else loss).backward()
        self._reduce(self.adam.grads, self.natural)
        self.adam.step()
        self.natural_step(gamma, step)
        return loss.detach()

    def q_only_step(self, X, Y, gamma, step: int, factor_state) -> torch.Tensor:
        """The natural step alone at frozen hypers: gradients of the
        variational raws only, the factorization injected, Adam untouched."""
        self.natural.zero_()
        loss = self._share(X, Y, factor_state)
        (loss.sum() if loss.ndim else loss).backward(inputs=self.natural.params)
        self._reduce(self.natural)
        self.natural_step(gamma, step)
        return loss.detach()

    def block(self, Xs, Ys, gammas, start: int = 0, hyper_every: int = 0) -> torch.Tensor:
        """K steps over Xs (K, B, D), Ys (K, B, L) at γ ``gammas[k]``, step
        ``k`` indexed ``start + k``; with ``hyper_every`` in groups of one
        full step, ``factor_state()`` under ``torch.no_grad()`` and
        ``hyper_every − 1`` q-only steps. Losses (K,) on the device, summed
        over the data group on a mesh."""
        out = self._block(Xs, Ys, gammas, start, hyper_every)
        return out if self.mesh is None else self.mesh.all_reduce_data(out)

    def _block(self, Xs, Ys, gammas, start: int, hyper_every: int) -> torch.Tensor:
        K = Xs.shape[0]
        if not hyper_every:
            return torch.stack([self.full_step(Xs[k], Ys[k], gammas[k], start + k) for k in range(K)])
        if K % hyper_every:
            raise ValueError(f"dispatch length ({K}) must divide by hyper_every ({hyper_every})")
        losses = []
        for g0 in range(0, K, hyper_every):
            losses.append(self.full_step(Xs[g0], Ys[g0], gammas[g0], start + g0))
            with torch.no_grad():
                state = self._factor_state()
            for k in range(g0 + 1, g0 + hyper_every):
                losses.append(self.q_only_step(Xs[k], Ys[k], gammas[k], start + k, state))
        return torch.stack(losses)


def fit_natgrad_scanned(
    model,
    data,
    *,
    num_iter: int,
    batch_size: int,
    num_inner: int = 50,
    gamma: float = 0.1,
    gamma_warmup: int = 2000,
    gamma_init: float = 1e-4,
    adam_lr: float = 1e-3,
    adam_warmup: int = 0,
    max_mean_step: float = 10.0,
    kron_joint: bool = False,
    kl_cap: Optional[float] = 10.0,
    log_every_blocks: int = 4,
    log_fn=print,
    ckpt_manager=None,
    recover_on_nan: bool = True,
    metric_logger=None,
    resume: bool = False,
    sampler: str = "host",
    sampler_seed: int = 0,
    mesh=None,
    hyper_every: int = 0,
) -> FitResult:
    """Natural-gradient training in blocks of ``num_inner`` steps, with the
    γ ramp keyed to the natural phase (``zigp_tpu/training/natgrad.py:
    781-1057``): ``adam_warmup`` steps of all-raw Adam through
    ``fit_scanned`` first (on a fresh start), capped at half of ``num_iter``
    and the block at what is left; checkpoints of (model, the trainer's
    Adam) at global steps, one at the start of the natural phase; NaN
    restore; ``resume`` from the latest checkpoint (the host stream skipped
    past it, the device sampler's block ``ceil(step / num_inner)``); a
    resumed run already at ``num_iter`` returns its loss on the first
    training rows without training; Ctrl-C checkpoints and returns
    ``interrupted``; a non-finite loss at the end raises
    ``FloatingPointError``. ``hyper_every`` > 0: groups of one full step
    and ``hyper_every − 1`` natural q-only steps (device sampler only, a
    Kronecker model, dividing the block). On the card each block after the
    warm-up is one CUDA-graph replay. ``mesh``: data parallel, as
    ``fit_scanned``'s (the warm-up too): each rank on its rows of every
    batch, the gradients summed over the data group before the Adam and
    natural steps, the γ ramp and the warm-start identical on every rank;
    with ``hyper_every`` it raises, as the JAX package's does."""
    from .scan import BlockRunner, _agree, fit_scanned, mesh_blocks

    num_iter = int(num_iter)
    adam_warmup = min(int(adam_warmup), num_iter // 2)
    num_inner = max(1, min(int(num_inner), num_iter - adam_warmup))
    if hyper_every and num_inner % hyper_every:
        raise ValueError(f"num_inner ({num_inner}) must divide by hyper_every ({hyper_every}) — adjust scan_inner "
                         "or the step budget")
    if hyper_every and not hasattr(model, "factor_state"):
        raise ValueError("hyper_every requires a Kron-family model exposing factor_state()/loss(factor_state=...)")

    trainer = NaturalGradientTrainer(model, gamma=gamma, adam_lr=adam_lr, gamma_warmup=gamma_warmup,
                                     gamma_init=gamma_init, max_mean_step=max_mean_step, kron_joint=kron_joint,
                                     kl_cap=kl_cap, mesh=mesh)
    p0 = next(model.parameters())
    start_step = None
    if resume and ckpt_manager is not None:
        restored = ckpt_manager.restore_latest(model, trainer.adam)
        if restored is not None:
            start_step = restored[2]
            log_fn(f"resumed natgrad from checkpoint at step {start_step}")
            if sampler != "device" and start_step and hasattr(data, "skip"):
                data.skip(batch_size, start_step)

    if start_step is not None and start_step >= num_iter:
        # a completed run: training on would make resume non-idempotent
        log_fn("checkpoint is already at or past num_iter; nothing to train")
        final = float("nan")
        if hasattr(data, "arrays"):
            Xa, Ya = data.arrays
            b0 = min(batch_size, Xa.shape[0])
            with torch.no_grad():
                final = float(model.loss(torch.as_tensor(np.asarray(Xa[:b0]), dtype=p0.dtype).to(p0.device),
                                         torch.as_tensor(np.asarray(Ya[:b0]), dtype=p0.dtype).to(p0.device)))
        return FitResult(model=model, optimizer=trainer.adam, final_loss=final)

    if start_step is None:
        if adam_warmup:
            warm = fit_scanned(model, data, num_iter=adam_warmup, batch_size=batch_size,
                               num_inner=min(num_inner, adam_warmup), learning_rate=adam_lr, log_every_blocks=0,
                               log_fn=log_fn, sampler=sampler, sampler_seed=sampler_seed, mesh=mesh)
            if warm.interrupted:
                return warm
        start_step = adam_warmup

    num_iter = max(num_iter, start_step + num_inner)
    device_mode = sampler == "device"
    if mesh is not None:
        from ..parallel.mesh import replicate

        replicate(mesh, model)
    if hyper_every and (not device_mode or mesh is not None):
        raise ValueError("hyper_every (block-coordinate natgrad) requires sampler='device' and no mesh")
    if hyper_every and hyper_every < 2:
        raise ValueError(f"hyper_every must be >= 2 (got {hyper_every})")

    blocks, capture = mesh_blocks(mesh, data, sampler, batch_size, num_inner, p0, sampler_seed, log_fn)
    # float32 whatever the model's dtype: the JAX step's γ is a float32 scalar,
    # so its products with constants (γ², 2γ/M_rest) round in float32 there too
    gammas = torch.empty((num_inner,), dtype=torch.float32, device=p0.device)
    runners = {}

    def runner_for(first: int) -> BlockRunner:
        r = first % trainer.period
        if r not in runners:
            runners[r] = BlockRunner(lambda: trainer.block(blocks.Xs, blocks.Ys, gammas, r, hyper_every), blocks.Xs,
                                     capture=capture)
        return runners[r]

    if ckpt_manager is not None and _agree(mesh, ckpt_manager.latest_step() is None):
        ckpt_manager.save_at(start_step, model, trainer.adam)

    losses, all_losses = [], []
    num_blocks = max(1, -(-(num_iter - start_step) // num_inner))  # ceil: never fewer steps than asked
    t_start = time.perf_counter()
    timed_steps = 0
    steps_done = start_step
    restored_this_block = False
    in_block = False
    block_losses = None
    try:
        for b in range(num_blocks):
            restored_this_block = False
            in_block = True
            local = steps_done - adam_warmup  # the γ ramp runs on the natural phase's steps
            gammas.copy_(torch.from_numpy(trainer.gamma_at(np.arange(local, local + num_inner))))
            # ceil: past the warm-up's block indices when it is not a multiple of num_inner
            blocks.fill(-(-steps_done // num_inner) if device_mode else 0)
            runner = runner_for(local)
            block_losses = runner()
            all_losses.append(block_losses)
            prev_steps = steps_done
            steps_done += num_inner
            in_block = False
            nxt = runner_for(steps_done - adam_warmup)
            capture = nxt.wants_capture and b + 1 < num_blocks
            if b == 0 or capture:
                float(block_losses[-1])  # waits: the first block and the capture are not timed
                if capture:
                    log_fn(f"step {steps_done:>8d}  natgrad block graph of {num_inner} steps: "
                           f"{nxt.capture().graph.describe()}")
                t_start = time.perf_counter()
                timed_steps = 0
            else:
                timed_steps += num_inner

            is_log = log_every_blocks and b % log_every_blocks == 0
            ckpt_due = ckpt_manager is not None and ckpt_manager.crossed(prev_steps, steps_done)
            if is_log or ckpt_due:
                last = float(block_losses[-1])
                if not np.isfinite(last):
                    log_fn(f"step {steps_done:>8d}  NON-FINITE loss")
                    if ckpt_manager is not None and recover_on_nan:
                        restored = ckpt_manager.restore_latest(model, trainer.adam)
                        if restored is not None:
                            restored_this_block = True
                            log_fn(f"restored from checkpoint at step {restored[2]}")
                    continue
                if ckpt_due:
                    ckpt_manager.save_at(steps_done, model, trainer.adam)
                if is_log:
                    losses.append(last)
                    log_fn(f"step {steps_done:>8d}  loss {last:.6f}")
                    if metric_logger is not None:
                        metric_logger.log(steps_done, scalars={
                            "loss": last, "elbo": -last, "gamma": float(trainer.gamma_at(steps_done - adam_warmup))})
    except KeyboardInterrupt as ki:
        block_for_interrupt(model, log_fn, ki, mid_step=in_block)
        log_fn(f"interrupted at step {steps_done} — checkpointing for resume")
        if ckpt_manager is not None:
            last = float(block_losses[-1]) if steps_done > start_step else 0.0
            if np.isfinite(last):
                ckpt_manager.save_at(steps_done, model, trainer.adam)
            else:
                log_fn("interrupt state is non-finite — not checkpointed")
        elapsed = max(time.perf_counter() - t_start, 1e-12)
        return FitResult(model=model, optimizer=trainer.adam, losses=losses,
                         steps_per_sec=timed_steps / elapsed if timed_steps else 0.0, interrupted=True,
                         step_losses=torch.cat(all_losses).cpu() if all_losses else None)
    step_losses = torch.cat(all_losses).cpu()  # waits for the device
    elapsed = max(time.perf_counter() - t_start, 1e-12)
    final_loss = float(step_losses[-1])
    if not np.isfinite(final_loss) and not restored_this_block:
        raise FloatingPointError(
            f"fit_natgrad_scanned finished at step {steps_done} with a non-finite loss ({final_loss}); the trained "
            "state is unusable. Enable checkpointing (ckpt_manager) to get NaN recovery mid-run.")
    save_final(ckpt_manager, steps_done, restored_this_block, model, trainer.adam, log_fn)
    return FitResult(model=model, optimizer=trainer.adam, losses=losses,
                     steps_per_sec=timed_steps / elapsed if timed_steps else 0.0,
                     final_loss=final_loss if not restored_this_block else float("nan"), step_losses=step_losses)


__all__ = [
    "NaturalGradientTrainer",
    "fit_natgrad_scanned",
    "gamma_schedule",
    "natgrad_update_block_kron",
    "natgrad_update_diag",
    "natgrad_update_mean_kron",
]
