"""Plain PyTorch reference of the Kronecker on/off GP: its loss, gradients,
Adam steps and the 9 predictive fields.

The model (Hegde et al.'s zero-inflated on/off GP, the reference repository
hegdepashupati/zero-inflated-gp ``onofftf``): a signal GP f and a support GP
g, each with an RBF kernel that is a product of a spatial (lat, lon) and a
temporal factor, on a Kronecker inducing grid Z = Z_s × Z_t, diagonal
q(u) = N(m, diag(s²)), unwhitened; y ≈ Φ(g)·f + ε with the probit gate's
moments in closed form (the clipped CDF Φ̃ = Φ·(1 − 2e-3) + 1e-3 and the
closed-form lower bound on Owen's T), ε ~ N(0, σ²). The ELBO is
(N / B) Σ_b E_q[log p(y_b | ·)] − KL_f − KL_g, and the loss its negative.

It is written from those equations in the most direct form: the factor
grams, their Cholesky factors and triangular inverses, the Kronecker
products as two-sided products on the (M_s, M_t) grid. It imports nothing
of the program and takes nothing the program made: every value comes from
the benchmark's inputs (``harness.data``).

The gram of a factor is jittered as the configuration states for float32:
K + (jitter + relative · mean diag K)·I. Positive parameters are
softplus(raw) + 1e-6 (gpflow's ``positive`` transform), so the gradient and
the Adam steps are taken on the same unconstrained raws as the program's.

Precision: ``dtype`` float64 is the reference. ``products`` sets the
precision of the matrix products in two classes, as the program's solve
precision does: ``bulk`` (the products that grow with the batch: the
projections of K_mn and the grid contractions) and ``factor`` (the
factor-space products: the inverse's square, the q_mu solve). Each is
"exact" (the dtype's own), "tf32" (operands rounded to 10 fraction bits,
float32 accumulation: the tensor cores' TF32) or "bf16" (operands rounded
to bfloat16, float32 accumulation: one pass on the bf16 tensor cores). The
lower precisions are the controls the check has to fail. The grid contractions are
grouped as the conditional's factored contraction states them: first
(B, M_s)·(M_s, M_t), then one (1, M_t)·(M_t, 1) dot a row.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

LOWER = 1e-6
NAMES = [
    "{gp}.kernels.0.lengthscales.raw", "{gp}.kernels.0.variance.raw",
    "{gp}.kernels.1.lengthscales.raw", "{gp}.kernels.1.variance.raw",
    "{gp}.Zs.0.raw", "{gp}.Zs.1.raw", "{gp}.q_mu.raw", "{gp}.q_sqrt.raw",
]
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
FIELDS = ("gfmean", "gfvar", "gfmeanu", "fmean", "fvar", "gmean", "gvar", "pgmean", "pgvar")


def _exact_tf32():
    """Plain float32 products must not run in TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to nearest with 10 fraction bits (Veltkamp's split at 13
    bits of float32's 24), as the TF32 tensor cores read it."""
    c = x * 8193.0
    return c - (c - x)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "exact":
        return a @ b
    if precision == "tf32":
        return round_tf32(a.float()) @ round_tf32(b.float())
    if precision == "bf16":
        return a.float().to(torch.bfloat16).float() @ b.float().to(torch.bfloat16).float()
    raise ValueError(f"unknown product precision {precision!r}")


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x)) + LOWER


def softplus_inv(y) -> np.ndarray:
    ys = np.asarray(y, dtype=np.float64) - LOWER
    return ys + np.log(-np.expm1(-ys))


def leaf_names() -> List[str]:
    return [n.format(gp=gp) for gp in ("f", "g") for n in NAMES] + ["likelihood.variance.raw"]


def initial_raws(state: dict, dtype, device) -> Dict[str, torch.Tensor]:
    """The unconstrained values of ``state`` (``harness.data``), by the
    program's parameter names."""
    out = {}
    for gp in ("f", "g"):
        s = state[gp]
        vals = [softplus_inv(np.asarray(s["kernels"][0]["lengthscales"], dtype=np.float64)),
                softplus_inv(s["kernels"][0]["variance"]),
                softplus_inv(np.asarray(s["kernels"][1]["lengthscales"], dtype=np.float64)),
                softplus_inv(s["kernels"][1]["variance"]),
                s["Zs"][0], s["Zs"][1], s["q_mu"], softplus_inv(s["q_sqrt"])]
        for n, v in zip(NAMES, vals):
            out[n.format(gp=gp)] = torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype, device=device)
    out["likelihood.variance.raw"] = torch.as_tensor(softplus_inv(state["noise_variance"]), dtype=dtype,
                                                     device=device)
    return out


class OnOffReference:
    """The model's mathematics over raws named as the program's."""

    def __init__(self, cfg: dict, num_data: int, *, bulk: str = "exact", factor: str = "exact"):
        self.jitter = float(cfg["jitter"])
        self.relative = float(cfg["jitter_relative"])
        self.num_data = int(num_data)
        self.bulk, self.factor = bulk, factor
        if bulk != "exact" or factor != "exact":
            _exact_tf32()

    @staticmethod
    def gram(A: torch.Tensor, B: torch.Tensor, ell: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
        d2 = torch.sum(torch.square((A[:, None, :] - B[None, :, :]) / ell), dim=-1)
        return var * torch.exp(-0.5 * d2)

    def jittered(self, K: torch.Tensor) -> torch.Tensor:
        j = self.jitter + self.relative * torch.mean(torch.diagonal(K))
        return K + j * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)

    def factors(self, raws, gp: str):
        """Per factor p: (Z_p, ℓ_p, σ²_p, L_p, L_p⁻¹)."""
        out = []
        for p in (0, 1):
            Z = raws[f"{gp}.Zs.{p}.raw"]
            ell = softplus(raws[f"{gp}.kernels.{p}.lengthscales.raw"])
            var = softplus(raws[f"{gp}.kernels.{p}.variance.raw"])
            L = torch.linalg.cholesky(self.jittered(self.gram(Z, Z, ell, var)))
            eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
            Li = torch.linalg.solve_triangular(L, eye, upper=False)
            out.append((Z, ell, var, L, Li))
        return out

    def kl(self, raws, gp: str, fac) -> torch.Tensor:
        (_, _, _, Ls, Lis), (_, _, _, Lt, Lit) = fac
        Ms, Mt = Ls.shape[0], Lt.shape[0]
        Q = raws[f"{gp}.q_mu.raw"].reshape(Ms, Mt)
        S = torch.square(softplus(raws[f"{gp}.q_sqrt.raw"])).reshape(Ms, Mt)
        A = mm(mm(Lis, Q, self.factor), Lit.T, self.factor)  # (L_s⁻¹ ⊗ L_t⁻¹) vec Q
        dKs = torch.sum(torch.square(Lis), dim=0)  # diag K_s⁻¹
        dKt = torch.sum(torch.square(Lit), dim=0)
        trace = torch.sum(dKs[:, None] * dKt[None, :] * S)
        logdet_prior = 2.0 * (Mt * torch.sum(torch.log(torch.diagonal(Ls)))
                              + Ms * torch.sum(torch.log(torch.diagonal(Lt))))
        return 0.5 * (torch.sum(torch.square(A)) - Ms * Mt - torch.sum(torch.log(S)) + trace + logdet_prior)

    def marginals(self, raws, gp: str, fac, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """q(f) at X: mean and variance (B,)."""
        (Zs, ells, vars_, Ls, Lis), (Zt, ellt, vart, Lt, Lit) = fac
        Ms, Mt = Ls.shape[0], Lt.shape[0]
        Q = raws[f"{gp}.q_mu.raw"].reshape(Ms, Mt)
        S = torch.square(softplus(raws[f"{gp}.q_sqrt.raw"])).reshape(Ms, Mt)
        Ks = self.gram(Zs, X[:, 0:2], ells, vars_)  # (Ms, B)
        Kt = self.gram(Zt, X[:, 2:3], ellt, vart)  # (Mt, B)
        Vs, Vt = mm(Lis, Ks, self.bulk), mm(Lit, Kt, self.bulk)
        Ps, Pt = mm(Lis.T, Vs, self.bulk), mm(Lit.T, Vt, self.bulk)  # K_p⁻¹ K_mn,p
        alpha = mm(mm(Lis.T, mm(mm(Lis, Q, self.factor), Lit.T, self.factor), self.factor), Lit, self.factor)
        mean = self.contract(alpha, Ks, Kt)
        c1 = torch.sum(torch.square(Vs), dim=0) * torch.sum(torch.square(Vt), dim=0)
        c2 = self.contract(S, torch.square(Ps), torch.square(Pt))
        var = torch.clamp(vars_ * vart - c1 + c2, min=0.0)
        return mean, var

    def contract(self, W: torch.Tensor, Fs: torch.Tensor, Ft: torch.Tensor) -> torch.Tensor:
        """out[b] = Σ_ij W[i, j] Fs[i, b] Ft[j, b]: (B, M_s)·(M_s, M_t), then
        a (1, M_t)·(M_t, 1) dot a row."""
        t = mm(Fs.T, W, self.bulk)  # (B, Mt)
        return mm(Ft.T[:, None, :], t[:, :, None], self.bulk)[:, 0, 0]

    @staticmethod
    def gate(gmean, gvar):
        """E[Φ(g)], E[Φ²(g)], Var[Φ(g)] under N(gmean, gvar)."""
        z = gmean / torch.sqrt(1.0 + gvar)
        a = 1.0 / torch.sqrt(1.0 + 2.0 * gvar)
        cdf = (0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))) * (1.0 - 2.0e-3) + 1.0e-3
        owen = torch.arctan(a) / (2.0 * math.pi) * torch.exp(-0.5 * torch.square(z) * (torch.square(a) + 1.0))
        e2 = cdf - 2.0 * owen
        v = e2 - torch.square(cdf)
        return cdf, torch.clamp(e2, min=0.0), torch.clamp(v, min=0.0)

    def predict(self, raws, X: torch.Tensor, fac=None) -> Dict[str, torch.Tensor]:
        fac = fac or {gp: self.factors(raws, gp) for gp in ("f", "g")}
        fmean, fvar = self.marginals(raws, "f", fac["f"], X)
        gmean, gvar = self.marginals(raws, "g", fac["g"], X)
        e1, e2, v = self.gate(gmean, gvar)
        vals = (e1 * fmean, e2 * fvar, v * torch.square(fmean), fmean, fvar, gmean, gvar, e1, v)
        return dict(zip(FIELDS, vals))

    def loss(self, raws, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        data, kl = self.loss_parts(raws, X, Y)
        return data + kl

    def loss_parts(self, raws, X: torch.Tensor, Y: torch.Tensor):
        """(the data term −(N / B) Σ E_q[log p(y | ·)], KL_f + KL_g)."""
        fac = {gp: self.factors(raws, gp) for gp in ("f", "g")}
        p = self.predict(raws, X, fac)
        nv = softplus(raws["likelihood.variance.raw"])
        y = Y.reshape(-1)
        ve = (-0.5 * math.log(2.0 * math.pi) - 0.5 * torch.log(nv)
              - 0.5 * (torch.square(y - p["gfmean"]) + p["gfvar"] + p["gfmeanu"]) / nv)
        kl = self.kl(raws, "f", fac["f"]) + self.kl(raws, "g", fac["g"])
        return -torch.sum(ve) * (self.num_data / X.shape[0]), kl


def learning_rates(cfg: dict) -> Dict[str, float]:
    """Each raw's learning rate: the kernels' and the likelihood's
    ``lr.kern``, the inducing inputs' and q's ``lr.indp``."""
    out = {}
    for n in leaf_names():
        out[n] = cfg["lr"]["kern"] if (".kernels." in n or n.startswith("likelihood")) else cfg["lr"]["indp"]
    return out


def train_steps(ref: OnOffReference, raws0: Dict[str, torch.Tensor], batches: Sequence[tuple],
                lrs: Dict[str, float], moments: Optional[Tuple[dict, dict]] = None, t0: int = 0,
                keep: int = 3) -> dict:
    """Adam over ``batches`` from ``raws0``, with the first and second
    moments ``moments`` after ``t0`` steps (zero when None): {"losses": the
    first ``keep`` steps' losses, "data": the first step's data term,
    "grad": its gradient by leaf, "raws": the raws after the last step,
    "data_leaves": the leaves the KL does not reach, whose gradient is the
    data term's alone}."""
    raws = {n: t.clone().requires_grad_(True) for n, t in raws0.items()}
    if moments is None:
        m = {n: torch.zeros_like(t) for n, t in raws0.items()}
        v = {n: torch.zeros_like(t) for n, t in raws0.items()}
    else:
        m = {n: moments[0][n].to(t).clone() for n, t in raws0.items()}
        v = {n: moments[1][n].to(t).clone() for n, t in raws0.items()}
    out = {"losses": [], "data": None, "grad": None, "data_leaves": []}
    for k, (X, Y) in enumerate(batches):
        data, kl = ref.loss_parts(raws, X, Y)
        loss = data + kl
        if k == 0:
            gkl = torch.autograd.grad(kl, list(raws.values()), retain_graph=True, allow_unused=True)
            out["data_leaves"] = [n for n, g in zip(raws, gkl) if g is None or not bool(torch.any(g != 0))]
            out["data"] = float(data.detach())
        grads = torch.autograd.grad(loss, list(raws.values()))
        if k < keep:
            out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            grads = {n: torch.nan_to_num(g, nan=0.0, posinf=math.inf, neginf=-math.inf)
                     for n, g in zip(raws, grads)}
            if k == 0:
                out["grad"] = {n: g.clone() for n, g in grads.items()}
            t = t0 + k + 1
            for n, g in grads.items():
                m[n].mul_(BETA1).add_(g, alpha=1.0 - BETA1)
                v[n].mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
                mhat = m[n] / (1.0 - BETA1**t)
                vhat = v[n] / (1.0 - BETA2**t)
                raws[n].sub_(lrs[n] * mhat / (torch.sqrt(vhat) + EPS))
    out["raws"] = {n: t.detach() for n, t in raws.items()}
    return out


def predict_blocks(ref: OnOffReference, raws, X: torch.Tensor, block: int = 16384) -> Dict[str, torch.Tensor]:
    """The 9 fields at X, in blocks of rows, the factors computed once."""
    with torch.no_grad():
        fac = {gp: ref.factors(raws, gp) for gp in ("f", "g")}
        parts = [ref.predict(raws, X[i : i + block], fac) for i in range(0, X.shape[0], block)]
    return {k: torch.cat([p[k] for p in parts]) for k in FIELDS}
