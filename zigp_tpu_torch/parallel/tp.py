"""Tensor parallelism over the Kronecker inducing dimension.

Counterpart of ``zigp_tpu/parallel/tp.py``. For grids whose M = Ms·Mt rows
outgrow one card, the memory-heavy objects are the variational parameters
(q_mu, q_sqrt: M rows) and their Adam moments; the factor grams stay small
and replicate. Two layers, as in the JAX package:

1. **State sharding** (``tp_place`` + ``make_tp_train_step``). The JAX
   package places the M-row leaves and their moments row-sharded over the
   mesh ``model`` axis and lets GSPMD partition the step. Here each rank of
   a model group owns one contiguous block of rows of every leaf that
   ``tp_shardings_tree`` picks: the master copy of those rows alone, and
   their two Adam moments (``RowShardedAdam``), 1/n_model of each per rank.
   Every step the model's own raws serve as the working buffers: after each
   update the owned rows are gathered into them over the model group (an
   ``all_reduce`` of a zero-filled full buffer, exact: the other ranks add
   zeros), and the model's own loss runs on this rank's data shard. The
   ranks of one model group ran the same shard, so each holds the same full
   gradient; it keeps its own rows of it (a slice, no collective) and the
   gradient is summed over the **data** group only. One mechanism covers
   every family, as GSPMD does for the JAX package; what it does not do is
   partition the conditional's compute over ``model``.
2. **The explicit row-partitioned predict + KL**
   (``tp_whitened_kron_predict_and_kl``), the JAX package's ``shard_map``
   path: partial contractions on the local rows, then one ``all_reduce``
   over the model group.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..io.convert import jax_key
from ..ops import linalg
from ..training.optim import GradBuffer, GroupedAdam
from .mesh import Mesh, replicate, row_block

_VARIATIONAL_KEYS = ("q_mu", "q_sqrt", "u_fm", "u_gm", "u_fs_sqrt", "u_gs_sqrt")


def _is_tp_shardable(path_name: str, leaf, n_model: int) -> bool:
    """Row-shard a leaf iff it is one of the M-row variational objects (by
    its JAX path) and its leading dim divides over the model axis.
    ``q_sqrt_factors`` (per-factor M_p × M_p Choleskys) stay replicated."""
    if "q_sqrt_factors" in path_name:
        return False
    if not any(k in path_name for k in _VARIATIONAL_KEYS):
        return False
    shape = getattr(leaf, "shape", None)
    return bool(shape) and len(shape) >= 1 and shape[0] % n_model == 0 and shape[0] >= n_model


def tp_shardings_tree(mesh: Mesh, tree):
    """The placement of every leaf of ``tree``, a module (its raws, by
    name) or a nested dict of tensors (an optimizer's ``state_tensors``,
    which reuses the raws' names): ``("model", None, ...)`` for the row-
    sharded M-row variational leaves, ``()`` (replicated) for the rest.
    The JAX rule, on the raws' JAX paths."""
    n_model = mesh.shape["model"]

    def pick(name, leaf):
        if _is_tp_shardable(jax_key(name), leaf, n_model):
            return ("model",) + (None,) * (leaf.dim() - 1)
        return ()

    if isinstance(tree, nn.Module):
        return {n: pick(n, p) for n, p in tree.named_parameters()}

    def walk(d, name):
        return {k: walk(v, k if name is None else name) if isinstance(v, dict) else pick(name, v)
                for k, v in d.items()}

    return walk(tree, None)


class RowShardedAdam:
    """``GroupedAdam`` with the model's row-sharded raws replaced by this
    rank's block of their rows (the masters; trainable raws only) and the
    rest whole: its moments of a sharded raw are the owned rows' alone.

    The training step runs the model's loss into the raws' gradients (the
    sharded raws' full-size gradients sit in ``work_grads``), then
    ``collect_grads`` copies each owned block into its master's gradient,
    the caller sums ``grads.flat`` over the data group, and ``step`` updates
    the masters and the whole raws and gathers the owned rows of every
    sharded raw back into the model over the model group. Everything stays
    in storage allocated here, so the step can be captured in a CUDA graph.

    ``state_tensors`` gives the full-size moments, gathered over the model
    group (a collective: every rank calls it), so a checkpoint is the same
    file whatever the mesh; ``load_state`` takes a full-size state, keeps
    the owned rows and re-slices the masters from the model, which a
    restore has written first."""

    def __init__(self, mesh: Mesh, model: nn.Module, optimizer: GroupedAdam):
        self.mesh = mesh
        specs = tp_shardings_tree(mesh, model)
        name_of = {id(p): n for n, p in zip(optimizer.names, optimizer.params)}
        self.work: Dict[str, nn.Parameter] = {}
        self.rows: Dict[str, slice] = {}
        self.masters: Dict[str, nn.Parameter] = {}
        groups = []
        for g in optimizer.adam.param_groups:
            params = []
            for p in g["params"]:
                n = name_of[id(p)]
                if specs[n]:
                    rows = row_block(mesh, p.shape[0], "model")
                    self.work[n], self.rows[n] = p, rows
                    self.masters[n] = nn.Parameter(p.detach()[rows].clone())
                    params.append((n, self.masters[n]))
                else:
                    params.append((n, p))
            groups.append({"label": g["label"], "lr": g["base_lr"], "params": params})
        self.inner = GroupedAdam(groups, optimizer.schedule, optimizer.zero_nans)
        self.work_grads = GradBuffer(list(self.work.values())) if self.work else None
        # the state so far (a resumed run's) carries over, sliced
        self.load_state(optimizer.state_tensors())

    # the interface of GroupedAdam the trainers use
    @property
    def grads(self) -> GradBuffer:
        return self.inner.grads

    @property
    def names(self):
        return self.inner.names

    @property
    def step_count(self) -> torch.Tensor:
        return self.inner.step_count

    def zero_grad(self) -> None:
        self.inner.zero_grad()
        if self.work_grads is not None:
            self.work_grads.zero_()

    def collect_grads(self) -> None:
        """Each master's gradient: its rows of the full gradient."""
        with torch.no_grad():
            for n, w in self.work.items():
                self.masters[n].grad.copy_(w.grad[self.rows[n]])

    def step(self) -> None:
        self.inner.step()
        self.gather()

    def gather(self) -> None:
        """The model's sharded raws from the owned rows of every rank of the
        model group, in place."""
        with torch.no_grad():
            for n, w in self.work.items():
                w.zero_()
                w[self.rows[n]] = self.masters[n]
                self.mesh.all_reduce_model(w.data)

    def place(self) -> None:
        """The masters re-sliced from the model's raws (after a restore)."""
        with torch.no_grad():
            for n, w in self.work.items():
                self.masters[n].copy_(w[self.rows[n]])

    def owned_bytes(self) -> Dict[str, int]:
        """{raw name: bytes this rank holds of its master and of its two
        moments} for every row-sharded raw."""
        st = self.inner.state_tensors()
        return {n: m.numel() * m.element_size() + sum(st[n][k].numel() * st[n][k].element_size()
                                                       for k in ("exp_avg", "exp_avg_sq"))
                for n, m in self.masters.items()}

    def state_tensors(self) -> Dict[str, Dict[str, torch.Tensor]]:
        st = self.inner.state_tensors()
        out = {}
        for n, ts in st.items():
            if n not in self.work:
                out[n] = ts
                continue
            full = {"step": ts["step"]}
            for k in ("exp_avg", "exp_avg_sq"):
                buf = torch.zeros_like(self.work[n], memory_format=torch.contiguous_format)
                buf[self.rows[n]] = ts[k]
                full[k] = self.mesh.all_reduce_model(buf)
            out[n] = full
        return out

    def _sliced(self, state):
        return {n: ({k: (v[self.rows[n]] if k != "step" else v) for k, v in ts.items()} if n in self.work else ts)
                for n, ts in state.items()}

    def check_state(self, state) -> None:
        """Raise unless ``state`` is a full-size state of these names."""
        for n in self.work:
            for k in ("exp_avg", "exp_avg_sq"):
                if n in state and tuple(state[n][k].shape) != tuple(self.work[n].shape):
                    raise ValueError(f"load_state: {n}.{k} has shape {tuple(state[n][k].shape)}, "
                                     f"expected {tuple(self.work[n].shape)}")
        self.inner.check_state(self._sliced(state))

    def load_state(self, state) -> None:
        self.check_state(state)
        self.inner.load_state(self._sliced(state))
        self.place()


def tp_place(mesh: Mesh, model: nn.Module, optimizer: GroupedAdam) -> RowShardedAdam:
    """Replicate ``model`` from rank 0 (in place) and return ``optimizer``
    re-placed with tensor-parallel placements (``RowShardedAdam``): this
    rank's rows of every row-sharded raw and their moments, the rest
    whole. The optimizer's state so far carries over."""
    replicate(mesh, model)
    if isinstance(optimizer, RowShardedAdam):
        return optimizer
    return RowShardedAdam(mesh, model, optimizer)


def make_tp_train_step(optimizer, mesh: Mesh, loss_fn=None, *, example_model: Optional[nn.Module] = None):
    """A step ``(model, X, Y) -> loss`` with the variational rows and their
    moments row-sharded over the model axis and the batch (X, Y, every
    rank's the same) over the data axis. Pass ``optimizer`` through
    ``tp_place`` first, or give the model as ``example_model`` to have it
    placed here; ``step.optimizer`` is the placed one."""
    from .step import make_sharded_train_step

    if not isinstance(optimizer, RowShardedAdam):
        if example_model is None:
            raise ValueError("make_tp_train_step: pass an optimizer placed by tp_place, or example_model")
        optimizer = tp_place(mesh, example_model, optimizer)
    step = make_sharded_train_step(optimizer, mesh, loss_fn)
    step.optimizer = optimizer
    return step


def tp_whitened_kron_predict_and_kl(
    mesh: Mesh,
    kernels: Sequence,
    Zs: Sequence[torch.Tensor],
    q_mu: torch.Tensor,
    q_sqrt: torch.Tensor,
    Xnew: torch.Tensor,
    input_masks,
    *,
    jitter: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean (B, 1), var (B, 1), kl) of a 2-factor whitened Kronecker GP
    with a diagonal q, its spatial-factor rows of q_mu / q_sqrt partitioned
    over the model axis: each rank contracts its block of Ms / n_model rows
    (of the full q_mu, q_sqrt every rank holds), and one ``all_reduce`` over
    the model group sums the mean's, the variance's and the KL's partial
    sums. The factor algebra is replicated."""
    assert len(Zs) == 2, "tensor-parallel path implemented for 2 factors"
    Ms, Mt = Zs[0].shape[0], Zs[1].shape[0]
    B = Xnew.shape[0]

    Kmms = [linalg.add_jitter(k.K(Z), jitter) for k, Z in zip(kernels, Zs)]
    Ls = [linalg.cholesky(K) for K in Kmms]
    Knn = torch.ones((B,), dtype=Xnew.dtype, device=Xnew.device)
    Vs_list = []
    for p, (k, Z, L) in enumerate(zip(kernels, Zs, Ls)):
        xp = Xnew[:, list(input_masks[p])]
        Knn = Knn * k.Kdiag(xp)
        Vs_list.append(linalg.tri_solve(L, k.K(Z, xp), lower=True))
    Vs, Vt = Vs_list  # (Ms, B), (Mt, B)
    c1 = torch.sum(Vs**2, dim=0) * torch.sum(Vt**2, dim=0)

    rows = row_block(mesh, Ms, "model")
    W_s = q_mu.reshape(Ms, Mt)[rows]
    Ssq_s = (q_sqrt**2).reshape(Ms, Mt)[rows]
    Vs_rows = Vs[rows]
    # the bulk class of the precision policy (linalg.bdot), as the JAX
    # package's bulk_precision() einsums: Σ_ij W[i, j] Vs[i, b] Vt[j, b] as
    # (B, Ms/n)·(Ms/n, Mt), then a dot a row of B
    contract = lambda W, P, Q: linalg.bdot(linalg.bdot(P.T, W).unsqueeze(-2), Q.T.unsqueeze(-1)).reshape(-1)
    mu_part = contract(W_s, Vs_rows, Vt)
    c2_part = contract(Ssq_s, Vs_rows**2, Vt**2)
    # whitened KL partial sums: ½(Σm² − M − Σlog s² + Σ s²)
    kl_part = 0.5 * (torch.sum(W_s**2) - torch.sum(torch.log(Ssq_s)) + torch.sum(Ssq_s))
    parts = mesh.all_reduce_model(torch.cat([mu_part, c2_part, kl_part.reshape(1)]))
    mu, c2, kl = parts[:B], parts[B : 2 * B], parts[2 * B] - 0.5 * (Ms * Mt)
    var = torch.clamp(Knn - c1 + c2, min=0.0)
    return mu[:, None], var[:, None], kl
