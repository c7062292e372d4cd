"""Helpers the port's tests share: the rows the JAX package's device
sampler draws, and a fixture that makes the port's device samplers draw
them (the two generators differ by design, so a trajectory is compared with
JAX's on JAX's own rows); and the ranks of the parallel tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_multihost.py``).

The ranks are spawned processes that import this module and the port, never
JAX: JAX is imported inside the functions that use it, which only the test
process calls."""

import contextlib
import inspect
import os
import pickle
import traceback

import numpy as np
import pytest
import torch


@contextlib.contextmanager
def jax_scan_unroll(value: int = 1):
    """The JAX package's scanned step builders (``training.scan``,
    ``batched``, ``alternating``, ``natgrad``) with ``value`` as the default
    of their ``unroll`` keyword while inside. ``lax.scan``'s unroll factor
    lays the loop out for XLA to overlap adjacent steps on the TPU; it
    changes what is compiled, not what is computed, and at 8 (4 in natgrad)
    it multiplies the CPU compile time of every JAX anchor of the port's
    trainers. A builder called with an explicit ``unroll`` is unaffected."""
    from zigp_tpu.training import alternating, batched, natgrad, scan

    saved = []
    for mod in (scan, batched, alternating, natgrad):
        fns = [f for f in vars(mod).values() if inspect.isfunction(f) and f.__module__ == mod.__name__]
        for cls in (c for c in vars(mod).values() if inspect.isclass(c) and c.__module__ == mod.__name__):
            fns += [f for f in vars(cls).values() if inspect.isfunction(f)]
        for f in fns:
            if f.__kwdefaults__ and "unroll" in f.__kwdefaults__:
                saved.append((f, f.__kwdefaults__["unroll"]))
                f.__kwdefaults__["unroll"] = value
    try:
        yield
    finally:
        for f, v in saved:
            f.__kwdefaults__["unroll"] = v


@contextlib.contextmanager
def one_torch_thread():
    """torch's intra-op threads at one while inside. The test run gives each
    of its worker processes the machine's cores; with every worker's torch
    spreading each small float64 op over all of them, the workers spend more
    time contending than computing (the five slowest files ran 2.2 × faster
    in summed time with one thread). A test compares both sides of a check
    inside the block, so both see the same setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_torch_thread_per_module():
    """``one_torch_thread`` around a test module (``pytestmark =
    pytest.mark.usefixtures("one_torch_thread_per_module")``)."""
    with one_torch_thread():
        yield


def jax_rows(key_pair, count, N):
    """The rows JAX's device sampler draws for block key ``key_pair``."""
    import jax
    import jax.numpy as jnp

    key = jnp.asarray(np.array(key_pair, dtype=np.uint32))
    return np.asarray(jax.random.randint(key, (count,), 0, N))


def draw_jax_rows(generator, seed, N, count):
    """``training.scan._draw`` drawing JAX's rows for the block seed
    ``seed`` (the pair (sampler seed, block) as one integer)."""
    return torch.from_numpy(jax_rows([seed >> 32, seed & 0xFFFFFFFF], count, N).copy())


@pytest.fixture
def jax_rows_as_port(monkeypatch):
    """The port's device samplers (``StagedBlocks``, ``StackedBlocks``) draw
    JAX's rows for each block."""
    from zigp_tpu_torch.training import scan as tscan

    monkeypatch.setattr(tscan, "_draw", draw_jax_rows)


# ---------------------------------------------------------------------------
# The parallel tests' ranks. Each scenario is ``fn(mesh, ctx) -> dict`` of
# numpy results: on a rank of a spawned world with the mesh of its shape, or
# in the test process with ``mesh=None``, the port's one-rank run (the
# anchor). ``ctx``: "rows" (JAX's device-sampler rows by (block seed,
# count): every device-sampled scenario draws them, so the JAX package's
# run is an anchor too) and "dir" (a directory the ranks share).
# ---------------------------------------------------------------------------

SCENARIOS = {}
LR = 1e-2


def scenario(world, shape):
    def register(fn, name=None):
        SCENARIOS[name or fn.__name__] = (world, shape, fn)
        return fn

    return register


def quiet(_msg):
    return None


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def onoff_model(*, whiten=True, q_cov="diag", Ms=8, Mt=6, N=64):
    """The JAX parallel tests' Kron on/off model (``tests/test_parallel_scan.py``)."""
    from zigp_tpu_torch.likelihoods import OnOffGaussian
    from zigp_tpu_torch.models import KronOnOffSVGP
    from zigp_tpu_torch.ops.kernels import RBF

    r = np.random.RandomState(11)
    Zs = [r.rand(Ms, 2), np.linspace(0, 1, Mt)[:, None]]
    ks = lambda v: [RBF.create([1.0, 1.0], v), RBF.create([0.3], v)]  # noqa: E731
    return KronOnOffSVGP.create(ks(2.0), Zs, ks(1.0), [Z.copy() for Z in Zs], OnOffGaussian.create(0.05),
                                num_data=N, jitter=1e-6, seed=3, whiten=whiten, q_cov=q_cov)


def hurdlej_model(N=64):
    from zigp_tpu_torch.likelihoods import Bernoulli, LogNormal
    from zigp_tpu_torch.models import KronHurdleSVGP
    from zigp_tpu_torch.ops.kernels import RBF

    r = np.random.RandomState(13)
    Zs = [r.rand(8, 2), np.linspace(0, 1, 6)[:, None]]
    ks = lambda v: [RBF.create([1.0, 1.0], v), RBF.create([0.3], v)]  # noqa: E731
    return KronHurdleSVGP.create(ks(1.0), Zs, ks(1.0), [Z.copy() for Z in Zs], Bernoulli.create(),
                                 LogNormal.create(0.1), num_data=N, jitter=1e-6, seed=4)


def svgp_model(seed=1, N=64, whiten=True):
    """The JAX TP test's single-GP regression (``tests/test_tp_train.py``)."""
    from zigp_tpu_torch.likelihoods import Gaussian
    from zigp_tpu_torch.models import KronSVGP
    from zigp_tpu_torch.ops.kernels import RBF

    r = np.random.RandomState(5)
    Zs = [r.rand(8, 2), np.linspace(0, 1, 6)[:, None]]
    ks = [RBF.create([1.0, 1.0], 1.5), RBF.create([0.3], 1.5)]
    return KronSVGP.create(ks, Zs, Gaussian.create(0.1), num_data=N, jitter=1e-6, seed=seed, whiten=whiten)


def blocks(K=6, B=16, seed=0):
    r = np.random.RandomState(seed)
    return r.rand(K, B, 3), np.maximum(r.randn(K, B, 1), 0.0)


def train_set(N=64, seed=1):
    r = np.random.RandomState(seed)
    return r.rand(N, 3), np.maximum(r.randn(N, 1), 0.0)


def poisoned(base, X, Y, at):
    """A DataSet of class ``base`` (either package's) whose ``at``-th batch
    has a NaN target in its first row."""

    class Poisoned(base):
        def __init__(self):
            super().__init__(X, Y, seed=5)
            self.calls = 0

        def next_batch(self, b, shuffle=True):
            self.calls += 1
            bx, by = super().next_batch(b, shuffle)
            if self.calls == at:
                by = by.copy()
                by[0, 0] = np.nan
            return bx, by

    return Poisoned()


class rows_of:
    """The port's device samplers draw ``rows`` ({(block seed, count):
    indices}) while in the block."""

    def __init__(self, rows):
        self.rows = rows

    def __enter__(self):
        from zigp_tpu_torch.training import scan as tscan

        self.saved = tscan._draw
        tscan._draw = lambda generator, seed, N, count: torch.from_numpy(self.rows[(seed, count)].copy())

    def __exit__(self, *exc):
        from zigp_tpu_torch.training import scan as tscan

        tscan._draw = self.saved


def jax_rows_table(sampler_seed, counts, N, blocks_=12):
    """JAX's rows for blocks 0..blocks_-1 of ``sampler_seed`` at each count."""
    from zigp_tpu_torch.training.scan import block_seed

    return {(block_seed(sampler_seed, b), c): jax_rows([sampler_seed, b], c, N)
            for b in range(blocks_) for c in counts}


def _raws(model):
    from zigp_tpu_torch.io.convert import dump_arrays

    return dump_arrays(model)


def _out(losses, model, **kw):
    if isinstance(losses, torch.Tensor):
        losses = losses.detach().cpu().numpy()
    return {"losses": np.asarray(losses, dtype=np.float64), "raws": _raws(model), **kw}


# ---- steps and blocks -----------------------------------------------------


@scenario(2, (2, 1))
def dp_step(mesh, ctx):
    """The sharded loss, then one sharded step (``tests/test_parallel.py``)."""
    from zigp_tpu_torch.parallel import make_sharded_train_step, replicate, shard_batch
    from zigp_tpu_torch.parallel.step import sharded_loss
    from zigp_tpu_torch.training import make_optimizer, make_train_step

    X, Y = (_t(a[0]) for a in blocks(K=1))
    m = onoff_model()
    opt = make_optimizer(m, default_lr=LR)
    if mesh is None:
        with torch.no_grad():
            first = m.loss(X, Y)
        loss = make_train_step(opt)(m, X, Y)
    else:
        replicate(mesh, m)
        with torch.no_grad():
            first = mesh.all_reduce_data(sharded_loss(None, mesh)(m, *shard_batch(mesh, X, Y)))
        loss = make_sharded_train_step(opt, mesh)(m, X, Y)
    return _out([float(first), float(loss)], m)


def _block(model, Xs, Ys, mesh, tp=False):
    from zigp_tpu_torch.parallel import make_scan_sharded_train_step, replicate, tp_place
    from zigp_tpu_torch.training import make_optimizer, make_scan_train_step

    opt = make_optimizer(model, default_lr=LR)
    if mesh is None:
        return make_scan_train_step(opt)(model, _t(Xs), _t(Ys)), opt
    if tp:
        opt = tp_place(mesh, model, opt)
    else:
        replicate(mesh, model)
    return make_scan_sharded_train_step(opt, mesh, tp=tp)(model, _t(Xs), _t(Ys)), opt


@scenario(2, (2, 1))
def dp_block_host(mesh, ctx):
    m = onoff_model()
    losses, _ = _block(m, *blocks(), mesh)
    return _out(losses, m)


DEVICE_SEED, DEVICE_K, DEVICE_B = (7 << 32) | 9, 5, 16


@scenario(2, (2, 1))
def dp_block_device(mesh, ctx):
    """One device-sampled block: the same K·B indices as one rank."""
    from zigp_tpu_torch.parallel import make_device_sampling_sharded_scan_step, replicate
    from zigp_tpu_torch.training import DataSet, StagedBlocks, make_optimizer, make_scan_train_step

    X, Y = train_set()
    m = onoff_model()
    opt = make_optimizer(m, default_lr=LR)
    with rows_of(ctx["rows"]):
        if mesh is None:
            staged = StagedBlocks(DataSet(X, Y), "device", DEVICE_B, DEVICE_K, device="cpu", dtype=torch.float64)
            staged.fill_seed(DEVICE_SEED)
            losses = make_scan_train_step(opt)(m, staged.Xs, staged.Ys)
        else:
            replicate(mesh, m)
            step = make_device_sampling_sharded_scan_step(opt, mesh, X, Y, DEVICE_B)
            losses = step(m, DEVICE_SEED, DEVICE_K)
    return _out(losses, m)


TP_CASES = [(w, q) for w in (True, False) for q in ("diag", "kron")]


def _tp_block(whiten, q_cov):
    def fn(mesh, ctx):
        m = onoff_model(whiten=whiten, q_cov=q_cov)
        losses, opt = _block(m, *blocks(), mesh, tp=True)
        extra = {}
        if mesh is not None:  # the variational rows are still row-sharded after the block
            extra["owned_rows"] = {n: tuple(p.shape) for n, p in opt.masters.items()}
        return _out(losses, m, **extra)

    return fn


for _w, _q in TP_CASES:
    _name = f"tp_block_{_q}_{'w' if _w else 'nw'}"
    scenario(2, (1, 2))(_tp_block(_w, _q), _name)
    scenario(4, (2, 2))(_tp_block(_w, _q), "tp4" + _name[2:])


def _tp_svgp(mesh, ctx):
    """The single-GP regression through the tensor-parallel step."""
    from zigp_tpu_torch.parallel import make_tp_train_step
    from zigp_tpu_torch.training import make_optimizer, make_train_step

    m = svgp_model()
    opt = make_optimizer(m, default_lr=LR)
    step = make_train_step(opt) if mesh is None else make_tp_train_step(opt, mesh, example_model=m)
    Xs, Ys = blocks(K=4, seed=2)
    losses = [step(m, _t(Xs[k]), _t(Ys[k])) for k in range(4)]
    return _out(torch.stack(losses), m)


scenario(2, (1, 2))(_tp_svgp, "tp_svgp")
scenario(4, (2, 2))(_tp_svgp, "tp4_svgp")


@scenario(2, (2, 1))
def hurdlej_block(mesh, ctx):
    m = hurdlej_model()
    losses, _ = _block(m, *blocks(seed=4), mesh)
    return _out(losses, m)


# ---- the production loops -------------------------------------------------

FIT = dict(num_iter=20, batch_size=16, num_inner=5, sampler_seed=3, learning_rate=LR)


def _fit(sampler, tp):
    def fn(mesh, ctx):
        from zigp_tpu_torch.training import DataSet, fit_scanned

        X, Y = train_set()
        with rows_of(ctx["rows"]):
            res = fit_scanned(onoff_model(), DataSet(X, Y, seed=5), log_fn=quiet, sampler=sampler, mesh=mesh,
                              mesh_tp=tp and mesh is not None, **FIT)
        return _out(res.step_losses, res.model)

    return fn


for _s in ("host", "device"):
    scenario(2, (2, 1))(_fit(_s, False), f"fit_{_s}")
    scenario(4, (2, 2))(_fit(_s, True), f"tp4_fit_{_s}")

NATGRAD = dict(gamma=0.05, adam_lr=LR)
NATGRAD_K = 2  # the joint step's two factors, one a step


def _natgrad_block(q_cov, kron_joint):
    def fn(mesh, ctx):
        from zigp_tpu_torch.parallel import replicate
        from zigp_tpu_torch.parallel.mesh import row_block
        from zigp_tpu_torch.training.natgrad import NaturalGradientTrainer

        Xs, Ys = (_t(a) for a in blocks(K=NATGRAD_K))
        m = onoff_model(q_cov=q_cov)
        trainer = NaturalGradientTrainer(m, kron_joint=kron_joint, mesh=mesh, **NATGRAD)
        if mesh is not None:
            replicate(mesh, m)
            rows = row_block(mesh, Xs.shape[1])
            Xs, Ys = Xs[:, rows], Ys[:, rows]
        gammas = torch.full((Xs.shape[0],), 0.05, dtype=torch.float32)
        return _out(trainer.block(Xs, Ys, gammas, 0), m)

    return fn


scenario(2, (2, 1))(_natgrad_block("diag", False), "natgrad_block_diag")
scenario(2, (2, 1))(_natgrad_block("kron", True), "natgrad_block_kron")
FIT_NATGRAD = dict(num_iter=20, batch_size=16, num_inner=5, gamma=0.05, gamma_warmup=0, adam_warmup=5,
                   sampler_seed=3)


def _fit_natgrad(sampler):
    def fn(mesh, ctx):
        from zigp_tpu_torch.training import DataSet, fit_natgrad_scanned

        X, Y = train_set()
        with rows_of(ctx["rows"]):
            res = fit_natgrad_scanned(onoff_model(), DataSet(X, Y, seed=5), log_fn=quiet, sampler=sampler, mesh=mesh,
                                      **FIT_NATGRAD)
        return _out(res.step_losses, res.model)

    return fn


scenario(2, (2, 1))(_fit_natgrad("host"), "fit_natgrad_host")
scenario(2, (2, 1))(_fit_natgrad("device"), "fit_natgrad_device")
ALTERNATING = dict(num_iter=12, batch_size=16, num_inner=4, sampler="device", alternating=2, sampler_seed=3)


@scenario(2, (2, 1))
def alternating(mesh, ctx):
    from zigp_tpu_torch.training import DataSet, fit_scanned

    X, Y = train_set()
    with rows_of(ctx["rows"]):
        res = fit_scanned(onoff_model(), DataSet(X, Y), log_fn=quiet, mesh=mesh, **ALTERNATING)
    return _out(res.step_losses, res.model)


@scenario(2, (1, 2))
def alternating_tp_refused(mesh, ctx):
    from zigp_tpu_torch.training import DataSet, fit_scanned

    X, Y = train_set(N=32)
    try:
        fit_scanned(onoff_model(N=32), DataSet(X, Y), num_iter=4, batch_size=8, num_inner=4, sampler="device",
                    alternating=2, mesh=mesh, mesh_tp=mesh is not None, log_fn=quiet)
    except ValueError as e:
        return {"refused": str(e)}
    return {"refused": None}


# ---- checkpoints, NaN recovery, resume across meshes ----------------------


def _dir(ctx, name, mesh):
    return os.path.join(ctx["dir"], name if mesh is not None else name + "_one_rank")


@scenario(2, (2, 1))
def ckpt_nan(mesh, ctx):
    """A NaN target in the sixth batch: the third block's last loss is
    non-finite on every rank (the losses are summed), every rank restores
    the step-4 checkpoint rank 0 wrote, and the run goes on."""
    from zigp_tpu_torch.io.checkpoint import CheckpointManager
    from zigp_tpu_torch.training import DataSet, fit_scanned

    X, Y = train_set()
    logs = []
    mgr = CheckpointManager(_dir(ctx, "ckpt_nan", mesh), every=4)
    res = fit_scanned(onoff_model(), poisoned(DataSet, X, Y, 6), num_iter=8, batch_size=16, num_inner=2,
                      learning_rate=LR, log_fn=logs.append, ckpt_manager=mgr, mesh=mesh)
    return {"losses": np.asarray(res.losses), "raws": _raws(res.model), "logs": logs,
            "ckpts": sorted(os.listdir(mgr.directory))}


@scenario(2, (2, 1))
def natgrad_nan(mesh, ctx):
    """Every block non-finite (all-NaN targets): each sync restores the
    start checkpoint, and the run ends on it, finite."""
    from zigp_tpu_torch.io.checkpoint import CheckpointManager
    from zigp_tpu_torch.training import DataSet, fit_natgrad_scanned

    X, _ = train_set()
    Y = np.full((X.shape[0], 1), np.nan)
    mgr = CheckpointManager(_dir(ctx, "natgrad_nan", mesh), every=5)
    res = fit_natgrad_scanned(onoff_model(), DataSet(X, Y, seed=5), num_iter=20, batch_size=16, num_inner=5,
                              gamma=0.05, gamma_warmup=0, adam_warmup=0, log_every_blocks=1, log_fn=quiet,
                              ckpt_manager=mgr, mesh=mesh)
    return {"raws": _raws(res.model), "interrupted": res.interrupted}


RESUME = dict(batch_size=16, num_inner=5, sampler="device", sampler_seed=3, learning_rate=LR)


def resume_run(mesh, ctx, directory, *, steps, start=0, tp=False):
    """``steps`` device-sampled steps from the checkpoint in ``directory``
    (or from the start, checkpointing every 10): the resume scenarios'
    one loop, on a mesh or one rank."""
    from zigp_tpu_torch.io.checkpoint import CheckpointManager
    from zigp_tpu_torch.parallel.mesh import barrier
    from zigp_tpu_torch.training import DataSet, fit_scanned, make_optimizer

    X, Y = train_set()
    m = onoff_model()
    opt = make_optimizer(m, default_lr=LR)
    mgr = CheckpointManager(directory, every=10)
    if start:
        assert mgr.restore_latest(m, opt)[2] == start
        barrier()  # every rank has read it before rank 0 writes again
    with rows_of(ctx["rows"]):
        res = fit_scanned(m, DataSet(X, Y), num_iter=steps, start_step=start, optimizer=opt, ckpt_manager=mgr,
                          log_fn=quiet, mesh=mesh, mesh_tp=tp and mesh is not None, **RESUME)
    return _out(res.step_losses, res.model)


@scenario(2, (1, 2))
def resume_two_to_one(mesh, ctx):
    """Two tensor-parallel ranks train 10 steps and checkpoint (the full
    rows and moments); the test process resumes on one rank."""
    return resume_run(mesh, ctx, _dir(ctx, "resume_two_to_one", mesh), steps=10, tp=True)


@scenario(2, (1, 2))
def resume_one_to_two(mesh, ctx):
    """One rank's checkpoint at step 10 (written by the test process before
    the spawn) resumed on two tensor-parallel ranks for 10 more steps."""
    return resume_run(mesh, ctx, ctx["one_rank_ckpt"], steps=10, start=10, tp=True)


@scenario(4, (2, 2))
def tp4_ckpt(mesh, ctx):
    """A tensor-parallel run with checkpoints, then a continuation restored
    into a fresh model and a fresh optimizer placed on the mesh."""
    d = _dir(ctx, "tp4_ckpt", mesh)
    first = resume_run(mesh, ctx, d, steps=10, tp=True)
    then = resume_run(mesh, ctx, d, steps=10, start=10, tp=True)
    return {"losses": np.concatenate([first["losses"], then["losses"]]), "raws": then["raws"]}


# ---- placement and the explicit row-partitioned predict -------------------


def _placement(mesh, ctx):
    """Bytes this rank holds of each row-sharded raw's owned copy and of
    its two Adam moments, beside the full sizes."""
    from zigp_tpu_torch.parallel import tp_place, tp_shardings_tree
    from zigp_tpu_torch.training import make_optimizer

    m = onoff_model()
    opt = make_optimizer(m, default_lr=LR)
    specs = tp_shardings_tree(mesh, m) if mesh is not None else {}
    full = {n: 3 * p.numel() * p.element_size() for n, p in m.named_parameters() if specs.get(n)}
    owned = tp_place(mesh, m, opt).owned_bytes() if mesh is not None else {}
    return {"owned": owned, "full": full, "specs": specs}


scenario(2, (1, 2))(_placement, "placement")
scenario(4, (2, 2))(_placement, "tp4_placement")


def tp_gp(seed=0, Ms=8, Mt=6):
    """The JAX TP test's whitened Kron GP (``tests/test_tp.py``), its q_sqrt
    moved off its init, and the 17 inputs."""
    from zigp_tpu_torch.models import KronGP
    from zigp_tpu_torch.ops.kernels import RBF

    r = np.random.RandomState(seed)
    Zs = [r.rand(Ms, 2), r.rand(Mt, 1)]
    ks = [RBF.create([0.8, 0.9], 1.3), RBF.create([0.3], 1.1)]
    gp = KronGP.create(ks, Zs, jitter=1e-6, whiten=True, seed=5)
    with torch.no_grad():
        gp.q_sqrt.raw.copy_(_t(0.3 * r.randn(Ms * Mt, 1)))
    return gp, r.rand(17, 3)


def _tp_predict(mesh, ctx):
    from zigp_tpu_torch.parallel import make_mesh
    from zigp_tpu_torch.parallel.tp import tp_whitened_kron_predict_and_kl

    gp, X = tp_gp()
    with torch.no_grad():
        mu, var, kl = tp_whitened_kron_predict_and_kl(
            mesh if mesh is not None else make_mesh(), gp.kernels, [Z.value for Z in gp.Zs], gp.q_mu.value,
            gp.q_sqrt.value, _t(X), gp.input_masks, jitter=gp.jitter)
        ref_mu, ref_var = gp.predict_f(_t(X))
        ref_kl = gp.prior_kl()
    return {"mu": mu.numpy(), "var": var.numpy(), "kl": float(kl), "raws": _raws(gp),
            "model_path": (ref_mu.numpy(), ref_var.numpy(), float(ref_kl))}


scenario(2, (1, 2))(_tp_predict, "tp_predict_kl")
scenario(4, (1, 4))(_tp_predict, "tp4_predict_kl")


# ---- the member-axis mesh -------------------------------------------------


def member_models(F, N=40):
    """F KronSVGP members of one structure (their own q_mu draws), each on
    its own data."""
    models, datas = [], []
    for f in range(F):
        r = np.random.RandomState(20 + f)
        models.append(svgp_model(seed=f, N=N))
        datas.append((r.rand(N, 3), r.randn(N, 1)))
    return models, datas


@scenario(2, (2, 1))
def members(mesh, ctx):
    """F = 5 members over 2 ranks (padded to 6), each member's losses and
    raws; checkpoints every 4 steps in each rank's own directory."""
    from zigp_tpu_torch.io.checkpoint import CheckpointManager
    from zigp_tpu_torch.training import fit_batched_scanned

    models, datas = member_models(5)
    logs = []
    mgr = CheckpointManager(_dir(ctx, "members", mesh), every=4)
    res = fit_batched_scanned(models, datas, num_iter=8, batch_size=8, num_inner=4, learning_rate=LR,
                              seeds=[3, 1, 4, 1, 5], log_fn=logs.append, ckpt_manager=mgr, mesh=mesh)
    return {"losses": [np.asarray(r.losses) for r in res], "final": [r.final_loss for r in res],
            "raws": [_raws(r.model) for r in res], "logs": logs}


@scenario(2, (2, 1))
def members_natgrad(mesh, ctx):
    """F = 3 natural-gradient members over 2 ranks (padded to 4)."""
    from zigp_tpu_torch.training import fit_natgrad_batched

    models, datas = member_models(3)
    res = fit_natgrad_batched(models, datas, num_iter=8, batch_size=8, num_inner=4, gamma=0.05, gamma_warmup=0,
                              adam_warmup=4, adam_lr=LR, log_fn=quiet, mesh=mesh)
    return {"losses": [np.asarray(r.losses) for r in res], "final": [r.final_loss for r in res],
            "raws": [_raws(r.model) for r in res]}


def cv_splits(F=3, N=48, Nt=20, seed=3):
    """The JAX tests' tiny folds (``tests/test_torch_cv_batched.py``)."""
    from zigp_tpu_torch.io.datasets import Split

    r = np.random.RandomState(seed)
    out = []
    for _ in range(F):
        Xtr, Xte = r.rand(N, 3), r.rand(Nt, 3)
        out.append(Split(Xtr, np.maximum(r.randn(N, 1) + 0.7, 0.0), Xte, np.maximum(r.randn(Nt, 1) + 0.7, 0.0)))
    return out


def cv_cfgs():
    import dataclasses

    from zigp_tpu_torch.experiments import configs as c

    sp, tm = c.KernelInit((0.5, 0.5), 1.0), c.KernelInit((0.5,), 1.0)
    tiny = dict(num_iter=8, batch_size=8, scan_inner=4, log_every=0, ckpt_every=0,
                grid=c.KronGridConfig(num_spatial=4, num_temporal=3), sampler="device")
    return dict(
        onoff_cfg=c.OnOffPptrConfig(**tiny, monitor_every=0, fk_spatial=sp, fk_temporal=tm, gk_spatial=sp,
                                    gk_temporal=tm),
        svgp_cfg=dataclasses.replace(c.SvgpPptrConfig(**tiny, k_spatial=sp, k_temporal=tm)),
    )


@scenario(2, (2, 1))
def cv_batched(mesh, ctx):
    from zigp_tpu_torch.experiments.cv_batched import run_cv_batched

    workdir = _dir(ctx, "cv_batched", mesh)
    summary = run_cv_batched(["svgp", "onoff"], splits=cv_splits(), log_fn=quiet, workdir=workdir,
                             mesh_members=mesh.shape["data"] if mesh is not None else 0, device="cpu",
                             dtype=torch.float64, **cv_cfgs())
    return {"summary": summary, "files": sorted(os.listdir(workdir))}


# ---- the ranks ------------------------------------------------------------


ONE_RANK = ["dp_step", "dp_block_host", "dp_block_device", *(f"tp_block_{q}_{'w' if w else 'nw'}" for w, q in TP_CASES),
            "tp_svgp", "hurdlej_block", "fit_host", "fit_device", "natgrad_block_diag", "natgrad_block_kron",
            "fit_natgrad_host", "fit_natgrad_device", "alternating", "ckpt_nan", "natgrad_nan", "uninterrupted",
            "tp_predict_kl", "members", "members_natgrad", "cv_batched"]


def one_rank_name(name):
    """The scenario whose one-rank run anchors ``name``: a four-rank
    scenario's two-rank twin (``tp4_fit_*`` is ``fit_*`` on one rank)."""
    return name.replace("tp4_fit_", "fit_").replace("tp4_", "tp_")


def run_one_rank(names, out, ctx):
    """The port's one-rank runs of ``names`` (``mesh=None``, no process
    group), in a process of their own beside the ranks, each pickled to
    ``out/{name}.one.pkl`` (or its traceback); "uninterrupted" is 20
    device-sampled steps in one run, the resume scenarios' anchor."""
    torch.set_num_threads(1)
    for name in names:
        try:
            if name == "uninterrupted":
                res = resume_run(None, ctx, os.path.join(ctx["dir"], "uninterrupted_one_rank"), steps=20)
            else:
                res = SCENARIOS[name][2](None, ctx)
        except Exception:
            res = {"error": traceback.format_exc()}
        tmp = os.path.join(out, f"{name}.one.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(res, f)
        os.replace(tmp, os.path.join(out, f"{name}.one.pkl"))


def run_rank(rank, world, store, names, out, ctx):
    """One rank of a spawned world: the process group over the FileStore
    ``store`` (gloo, a short timeout: a rank that hangs ends the run), then
    each scenario in ``names`` on its mesh, its result pickled to
    ``out/{name}.{rank}.pkl`` (a failure's traceback in its place, then
    the rank stops)."""
    import datetime

    torch.set_num_threads(1)
    from zigp_tpu_torch.parallel import initialize_distributed, make_mesh
    from zigp_tpu_torch.parallel.distributed import shutdown

    assert initialize_distributed(f"file://{store}", world, rank, backend="gloo",
                                  timeout=datetime.timedelta(seconds=60))
    meshes = {}
    try:
        for name in names:
            _, shape, fn = SCENARIOS[name]
            if shape not in meshes:
                meshes[shape] = make_mesh(*shape)
            try:
                res = fn(meshes[shape], ctx)
            except Exception:
                res = {"error": traceback.format_exc()}
            with open(os.path.join(out, f"{name}.{rank}.pkl"), "wb") as f:
                pickle.dump(res, f)
            if "error" in res:
                os._exit(1)
    finally:
        shutdown()


def multihost_smoke(rank, world, store, out):
    """``tests/test_torch_multihost.py``'s two-process smoke, one process:
    ``initialize`` from explicit arguments (twice: idempotent), the
    multi-host mesh over both processes, and one real all-reduce over its
    data axis; the findings pickled to ``out/smoke.{rank}.pkl``."""
    import datetime

    torch.set_num_threads(1)
    from zigp_tpu_torch.parallel import initialize_distributed, make_multihost_mesh
    from zigp_tpu_torch.parallel.distributed import shutdown

    first = initialize_distributed(f"file://{store}", world, rank, backend="gloo",
                                   timeout=datetime.timedelta(seconds=60))
    again = initialize_distributed(f"file://{store}", world, rank)
    try:
        mesh = make_multihost_mesh()
        x = torch.ones(2, dtype=torch.float64)
        mesh.all_reduce_data(x)
        res = {"initialized": (first, again), "shape": mesh.shape, "coords": mesh.coords, "sum": x.numpy(),
               "backend": mesh.backend}
    finally:
        shutdown()
    with open(os.path.join(out, f"smoke.{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
