"""The port's parallel layer (``zigp_tpu_torch.parallel`` and the mesh paths
of the trainers, the CV runners and the command line) on the CPU, in float64,
over gloo.

The scenarios of ``tests/test_parallel.py``, ``test_parallel_scan.py``,
``test_tp.py`` and ``test_tp_train.py``, run by spawned ranks
(``torch_helpers.SCENARIOS``, ``torch_helpers.run_rank``): each world size
is spawned once for the module (2 ranks, and 4 as data 2 × model 2), runs
every scenario of its size, and the tests read the results. Each scenario
has two anchors: the port's one-rank run (``mesh=None``, no process group;
``torch_helpers.run_one_rank``) at rtol 1e-9, atol 1e-11 (the tolerance at
which the JAX package holds its 8-device CPU mesh to one device), and the
JAX package's single-device run on the same raws (``io.convert``) and the
same rows at rtol 1e-8 (the port's tolerance for Adam trajectories against
JAX). The one-rank runs and the JAX runs are computed by processes started
beside the ranks, so the module's wall is the longest of them. The member-axis mesh is held
to the unsharded stack at rtol 1e-12. The command line runs under
``python -m torch.distributed.run --standalone --nproc-per-node 2``.
"""

import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from zigp_tpu.io.checkpoint import CheckpointManager as JCheckpointManager
from zigp_tpu.likelihoods import Bernoulli as JBernoulli
from zigp_tpu.likelihoods import Gaussian as JGaussian
from zigp_tpu.likelihoods import LogNormal as JLogNormal
from zigp_tpu.likelihoods import OnOffGaussian as JOnOffGaussian
from zigp_tpu.models import KronGP as JKronGP
from zigp_tpu.models import KronHurdleSVGP as JKronHurdleSVGP
from zigp_tpu.models import KronOnOffSVGP as JKronOnOffSVGP
from zigp_tpu.models import KronSVGP as JKronSVGP
from zigp_tpu.ops.kernels import RBF as JRBF
from zigp_tpu.training import fit_scanned as jfit_scanned
from zigp_tpu.training import make_optimizer as jmake_optimizer
from zigp_tpu.training import natgrad as jng
from zigp_tpu.training.data import DataSet as JDataSet
from zigp_tpu.training.loop import make_train_step as jmake_train_step
from zigp_tpu_torch.io.convert import dump_arrays

from . import torch_helpers as h
from .test_torch_natgrad import jax_steps
from .test_torch_train import _jraws, _with_raws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
RTOL_ONE_RANK, ATOL_ONE_RANK = 1e-9, 1e-11
RTOL_JAX = 1e-8


def _ctx(directory):
    rows = h.jax_rows_table(3, [16 * 5, 16 * 4], 64)
    rows[(h.DEVICE_SEED, h.DEVICE_K * h.DEVICE_B)] = h.jax_rows([7, 9], h.DEVICE_K * h.DEVICE_B, 64)
    return {"rows": rows, "dir": str(directory), "one_rank_ckpt": os.path.join(str(directory), "one_rank_ckpt")}


CLI_ARGS = ["onoff", "--device", "cpu", "--dtype", "float64", "--grid", "3x8", "--scan-inner", "10", "--iters",
            "20", "--batch", "16", "--sampler", "device"]


class Spawned:
    """The module's worlds, started at once and joined when first read; the
    command line's torchrun launch beside them."""

    def __init__(self, directory):
        self.dir = directory
        self.ctx = _ctx(directory / "ranks")
        os.makedirs(self.ctx["dir"])
        # the one-rank checkpoint that resume_one_to_two resumes on two ranks
        self.one_rank_resume = h.resume_run(None, self.ctx, self.ctx["one_rank_ckpt"], steps=10)
        self.names = {w: [n for n, (world, _, _) in h.SCENARIOS.items() if world == w] for w in WORLDS}
        self.procs = {w: mp.spawn(h.run_rank, args=(w, os.path.join(self.ctx["dir"], f"store{w}"), self.names[w],
                                                     self.ctx["dir"], self.ctx), nprocs=w, join=False)
                      for w in WORLDS}
        self.cli = self._start_cli()
        spawn = mp.get_context("spawn")
        self.jax_procs = [spawn.Process(target=jax_worker, args=(names, self.ctx["dir"])) for names in JAX_WORKERS]
        self.one_proc = spawn.Process(target=h.run_one_rank, args=(h.ONE_RANK, self.ctx["dir"], self.ctx))
        for p in (*self.jax_procs, self.one_proc):
            p.start()
        self.joined = {}

    def _start_cli(self):
        from zigp_tpu_torch.io.datasets import save_pptr, synthetic_pptr

        self.data = str(self.dir / "synth.pickle")
        save_pptr(synthetic_pptr(8, 24, seed=0), self.data)
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
        argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2", "-m",
                "zigp_tpu_torch.experiments", *CLI_ARGS, "--mesh-data", "2", "--data", self.data, "--workdir",
                str(self.dir / "cli")]
        return subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    def _join(self, world):
        if world not in self.joined:
            try:
                deadline = time.time() + 600
                while not self.procs[world].join(timeout=5):
                    assert time.time() < deadline, f"world {world} did not finish"
                self.joined[world] = None
            except Exception as e:  # a failed rank: its scenario's pickle holds the traceback
                self.joined[world] = repr(e)
        return self.joined[world]

    def result(self, name, rank=0):
        world = h.SCENARIOS[name][0]
        failure = self._join(world)
        path = os.path.join(self.ctx["dir"], f"{name}.{rank}.pkl")
        assert os.path.exists(path), f"{name} on rank {rank}: no result ({failure})"
        with open(path, "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, res.get("error")
        return res

    def _written(self, path, worker, what):
        deadline = time.time() + 600
        while not os.path.exists(path):
            assert worker.is_alive() or os.path.exists(path), f"the process of {what} died"
            assert time.time() < deadline, f"no result for {what}"
            time.sleep(0.1)
        with open(path, "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, res.get("error")
        return res

    def jax(self, name):
        """The JAX package's single-device run of ``name``, when its worker
        has written it."""
        worker = self.jax_procs[next(i for i, names in enumerate(JAX_WORKERS) if name in names)]
        return self._written(os.path.join(self.ctx["dir"], f"jax_{name}.pkl"), worker, f"JAX {name}")

    def one(self, name):
        """The port's one-rank run anchoring ``name`` (``run_one_rank``)."""
        name = h.one_rank_name(name)
        return self._written(os.path.join(self.ctx["dir"], f"{name}.one.pkl"), self.one_proc, f"one-rank {name}")

    def close(self):
        for w in WORLDS:
            self._join(w)
        for p in (*self.jax_procs, self.one_proc):
            p.join(timeout=600)
            if p.is_alive():
                p.kill()
        if self.cli.poll() is None:
            self.cli.kill()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    # the one-rank anchors are tiny: one thread, beside the module's other
    # processes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    s = Spawned(tmp_path_factory.mktemp("parallel"))
    yield s
    s.close()
    torch.set_num_threads(threads)


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _same_raws(got, want, rtol, atol=0.0):
    assert set(got) == set(want)
    for k in want:
        scale = np.abs(np.asarray(want[k])).max() if np.size(want[k]) else 0.0
        _close(got[k], want[k], rtol, max(atol, rtol * 1e-3 * scale), k)


def _anchored(got, one, want=None):
    """``got`` (a rank's) against the port's one-rank run ``one`` and the JAX
    run ``want`` (its losses and raws, where it has them)."""
    _close(got["losses"], one["losses"], RTOL_ONE_RANK, ATOL_ONE_RANK, "losses vs one rank")
    _same_raws(got["raws"], one["raws"], RTOL_ONE_RANK, ATOL_ONE_RANK)
    if want is not None and "losses" in want:
        _close(got["losses"], want["losses"], RTOL_JAX, 0.0, "losses vs JAX")
    if want is not None:
        _same_raws(got["raws"], want["raws"], RTOL_JAX)


# ---------------------------------------------------------------------------
# the JAX package's single-device runs: computed by worker processes started
# with the ranks, each anchor pickled as it is done (``JAX_WORKERS``)
# ---------------------------------------------------------------------------


def _ks(v, ls=(1.0, 1.0), lt=0.3):
    return [JRBF.create(list(ls), v), JRBF.create([lt], v)]


def j_onoff(*, whiten=True, q_cov="diag", N=64):
    r = np.random.RandomState(11)
    Zs = [r.rand(8, 2), np.linspace(0, 1, 6)[:, None]]
    return JKronOnOffSVGP.create(_ks(2.0), Zs, _ks(1.0), [Z.copy() for Z in Zs], JOnOffGaussian.create(0.05),
                                 num_data=N, jitter=1e-6, seed=3, whiten=whiten, q_cov=q_cov)


def j_hurdlej(N=64):
    r = np.random.RandomState(13)
    Zs = [r.rand(8, 2), np.linspace(0, 1, 6)[:, None]]
    return JKronHurdleSVGP.create(_ks(1.0), Zs, _ks(1.0), [Z.copy() for Z in Zs], JBernoulli.create(),
                                  JLogNormal.create(0.1), num_data=N, jitter=1e-6, seed=4)


def j_svgp(N=64):
    r = np.random.RandomState(5)
    Zs = [r.rand(8, 2), np.linspace(0, 1, 6)[:, None]]
    return JKronSVGP.create(_ks(1.5), Zs, JGaussian.create(0.1), num_data=N, jitter=1e-6, seed=1, whiten=True)


def _as_jax(jm, tm):
    """The JAX model ``jm`` with the port model ``tm``'s raws."""
    return _with_raws(jm, dump_arrays(tm))


_STEPS = {}


def jax_step(key, build):
    """One jitted Adam step of the JAX package per model structure, shared
    by the anchors (one compile each)."""
    if key not in _STEPS:
        opt = jmake_optimizer(build(), default_lr=h.LR)
        _STEPS[key] = (opt, jmake_train_step(opt))
    return _STEPS[key]


def jax_steps_on(key, build, tm, batches):
    """The JAX single-device run of ``batches`` from the port model ``tm``'s
    raws: {"losses", "raws"}."""
    opt, step = jax_step(key, build)
    jm = _as_jax(build(), tm)
    state = opt.init(jm)
    losses = []
    for X, Y in batches:
        jm, state, loss = step(jm, state, jnp.asarray(X), jnp.asarray(Y))
        losses.append(float(loss))
    return {"losses": np.asarray(losses), "raws": _jraws(jm)}


def _fit_batches(sampler, steps=20, K=5, B=16):
    X, Y = h.train_set()
    if sampler == "host":
        ds = JDataSet(X, Y, seed=5)
        return [ds.next_batch(B) for _ in range(steps)]
    out = []
    for b in range(steps // K):
        idx = h.jax_rows([3, b], K * B, X.shape[0]).reshape(K, B)
        out += [(X[i], Y[i]) for i in idx]
    return out


def j_dp_step(d):
    X, Y = (a[0] for a in h.blocks(K=1))
    first = float(_as_jax(j_onoff(), h.onoff_model()).loss(jnp.asarray(X), jnp.asarray(Y)))
    out = jax_steps_on(("onoff", True, "diag"), j_onoff, h.onoff_model(), [(X, Y)])
    return dict(out, losses=np.asarray([first, out["losses"][0]]))


def j_dp_block_host(d):
    return jax_steps_on(("onoff", True, "diag"), j_onoff, h.onoff_model(), list(zip(*h.blocks())))


def j_dp_block_device(d):
    X, Y = h.train_set()
    idx = h.jax_rows([7, 9], h.DEVICE_K * h.DEVICE_B, X.shape[0]).reshape(h.DEVICE_K, h.DEVICE_B)
    return jax_steps_on(("onoff", True, "diag"), j_onoff, h.onoff_model(), [(X[i], Y[i]) for i in idx])


def j_tp_block(whiten, q_cov):
    build = lambda: j_onoff(whiten=whiten, q_cov=q_cov)  # noqa: E731
    return lambda d: jax_steps_on(("onoff", whiten, q_cov), build, h.onoff_model(whiten=whiten, q_cov=q_cov),
                                  list(zip(*h.blocks())))


def j_tp_svgp(d):
    return jax_steps_on("svgp", j_svgp, h.svgp_model(), list(zip(*h.blocks(K=4, seed=2))))


def j_hurdlej_block(d):
    return jax_steps_on("hurdlej", j_hurdlej, h.hurdlej_model(), list(zip(*h.blocks(seed=4))))


def j_fit(sampler):
    return lambda d: jax_steps_on(("onoff", True, "diag"), j_onoff, h.onoff_model(), _fit_batches(sampler))


def j_natgrad_block(q_cov, kron_joint):
    def fn(d):
        Xs, Ys = h.blocks(K=h.NATGRAD_K)
        jm = _as_jax(j_onoff(q_cov=q_cov), h.onoff_model(q_cov=q_cov))
        jt = jng.NaturalGradientTrainer(jm, kron_joint=kron_joint, **h.NATGRAD)
        K = Xs.shape[0]
        jm, losses = jax_steps(jt, jm, jnp.asarray(Xs), jnp.asarray(Ys), jnp.full((K,), 0.05, jnp.float32),
                               np.arange(K))
        return {"losses": losses, "raws": _jraws(jm)}

    return fn


def j_fit_natgrad(sampler):
    def fn(d):
        X, Y = h.train_set()
        jm = _as_jax(j_onoff(), h.onoff_model())
        res = jng.fit_natgrad_scanned(jm, JDataSet(X, Y, seed=5), log_fn=h.quiet, sampler=sampler,
                                      **h.FIT_NATGRAD)
        return {"final": res.final_loss, "raws": _jraws(res.model)}

    return fn


def j_alternating(d):
    X, Y = h.train_set()
    res = jfit_scanned(_as_jax(j_onoff(), h.onoff_model()), JDataSet(X, Y), log_fn=h.quiet, **h.ALTERNATING)
    return {"final": res.final_loss, "raws": _jraws(res.model)}


def j_ckpt_nan(d):
    X, Y = h.train_set()
    logs = []
    mgr = JCheckpointManager(os.path.join(d, "jax_ckpt_nan"), every=4)
    res = jfit_scanned(_as_jax(j_onoff(), h.onoff_model()), h.poisoned(JDataSet, X, Y, 6), num_iter=8,
                       batch_size=16, num_inner=2, learning_rate=h.LR, log_fn=logs.append, ckpt_manager=mgr)
    return {"losses": np.asarray(res.losses), "raws": _jraws(res.model), "logs": logs,
            "ckpts": sorted(os.listdir(mgr.directory))}


def j_tp_predict(d):
    """The JAX model path (predict_f, prior_kl) on the TP test GP's raws."""
    gp, X = h.tp_gp()
    ks = [JRBF.create([0.8, 0.9], 1.3), JRBF.create([0.3], 1.1)]
    gp_j = _with_raws(JKronGP.create(ks, [np.zeros((8, 2)), np.zeros((6, 1))], jitter=1e-6, whiten=True, seed=5),
                      dump_arrays(gp))
    mu, var, kl = jax.jit(lambda g, x: (*g.predict_f(x), g.prior_kl()))(gp_j, jnp.asarray(X))
    return {"mu": np.asarray(mu), "var": np.asarray(var), "kl": float(kl)}


JAX_ANCHORS = {
    "dp_step": j_dp_step,
    "dp_block_host": j_dp_block_host,
    "dp_block_device": j_dp_block_device,
    **{f"tp_block_{q}_{'w' if w else 'nw'}": j_tp_block(w, q) for w, q in h.TP_CASES},
    "tp_svgp": j_tp_svgp,
    "hurdlej_block": j_hurdlej_block,
    "fit_host": j_fit("host"),
    "fit_device": j_fit("device"),
    "natgrad_block_diag": j_natgrad_block("diag", False),
    "natgrad_block_kron": j_natgrad_block("kron", True),
    "fit_natgrad_host": j_fit_natgrad("host"),
    "fit_natgrad_device": j_fit_natgrad("device"),
    "alternating": j_alternating,
    "ckpt_nan": j_ckpt_nan,
    "tp_predict": j_tp_predict,
}
# three processes, about equal in compile time
JAX_WORKERS = [
    ["dp_step", "dp_block_host", "dp_block_device", "fit_host", "fit_device", "tp_predict", "tp_block_diag_w",
     "tp_block_kron_w", "tp_block_diag_nw", "tp_block_kron_nw", "tp_svgp", "hurdlej_block"],
    ["natgrad_block_diag", "natgrad_block_kron", "alternating", "ckpt_nan"],
    ["fit_natgrad_host", "fit_natgrad_device"],
]


def jax_worker(names, directory):
    """A process of JAX anchors: each of ``names`` pickled to
    ``directory/jax_{name}.pkl`` (or its traceback)."""
    import traceback

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    for name in names:
        try:
            res = JAX_ANCHORS[name](directory)
        except Exception:
            res = {"error": traceback.format_exc()}
        with open(os.path.join(directory, f"jax_{name}.pkl.tmp"), "wb") as f:
            pickle.dump(res, f)
        os.replace(os.path.join(directory, f"jax_{name}.pkl.tmp"), os.path.join(directory, f"jax_{name}.pkl"))


# ---------------------------------------------------------------------------
# steps and blocks
# ---------------------------------------------------------------------------


def test_sharded_loss_and_step(spawned):
    got = spawned.result("dp_step")
    _anchored(got, spawned.one("dp_step"), spawned.jax("dp_step"))
    _same_raws(spawned.result("dp_step", 1)["raws"], got["raws"], 0.0)  # every rank holds the same model


def test_scanned_dp_block_host(spawned):
    _anchored(spawned.result("dp_block_host"), spawned.one("dp_block_host"),
              spawned.jax("dp_block_host"))


def test_scanned_dp_block_device_sampler_draws_one_rank_indices(spawned):
    _anchored(spawned.result("dp_block_device"), spawned.one("dp_block_device"),
              spawned.jax("dp_block_device"))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("whiten,q_cov", h.TP_CASES)
def test_scanned_tp_block(spawned, world, whiten, q_cov):
    """The variational rows and their moments row-sharded over the model
    axis (1 × 2, and 2 × 2 on four ranks) for a block of 6 steps."""
    case = f"block_{q_cov}_{'w' if whiten else 'nw'}"
    name = ("tp_" if world == 2 else "tp4_") + case
    got = spawned.result(name)
    _anchored(got, spawned.one(name), spawned.jax("tp_" + case))
    full = dict(h.onoff_model(whiten=whiten, q_cov=q_cov).named_parameters())
    assert got["owned_rows"]
    for n, shape in got["owned_rows"].items():
        assert shape == (full[n].shape[0] // 2, *full[n].shape[1:]), n


@pytest.mark.parametrize("world", WORLDS)
def test_tp_svgp_regression_step(spawned, world):
    name = "tp_svgp" if world == 2 else "tp4_svgp"
    _anchored(spawned.result(name), spawned.one(name), spawned.jax("tp_svgp"))


def test_hurdlej_dp_block(spawned):
    _anchored(spawned.result("hurdlej_block"), spawned.one("hurdlej_block"),
              spawned.jax("hurdlej_block"))


# ---------------------------------------------------------------------------
# the production loops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("sampler", ["host", "device"])
def test_fit_scanned_with_mesh(spawned, world, sampler):
    """``fit_scanned(mesh=)``: data parallel on two ranks, data 2 × model 2
    (``mesh_tp``) on four."""
    name = f"fit_{sampler}" if world == 2 else f"tp4_fit_{sampler}"
    _anchored(spawned.result(name), spawned.one(name), spawned.jax(f"fit_{sampler}"))


@pytest.mark.parametrize("q_cov", ["diag", "kron"])
def test_natgrad_dp_block(spawned, q_cov):
    """The diagonal natural step, and the joint Kronecker step on "kron"."""
    name = f"natgrad_block_{q_cov}"
    _anchored(spawned.result(name), spawned.one(name), spawned.jax(name))


def _anchored_final(got, one, want):
    _anchored(got, one, want)
    _close(got["losses"][-1], want["final"], RTOL_JAX, 0.0, "final loss vs JAX")


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_fit_natgrad_scanned_with_mesh(spawned, sampler):
    """The Adam warm-start through ``fit_scanned``'s data-parallel path,
    then the natural blocks, on two ranks."""
    name = f"fit_natgrad_{sampler}"
    _anchored_final(spawned.result(name), spawned.one(name), spawned.jax(name))


def test_alternating_dp(spawned):
    _anchored_final(spawned.result("alternating"), spawned.one("alternating"),
                    spawned.jax("alternating"))


def test_alternating_refuses_a_tensor_parallel_mesh(spawned):
    for rank in range(2):
        assert "data-parallel meshes only" in spawned.result("alternating_tp_refused", rank)["refused"]


# ---------------------------------------------------------------------------
# checkpoints, NaN recovery, resume across meshes
# ---------------------------------------------------------------------------


def test_checkpoint_and_nan_restore_under_a_mesh(spawned):
    got, one, want = spawned.result("ckpt_nan"), spawned.one("ckpt_nan"), spawned.jax("ckpt_nan")
    _anchored(got, one, want)
    assert got["logs"] == one["logs"]
    assert "restored from checkpoint at step 4" in got["logs"]
    assert got["ckpts"] == one["ckpts"] == want["ckpts"]
    assert spawned.result("ckpt_nan", 1)["logs"] == got["logs"]  # every rank took the same branches


def test_natgrad_nan_recovery_under_a_mesh(spawned):
    """Every block non-finite: every sync restores the start checkpoint, as
    the JAX package's run does (``tests/test_parallel_scan.py``), so the run
    ends finite on the start state, on every rank."""
    start = h._raws(h.onoff_model())
    for rank in range(2):
        got = spawned.result("natgrad_nan", rank)
        assert not got["interrupted"]
        _same_raws(got["raws"], start, 0.0)
    _same_raws(spawned.one("natgrad_nan")["raws"], start, 0.0)


@pytest.fixture(scope="module")
def uninterrupted(spawned):
    """20 device-sampled steps in one run: the port's one rank, and JAX's
    (``fit_device``'s anchor: the same run)."""
    return spawned.one("uninterrupted"), spawned.jax("fit_device")


def _second_half(run):
    """The last 10 of a 20-step run's losses, and its end raws."""
    return {"losses": run["losses"][10:], "raws": run["raws"]}


def test_two_rank_checkpoint_resumes_on_one_rank(spawned, uninterrupted):
    """Two tensor-parallel ranks write the full rows and moments at step 10;
    one rank restores them and trains 10 more steps, on the uninterrupted
    run's trajectory."""
    one, want = uninterrupted
    got = spawned.result("resume_two_to_one")
    _close(got["losses"], one["losses"][:10], RTOL_ONE_RANK, ATOL_ONE_RANK)
    directory = os.path.join(spawned.ctx["dir"], "resume_two_to_one")
    rest = h.resume_run(None, spawned.ctx, directory, steps=10, start=10)
    _anchored(rest, _second_half(one), _second_half(want))


def test_one_rank_checkpoint_resumes_on_two_ranks(spawned, uninterrupted):
    one, want = uninterrupted
    _close(spawned.one_rank_resume["losses"], one["losses"][:10], 0.0)
    _anchored(spawned.result("resume_one_to_two"), _second_half(one), _second_half(want))


def test_tensor_parallel_checkpoint_restores_into_a_placed_run(spawned, uninterrupted):
    one, want = uninterrupted
    _anchored(spawned.result("tp4_ckpt"), one, want)


# ---------------------------------------------------------------------------
# placement and the explicit row-partitioned predict
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_placement_halves_the_row_sharded_state(spawned, world):
    """Per rank, each row-sharded raw's owned copy and its two Adam moments
    take half of one rank's bytes; kernels and inducing inputs stay whole."""
    name = "placement" if world == 2 else "tp4_placement"
    for rank in range(world):
        got = spawned.result(name, rank)
        assert set(got["owned"]) == {n for n in got["full"]}
        assert {n for n, spec in got["specs"].items() if spec} == set(got["full"])
        assert any("q_mu" in n for n in got["full"]) and not any("kernels" in n for n in got["full"])
        for n, full in got["full"].items():
            assert 2 * got["owned"][n] == full, n


@pytest.mark.parametrize("world", WORLDS)
def test_tp_whitened_kron_predict_and_kl(spawned, world):
    """The row-partitioned predict + KL at model 2 and 4 against the model
    path, on one rank and in JAX."""
    name = "tp_predict_kl" if world == 2 else "tp4_predict_kl"
    got = spawned.result(name)
    one = spawned.one(name)
    want = spawned.jax("tp_predict")
    mu, var, kl = got["model_path"]
    for k, ref in (("mu", mu), ("var", var), ("kl", kl)):
        _close(got[k], one[k], RTOL_ONE_RANK, 1e-12, k)
        _close(got[k], want[k], RTOL_JAX, 1e-12, k)
        _close(got[k], ref, 1e-9, 1e-12, k)


# ---------------------------------------------------------------------------
# the member-axis mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["members", "members_natgrad"])
def test_member_mesh_equals_the_unsharded_stack(spawned, name):
    """F members over 2 ranks, padded to a multiple of 2: each member's
    losses and raws are the unsharded stack's, the pads dropped, and every
    rank returns all F."""
    one = spawned.one(name)
    F = len(one["raws"])
    for rank in range(2):
        got = spawned.result(name, rank)
        assert len(got["raws"]) == len(got["losses"]) == F
        for f in range(F):
            _close(got["losses"][f], one["losses"][f], 1e-12, 0.0, f"member {f}")
            _close(got["final"][f], one["final"][f], 1e-12, 0.0, f"member {f}")
            _same_raws(got["raws"][f], one["raws"][f], 1e-12)
    if name == "members":
        logs = spawned.result(name)["logs"]
        assert "member padding: 5 -> 6 members to fill the 2-device data axis (pads discarded)" in logs
        # each rank checkpoints its own block of members
        assert sorted(os.listdir(os.path.join(spawned.ctx["dir"], "members"))) == ["members_0_of_2", "members_1_of_2"]


def test_run_cv_batched_with_mesh_members(spawned):
    from .test_torch_cv_batched import _same_summary

    one = spawned.one("cv_batched")
    for rank in range(2):
        _same_summary(spawned.result("cv_batched", rank)["summary"], one["summary"], rtol=1e-12)
    assert "cv_summary.json" in spawned.result("cv_batched")["files"]


# ---------------------------------------------------------------------------
# the command line under torchrun
# ---------------------------------------------------------------------------


def test_cli_mesh_data_under_torchrun(spawned, tmp_path):
    """``onoff --mesh-data 2`` on two ranks launched by torchrun: rank 0
    alone writes the results (one log, one results pickle), and they are a
    one-rank run's at rtol 1e-9."""
    from zigp_tpu_torch.experiments import cli as tcli

    tcli.main([*CLI_ARGS, "--data", spawned.data, "--workdir", str(tmp_path / "one")])
    out, _ = spawned.cli.communicate(timeout=600)
    assert spawned.cli.returncode == 0, out.decode()[-4000:]
    assert "mesh: 2-way data parallel" in out.decode()
    with open(tmp_path / "one" / "1" / "results_onoff.pickle", "rb") as f:
        want = pickle.load(f)
    wd = spawned.dir / "cli" / "1"
    with open(wd / "results_onoff.pickle", "rb") as f:
        got = pickle.load(f)
    assert sorted(os.listdir(wd)) == sorted(os.listdir(tmp_path / "one" / "1"))
    with open(wd / "modelsumm_onoff.log") as f:
        assert f.read().count("mesh: 2-way data parallel") == 1  # rank 0 alone logs
    _close(got["losses"], want["losses"], RTOL_ONE_RANK)
    for k in ("test_rmse", "test_mae"):
        _close(got[k], want[k], RTOL_ONE_RANK, 0.0, k)
