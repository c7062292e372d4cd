"""The rest of the JAX package's public API on the port, against ``zigp_tpu``.

On the CPU in float64, inputs from a seeded numpy ``RandomState``: the pptr
``Preprocessing`` (exactly equal), the Kronecker solves and products (rtol
1e-12), ``probit``, ``is_parameter`` and ``constrained`` leaf by leaf, the
jitter settings with ``jitter_level`` (a model keeps the level in force when
it was created, in both packages), the packages' re-exports against the
JAX ``__all__`` and every public top-level def/class (the API guard, with
each renamed or excluded name beside its reason), the packaging of the
CUDA sources and the ``zigp-torch`` script, and ``make_mesh`` with a CUDA
device that has no index.
"""

import ast
import fnmatch
import importlib
import subprocess
import sys
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigp_tpu.core import config as jconfig
from zigp_tpu.core import parameters as jparams
from zigp_tpu.io.datasets import Preprocessing as JPreprocessing
from zigp_tpu.io.datasets import Split as JSplit
from zigp_tpu.likelihoods import OnOffGaussian as JOnOffGaussian
from zigp_tpu.models import KronOnOffSVGP as JKronOnOffSVGP
from zigp_tpu.ops import linalg as jlinalg
from zigp_tpu.ops import probit as jprobit
from zigp_tpu.ops.kernels import RBF as JRBF
from zigp_tpu_torch.core import config as tconfig
from zigp_tpu_torch.core import parameters as tparams
from zigp_tpu_torch.io.convert import dump_arrays, jax_key, load_jax_arrays
from zigp_tpu_torch.io.datasets import Preprocessing as TPreprocessing
from zigp_tpu_torch.io.datasets import Split as TSplit
from zigp_tpu_torch.likelihoods import OnOffGaussian as TOnOffGaussian
from zigp_tpu_torch.models import KronOnOffSVGP as TKronOnOffSVGP
from zigp_tpu_torch.ops import linalg as tlinalg
from zigp_tpu_torch.ops import probit as tprobit
from zigp_tpu_torch.ops.kernels import RBF as TRBF

from .test_golden import _kron_fixture

ROOT = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


# ---------------------------------------------------------------------------
# Preprocessing: the four cases of tests/test_preprocessing.py, both packages
# ---------------------------------------------------------------------------


def _arrays(rng):
    Xtr = np.stack([59 + 11 * rng.rand(50), 20 + 11 * rng.rand(50), 4000 + 1500 * rng.rand(50)], 1)
    Xte = np.stack([59 + 11 * rng.rand(20), 20 + 11 * rng.rand(20), 4000 + 1500 * rng.rand(20)], 1)
    return Xtr, rng.rand(50, 1) * 3, Xte, rng.rand(20, 1) * 3


PIPELINES = {
    "filter_time": lambda p: p.filter_time(min_idx=4368, max_idx=5447),
    "scale": lambda p: p.scale(scale_loc=True, scale_time=True),
    "filter_then_scale_time": lambda p: p.filter_time(min_idx=4368, max_idx=5447).scale(scale_loc=False),
    "unscaled": lambda p: p,
}


@pytest.mark.parametrize("case", list(PIPELINES))
def test_preprocessing_equals_jax(case):
    arrays = _arrays(np.random.RandomState(0))
    jp = PIPELINES[case](JPreprocessing(JSplit(*arrays)))
    tp = PIPELINES[case](TPreprocessing(TSplit(*arrays)))
    for field in ("Xtrain", "Ytrain", "Xtest", "Ytest"):
        np.testing.assert_array_equal(getattr(tp.model_data, field), getattr(jp.model_data, field))
    assert tp.scale_params.mins == jp.scale_params.mins
    assert tp.scale_params.ranges == jp.scale_params.ranges
    assert tp.kernel_params == jp.kernel_params
    # the input split is copied, never written
    np.testing.assert_array_equal(arrays[0], _arrays(np.random.RandomState(0))[0])


# ---------------------------------------------------------------------------
# linalg: the Kronecker algebra and chol_solve
# ---------------------------------------------------------------------------

SIZES = {"2 factors": (3, 5), "3 factors": (4, 3, 6)}


def _spd(rng, n):
    A = rng.randn(n, n)
    return A @ A.T + n * np.eye(n)


def _rhs(rng, N, cols):
    return rng.randn(N) if cols == 0 else rng.randn(N, cols)


@pytest.mark.parametrize("cols", [0, 1, 4], ids=["vector", "1 column", "4 columns"])
@pytest.mark.parametrize("sizes", list(SIZES.values()), ids=list(SIZES))
def test_kron_algebra_matches_jax(sizes, cols):
    rng = np.random.RandomState(sum(sizes) + cols)
    N = int(np.prod(sizes))
    mats = [rng.randn(n, n) for n in sizes]
    Ls = [np.linalg.cholesky(_spd(rng, n)) for n in sizes]
    b = _rhs(rng, N, cols)
    jm, jL, jb = [jnp.asarray(A) for A in mats], [jnp.asarray(L) for L in Ls], jnp.asarray(b)
    tm, tL, tb = [_t(A) for A in mats], [_t(L) for L in Ls], _t(b)
    # one jitted JAX program for the four references (eager dispatch compiles each op)
    jdense, jmv, jlower, jchol = jax.jit(lambda m, L, b: (
        jlinalg.kron_dense(*m), jlinalg.kron_mv(m, b), jlinalg.kron_solve_lower(L, b),
        jlinalg.kron_chol_solve(L, b)))(jm, jL, jb)
    np.testing.assert_allclose(tlinalg.kron_dense(*tm).numpy(), np.asarray(jdense), rtol=1e-12)
    cases = {
        "kron_mv": (tlinalg.kron_mv(tm, tb), jmv),
        "kron_mv precision": (tlinalg.kron_mv(tm, tb, precision="highest"), jmv),
        "kron_solve_lower": (tlinalg.kron_solve_lower(tL, tb), jlower),
        "kron_chol_solve": (tlinalg.kron_chol_solve(tL, tb), jchol),
    }
    for name, (got, want) in cases.items():
        assert got.shape == tb.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-13, err_msg=name)
    # and against the dense product
    K = tlinalg.kron_dense(*[_t(L @ L.T) for L in Ls]).numpy()
    np.testing.assert_allclose(tlinalg.kron_chol_solve(tL, tb).numpy(), np.linalg.solve(K, b), rtol=1e-9)


@pytest.mark.parametrize("cols", [0, 3])
def test_chol_solve_matches_jax(cols):
    rng = np.random.RandomState(cols)
    L = np.linalg.cholesky(_spd(rng, 6))
    b = _rhs(rng, 6, cols)
    got = tlinalg.chol_solve(_t(L), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(jlinalg.chol_solve(jnp.asarray(L), jnp.asarray(b))),
                               rtol=1e-12)


def test_probit_matches_jax():
    x = np.random.RandomState(5).randn(200) * 4.0
    np.testing.assert_allclose(tprobit.probit(_t(x)).numpy(), np.asarray(jprobit.probit(jnp.asarray(x))),
                               rtol=1e-13)


# ---------------------------------------------------------------------------
# parameters: is_parameter and constrained on a model carried across
# ---------------------------------------------------------------------------


def _onoff_pair(jitter=1e-5, perturb=True):
    """The golden Kron on/off fixture in both packages, the JAX raws moved
    off the init by seeded noise and carried into the port."""
    Zs, X, Y, _, _ = _kron_fixture()
    ks = lambda RBF, v: [RBF.create([0.5, 0.5], v), RBF.create([0.2], v)]
    kw = dict(num_data=100, jitter=jitter, seed=0)
    jm = JKronOnOffSVGP.create(ks(JRBF, 1.0), Zs, ks(JRBF, 2.0), [Z.copy() for Z in Zs], JOnOffGaussian.create(0.01),
                               **kw)
    tm = TKronOnOffSVGP.create(ks(TRBF, 1.0), Zs, ks(TRBF, 2.0), [Z.copy() for Z in Zs], TOnOffGaussian.create(0.01),
                               **kw)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jm)
    rng = np.random.RandomState(11)
    arrays = {jax.tree_util.keystr(p): np.array(v) + (0.05 * rng.randn(*np.shape(v)) if perturb else 0.0)
              for p, v in leaves}
    jm = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(arrays[jax.tree_util.keystr(p)]) for p, _ in leaves])
    load_jax_arrays(tm, arrays)
    return jm, tm, X, Y


def test_is_parameter_and_constrained_match_jax():
    jm, tm, _, _ = _onoff_pair()
    for path in (("f", "q_mu"), ("likelihood", "variance"), ("f",)):
        jx, tx = jm, tm
        for a in path:
            jx, tx = getattr(jx, a), getattr(tx, a)
        assert tparams.is_parameter(tx) == jparams.is_parameter(jx)
    assert not tparams.is_parameter(tm.f.q_mu.raw) and not tparams.is_parameter(tm)
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jparams.constrained(jm))[0]}
    got = {jax_key(name).removesuffix(".raw"): v for name, v in tparams.constrained(tm).items()}
    assert set(got) == set(want)
    for key, v in got.items():
        np.testing.assert_allclose(v.detach().numpy(), want[key], rtol=1e-12, err_msg=key)
    # the names are lr_labels' names
    assert set(tparams.constrained(tm)) == set(tparams.lr_labels(tm))


# ---------------------------------------------------------------------------
# config: settings, default_float, jitter_level
# ---------------------------------------------------------------------------


def test_settings_default_float_and_jitter_level_restore_after_an_exception():
    s = tconfig.settings()
    assert (s.jitter, s.jitter_f32) == (jconfig.settings().jitter, jconfig.settings().jitter_f32) == (1e-6, 1e-5)
    assert tconfig.default_float() == torch.get_default_dtype()
    assert tconfig.default_jitter(torch.float64) == 1e-6 and tconfig.default_jitter(torch.float32) == 1e-5
    with pytest.raises(RuntimeError, match="inside"):
        with tconfig.jitter_level(3e-3):
            assert (s.jitter, s.jitter_f32) == (3e-3, 3e-3)
            assert tconfig.default_jitter(torch.float32) == 3e-3
            raise RuntimeError("inside the block")
    assert (s.jitter, s.jitter_f32) == (1e-6, 1e-5)


def test_a_model_keeps_the_jitter_level_it_was_created_in_as_jax():
    """Created inside ``jitter_level(1e-4)`` in both packages: the same
    jitter and ELBO, and both keep 1e-4 after the block ends; the port's
    model reads no setting after its creation, and the converter carries
    JAX's stored jitter. Created after the block: 1e-6 in float64, 1e-5
    once moved to float32."""
    Zs, X, Y, _, _ = _kron_fixture()
    with jconfig.jitter_level(1e-4), tconfig.jitter_level(1e-4):
        jm, tm, _, _ = _onoff_pair(jitter=None, perturb=False)
        assert jm.f.jitter == tm.f.jitter_for(torch.float64) == tm.g.jitter_for(torch.float32) == 1e-4
        inside = float(tm.elbo(_t(X), _t(Y)).detach())
    # JAX's ELBO after the block: the model's stored jitter, not the setting
    want = float(jax.jit(jm.elbo)(jnp.asarray(X), jnp.asarray(Y)))
    np.testing.assert_allclose(inside, want, rtol=1e-10)
    assert jm.f.jitter == tm.f.jitter_for(torch.float64) == 1e-4 and tm.f.jitter is None
    with tconfig.jitter_level(5e-2):
        after = float(tm.elbo(_t(X), _t(Y)).detach())
    assert after == inside

    # io.convert carries JAX's stored float across as an explicit jitter
    ks = lambda: [TRBF.create([0.5, 0.5], 1.0), TRBF.create([0.2], 1.0)]
    carried = TKronOnOffSVGP.create(ks(), Zs, ks(), Zs, TOnOffGaussian.create(0.01), num_data=100)
    load_jax_arrays(carried, dump_arrays(tm), jitter=jm.f.jitter)
    assert carried.f.jitter == carried.g.jitter == 1e-4 and carried.f.signature() == tm.f.signature()
    np.testing.assert_allclose(float(carried.elbo(_t(X), _t(Y)).detach()), want, rtol=1e-10)

    fresh = TKronOnOffSVGP.create(ks(), Zs, ks(), Zs, TOnOffGaussian.create(0.01), num_data=100)
    assert fresh.f.jitter_for(torch.float64) == 1e-6
    fresh32 = fresh.to(dtype=torch.float32)
    assert fresh32.f.jitter_for(torch.float32) == fresh32.g.jitter_for(torch.float32) == 1e-5
    # the pairing rule sees the frozen pair: models of two levels do not stack
    assert fresh.f.signature() != tm.f.signature() and tm.f.signature() == tm.g.signature()


def test_no_model_method_but_create_reads_the_settings():
    """After creation no model reads a global: only ``create`` calls
    ``settings``, ``default_jitter`` or ``jitter_pair``."""
    readers = {"settings", "default_jitter", "jitter_pair"}
    seen = []
    for path in sorted((ROOT / "zigp_tpu_torch" / "models").glob("*.py")):
        for cls in ast.parse(path.read_text()).body:
            if not isinstance(cls, ast.ClassDef):
                continue
            for fn in cls.body:
                if not isinstance(fn, ast.FunctionDef):
                    continue
                called = {n.func.id for n in ast.walk(fn) if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
                if called & readers:
                    seen.append((path.name, cls.name, fn.name))
    assert seen and all(fn == "create" for _, _, fn in seen), seen


# ---------------------------------------------------------------------------
# The API guard
# ---------------------------------------------------------------------------

# JAX module -> the port's, where the file differs
MODULE_MAP = {"ops/pallas": "ops/cuda"}

# "package:name" (a JAX __all__ entry) or "module:name" (a JAX public def or
# class) that the port does not have under that name, with the reason
EXCEPTIONS = {
    "training/alternating:make_alternating_device_step": "a device-sampling step builder: StagedBlocks with "
                                                         "BlockRunner does its work (make_alternating_block)",
    "training:make_alternating_device_step": "as training/alternating:make_alternating_device_step",
    "training/batched:make_batched_device_sampling_scan_step": "a device-sampling step builder: StackedBlocks with "
                                                               "BlockRunner does its work",
    "training/scan:make_device_sampling_scan_step": "removed on purpose: StagedBlocks.fill does its work",
    "training/batched:stack_pytrees": "renamed stack_models: the stack is one module, not a pytree",
    "training/batched:unstack_pytree": "renamed unstack_model",
    "training:stack_pytrees": "renamed stack_models",
    "training:unstack_pytree": "renamed unstack_model",
    "utils/profiling:StepTimer": "removed: no path of the port used it; its tools time through experiments.measure",
    "utils/profiling:time_fn": "removed: no path of the port used it; its tools time through experiments.measure",
    "utils/xprof:Plane": "an XSpace protobuf plane; the port reads torch-profiler Chrome traces",
    "utils/xprof:find_xplane_files": "XSpace files are the TPU profiler's; the port reads Chrome traces",
    "utils/xprof:load_xspace": "XSpace files are the TPU profiler's; the port reads Chrome traces",
}
# the Pallas kernels' entry points, each under its CUDA wrapper's name, in
# its module and in the package (ops/cuda/__init__.py)
for _module, _name, _wrapper in (("chol_inv", "chol_pallas", "chol_cuda"), ("chol_inv", "chol_inv_pallas", "chol_inv_cuda"),
                                 ("cholesky", "small_cholesky", "small_cholesky_cuda"),
                                 ("cholesky", "batched_small_cholesky", "batched_small_cholesky_cuda"),
                                 ("kron_matvec", "kron_mv_2", "kron_mv_2_cuda")):
    for _key in (f"ops/pallas/{_module}:{_name}", f"ops/pallas:{_name}"):
        EXCEPTIONS[_key] = f"renamed {_wrapper}: the CUDA kernel's launch wrapper"


def _public_defs(path: Path) -> set:
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


def _port_module(rel: str):
    for a, b in MODULE_MAP.items():
        if rel == a or rel.startswith(a + "/"):
            rel = b + rel[len(a):]
    return importlib.import_module("zigp_tpu_torch" + ("." + rel.replace("/", ".") if rel else ""))


def _jax_all(init: Path) -> list:
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return []


def _missing() -> list:
    jroot = ROOT / "zigp_tpu"
    missing = []
    for path in sorted(jroot.rglob("*.py")):
        if path.name == "__main__.py":  # the command line's entry, run on import
            continue
        rel = path.relative_to(jroot).with_suffix("").as_posix()
        if path.name == "__init__.py":
            rel = path.parent.relative_to(jroot).as_posix().removeprefix(".")
            names = _jax_all(path)
        else:
            names = sorted(_public_defs(path))
        port = _port_module(rel)
        missing += [f"{rel}:{n}" for n in names if not hasattr(port, n)]
    top = [n for n in ("core", "io", "likelihoods", "models", "ops", "parallel", "training", "utils", "bijectors",
                       "config", "Parameter", "param", "positive_param", "__version__")]
    port = importlib.import_module("zigp_tpu_torch")
    missing += [f":{n}" for n in top if not hasattr(port, n)]
    return missing


def test_the_port_has_every_public_name_of_the_jax_package():
    missing = _missing()
    unexplained = sorted(set(missing) - set(EXCEPTIONS))
    assert not unexplained, f"JAX public names missing from the port: {unexplained}"
    stale = sorted(set(EXCEPTIONS) - set(missing))
    assert not stale, f"exceptions the port no longer needs: {stale}"
    assert all(reason.strip() for reason in EXCEPTIONS.values())
    import zigp_tpu_torch as z

    assert z.__version__ == "0.1.0" and z.config is z.core.config and z.param is tparams.param


def test_importing_the_package_builds_nothing_and_starts_no_cuda():
    code = ("import sys, torch, zigp_tpu_torch, zigp_tpu_torch.experiments, zigp_tpu_torch.utils\n"
            "from zigp_tpu_torch.ops.cuda import _build\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert not _build._libs, _build._libs\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('matplotlib', 'jax', 'zigp_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)


# ---------------------------------------------------------------------------
# Packaging
# ---------------------------------------------------------------------------


def _package_data():
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)


def test_the_wheel_ships_every_cuda_source_and_header():
    """Every file ``ops/cuda/_build.py`` compiles or hashes, and every
    ``experiments/*.cu``, matches a package-data pattern of its package."""
    from zigp_tpu_torch.ops.cuda import _build

    data = _package_data()["tool"]["setuptools"]["package-data"]
    pkg_dir = lambda pkg: ROOT / pkg.replace(".", "/")
    wanted = {"zigp_tpu_torch.ops.cuda": sorted(_build.CSRC.glob("*.cu*")),
              "zigp_tpu_torch.experiments": sorted((ROOT / "zigp_tpu_torch" / "experiments").glob("*.cu"))}
    assert any(p.suffix == ".cuh" for p in wanted["zigp_tpu_torch.ops.cuda"])
    for pkg, files in wanted.items():
        assert files
        patterns = data.get(pkg, []) + data.get("*", [])
        for f in files:
            rel = f.relative_to(pkg_dir(pkg)).as_posix()
            assert any(fnmatch.fnmatch(rel, pat) for pat in patterns), f"{rel} is not in {pkg}'s package data"


def test_the_zigp_torch_script_resolves_to_the_port():
    project = _package_data()["project"]
    target = project["scripts"]["zigp-torch"]
    module, _, attr = target.partition(":")
    assert module.startswith("zigp_tpu_torch.")
    assert callable(getattr(importlib.import_module(module), attr))
    assert project["scripts"]["zigp"] == "zigp_tpu.experiments.cli:main"
    assert any(dep.startswith("torch") for dep in project["optional-dependencies"]["torch"])


# ---------------------------------------------------------------------------
# make_mesh with a CUDA device that has no index
# ---------------------------------------------------------------------------


def test_make_mesh_names_an_index_less_cuda_device_by_the_current_card(monkeypatch):
    from zigp_tpu_torch.parallel import make_mesh

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(d))
    mesh = make_mesh(1, 1, devices=["cuda"])
    assert mesh.device == torch.device("cuda", 3)
    assert calls == [3]
    mesh = make_mesh(1, 1, devices=[torch.device("cuda", 1)])
    assert mesh.device == torch.device("cuda", 1) and calls == [3, 1]
