"""The port's serving artifact (``io.export``) and the custom ops it records,
on the CPU in float64.

- Each kind's ``torch.export`` program, loaded without the model, against
  the live model's predict dict at two batch sizes through one
  symbolic-batch artifact (1e-12 of each field's largest value), the JAX
  package's output names, a pinned batch, input validation.
- Each package's loader refuses the other's artifact by its magic.
- With ``chol_inv``'s route set as on the card (the kernel to n = 238, the
  cluster kernel above) and the gram kernel flag on, the program records one
  ``zigp_tpu_torch::chol_inv``/``chol_inv_blocked`` call per factor and one
  ``zigp_tpu_torch::rbf_gram`` call per gram, whatever the batch; here the
  ops run their plain versions and launch nothing.
- ``torch.library.opcheck`` of the three ops (schema, fake implementation,
  dynamic shapes) on CPU tensors; ``chol_inv`` through its op under
  ``torch.func.vmap`` and ``grad``.
"""

import numpy as np
import pytest
import torch

from zigp_tpu_torch.experiments import builders, configs
from zigp_tpu_torch.io.datasets import Split
from zigp_tpu_torch.io.export import _predict_dict_fn, export_predictor, load_predictor
from zigp_tpu_torch.ops import linalg
from zigp_tpu_torch.ops.cuda import chol_inv as ci
from zigp_tpu_torch.ops.cuda import rbf_gram as rg

from .torch_helpers import one_torch_thread_per_module  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

CPU64 = dict(device="cpu", dtype=torch.float64)
OUTPUTS = {
    "onoff": ["fmean", "fvar", "gfmean", "gfmeanu", "gfvar", "gmean", "gvar", "pgmean", "pgvar"],
    "svgp": ["fmean", "fvar"],
    "classifier": ["fmean", "fvar", "p"],
    "hurdlej": ["fmean", "fvar", "gmean", "gvar", "p_on"],
}
BUILD = {
    "onoff": (builders.build_onoff_pptr, "OnOffPptrConfig"),
    "svgp": (builders.build_svgp_pptr, "SvgpPptrConfig"),
    "classifier": (builders.build_classifier_pptr, "ClassifierPptrConfig"),
    "hurdlej": (builders.build_hurdle_joint_pptr, "HurdleJointConfig"),
}


@pytest.fixture(scope="module")
def split():
    rng = np.random.RandomState(0)

    def gen(n):
        X = rng.rand(n, 3)
        return X, np.maximum(np.sin(4 * X[:, 2:3]) * (rng.rand(n, 1) > 0.5), 0.0)

    return Split(*gen(150), *gen(40))


def _model(kind, split, grid=(3, 6), use_kernel=False, seed=0):
    """The kind's model on the CPU in float64, its raws moved off the init."""
    build, cfg = BUILD[kind]
    model = build(getattr(configs, cfg)(grid=configs.KronGridConfig(*grid)), split, use_kernel=use_kernel, **CPU64)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.endswith("q_sqrt.raw") and ".Zs." not in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen, dtype=p.dtype))
    return model


def _live(model, kind, X):
    with torch.no_grad():
        out = _predict_dict_fn(model, kind)(torch.as_tensor(X))
    return {k: (torch.stack(v) if isinstance(v, tuple) else v).numpy() for k, v in out.items()}


def _close(got, want, tol=1e-12):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        scale = max(np.abs(want[k]).max(), 1e-300)
        assert np.abs(got[k] - want[k]).max() <= tol * scale, k


@pytest.mark.parametrize("kind", ["onoff", "svgp", "classifier", "hurdlej"])
def test_round_trip_symbolic_batch(kind, split, tmp_path):
    model = _model(kind, split)
    path = export_predictor(model, kind, 3, str(tmp_path / f"{kind}.zigp"))
    served = load_predictor(path)
    assert served.meta["kind"] == kind and served.meta["batch_size"] is None
    assert served.meta["outputs"] == OUTPUTS[kind]
    assert (served.meta["device"], served.meta["dtype"]) == ("cpu", "float64")
    for n in (7, 23):  # two request sizes through one artifact
        X = split.Xtest[:n]
        _close(served(X), _live(model, kind, X))


def test_fixed_batch_and_input_validation(split, tmp_path):
    model = _model("classifier", split)
    served = load_predictor(export_predictor(model, "classifier", 3, str(tmp_path / "clf.zigp"), batch_size=8))
    assert served.meta["batch_size"] == 8
    _close(served(split.Xtest[:8]), _live(model, "classifier", split.Xtest[:8]))
    with pytest.raises(ValueError, match="fixed batch"):
        served(split.Xtest[:5])
    with pytest.raises(ValueError, match="expected"):
        served(np.zeros((8, 2)))
    bad = tmp_path / "bad.zigp"
    bad.write_bytes(b"not an artifact\njunk")
    with pytest.raises(ValueError, match="not a zigp_tpu_torch export artifact"):
        load_predictor(str(bad))
    with pytest.raises(ValueError, match="unknown export kind"):
        export_predictor(model, "nope", 3, str(tmp_path / "x.zigp"))


def test_each_loader_refuses_the_others_artifact(split, tmp_path):
    from zigp_tpu.experiments import builders as jbuilders
    from zigp_tpu.experiments import configs as jconfigs
    from zigp_tpu.io import datasets as jdatasets
    from zigp_tpu.io import export as jexport

    jmodel = jbuilders.build_svgp_pptr(jconfigs.SvgpPptrConfig(grid=jconfigs.KronGridConfig(3, 6)),
                                       jdatasets.Split(split.Xtrain, split.Ytrain, split.Xtest, split.Ytest))
    jpath = jexport.export_predictor(jmodel, "svgp", 3, str(tmp_path / "jax.zigp"))
    tpath = export_predictor(_model("svgp", split), "svgp", 3, str(tmp_path / "torch.zigp"))
    with pytest.raises(ValueError, match="zigp_tpu \\(JAX\\) export artifact"):
        load_predictor(jpath)
    with pytest.raises(ValueError, match="not a zigp export artifact"):
        jexport.load_predictor(tpath)


def _card_route(n, dtype, device_type):
    """``chol_inv_route`` as it routes float32 on the card."""
    return "kernel" if n <= ci.MAX_N else "cluster" if n <= ci.BLOCKED_MAX_N else "library"


def _op_calls(program) -> dict:
    names = {torch.ops.zigp_tpu_torch.chol_inv.default: "chol_inv",
             torch.ops.zigp_tpu_torch.chol_inv_blocked.default: "chol_inv_blocked",
             torch.ops.zigp_tpu_torch.rbf_gram.default: "rbf_gram"}
    out = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and node.target in names:
            out[names[node.target]] = out.get(names[node.target], 0) + 1
    return out


def test_the_kernel_route_is_recorded_as_the_ops(split, tmp_path, monkeypatch):
    """The on/off model at a 3 x 250 grid: factor n = 3 by chol_inv, n = 250
    by chol_inv_blocked, the f/g pair in one call each, and the K_mm and
    K_mn grams of both factors by rbf_gram."""
    monkeypatch.setattr(linalg, "chol_inv_route", _card_route)
    model = _model("onoff", split, grid=(3, 250), use_kernel=True)
    counts = (ci.chol_inv_cuda.launches, ci.chol_inv_blocked.launches, rg.rbf_gram_cuda.launches)
    served = load_predictor(export_predictor(model, "onoff", 3, str(tmp_path / "onoff.zigp")))
    assert _op_calls(served._program) == {"chol_inv": 1, "chol_inv_blocked": 1, "rbf_gram": 4}
    for n in (5, 40):
        _close(served(split.Xtest[:n]), _live(model, "onoff", split.Xtest[:n]))
    assert (ci.chol_inv_cuda.launches, ci.chol_inv_blocked.launches, rg.rbf_gram_cuda.launches) == counts


def test_the_library_route_records_no_op(split, tmp_path):
    """On the CPU (the library factorization, the gram kernel flag off) the
    program calls none of the registered ops."""
    model = _model("svgp", split)
    served = load_predictor(export_predictor(model, "svgp", 3, str(tmp_path / "svgp.zigp")))
    assert _op_calls(served._program) == {}


def _spd(G, n, seed=0, dtype=torch.float64):
    A = np.random.RandomState(seed).randn(G, n, n)
    return torch.as_tensor(A @ A.transpose(0, 2, 1) + n * np.eye(n), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("op", ["chol_inv", "chol_inv_blocked", "rbf_gram"])
def test_opcheck_on_cpu(op, dtype):
    if op == "rbf_gram":
        rng = np.random.RandomState(1)
        t = lambda a: torch.as_tensor(a, dtype=dtype)
        for X, Z in ((rng.rand(7, 3), rng.rand(2, 4, 3)), (rng.rand(2, 7, 5), rng.rand(4, 5))):
            torch.library.opcheck(rg.rbf_gram_op, (t(X), t(Z), t(rng.rand(2, X.shape[-1]) + 0.5),
                                                    t(rng.rand(2) + 0.5)))
        return
    fn = ci.chol_inv_op if op == "chol_inv" else ci.chol_inv_blocked_op
    torch.library.opcheck(fn, (_spd(2, 6, dtype=dtype),))


def test_chol_inv_op_under_vmap_and_grad(monkeypatch):
    """The member stack's path: ``linalg.chol_inv`` on the kernel route under
    ``torch.func.vmap`` (its rule folds the members into one op call) and
    ``torch.func.grad`` equal to each member alone on the library route."""
    K = _spd(3, 5, seed=2)[:, None].expand(3, 2, 5, 5).contiguous()  # F = 3 members of G = 2
    loss = lambda A: sum(torch.sum(torch.sin(t)) for t in linalg.chol_inv(A))
    want = [torch.func.grad(loss)(K[f]) for f in range(3)]
    calls = []
    monkeypatch.setattr(linalg, "chol_inv_route", _card_route)
    monkeypatch.setattr(ci, "chol_inv_cuda", lambda A: calls.append(tuple(A.shape)) or ci.chol_inv_plain(A))
    got = torch.func.vmap(torch.func.grad(loss))(K)
    assert calls == [(6, 5, 5)]  # one call for the stack
    for f in range(3):
        torch.testing.assert_close(got[f], want[f], rtol=1e-10, atol=1e-12)
