"""The port's command line (``python -m zigp_tpu_torch.experiments``) on the
CPU, against the JAX package's.

- Parse parity: for each argv list both CLIs run with their runners replaced
  by recorders, and must call the same runner with configs equal field for
  field (the kernel zoo's family, period and alpha included) and the same
  splits.
- End to end with ``--device cpu --dtype float64`` on a pptr-shaped pickle
  (300 train rows, 10–20 steps, the mirror of ``tests/test_cli.py``):
  ``cvsplits``; ``onoff`` → ``classifier`` → ``svgp`` → ``hurdle`` → ``zi``;
  ``predict --samples 6``; ``export`` then ``load_predictor`` at two batch
  sizes against the restored model; ``hurdle --joint``; ``cv --split
  forecast --covariates``; ``cv --batched``; ``ensemble``; the kernel zoo's
  flags (``--kernel-temporal 'periodic*rbf' --kernel-period``, ``cv
  --kernel-spatial matern32``), each kernel built as the flags say.
- Every guard rail and every "not ported" exit, each with its message, the
  latter before any data is read.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from zigp_tpu.experiments import cli as jcli
from zigp_tpu_torch.experiments import cli as tcli


@pytest.fixture(autouse=True)
def _cli_log_handlers():
    """Both CLIs log through the "zigp" logger: close the handlers a test's
    runs added."""
    import logging

    logger = logging.getLogger("zigp")
    before = list(logger.handlers)
    yield
    for h in [h for h in logger.handlers if h not in before]:
        logger.removeHandler(h)
        h.close()


@pytest.fixture(scope="module")
def synth_pptr(tmp_path_factory):
    """``tests/test_cli.py``'s data: 300 train and 80 test rows shaped like
    pptr (raw ndatehour), about 40 % wet."""
    rng = np.random.RandomState(0)

    def gen(n):
        X = np.stack([59.8 + 10 * rng.rand(n), 20 + 11 * rng.rand(n), 4368 + 1079 * rng.rand(n)], 1)
        Y = np.maximum(np.sin(X[:, 2:3] / 100) * (rng.rand(n, 1) > 0.6), 0.0)
        return X, Y

    Xtr, Ytr = gen(300)
    Xte, Yte = gen(80)
    p = tmp_path_factory.mktemp("data") / "pptr.pickle"
    with open(p, "wb") as f:
        pickle.dump({"Xtrain": Xtr, "Ytrain": Ytr, "Xtest": Xte, "Ytest": Yte}, f)
    return str(p)


# ---------------------------------------------------------------------------
# parse parity
# ---------------------------------------------------------------------------

RUNNERS = {
    "runners": ("run_onoff", "run_svgp", "run_classifier", "run_hurdle", "run_hurdle_joint", "run_zero_inflated",
                "run_predict", "run_export"),
    "cv": ("run_cv",),
    "cv_batched": ("run_cv_batched",),
    "ensemble": ("run_ensemble",),
}

PARITY_ARGV = [
    "onoff --preset best --grid 6x6x100",
    "cv --split forecast --covariates --num-exog 4 --models onoff,svgp --origins 2",
    "cv --batched --ensemble 2 --hyper-every 10 --sampler device --models onoff,classifier",
    "hurdle --joint --likelihood gamma --gamma-shape 2.5",
    "svgp --kernel-trust 3 --whiten --lr-schedule cosine --lr 0.01 --q-cov kron",
    "classifier --optimizer natgrad --natgrad-gamma 0.05 --natgrad-kl-cap 4 --iters 12 --batch 64",
    "onoff --sampler device --hyper-every 10 --scan-inner 20 --kern-lr 0.02 --recalibrate-noise --fold 3",
    "predict --model hurdlej --samples 6 --preset reference-stable --likelihood lognormal",
    "export --model classifier --fixed-batch 8 --q-cov kron --natgrad-joint --out art.zigp",
    "ensemble --model svgp --size 3 --likelihood lognormal --lognormal-variance 0.3",
    "cv --models classifier,hurdle,zi --kernel-trust 3 --q-cov kron --optimizer natgrad --natgrad-joint "
    "--preset reference-stable --solve-precision highest --indp-lr 0.003 --lr-schedule constant --grid 5x7",
    "hurdle --fold 2 --grid 5x7 --batch 32 --kernel-temporal rbf",
    "onoff --kernel-temporal periodic*rbf --kernel-period 0.001 --kernel-trust 4",
    "cv --models onoff,svgp,classifier --kernel-spatial matern32 --kernel-temporal rq+linear --kernel-period 0.5",
]


def _record(monkeypatch, package):
    """Replace ``package``'s runners by recorders; returns the call list."""
    import importlib

    calls = []
    # every module first: ``cv`` binds the runners when it is imported
    modules = {mod: importlib.import_module(f"{package}.experiments.{mod}") for mod in RUNNERS}
    for mod, names in RUNNERS.items():
        module = modules[mod]
        for name in names:
            def rec(*a, _name=name, **k):
                calls.append((_name, a, k))
                return "artifact" if _name == "run_export" else {}

            monkeypatch.setattr(module, name, rec)
    return calls


def _same(got, want, where):
    if dataclasses.is_dataclass(want) and not isinstance(want, type) and hasattr(want, "Xtrain"):
        for f in ("Xtrain", "Ytrain", "Xtest", "Ytest"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=where)
    elif dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert dataclasses.asdict(got) == dataclasses.asdict(want), where
    elif isinstance(want, (list, tuple)) and want and hasattr(want[0], "Xtrain"):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{where}[{i}]")
    elif not callable(want):
        assert got == want, where


@pytest.mark.parametrize("argv", PARITY_ARGV)
def test_both_clis_call_the_same_runner_with_the_same_configs(argv, synth_pptr, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = argv.split() + ["--data", synth_pptr, "--workdir", "wd"]
    if argv.startswith("hurdle --fold"):  # the two-stage hurdle reads the classifier's results
        os.makedirs("wd/2", exist_ok=True)
        with open("wd/2/results_scgp.pickle", "wb") as f:
            pickle.dump({"pred_train": {}}, f)
    want = _record(monkeypatch, "zigp_tpu")
    assert jcli.main(args) == 0
    got = _record(monkeypatch, "zigp_tpu_torch")
    assert tcli.main(args + ["--device", "cpu"]) == 0
    assert [c[0] for c in got] == [c[0] for c in want]
    (name, ja, jk), (_, ta, tk) = want[0], got[0]
    assert len(ta) == len(ja) and set(jk) <= set(tk)
    assert (tk["device"].type, tk["dtype"], tk["use_kernel"]) == ("cpu", torch.float32, False)
    for i, (a, b) in enumerate(zip(ta, ja)):
        _same(a, b, f"{name} arg {i}")
    for k in jk:
        _same(tk[k], jk[k], f"{name} {k}")


def test_device_cuda_turns_the_gram_kernel_on(synth_pptr, tmp_path, monkeypatch):
    """``--device cuda`` (the default) gives the runners the card and the
    gram kernel; without a card it stops before any work."""
    monkeypatch.chdir(tmp_path)
    calls = _record(monkeypatch, "zigp_tpu_torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tcli.main(["onoff", "--data", synth_pptr, "--workdir", "wd"]) == 0
    assert (calls[0][2]["device"].type, calls[0][2]["use_kernel"]) == ("cuda", True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device is available; pass --device cpu"):
        tcli.main(["onoff", "--data", synth_pptr, "--workdir", "wd"])


def test_help_lists_the_jax_subcommands(capsys):
    with pytest.raises(SystemExit):
        tcli.main(["--help"])
    out = capsys.readouterr().out
    for cmd in ("toy", "cvsplits", "selfcheck", "onoff", "svgp", "classifier", "hurdle", "zi", "predict", "export",
                "ensemble", "cv"):
        assert cmd in out


# ---------------------------------------------------------------------------
# end to end on the CPU
# ---------------------------------------------------------------------------

CPU = ["--device", "cpu", "--dtype", "float64"]
SMALL = ["--grid", "3x8", "--scan-inner", "10"]


def _run(*argv):
    assert tcli.main(list(argv) + CPU) == 0


@pytest.fixture(scope="module")
def trained(synth_pptr, tmp_path_factory):
    """onoff → classifier → svgp → hurdle → zi on fold 1 in one workdir."""
    wd = str(tmp_path_factory.mktemp("runs"))
    common = ["--fold", "1", "--data", synth_pptr, "--workdir", wd, "--iters", "20", *SMALL]
    _run("onoff", *common, "--batch", "64")
    _run("classifier", *common, "--batch", "64")
    _run("svgp", *common, "--batch", "64")
    _run("hurdle", *common, "--batch", "32")
    _run("zi", "--fold", "1", "--data", synth_pptr, "--workdir", wd)
    return wd, common


def test_cvsplits(synth_pptr, tmp_path):
    assert tcli.main(["cvsplits", "--data", synth_pptr, "--out", str(tmp_path / "cv")]) == 0
    with open(tmp_path / "cv" / "5" / "data.pickle", "rb") as f:
        assert set(pickle.load(f)) == {"Xtrain", "Ytrain", "Xtest", "Ytest"}


def test_the_fold_chain_writes_every_result(trained):
    wd, _ = trained
    for name in ("onoff", "scgp", "svgp", "hurdle", "zi"):
        assert os.path.exists(os.path.join(wd, "1", f"results_{name}.pickle")), name
    assert os.path.exists(os.path.join(wd, "1", "modelsumm_zi.log"))


def test_predict_restores_and_samples(trained):
    wd, common = trained
    _run("predict", "--model", "onoff", *common, "--samples", "6")
    with open(os.path.join(wd, "1", "predictions_onoff.pickle"), "rb") as f:
        preds = pickle.load(f)
    s = preds["y_samples"]
    assert s.shape == (6, 76, 1) and np.isfinite(s).all()
    assert preds["restored_step"] == 20
    with open(os.path.join(wd, "1", "results_onoff.pickle"), "rb") as f:
        trained_res = pickle.load(f)
    np.testing.assert_array_equal(preds["pred_test"]["gfmean"], trained_res["pred_test"]["gfmean"])
    _run("predict", "--model", "classifier", *common, "--samples", "4")
    with open(os.path.join(wd, "1", "predictions_classifier.pickle"), "rb") as f:
        labels = pickle.load(f)["y_samples"]
    assert labels.shape == (4, 76, 1) and set(np.unique(labels)) <= {0.0, 1.0}


def test_export_serves_the_restored_model(trained, synth_pptr):
    """One symbolic-batch artifact at two batch sizes, within 1e-12 of each
    field's largest value of the restored model's predictions."""
    from zigp_tpu_torch.experiments import runners
    from zigp_tpu_torch.experiments.configs import preset_configs
    from zigp_tpu_torch.io.export import _predict_dict_fn, load_predictor

    wd, common = trained
    _run("export", "--model", "onoff", *common)
    served = load_predictor(os.path.join(wd, "1", "export_onoff.zigp"))
    split = tcli._load_fold(type("A", (), {"data": synth_pptr, "fold": 1}))
    cfg = dataclasses.replace(preset_configs("reference")["onoff"], grid=tcli._parse_grid("3x8"))
    model, step, _ = runners._restore_model(split, "onoff", cfg, os.path.join(wd, "1"), lambda s: None, device="cpu",
                                            dtype=torch.float64)
    assert step == 20
    for n in (7, 30):
        X = split.Xtest[:n]
        got = served(X)
        with torch.no_grad():
            want = {k: v.numpy() for k, v in _predict_dict_fn(model, "onoff")(torch.as_tensor(X)).items()}
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= 1e-12 * np.abs(want[k]).max(), k
    with pytest.raises(SystemExit, match="no checkpoint"):
        tcli.main(["export", "--model", "hurdlej", *common, *CPU])


def test_hurdle_joint_with_a_gamma_head(synth_pptr, tmp_path):
    wd = str(tmp_path / "runs")
    _run("hurdle", "--joint", "--fold", "1", "--data", synth_pptr, "--workdir", wd, "--iters", "10", "--batch", "32",
         "--likelihood", "gamma", *SMALL)
    assert (tmp_path / "runs" / "1" / "results_hurdlej.pickle").exists()


def test_cv_forecast_with_covariates(synth_pptr, tmp_path):
    wd = tmp_path / "fc"
    _run("cv", "--models", "onoff,classifier", "--split", "forecast", "--covariates", "--num-exog", "3",
         "--origins", "2", "--data", synth_pptr, "--workdir", str(wd), "--iters", "10", "--batch", "32", *SMALL)
    with open(wd / "cv_summary.json") as f:
        text = f.read()
    assert "onoff" in text and "classifier" in text
    with open(wd / "2" / "results_onoff.pickle", "rb") as f:
        assert np.isfinite(pickle.load(f)["test_rmse"])
    assert "exogenous covariates on (3 knots)" in (wd / "modelsumm_cv.log").read_text()


def test_cv_batched_and_ensemble(synth_pptr, tmp_path):
    _run("cv", "--models", "onoff", "--batched", "--data", synth_pptr, "--workdir", str(tmp_path / "cvb"),
         "--iters", "10", "--batch", "32", *SMALL)
    assert (tmp_path / "cvb" / "cv_summary.json").exists()
    _run("ensemble", "--model", "svgp", "--size", "2", "--data", synth_pptr, "--workdir", str(tmp_path / "ens"),
         "--iters", "10", "--batch", "32", *SMALL)


ZOO_RUNS = {
    "onoff --kernel-temporal periodic*rbf --kernel-period 0.001": {("rbf", ()), ("periodic*rbf", (0.001,))},
    "cv --models onoff --batched --kernel-spatial matern32": {("matern32", ()), ("rbf", ())},
}


@pytest.mark.parametrize("argv", list(ZOO_RUNS))
def test_kernel_zoo_flags_train_end_to_end(argv, synth_pptr, tmp_path, monkeypatch):
    """A few steps on the CPU with the zoo's flags: every kernel is built
    from a config that carries the family and the period, and the run
    writes its results."""
    from zigp_tpu_torch.experiments import builders

    built = set()
    make_kernel = builders.make_kernel

    def recorded(init, **kw):
        built.add((init.family, tuple(init.period)))
        return make_kernel(init, **kw)

    monkeypatch.setattr(builders, "make_kernel", recorded)
    wd = tmp_path / "zoo"
    _run(*argv.split(), "--data", synth_pptr, "--workdir", str(wd), "--iters", "10", "--batch", "32", *SMALL)
    assert built == ZOO_RUNS[argv]
    result = wd / "1" / "results_onoff.pickle"
    with open(result if result.exists() else wd / "cv_summary.json", "rb") as f:
        assert f.read()


# ---------------------------------------------------------------------------
# guard rails and "not ported" exits
# ---------------------------------------------------------------------------

GUARDS = {
    "cv --split forecast --batched": "not supported with --batched",
    "cv --covariates": "--covariates requires --split forecast",
    "cv --ensemble 2": "--ensemble requires --batched",
    "onoff --fold 9": "--fold must be in 1..5",
    "onoff --grid 10": "--grid must be SxT",
    "hurdle": "run the 'classifier' experiment",
    "predict --model svgp": "no checkpoint",
    "onoff --hyper-every 10 --iters 50": "requires --sampler device",
    "onoff --mesh-data 2": "torchrun --nproc-per-node 2",
    "onoff --sampler device --hyper-every 10 --iters 50 --mesh-data 1": "--hyper-every does not compose with --mesh-",
}


@pytest.mark.parametrize("argv", list(GUARDS))
def test_guard_rails(argv, synth_pptr, tmp_path):
    with pytest.raises(SystemExit, match=GUARDS[argv]):
        tcli.main(argv.split() + ["--data", synth_pptr, "--workdir", str(tmp_path / "wd"), "--batch", "32", *SMALL[2:],
                                  *CPU])


def test_natgrad_with_mesh_model_warns_and_trains_on_one_rank(synth_pptr, tmp_path):
    """Tensor parallelism does not compose with the natural gradients: the
    JAX runner's warning, then a one-rank run (no mesh_data asked)."""
    wd = tmp_path / "wd"
    _run("onoff", "--optimizer", "natgrad", "--mesh-model", "2", "--sampler", "device", "--data", synth_pptr,
         "--workdir", str(wd), "--iters", "20", "--batch", "32", *SMALL)
    with open(wd / "1" / "modelsumm_onoff.log") as f:
        log = f.read()
    assert ("warning: tensor parallelism (mesh_model > 1) is not supported with optimizer=natgrad; training "
            "single-device") in log
    assert "mesh:" not in log
    assert (wd / "1" / "results_onoff.pickle").exists()


NOT_PORTED = {
    "toy --plot toy.png": "toy --plot is not ported",
    "selfcheck": "'selfcheck' is not ported",
    "onoff --solve-precision high": "--solve-precision high is not ported",
    "cv --solve-precision mixed": "--solve-precision mixed is not ported",
}


@pytest.mark.parametrize("argv", list(NOT_PORTED))
def test_not_ported_exits_before_any_work(argv, tmp_path):
    """A data path that does not exist: reading it would raise
    FileNotFoundError, so the exit comes first."""
    extra = [] if argv.split()[0] in ("toy", "selfcheck") else ["--data", str(tmp_path / "absent.pickle"), "--device", "cpu"]
    with pytest.raises(SystemExit, match=NOT_PORTED[argv]):
        tcli.main(argv.split() + extra)
    assert not (tmp_path / "runs").exists()
