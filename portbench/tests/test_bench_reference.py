"""The plain reference against the port on the CPU: the same loss,
gradients and 9 predictive fields in float64, and a whole tiny run of each
cell through the harness coming out correct."""

import time

import numpy as np
import pytest
import torch

from portbench.harness import data as D
from portbench.harness import manifest as M
from portbench.harness import program
from portbench.reference import onoff as R
from portbench.tests.tiny import tiny_root

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("config, kind", [("grid", "train"), ("flagship", "train"), ("grid", "serve")])
def test_reference_is_the_port_in_float64(root, config, kind):
    cfg = M.load_json("configs", config, root)
    cfg["jitter_relative"] = 0.0  # the port's float64 grams take the absolute jitter alone
    d = D.pptr(cfg["data"], 7)
    Zs = D.grid_factors(cfg, d, 7)
    state = (D.train_state if kind == "train" else D.serve_state)(cfg, Zs, 7)
    model = program.build_model(cfg, state, d.Xtrain.shape[0], CPU).to(torch.float64)
    ref = R.OnOffReference(cfg, d.Xtrain.shape[0])
    raws = {n: t.requires_grad_(True) for n, t in R.initial_raws(state, torch.float64, CPU).items()}
    X = torch.as_tensor(d.Xtrain[:48])
    Y = torch.as_tensor(d.Ytrain[:48])
    with torch.no_grad():
        for (n, p), (m, r) in zip(model.named_parameters(), raws.items()):
            assert n == m
            p.copy_(r)  # the float64 raws, not the float32-rounded ones the port was built with
    if kind == "train":
        lp = model.loss(X, Y)
        lr = ref.loss(raws, X, Y)
        assert float(lp.detach()) == pytest.approx(float(lr.detach()), rel=1e-9)
        gp = torch.autograd.grad(lp, list(model.parameters()))
        gr = torch.autograd.grad(lr, list(raws.values()))
        for a, b in zip(gp, gr):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-7, atol=1e-9 * float(b.abs().max()) + 1e-12)
    else:
        with torch.no_grad():
            p = model.predict(X)._asdict()
            r = ref.predict(raws, X)
        for k in R.FIELDS:
            np.testing.assert_allclose(p[k][:, 0].numpy(), r[k].numpy(), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("cell", ["grid.train", "flagship.train", "grid.serve", "flagship.train_mixed"])
def test_a_tiny_run_is_correct(root, cell):
    from portbench.run import run_cell

    c = M.Cell(M.load_manifest(), cell, root)
    result, checks = run_cell(c, 2**31 + 11, 0.2, False, CPU, t_process=time.perf_counter(), log=lambda s: None)
    assert result["correct"], [ch.line() for ch in checks]
    assert list(result)[-1] == "checks" and result["attempted"] > 0
    assert {m["name"] for m in c.end_to_end} == set(result["metrics"])
