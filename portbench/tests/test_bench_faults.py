"""A whole tiny run of each cell on the CPU, with the timed path broken
underneath, comes out not correct: a step that leaves the state unchanged,
half of the batch left out with the mean taken over the rest, each of
these in the replayed blocks alone, a sampler that stops advancing, an
answer altered where it is produced. And the control (the reference in the
configuration's next lower precision, in the program's place) fails the
cell's limits. The cells are on one chip: no exchange between chips to
leave out."""

import time

import pytest
import torch

from portbench.harness import compare, train
from portbench.harness import manifest as M
from portbench.tests.tiny import tiny_root

CPU = torch.device("cpu")
SEED = 2**31 + 17
TINY_K = 5  # the tiny mixes' block of steps (``tiny.tiny_root``)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def run(root, cell):
    from portbench.run import run_cell

    c = M.Cell(M.load_manifest(), cell, root)
    result, checks = run_cell(c, SEED, 0.2, False, CPU, t_process=time.perf_counter(), log=lambda s: None)
    return result


def state_unchanged(monkeypatch):
    from zigp_tpu_torch.training.optim import GroupedAdam

    monkeypatch.setattr(GroupedAdam, "step", lambda self: None)


def half_batch(monkeypatch):
    from zigp_tpu_torch.models import KronOnOffSVGP

    loss = KronOnOffSVGP.loss

    def half(self, X, Y, **kw):
        n = X.shape[0] // 2
        return loss(self, X[:n], Y[:n], **kw)

    monkeypatch.setattr(KronOnOffSVGP, "loss", half)


def after_the_first_block(monkeypatch, cls, name, broken):
    """``cls.name`` as it is for the first block's K calls, then ``broken``:
    a fault of the replayed blocks alone (on the card the eager first block
    and the graph's replays are different paths)."""
    real = getattr(cls, name)
    calls = [0]

    def patched(self, *a, **kw):
        calls[0] += 1
        return (real if calls[0] <= TINY_K else broken(real))(self, *a, **kw)

    monkeypatch.setattr(cls, name, patched)


def replay_state_unchanged(monkeypatch):
    from zigp_tpu_torch.training.optim import GroupedAdam

    after_the_first_block(monkeypatch, GroupedAdam, "step", lambda real: lambda self: None)


def replay_half_batch(monkeypatch):
    from zigp_tpu_torch.models import KronOnOffSVGP

    def half(real):
        return lambda self, X, Y, **kw: real(self, X[: X.shape[0] // 2], Y[: Y.shape[0] // 2], **kw)

    after_the_first_block(monkeypatch, KronOnOffSVGP, "loss", half)


def sampler_stuck(monkeypatch):
    from zigp_tpu_torch.training.scan import StagedBlocks

    fill = StagedBlocks.fill
    monkeypatch.setattr(StagedBlocks, "fill", lambda self, block: fill(self, 0))


def answer_altered(monkeypatch):
    from zigp_tpu_torch.models import KronOnOffSVGP

    predict = KronOnOffSVGP.predict

    def shifted(self, X):  # each row gets its neighbour's answer
        out = predict(self, X)
        return type(out)(*(torch.roll(f, 1, dims=0) for f in out))

    monkeypatch.setattr(KronOnOffSVGP, "predict", shifted)


@pytest.mark.parametrize("cell", ["grid.train", "flagship.train", "grid.serve", "flagship.train_mixed"])
def test_sound_run_is_correct(root, cell):
    assert run(root, cell)["correct"]


TRAIN_FAULTS = [state_unchanged, half_batch, replay_state_unchanged, replay_half_batch, sampler_stuck]


@pytest.mark.parametrize("cell, fault", [
    *((cell, fault) for cell in ("grid.train", "flagship.train", "flagship.train_mixed") for fault in TRAIN_FAULTS),
    ("grid.serve", answer_altered),
])
def test_a_broken_path_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not run(root, cell)["correct"]


@pytest.mark.parametrize("cell", ["grid.train", "flagship.train", "flagship.train_mixed"])
def test_the_control_fails(root, cell):
    c = M.Cell(M.load_manifest(), cell, root)
    d, state, ss = train.inputs_of(c, SEED)
    ref = train.reference_readings(c, d, state, ss, CPU)
    low = train.reference_readings(c, d, state, ss, CPU, dtype=torch.float32, **c.control)
    assert not all(ch.ok for ch in compare.checks(compare.train_numbers(low, ref, **c.numbers), c.limits))


def test_the_serving_control_fails(root):
    from portbench.harness import serve

    c = M.Cell(M.load_manifest(), "grid.serve", root)
    d, state = serve.inputs_of(c, SEED)
    ref = serve.reference_fields(c, state, d.Xtest, d.Xtrain.shape[0], CPU)
    low = serve.reference_fields(c, state, d.Xtest, d.Xtrain.shape[0], CPU, dtype=torch.float32, **c.control)
    assert not all(ch.ok for ch in compare.checks(compare.serve_numbers(low, ref), c.limits))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["grid.train", "flagship.train", "flagship.train_mixed", "grid.serve"])
def test_the_control_fails_at_the_cells_size(cell):
    """On the card, at the cell's own size: the control fails the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from portbench.calibrate import serve_readings, train_readings

    c = M.Cell(M.load_manifest(), cell)
    dev = torch.device("cuda", 0)
    gen = (train_readings(c, [], [SEED], dev, lambda s: None) if c.kind == "train"
           else serve_readings(c, [], [SEED], 0.0, dev, lambda s: None))
    control = next(r for r in gen if r["side"] == "control")
    numbers = {k: v for k, v in control.items() if k in c.limits}
    assert not all(ch.ok for ch in compare.checks(numbers, c.limits))
