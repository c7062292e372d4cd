"""The port's checkpoints and metric logs against the JAX package's, on the CPU.

- ``CheckpointManager``'s layout (``step_{step:010d}``) and its cadence
  (``maybe_save``, ``crossed``, ``latest_step``) equal the JAX manager's;
- a restore writes every parameter and every Adam tensor, the step counts
  included, into the storage that exists (``data_ptr`` unchanged), so a CUDA
  graph captured over it stays valid, and resets the lrs from the restored
  step count; the partial, model-only restore; what a restore refuses;
- ``MetricLogger`` writes the JAX logger's records, and ``log_param_tree``
  the JAX keys, for the model and for its gradients.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from zigp_tpu.io.checkpoint import CheckpointManager as JCheckpointManager
from zigp_tpu.utils.logging import MetricLogger as JMetricLogger
from zigp_tpu_torch.io.checkpoint import CheckpointManager, restore, save
from zigp_tpu_torch.training import cosine_adam, make_optimizer, make_scan_train_step
from zigp_tpu_torch.training.optim import cosine_scale
from zigp_tpu_torch.utils.logging import MetricLogger

from .test_torch_train import _pair_models, _staged_block, _t


def _trained(K=4, **kw):
    _, tm = _pair_models(whiten=True, q_cov="kron", perturb=True, kern_lr=1e-2, **kw)
    opt = make_optimizer(tm, default_lr=1e-3, schedule=cosine_adam(20))
    step = make_scan_train_step(opt)
    Xs, Ys = _staged_block(K=K)
    step(tm, _t(Xs), _t(Ys))
    return tm, opt, lambda: step(tm, _t(Xs), _t(Ys))


def _storage(tm, opt):
    """Every tensor a captured step reads or writes, by name."""
    out = {f"param {n}": p for n, p in tm.named_parameters()}
    out.update({f"grad {n}": p.grad for n, p in zip(opt.names, opt.params)})
    for n, ts in opt.state_tensors().items():
        out.update({f"{k} {n}": t for k, t in ts.items()})
    out.update({f"lr {g['label']}": g["lr"] for g in opt.adam.param_groups})
    return out


def test_layout_and_cadence_match_jax(tmp_path):
    ours, theirs = CheckpointManager(str(tmp_path / "a"), every=10), JCheckpointManager(str(tmp_path / "b"), every=10)
    assert os.path.basename(ours._path(20)) == os.path.basename(theirs._path(20)) == "step_0000000020"
    for prev in range(0, 35, 5):
        for step in (prev + 1, prev + 5, prev + 10, prev + 25):
            assert ours.crossed(prev, step) == theirs.crossed(prev, step)
    for name in ("step_0000000010", "step_0000000030", "step_0000000020.tmp-1", "other"):
        for mgr in (ours, theirs):
            os.makedirs(os.path.join(mgr.directory, name))
    assert ours.latest_step() == theirs.latest_step() == 30
    assert CheckpointManager(str(tmp_path / "empty")).latest_step() is None


def test_save_restore_round_trip_and_maybe_save(tmp_path):
    tm, opt, more = _trained()
    mgr = CheckpointManager(str(tmp_path / "ck"), every=4)
    assert mgr.maybe_save(3, tm, opt) is None and mgr.latest_step() is None
    mgr.maybe_save(4, tm, opt)
    assert sorted(os.listdir(mgr.directory)) == ["step_0000000004"]
    saved = {k: v.clone() for k, v in _storage(tm, opt).items() if not k.startswith("grad")}
    more()
    assert any(not torch.equal(saved[k], v) for k, v in _storage(tm, opt).items() if k in saved)
    _, _, step = mgr.restore_latest(tm, opt)
    assert step == 4
    for k, v in _storage(tm, opt).items():
        if k in saved:
            assert torch.equal(v, saved[k]), k
    assert float(opt.step_count) == 4.0


def test_restore_keeps_every_data_ptr(tmp_path):
    """The parameters, the gradient views, the moments, the step counts and
    the lrs keep their storage through a restore (what a graph reads)."""
    tm, opt, more = _trained()
    save(str(tmp_path / "ck"), tm, opt, step=4)
    ptrs = {k: v.data_ptr() for k, v in _storage(tm, opt).items()}
    more()
    restore(str(tmp_path / "ck"), tm, opt)
    assert {k: v.data_ptr() for k, v in _storage(tm, opt).items()} == ptrs
    for g in opt.adam.param_groups:  # the lr of the next update, from the restored count
        np.testing.assert_allclose(float(g["lr"]), g["base_lr"] * cosine_scale(4, 20), rtol=1e-12)


def test_restore_model_only_for_prediction(tmp_path):
    tm, opt, more = _trained()
    save(str(tmp_path / "ck"), tm, opt, step=7)
    want = {n: p.detach().clone() for n, p in tm.named_parameters()}
    fresh = _pair_models(whiten=True, q_cov="kron")[1]
    model, opt_state, step = restore(str(tmp_path / "ck"), fresh)
    assert model is fresh and opt_state is None and step == 7
    for n, p in fresh.named_parameters():
        assert torch.equal(p, want[n]), n


def test_restore_refuses_a_mismatch_before_writing(tmp_path):
    tm, opt, _ = _trained()
    save(str(tmp_path / "model_only"), tm, None, step=1)
    with pytest.raises(KeyError, match="no optimizer state"):
        restore(str(tmp_path / "model_only"), tm, opt)
    save(str(tmp_path / "diag"), _pair_models()[1], None)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    with pytest.raises(KeyError):  # the diagonal family has no q_sqrt_factors
        restore(str(tmp_path / "diag"), tm)
    for n, p in tm.named_parameters():
        assert torch.equal(p, before[n]), n


def test_metric_logger_records_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    hist = {"a": rng.randn(7, 3), "b": rng.rand(1), "c": np.zeros(0)}
    paths = [str(tmp_path / "j" / "m.jsonl"), str(tmp_path / "t" / "m.jsonl")]
    for cls, path in zip((JMetricLogger, MetricLogger), paths):
        logger = cls(path)
        logger.log(5, scalars={"loss": 1.5, "elbo": -1.5}, histograms=hist)
        logger.log(10, histograms={"a": torch.as_tensor(hist["a"]) if cls is MetricLogger else hist["a"]})
        logger.close()
    recs = [[json.loads(line) for line in open(p)] for p in paths]
    for j, t in zip(*recs):
        j.pop("wall"), t.pop("wall")
        assert j == t


@pytest.mark.parametrize("q_cov", ["diag", "kron"])
def test_log_param_tree_keys_match_jax(tmp_path, q_cov):
    jm, tm = _pair_models(whiten=q_cov == "kron", q_cov=q_cov, perturb=True)
    jl, tl = JMetricLogger(), MetricLogger()
    want = jl.log_param_tree(3, jm, prefix="param")
    got = tl.log_param_tree(3, tm, prefix="param")
    grads = tl.log_param_tree(3, {n: torch.zeros_like(p) for n, p in tm.named_parameters()}, prefix="grad")
    assert set(got) == set(want)
    assert {k.replace("hist/grad", "hist/param") for k in grads} == set(want)
    for k, v in want.items():
        if k.startswith("hist/"):
            for stat, x in v.items():
                np.testing.assert_allclose(got[k][stat], x, rtol=1e-12, atol=1e-15, err_msg=f"{k} {stat}")
    assert len(jax.tree_util.tree_leaves(jm)) == len(list(tm.parameters()))


def test_save_final_on_a_mesh_takes_rank_0s_reading(tmp_path):
    """Ranks that share a checkpoint directory decide the final save on rank
    0's reading of it (``Mesh.agree``). Here the view of a slower rank: rank
    0 found no final checkpoint and has already written it, so this rank's
    own reading says there is nothing to save; it saves all the same, and
    so meets rank 0 in the save's barrier instead of leaving it waiting."""
    from zigp_tpu_torch.training.loop import save_final

    class RankOneOfTwo:
        def agree(self, obj):
            return True  # rank 0's reading: the final checkpoint was missing

    model = torch.nn.Linear(2, 2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_at(20, model)  # rank 0's save, already on disk
    saved = []
    mgr.save_at = lambda step, model, opt_state: saved.append(step)
    save_final(mgr, 20, False, model, None, print, mesh=RankOneOfTwo())
    assert saved == [20]
    save_final(mgr, 20, False, model, None, print)  # one process: its own reading
    assert saved == [20]
