"""The port's checkpoints: bit-for-bit restore, retention (latest and best by metric), background writes, the metric log.

The semantics are the JAX package's ``CheckpointManager`` (orbax underneath):
``max_to_keep`` latest or best-by-``best_metric_key`` (descending), a JSON log
of every metric reported, ``save(block=False)`` copying to the host before it
returns.  Everything here is exact: restored tensors equal the saved ones bit
for bit.
"""

import numpy as np
import pytest
import torch

from factorizer_tpu_torch.train import checkpoint as ckpt
from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step

torch.set_num_threads(1)


def _state(seed=0, steps=2):
    """A small conv net's train state after ``steps`` AdamW steps, so the optimiser has moments to save."""
    gen = torch.Generator().manual_seed(seed)

    def factory(device):
        net = torch.nn.Sequential(torch.nn.Conv3d(2, 4, 3, padding=1), torch.nn.ReLU(), torch.nn.Conv3d(4, 3, 1))
        with torch.no_grad():
            for p in net.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
        return net.to(device)

    state = create_train_state(factory, device="cpu", lr=1e-2, weight_decay=1e-2, warmup_steps=1, total_steps=10)
    step = make_train_step(state.model)
    for i in range(steps):
        x = torch.randn(2, 2, 6, 6, 6, generator=gen)
        y = (torch.rand(2, 3, 6, 6, 6, generator=gen) > 0.5).float()
        state, _ = step(state, {"image": x, "label": y})
    return state


def _flat(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in s.items()})
    return out


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    assert a.step == b.step
    assert a.optimizer.state_dict()["param_groups"] == b.optimizer.state_dict()["param_groups"]


def test_save_and_restore_bit_for_bit(tmp_path):
    """A restored state equals the saved one, weights and AdamW moments, bit for bit; both then take the same step."""
    saved = _state()
    mgr = ckpt.CheckpointManager(tmp_path)
    mgr.save(2, saved)
    restored = mgr.restore(template=_state(seed=1, steps=0))
    _assert_same(restored, saved)
    payload = mgr.restore()
    assert payload["step"] == 2 and set(payload) == {"step", "model", "optimizer"}
    assert all(t.device.type == "cpu" for t in payload["model"].values())
    x = torch.randn(2, 2, 6, 6, 6, generator=torch.Generator().manual_seed(9))
    y = (x[:, :1].repeat(1, 3, 1, 1, 1) > 0).float()
    for s in (saved, restored):
        make_train_step(s.model)(s, {"image": x, "label": y})
    _assert_same(restored, saved)


def test_latest_retention(tmp_path):
    """max_to_keep=2 keeps the two latest steps; None keeps all."""
    mgr = ckpt.CheckpointManager(tmp_path / "a", max_to_keep=2)
    state = _state(steps=1)
    for s in range(1, 5):
        mgr.save(s, state, block=s % 2 == 0)
    assert mgr.latest_step() == 4 and mgr.all_steps() == [3, 4]
    keep_all = ckpt.CheckpointManager(tmp_path / "b", max_to_keep=None)
    for s in range(1, 4):
        keep_all.save(s, state)
    assert keep_all.all_steps() == [1, 2, 3]


def test_best_by_metric_retention(tmp_path):
    """With best_metric_key the highest metrics are kept (descending), whatever their step; a save without the
    metric ranks below all with it."""
    mgr = ckpt.CheckpointManager(tmp_path, max_to_keep=2, best_metric_key="mean_dice")
    state = _state(steps=1)
    for step, dice in [(1, 0.5), (2, 0.9), (3, 0.7), (4, 0.2)]:
        mgr.save(step, state, metrics={"mean_dice": dice}, block=False)
    mgr.save(5, state)
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    assert mgr.best_saved_metric("mean_dice") == 0.9


def test_background_save_is_a_host_copy_and_durable_after_wait(tmp_path):
    """save(block=False) returns with the tensors on the host: an in-place update right after it does not reach
    the file, which is complete after wait() and leaves no temporary file."""
    state = _state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    mgr = ckpt.CheckpointManager(tmp_path)
    mgr.save(7, state, block=False)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    mgr.wait()
    assert (tmp_path / "step_7.pt").is_file()
    assert not [p for p in tmp_path.iterdir() if "tmp" in p.name]
    restored = ckpt.restore_checkpoint(tmp_path / "step_7.pt")
    for k, v in before.items():
        assert torch.equal(restored["model"][k], v), k
    (timing,) = mgr.timings
    assert timing["step"] == 7 and timing["blocking_s"] >= 0 and timing["background_s"] > 0


def test_best_saved_metric_survives_a_restart(tmp_path):
    """The metric log outlives the checkpoints it names and the manager: a new manager on the directory reads the
    best of every metric ever reported, deleted checkpoints' too."""
    state = _state(steps=1)
    mgr = ckpt.CheckpointManager(tmp_path, max_to_keep=1)
    mgr.save(1, state, metrics={"mean_dice": 0.8})
    mgr.save(2, state, metrics={"mean_dice": 0.6})
    mgr.save(3, state)
    again = ckpt.CheckpointManager(tmp_path, max_to_keep=1)
    assert again.all_steps() == [3]
    assert again.best_saved_metric("mean_dice") == 0.8
    assert again.best_saved_metric("hd95") is None


def test_one_shot_save_and_fold_loading(tmp_path):
    """save_checkpoint / restore_checkpoint into a module, and load_checkpoints of two folds."""
    states = [_state(seed=s, steps=1) for s in (3, 4)]
    paths = [tmp_path / f"fold{i}" / "model.pt" for i in range(2)]
    for s, p in zip(states, paths):
        ckpt.save_checkpoint(p, s)
    folds = ckpt.load_checkpoints(paths)
    for s, f in zip(states, folds):
        for k, v in s.model.state_dict().items():
            assert torch.equal(f["model"][k], v)
    module = _state(seed=5, steps=0).model
    ckpt.restore_checkpoint(paths[1], template=module)
    for k, v in states[1].model.state_dict().items():
        assert torch.equal(module.state_dict()[k], v)
    ckpt.save_checkpoint(tmp_path / "weights.pt", module)  # a module saves its state_dict alone
    assert set(ckpt.restore_checkpoint(tmp_path / "weights.pt")) == set(module.state_dict())


def test_failed_background_write_raises_at_wait(tmp_path):
    """An error of the write thread is not lost: the next wait() raises it."""
    mgr = ckpt.CheckpointManager(tmp_path / "gone")
    (tmp_path / "gone").rmdir()
    mgr.save(1, _state(steps=0), block=False)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    mgr.wait()  # raised once


def test_restore_without_checkpoints_is_none(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path)
    assert mgr.latest_step() is None and mgr.restore() is None and mgr.best_saved_metric("mean_dice") is None
    assert np.isfinite(sum(float(v.sum()) for v in _flat(_state(steps=1)).values()))
