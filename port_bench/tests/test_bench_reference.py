"""The benchmark's plain reference against the program, ``factorizer_tpu_torch``, on the same seeded tensors at a
small size on the CPU (float64 where the comparison is of the functions, float32 where it is of what a run reads)."""

from __future__ import annotations

import json

import pytest
import torch

from port_bench.bench import program, spec, traffic, weights
from port_bench.reference import serve as ref_serve, train as ref_train

from .conftest import ROOT, merged, tiny_config

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = [c["name"] for c in BENCH["configs"]]
# the Deconver in 2-D, as the FIVES bundle runs it (zoo/deconver_fives/configs/train.yaml), at a CPU's size
DECONVER_2D = {"roi_size": [32, 32], "network_def": {"in_channels": 3, "out_channels": 1, "spatial_dims": 2,
                                                      "kernel_size": [7, 7]}}


def _config(name: str, changes: dict | None = None) -> dict:
    cfg = tiny_config(next(c for c in BENCH["configs"] if c["name"] == name))
    return merged(cfg, changes) if changes else cfg


def _setup(cfg: dict, dtype=torch.float64):
    ref = spec.load_reference(cfg)
    net, roi = cfg["network_def"], tuple(cfg["roi_size"])
    spec_ = ref.param_spec(net, roi)
    w = weights.make_weights(spec_, 2 ** 31 + 3, 0, "cpu", dtype)
    model = program.build_network(cfg, "cpu").to(dtype)
    model.load_state_dict(w, strict=True)
    return ref, net, roi, spec_, w, model


@pytest.mark.parametrize("name", CONFIGS)
def test_param_spec_names_every_tensor_of_the_program(name):
    ref, net, roi, spec_, w, model = _setup(_config(name), torch.float32)
    assert list(spec_) == list(model.state_dict())
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {k: s for k, (s, _) in spec_.items()}


@pytest.mark.parametrize("cfg", [_config(n) for n in CONFIGS] + [_config("deconver_brats23", DECONVER_2D)],
                         ids=CONFIGS + ["deconver_brats23_2d"])
def test_forward_equals_the_program(cfg):
    ref, net, roi, spec_, w, model = _setup(cfg)
    x = torch.randn(2, net["in_channels"], *roi, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model.eval()(x)
    want = ref.forward(w, x, net)
    assert got.shape == want.shape == (2, net["out_channels"], *roi)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_windows_fold_and_unfold_in_two_and_three_dimensions():
    from port_bench.reference import factorizer

    for shape in [(2, 16, 24, 16), (2, 16, 8, 24, 16)]:
        x = torch.randn(shape, generator=torch.Generator().manual_seed(3))
        folded = factorizer._fold(x, 8, 4)
        assert folded.shape == (2 * 2, x[0, ..., 0].numel() // 4 ** (x.ndim - 2), 8, 4 ** (x.ndim - 2))
        assert torch.equal(factorizer._unfold(folded, x.shape, 8, 4), x)
    # one window of the 2-D fold holds the patch's pixels of one head's channels
    x = torch.arange(2 * 8 * 8 * 4, dtype=torch.float64).reshape(2, 8, 8, 4)
    assert torch.equal(factorizer._fold(x, 2, 4)[0, 1], x[0, 0:4, 4:8, 0:2].reshape(16, 2).T)


@pytest.mark.parametrize("name", CONFIGS)
def test_training_equals_the_programs_step(name):
    """Three steps of DiceCE and AdamW: losses, the first gradient and the leaves after the last step."""
    from factorizer_tpu_torch.train.losses import dice_ce_loss

    cfg = _config(name)
    ref, net, roi, spec_, w, model = _setup(cfg)
    mix = {"batch": 2, "roi": list(roi), "ring": 3, "label": {"coarse": 4, "threshold": 0.3}}
    ring = traffic.train_ring(mix, net, 5, "cpu", torch.float64)
    assert float(ref_train.dice_ce_loss(ring[0]["image"][:, :3], ring[0]["label"])) == pytest.approx(
        float(dice_ce_loss(ring[0]["image"][:, :3], ring[0]["label"])), rel=1e-12)
    state, step = program.train_state(model, cfg["learning_rate"], cfg["weight_decay"])
    losses = []
    for i, batch in enumerate(ring):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            first = {k: v / (1 - 0.9) for k, v in program.first_moments(state).items()}
    trainable = {k for k, (_, kind) in spec_.items() if kind != "nonneg"}
    got = ref_train.train_steps(ref.forward, w, net, ring, cfg["learning_rate"], cfg["weight_decay"], trainable)
    assert losses == pytest.approx(got["losses"], rel=1e-10)
    for k in trainable:
        torch.testing.assert_close(first[k], got["first_grads"][k], rtol=1e-7, atol=1e-12)
    params = dict(model.named_parameters())
    for k in trainable:
        torch.testing.assert_close(params[k].detach(), got["params"][k], rtol=1e-7, atol=1e-9)


def test_sliding_window_and_fold_mean_equal_the_program():
    cfg = _config("factorizer_brats23")
    ref, net, roi, spec_, w, model = _setup(cfg)
    folds = [w, weights.make_weights(spec_, 9, 1, "cpu", torch.float64)]
    models = []
    for f in folds:
        m = program.build_network(cfg, "cpu").to(torch.float64).eval()
        m.load_state_dict(f)
        models.append(m)
    image = torch.randn(1, 4, 40, 36, 33, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    mask, probs = program.serve(models, image, roi, 2, 0.5)
    want = ref_serve.ensemble_probs(ref.forward, folds, net, image, roi, 2, 0.5, "gaussian")
    torch.testing.assert_close(probs.double(), want.double(), rtol=1e-6, atol=1e-7)
    assert torch.equal(mask.bool(), probs > 0.5)
    constant = ref_serve.ensemble_probs(ref.forward, folds, net, image, roi, 2, 0.5, "constant")
    assert (constant - want).abs().max() > 1e-6  # the mode is read: the blends differ where windows overlap
    assert ref_serve.windows_of((158, 189, 155), (128,) * 3, 0.5) == 8
    assert ref_serve.windows_of((196, 212, 155), (128,) * 3, 0.5) == 18
