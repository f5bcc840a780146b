"""The program's phase spans (``utils/profiling.py::span``) on the CPU: off without a profiler, the train step's and
the served case's phases in order under one, and the same results with the profiler on and off."""

from __future__ import annotations

import copy

import pytest
import torch

from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step
from factorizer_tpu_torch.utils import profiling
from factorizer_tpu_torch.zoo_scripts import ensemble_predict

ROI = (8, 8, 8)
IMAGE_SHAPE = (1, 2, 12, 12, 12)  # 2 x 2 x 2 = 8 windows of ROI at overlap 0.5
SW_BATCH = 3  # 3 groups a fold, the last filled up


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _spans(prof) -> list:
    """The ``ftt.`` spans of a profile, by start, without the prefix."""
    events = [e for e in prof.events() if e.name.startswith(profiling.SPAN_PREFIX)]
    return [e.name[len(profiling.SPAN_PREFIX):] for e in sorted(events, key=lambda e: e.time_range.start)]


def _net(seed: int) -> torch.nn.Module:
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Conv3d(2, 4, 3, padding=1), torch.nn.ReLU(), torch.nn.Conv3d(4, 3, 1))


def _batch() -> dict:
    gen = torch.Generator().manual_seed(1)
    return {"image": torch.randn(4, 2, 8, 8, 8, generator=gen),
            "label": (torch.rand(4, 3, 8, 8, 8, generator=gen) > 0.5).float()}


def _step(accum_steps: int, profiled: bool):
    """One AdamW step of a fresh tiny network: ``(loss, parameters, spans opened)``."""
    state = create_train_state(_net(0), device="cpu", lr=1e-2, weight_decay=1e-5)
    step = make_train_step(state.model, accum_steps=accum_steps)
    if not profiled:
        state, metrics = step(state, _batch())
        return metrics["loss"], copy.deepcopy(state.model.state_dict()), []
    with _profiled() as prof:
        state, metrics = step(state, _batch())
    return metrics["loss"], copy.deepcopy(state.model.state_dict()), _spans(prof)


def _serve(profiled: bool):
    models = [_net(10).eval(), _net(11).eval()]
    image = torch.randn(*IMAGE_SHAPE, generator=torch.Generator().manual_seed(2))
    if not profiled:
        return (*ensemble_predict(models, image, ROI, SW_BATCH, 0.5), [])
    with _profiled() as prof:
        mask, probs = ensemble_predict(models, image, ROI, SW_BATCH, 0.5)
    return mask, probs, _spans(prof)


def test_span_is_the_shared_no_op_without_a_profiler():
    """Without a profiler ``span`` hands back one shared no-op context and a later profile holds none of its
    names; under a profiler it is a ``record_function`` whose ``ftt.<name>`` event the profile holds."""
    first, second = profiling.span("probe.off"), profiling.span("probe.other")
    assert first is second is profiling._NO_SPAN
    with first:
        torch.ones(2) + 1
    with _profiled() as prof:
        inside = profiling.span("probe.on")
        with inside:
            torch.ones(2) + 1
    assert isinstance(inside, torch.profiler.record_function)
    assert _spans(prof) == ["probe.on"]
    assert profiling.span("probe.after") is profiling._NO_SPAN


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_opens_forward_backward_update_in_order(accum_steps):
    _, _, spans = _step(accum_steps, profiled=True)
    assert spans == ["train.forward", "train.backward"] * accum_steps + ["train.update"]


def test_ensemble_predict_opens_the_sliding_window_phases():
    """Per fold one ``prepare`` and one ``normalize``, per group of windows ``gather``, ``predict`` and ``blend`` in
    turn; ``serve.combine`` after each fold and once more for the mean and threshold."""
    *_, spans = _serve(profiled=True)
    groups = -(-8 // SW_BATCH)
    fold = (["sliding_window.prepare"]
            + ["sliding_window.gather", "sliding_window.predict", "sliding_window.blend"] * groups
            + ["sliding_window.normalize", "serve.combine"])
    assert spans == fold * 2 + ["serve.combine"]


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_is_the_same_with_the_profiler_on(accum_steps):
    loss_off, params_off, _ = _step(accum_steps, profiled=False)
    loss_on, params_on, _ = _step(accum_steps, profiled=True)
    assert torch.equal(loss_on, loss_off)
    assert params_on.keys() == params_off.keys()
    assert all(torch.equal(params_on[k], params_off[k]) for k in params_off)


def test_ensemble_predict_is_the_same_with_the_profiler_on():
    mask_off, probs_off, _ = _serve(profiled=False)
    mask_on, probs_on, _ = _serve(profiled=True)
    assert torch.equal(mask_on, mask_off) and torch.equal(probs_on, probs_off)
