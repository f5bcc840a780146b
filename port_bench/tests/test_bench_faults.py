"""A run, with the look for a card skipped, at a small size on the CPU: sound, it is correct; with the timed path
broken underneath, ``correct`` comes out false, once for each fault a cell of one card can have."""

from __future__ import annotations

import time

import pytest
import torch

from port_bench.bench import cell, program

SEED = 2 ** 31 + 77
TRAIN = ["factorizer_brats23.train", "deconver_brats23.train"]
SERVE = ["factorizer_brats23.serve", "deconver_brats23.serve"]


def _run(bench_cell, trace: bool = False) -> dict:
    return cell.run_cell(bench_cell, SEED, 0.5, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_sound_run_is_correct(tiny, workload):
    result = _run(tiny(workload))
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    assert set(result["metrics"]) == {m["name"] for m in tiny(workload).end_to_end}


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_stated_dtype_reaches_both_sides(tiny, workload):
    """A configuration that states float64 runs the program and the reference in float64: the steps agree to its
    rounding (float32 reads some 1e-7 in the gradients), and the served cases to the program's sliding window,
    whose blend weights and sums are float32 whatever the dtype (some 1e-7)."""
    bench_cell = tiny(workload)
    bench_cell.config["precision"] = {**bench_cell.config["precision"], "dtype": "float64"}
    result = _run(bench_cell)
    assert result["correct"]
    limit = 1e-12 if workload in TRAIN else 1e-6
    assert all(c["value"] <= limit for c in result["checks"].values()), result["checks"]


def _broken_step(kind: str):
    real = program.train_state

    def train_state(model, lr, weight_decay):
        state, step = real(model, lr, weight_decay)

        def unchanged(state, batch):
            kept = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
            state, metrics = step(state, batch)
            state.model.load_state_dict(kept)
            return state, metrics

        def half(state, batch):
            return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

        return state, {"unchanged": unchanged, "half_batch": half}[kind]

    return train_state


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_broken_train_step_is_not_correct(tiny, monkeypatch, workload, fault):
    monkeypatch.setattr(program, "train_state", _broken_step(fault))
    result = _run(tiny(workload))
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("workload", SERVE)
def test_altered_answer_is_not_correct(tiny, monkeypatch, workload):
    real = program.serve

    def serve(models, image, roi, sw_batch, overlap):
        mask, probs = real(models, image, roi, sw_batch, overlap)
        probs = probs.clone()
        probs.view(-1)[probs.numel() // 2] += 0.05  # one voxel's answer moved where it is produced
        return (probs > 0.5).to(torch.uint8), probs

    monkeypatch.setattr(program, "serve", serve)
    result = _run(tiny(workload))
    assert not result["correct"] and result["checks"]["probs_gap"]["value"] > result["checks"]["probs_gap"]["limit"]


@pytest.mark.parametrize("workload", TRAIN)
def test_traced_run_reads_the_counters_of_its_kernels(tiny, workload):
    """A traced run reads the launch counters that its roofline metrics' kernel files name, and gives a breakdown;
    on the CPU no kernel of the program launches, so no roofline is read."""
    bench_cell = tiny(workload)
    result = _run(bench_cell, trace=True)
    assert result["correct"] and set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in bench_cell.per_layer}
    assert set(result["metrics"]) <= names and not any("roofline" in k for k in result["metrics"])
    assert "busy_s" in result["device"] and "window_s" in result["device"]
