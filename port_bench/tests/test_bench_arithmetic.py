"""The metric arithmetic on synthetic spans and traces, the inputs' generator and the benchmark's tensors."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from port_bench.bench import check, groups, readings, spec, trace, traffic, weights, work

from .conftest import DATA


def _serve_run(latencies, window_s, windows_done=None, mean_windows=1.0):
    return SimpleNamespace(kind="serve", latencies=latencies, window_s=window_s, units=len(latencies),
                           windows_done=len(latencies) if windows_done is None else windows_done,
                           mean_windows=mean_windows)


def test_rate_is_all_work_over_all_time():
    run = _serve_run([1.0] * 30 + [3.0] * 10, 61.0)
    assert spec.load_metric("case_s").read(run) == pytest.approx(61.0 / 40)
    # 40 cases of 8 windows and 10 of 18 served in 90 s, in a mix of 10.5 windows a case: 90 / 500 * 10.5
    run = _serve_run([1.0] * 50, 90.0, windows_done=40 * 8 + 10 * 18, mean_windows=10.5)
    assert spec.load_metric("case_s").read(run) == pytest.approx(90.0 / 500 * 10.5)
    train = SimpleNamespace(kind="train", window_s=51.0, units=400)
    assert spec.load_metric("step_s").read(train) == pytest.approx(51.0 / 400)


def test_trace_reduction_busy_union_and_gaps_by_span():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "port_bench.train.step", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "port_bench.forward", "ts": 40, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 20, "dur": 20},  # overlaps k_a: counted once in busy
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 50, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 200, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 500},
    ]
    out = trace.reduce_events(events)
    assert out["busy_s"] == pytest.approx((30 + 10 + 5) * 1e-6)
    assert out["by_kernel"]["k_a"] == pytest.approx(25e-6)
    # the gap 40-50 opens inside the forward span, the gap 60-200 inside the step span (the innermost open)
    assert out["gaps"] == pytest.approx({"forward": 10e-6, "train.step": 140e-6})
    assert trace.top({"a": 1, "b": 3, "c": 2}, 2) == [["b", 3], ["c", 2]]


def test_groups_take_the_kernels_by_name():
    assert groups.group_of("void ftt::windowed_nmf_factors_kernel<float, 8, 8, false>(...)") == groups.K1_FWD
    assert groups.group_of("windowed_nmf_shift_bwd_group_kernel") == groups.K1_BWD
    assert groups.group_of("prenorm_mlp_bwd_kernel<float>") == groups.K2_BWD
    assert groups.group_of("depthwise_conv_tile_kernel<float, 3, 3>") == groups.K3_FWD
    assert groups.group_of("vectorized_layer_norm_kernel") == groups.LAYER_NORM
    assert groups.group_of("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous "
                           "namespace)::TensorListMetadata<4>, at::native::(anonymous namespace)::FusedAdamMathFunctor"
                           "<float, 4, (at::native::ADAM_MODE)1, false>, float*, float, float>(...)") == groups.OPTIMISER


def _factorizer_run(launches, k1_seconds):
    net = {"encoder_width": [32, 64], "strides": [1, 2], "encoder_depth": [1, 1], "decoder_depth": [1],
           "reshape": ["$ftx.SWMatricize", {"shifts": [None, 2]}], "mlp_ratio": 4}
    return SimpleNamespace(kind="train", net=net, traffic={"batch": 2, "roi": [16, 16, 16]}, traced_units=2,
                           launches=launches, dtype=torch.float32,
                           trace={"by_kernel": {"windowed_nmf_factors_kernel": k1_seconds, "nmf_reconstruct_kernel": 1.0,
                                                "prenorm_mlp_kernel": 1.0}})


def test_roofline_share_is_bound_over_time_and_checks_launches():
    # 3 mixers a step (two encoder levels, one decoder level), 2 shifts, 2 steps traced
    launches = {"windowed_nmf_factors": 6, "windowed_nmf_reconstruct": 6, "windowed_nmf_bwd": 12}
    run = _factorizer_run(launches, 1e-3)
    shapes = [work.meta(s) for s in [(2, 16, 16, 16, 32), (2, 8, 8, 8, 64), (2, 16, 16, 16, 32)]]
    bound = 2 * sum(work.bound_ms(*work.k1_work(x, 2, b), x.dtype)[0] for x in shapes for b in (False, True))
    # K4's and K2's kernels in the trace are not K1's: its kernel file's names find its own alone
    assert readings.roofline_share(run, "k1") == pytest.approx(100 * bound / 1.0)
    with pytest.raises(ValueError, match="launches"):
        readings.roofline_share(_factorizer_run({**launches, "windowed_nmf_bwd": 11}, 1e-3), "k1")
    assert readings.roofline_share(_factorizer_run({}, 0.0), "k1") is None


def test_mfu_and_idle():
    run = SimpleNamespace(kind="train", flops_unit=6.7e12, units=10, window_s=10.0, dtype=torch.float32, tf32=False,
                          trace={"busy_s": 0.9, "window_s": 1.0})
    assert readings.mfu(run) == pytest.approx(10.0)
    assert readings.device_idle(run) == pytest.approx(10.0)
    run.tf32 = True  # the peak of the precision the cell states: TF32's where it states TF32 on
    assert readings.mfu(run) == pytest.approx(100.0 * 6.7e12 / 495e12)
    run.dtype = torch.bfloat16
    assert readings.mfu(run) == pytest.approx(100.0 * 6.7e12 / 989e12)


@pytest.mark.parametrize("path", [spec.BENCH_DIR / "traffic" / "serve.json", DATA / "traffic" / "serve.json"],
                         ids=["serve", "test_serve"])
def test_serve_counts_do_not_change_with_the_seed(path):
    """The cycle's sizes and their order come from the file alone; the seed draws the voxels and the checked cases,
    one of them among the largest."""
    from port_bench.reference.serve import windows_of

    mix = spec.load_json(path)
    shapes = traffic.serve_cycle(mix)
    assert shapes == [tuple(mix["shapes"][i]["shape"]) for i in mix["pattern"]]
    assert [windows_of(s["shape"], mix["roi"], mix["overlap"]) for s in mix["shapes"]] == [s["windows"] for s in mix["shapes"]]
    net = {"in_channels": 4}
    small = {**mix, "shapes": [{**s, "shape": [4, 4, 4]} for s in mix["shapes"]]}
    a, b = traffic.serve_cases(small, net, 2 ** 31 + 1, "cpu"), traffic.serve_cases(small, net, 2 ** 31 + 2, "cpu")
    assert [x.shape for x in a] == [y.shape for y in b] and not torch.equal(a[0], b[0])
    largest = max(s["windows"] for s in mix["shapes"])
    for seed in (0, 1, 2 ** 31 + 11):
        checked = traffic.serve_checked(mix, seed)
        assert len(set(checked)) == mix["check_cases"]
        assert any(mix["shapes"][mix["pattern"][k]]["windows"] == largest for k in checked)


def test_inputs_and_tensors_follow_the_seed():
    mix = {"batch": 1, "roi": [8, 8, 8], "ring": 2, "label": {"coarse": 4, "threshold": 0.3}}
    net = {"in_channels": 2, "out_channels": 3}
    big = 2 ** 31 + 5
    a, b = traffic.train_ring(mix, net, big, "cpu"), traffic.train_ring(mix, net, big, "cpu")
    c = traffic.train_ring(mix, net, big + 1, "cpu")
    assert torch.equal(a[1]["image"], b[1]["image"]) and not torch.equal(a[1]["image"], c[1]["image"])
    assert not torch.equal(a[0]["image"], a[1]["image"])
    assert set(a[0]["label"].unique().tolist()) <= {0.0, 1.0}
    spec_ = {"x.weight": ((4, 3, 2), "weight"), "x.bias": ((4,), "bias"), "n.norm.weight": ((3,), "norm_weight"),
             "u0": ((5, 1), "nonneg"), "pos": ((1, 2, 2), "normal")}
    w1, w2 = weights.make_weights(spec_, big, 0, "cpu"), weights.make_weights(spec_, big, 1, "cpu")
    assert all(torch.equal(w1[k], weights.make_weights(spec_, big, 0, "cpu")[k]) for k in spec_)
    assert not torch.equal(w1["x.weight"], w2["x.weight"])
    assert w1["x.weight"].abs().max() <= 1 / 6 ** 0.5 and w1["x.bias"].abs().max() <= 1 / 6 ** 0.5
    assert (w1["u0"] >= 0).all() and ((w1["n.norm.weight"] - 1).abs() <= 0.1).all()


def test_train_numbers_leave_out_leaves_of_nought_gradient():
    ref = {"losses": [1.0, 0.9], "grad_norms": {"a": 1.0, "b": 2.0, "c": 1e-9},
           "change_norms": {"a": 0.1, "b": 0.1, "c": 0.1}}
    prog = {"losses": [1.0, 0.9009], "grad_norms": {"a": 1.0, "b": 2.002, "c": 0.0},
            "change_norms": {"a": 0.1, "b": 0.1001, "c": 0.5}}
    nums = check.train_numbers(prog, ref)
    assert nums["loss_gap"] == pytest.approx(1e-3) and nums["loss_gap_first"] == 0.0
    assert nums["grad_gap"] == pytest.approx(1e-3)  # b: 0.002 against its own norm 2.0; c: 1e-9 against the median 1.0
    assert nums["change_gap"] == pytest.approx(1e-3)  # c left out: its gradient is nought to rounding
    assert nums["change_gap_median"] == pytest.approx(5e-4)  # the median of a's 0 and b's 1e-3
    ok, shown = check.judge(nums, {"loss_gap": 1e-2, "grad_gap": 1e-2, "change_gap": 1e-4})
    assert not ok and shown["change_gap"] == {"value": nums["change_gap"], "limit": 1e-4}
    ok, shown = check.judge(nums, {"loss_gap": 1e-2, "change_gap_median": 1e-3})  # only the limits' numbers
    assert ok and set(shown) == {"loss_gap", "change_gap_median"}
