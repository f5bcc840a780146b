"""Device time of one train step of one of the PyTorch port's bundle networks, by kernel.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/profile_torch_train_step.py [--model factorizer|factorizer_flat|deconver] [--dtype float32|bfloat16]
                                              [--steps 3] [--top 25] [--cudnn-benchmark]

Builds ``brats23_network()`` (``--model factorizer``, the default), the same
network on the flat-NMF route (``--model factorizer_flat``:
``factorize_options={"use_windowed": False}``) or
``deconver_brats23_network()`` from seed 0, takes two warm-up steps on a
synthetic batch 2 x 128^3, then traces ``--steps`` steps with
``torch.profiler`` and prints, per kernel name, the device milliseconds per
step, grouped under a few headings (the port's eight kernels, the norms,
cuDNN, GEMMs, the optimiser, elementwise and the rest), the wall time per
step under the profiler and the share of it that the device was busy, and
the convolution calls by input shape.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

GROUPS = (  # first match wins
    ("K4 bwd (nmf_bwd.cu)", ("nmf_reconstruct_bwd",)),
    ("K4 fwd (nmf.cu)", ("nmf_reconstruct",)),
    ("K1 bwd (windowed_nmf_bwd.cu)", ("windowed_nmf_shift_bwd",)),
    ("K1 fwd (windowed_nmf.cu)", ("windowed_nmf_shift",)),
    ("K2 bwd (mlp_block_bwd.cu)", ("prenorm_mlp_bwd", "sum_partials")),
    ("K2 fwd (mlp_block.cu)", ("prenorm_mlp",)),
    ("K3 dw (depthwise_conv_dw.cu)", ("depthwise_conv_dw", "sum_dw_partials")),
    ("K3 fwd and dx (depthwise_conv.cu)", ("depthwise_conv",)),
    ("LayerNorm fwd+bwd", ("layer_norm", "LayerNorm", "GammaBeta")),
    ("InstanceNorm statistics (var_mean)", ("WelfordOps", "welford", "var_mean")),
    ("GEMMs (cuBLAS)", ("cublas", "gemv", "splitK", "cutlass")),
    ("cuDNN convolutions and their layout transposes", ("cudnn", "conv", "nchwToNhwc", "nhwcToNchw", "xmma", "wgrad", "dgrad")),
    ("optimiser (fused AdamW)", ("adam",)),
    ("roll (the flat route's shifts)", ("roll",)),
    ("concat / copies (the flat route's folds and unfolds among them)", ("CatArray", "copy", "Memcpy", "Memset")),
    ("reductions (loss, norms, bias grads)", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized")),
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="factorizer", choices=("factorizer", "factorizer_flat", "deconver"),
                    help="factorizer_brats23, the same on the flat-NMF route, or deconver_brats23, at full width and depth")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--cudnn-benchmark", action="store_true", help="let cuDNN time its algorithms per shape")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("profile_torch_train_step: no CUDA device")
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step
    from factorizer_tpu_torch.zoo_scripts import brats23_network, deconver_brats23_network

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    print(f"[profile] torch.backends.cudnn.benchmark={args.cudnn_benchmark}, TF32 off")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dtype = None if args.dtype == "float32" else torch.bfloat16
    network = {"factorizer": brats23_network, "factorizer_flat": brats23_network, "deconver": deconver_brats23_network}[args.model]
    options = {"factorize_options": {"use_windowed": False}} if args.model == "factorizer_flat" else {}
    state = create_train_state(network(dtype=dtype, generator=torch.Generator().manual_seed(0), **options), lr=1e-4, weight_decay=1e-5)
    step = make_train_step(state.model)
    gen = torch.Generator(device="cuda").manual_seed(7)
    field = F.interpolate(torch.randn(2, 3, 8, 8, 8, device="cuda", generator=gen), size=(128,) * 3, mode="trilinear")
    batch = {"image": torch.randn(2, 4, 128, 128, 128, device="cuda", generator=gen), "label": (field > 0.3).float()}
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    def device_us(ev, own: bool = True) -> float:
        for attr in ("self_device_time_total", "self_cuda_time_total") if own else ("device_time_total", "cuda_time_total"):
            if hasattr(ev, attr):
                return getattr(ev, attr)
        return 0.0

    by_kernel = defaultdict(float)
    for ev in prof.key_averages():
        if device_us(ev) > 0 and ev.device_type.name != "CPU":
            by_kernel[ev.key] += device_us(ev) / 1e3 / args.steps
    if not by_kernel:
        sys.exit("profile_torch_train_step: the profiler recorded no device time")
    by_group = defaultdict(float)
    for name, ms in by_kernel.items():
        group = next((g for g, keys in GROUPS if any(k in name for k in keys)), "other")
        by_group[group] += ms
    total = sum(by_kernel.values())
    print(f"[profile] {args.model} {args.dtype}: {wall_ms:.1f} ms wall per step under the profiler, {total:.1f} ms of device time "
          f"per step ({100 * total / wall_ms:.1f} % busy), {args.steps} steps, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for group, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {ms:8.2f} ms  {100 * ms / total:5.1f} %  {group}")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"[kernel]  {ms:8.2f} ms  {name[:150]}")
    convs = [ev for ev in prof.key_averages(group_by_input_shape=True)
             if ev.key in ("aten::convolution_backward", "aten::cudnn_convolution", "aten::cudnn_convolution_transpose")]
    for ev in sorted(convs, key=lambda e: -device_us(e, own=False))[:12]:
        print(f"[conv]    {device_us(ev, own=False) / 1e3 / args.steps:8.2f} ms  {ev.key} {ev.input_shapes}")


if __name__ == "__main__":
    main()
