"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check and time its kernels, serve and train the bundles.

Run from the repository root:

    python3 chip_smoke.py             # one card: every phase below
    python3 chip_smoke.py --cards 4   # a host with 4 cards: phases 1, 2, 20 and 21 alone, one process per card (NCCL)

Phases, one or more result lines each:
  1. environment: the card (name, power limit), torch / CUDA / nvcc versions; TF32 off.
  2. build: one nvcc per csrc/*.cu for sm_90a, started together, into factorizer_tpu_torch/build/.
  3. K1 (windowed NMF) against its plain PyTorch version at the five stage shapes
     of a batch-2 128^3 forward, f32 and bf16, plus MU, a single zero shift, and the
     factorizer_isles22 shapes (8,64^3,32) and (8,8^3,256) with patches of 4^3: the
     whole forward, and each of its two kernels (the factors pass, the reconstruct
     pass) against its own plain version on the same inputs.
  4. K2 (fused pre-norm MLP) against its plain version at the five block-tail shapes,
     f32 and bf16; twice on one input, bit for bit.
  5. the serving slice: the full-width factorizer_brats23 network (random weights
     from a seed) serves 2 synthetic BraTS-native (1, 4, 240, 240, 155) volumes
     through ensemble_predict, in f32 and in bf16; the launch counters show every
     mixer (two K1 launches: factors, reconstruct) and every block tail on a kernel;
     the first request's logits are
     compared with the same call on the plain versions.
  6. K1 backward against autograd through the plain version: the five stage shapes,
     f32 and bf16, plus MU, a single zero shift, num_grad_steps=2, an input
     with whole windows set to zero, and the two factorizer_isles22 shapes.
  7. K2 backward (dx and the six parameter gradients) against autograd through the
     plain version at the five shapes, f32 and bf16; twice on one input, bit for bit.
  8. the training slice: brats23_network() -> create_train_state -> make_train_step
     takes 1 warm-up and 3 timed steps on a synthetic batch 2 x 128^3, in f32 and in
     bf16; the launch counters show 9 K1 factors, 9 K1 reconstruct, 36 K1 backward, 9 K2
     forward and 9 K2 backward launches per step; the first step's loss and gradients are
     compared with the same step on the plain versions.  Then the same step with the
     bundle's remat: true (brats23_network(remat=True)), f32: 18 K1 factors, 18 K1
     reconstruct and 18 K2 forward launches per step (each stage's forward runs again in
     the backward), 36 K1 backward and 9 K2 backward; its first step's loss, gradient norm
     and every gradient equal bit for bit to those of the step without remat from the same
     seed (the recompute repeats the same launches on the same inputs); s/step and peak
     memory beside the step without it.
  9. K3 (per-sample depthwise convolution) against its plain version, a grouped F.conv{2,3}d: the five
     stage shapes of a batch-2 128^3 Deconver forward (kernel 3^3), f32 and bf16, the FIVES shapes
     (16,512^2,32) and (16,128^2,128) with kernel 7^2, the non-cubic kernels (1,3,5) and (3,1,9), C = 48, an input
     with a quarter all zero, the deconver_isles22 train shape (8,64^3,32), tiles that (2,5x7x9,12) does not
     divide, and the run kernels' shapes: C = 30 f32, C = 20 bf16 and the (3,5,5) weight gradient, each also
     through the per-output kernel; every case asserts the route that conv_plan gives it in both directions, every
     route is reached, and each tiled plan's constants and shared memory agree with csrc/depthwise_conv.cuh
     (ftt_depthwise_conv_tile_query); beside the kernel's time the one
     library call that computes the same function, kernel / library, both also as device time from a CUDA graph of 20
     calls (without the host's launch cost, which dominates at the deep stages), and the launch plan (conv_plan: the
     route, the tile, channels, planes a block, threads, blocks, waves on the card, shared memory); then one line
     naming the cases where the kernel is slower than its library call, per call or on the device (K3 and K3 dw).
 10. K3 dw (the weight gradient) against autograd through the plain version at the same shapes, twice
     on one input bit for bit, and dx and dw through the autograd function (the first case also the summing
     pass's share of the time, from torch.profiler); then the Deconv layer, forward and backward, on an input
     with a quarter all zero, kernels against plain versions.
 11. the Deconver serving slice: deconver_brats23_network() serves 2 synthetic BraTS-native volumes, f32
     and bf16: 27 K3 launches per forward, none of K1 and K2 (the bundle's InstanceNorm tails are stock torch).
 12. the FIVES forward: deconver_fives_network() on (16, 3, 512, 512) f32, 27 K3 launches, logits against
     the plain versions.
 13. the Deconver training slice: 1 warm-up and 3 timed steps, f32 and bf16: 54 forward-kernel launches
     (27 forward, 27 dx) and 27 dw launches per step; the first step against the plain versions.
 14. K4 (NMF of a flat batch of small matrices, rank 1 to 4) against its plain version: the five folded stage
     shapes of the flat factorizer_brats23 forward at batch 2, (n, 8, 512) with n = 131072 ... 512, f32 and bf16;
     the 2-D shapes (524288, 8, 64) and (32768, 8, 64); MU; ranks 2, 3, 4; (1000, 5, 37) at rank 3; an input
     with a quarter of its matrices all zero.
 15. K4 backward at rank 1 against autograd through the plain version at the same shapes, with MU,
     num_grad_steps=2 and the zero matrices; rank 2 through the autograd function, whose backward is a
     recompute in torch operations (counted, not a kernel launch).
 16. the flat-route serving slices: brats23_network(factorize_options={"use_windowed": False}) serves a
     2 BraTS-native volumes in f32 and bf16 (9 K4 launches per forward, none of K1; logits against the plain
     versions and against the windowed route from the same seed); a 2-D Swin-Factorizer at the FIVES data
     shape, one forward of (16, 3, 512, 512); brats23_network(rank=2), one forward of a window pair;
     factorizer_isles22_network() and deconver_isles22_network() each serve 2 (1, 2, 112, 112, 73) volumes.
 17. the flat-route training slices: the flat factorizer_brats23 step at batch 2 x 128^3, f32 and bf16 (9 K4
     forward and 9 K4 backward launches per step beside K2's), and the factorizer_isles22 step at batch
     8 x 64^3, f32; each first step against the plain versions.
 18. K5 (K1 on a volume cut into slabs along S1: the slab kernels and a halo exchange) in one process, all
     slabs of a ring held as a list: (2,128^3,32) f32 and bf16 as 4 slabs of 32 rows and as 2 of 64, the stage
     shapes (2,64^3,64) and (2,32^3,128) and the factorizer_isles22 shape (8,64^3,32) with patches of 4^3 in 4
     slabs, MU, a shift list whose first entry moves rows, one that moves none (no byte sent), a ring of one;
     the joined output against the plain version and, bit for bit, against K1 on the whole volume; a slab of
     rows that the patch does not divide must raise.
 19. K5 backward at the same cases and with num_grad_steps=2: autograd through the slab kernels against
     autograd through the plain version and, bit for bit, against K1's backward on the whole volume.
 20. the spatial slice: two processes on the one card (gloo, halos staged through the host) run stage 0 of
     brats23_network (a FactorizerStage of 32 channels on 128^3, batch 2) with spatial_mesh on slabs of 64
     rows, forward and backward of a sum of squares; the first process gathers the output, the input gradient
     and the summed parameter gradients and holds them against the one-process stage; launches per process.
 21. the data-parallel training slice: two processes on the one card take 1 warm-up and 3 timed steps of
     make_train_step(model, mesh=data_parallel_mesh()) on brats23_network() at global batch 2, f32; loss,
     gradient norm and every parameter against the one-process steps on the whole batch.
     Two processes share one card in 20 and 21: their times show that the path runs, not how it scales.
Then a check that no process started here is still alive, the card's line, a JSON line with every kernel, and as the last line
{"ok": true, "device": {...}}.  Any failed check raises, so the exit code is
non-zero and no result line is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_time_ms(fn, warmup: int = 3, runs: int = 15) -> float:
    """Median device time of ``fn()`` over ``runs`` launches, CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_time_ms(fn, calls: int = 20, replays: int = 7) -> float:
    """Median device time of one ``fn()`` from replays of a CUDA graph of ``calls`` calls: the host's launch cost,
    which CUDA events around one call also count, drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def dw_sum_share(fn) -> str:
    """K3 dw's device time by kernel over 5 calls of ``fn`` (torch.profiler): the tiled walk and the pass that adds
    the partial sets."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    walk = adds = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
        if "sum_dw_partials" in ev.key:
            adds += us
        elif "depthwise_conv_dw" in ev.key:
            walk += us
    if walk + adds == 0:
        return "the summing pass: not measured (the profiler saw no device time)"
    return f"the summing pass {adds / 5e3:.4f} ms of {(walk + adds) / 5e3:.4f} ms (torch.profiler, 5 calls)"


def kernel_label(mangled: str) -> str:
    """``prenorm_mlp_bwd_kernel<f32,512,16,16,16>`` from the mangled name ptxas reports."""
    found = re.search(r"\d+((?:windowed_nmf|nmf_reconstruct|prenorm_mlp|sum_partials|depthwise_conv|sum_dw_partials|slab_tail)\w*?_kernel)(?:I(.+?)EEv)?", mangled)
    if not found:
        return mangled
    name, targs = found.groups()
    if not targs:
        return name
    dtype = "bf16" if "bfloat16" in targs else "f32"
    return f"{name}<{','.join([dtype, *re.findall(r'Li(\d+)', targs)])}>"


def dname(dtype) -> str:
    return str(dtype).split(".")[1]


def compare(out, ref) -> tuple[float, float]:
    """(max |out - ref|, that over max |ref|)."""
    diff = (out.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-30)


# Relative tolerances (max |kernel - plain| / max |plain|).  f32: the kernels
# sum in another order than the plain versions' library calls (the NMF solve
# repeats 5 times, the MLP sums over C and 4C terms).  bf16: both compute in
# f32 and round the output once, so they differ by at most one bf16 ulp
# (2^-7 of the largest value) where the roundings fall apart.
KERNEL_RTOL = {"float32": 1e-4, "bfloat16": 2.0**-7}
# K1 backward: the reverse sweep repeats the forward's sums and divides by
# the same small denominators, so f32 gets ten times the forward's band; bf16
# rounds dx once, as the forward rounds y.
K1_BWD_RTOL = {"float32": 1e-3, "bfloat16": 2.0**-7}
# K2 backward parameter gradients, relative to the gradient's largest entry:
# each entry sums one f32 term per token (4.2 M at stage 0) in the kernel's
# fixed tile order and in the library's own order; either order's rounding
# grows like sqrt(tokens) * 2^-24 of the terms' size, and cancellation leaves
# entries far below that size, so the band is stated against the largest entry.
# Both dtypes sum in f32 from the same inputs.
K2_PARAM_RTOL = 1e-3
# Whole-network logits, kernels against plain versions: the per-layer
# differences above pass through 9 blocks and 9 convolutions.
SLICE_RTOL = {"float32": 1e-3, "bfloat16": 5e-2}
# One train step, kernels against plain versions: the loss, the global
# gradient norm and three gradient leaves (relative to each leaf's largest
# entry).  The forward differences above pass back through every layer; in
# bf16 a rounding that falls the other way changes a whole activation by 2^-8.
TRAIN_RTOL = {"float32": {"loss": 1e-4, "grad": 1e-2}, "bfloat16": {"loss": 1e-2, "grad": 1e-1}}

# K3 dw: each entry sums one f32 product per voxel (2.1 M at stage 0) in the kernel's fixed order and in the
# library's; stated against the gradient's largest entry, as K2's parameter gradients are.  The Deconv layer
# with a quarter of its input zero: the update's quotient is eps / eps there and the cotangents pass through
# 1 / (den + eps) ~ 1e16, in kernels and plain versions alike, so f32 gets ten times the kernels' band.
K3_DW_RTOL = 1e-4
DECONV_RTOL = 1e-3

# K4 at rank 2 to 4: HALS sweeps column by column and subtracts sums of nearly equal size
# (a[:, r] - sum_j u[:, j] b[j, r]) before each division, so the order of summation moves the f32 result
# more than at rank 1, where the update is one quotient.  Measured 9e-7, 3e-6 and 2e-5 to 6e-5 at ranks 2, 3
# and 4 (the difference grows with the rank and moves with the input); the band is that of the backward kernels.
K4_RANK_RTOL = 1e-3
# The flat route against the windowed route, whole-network logits from the same weights: the same function.
# f32: two summation orders per mixer, as kernels against plain versions.  bf16: K1 sums the shifts in f32 and
# rounds once, the flat route rounds each shift's reconstruction to bf16 before the mean.
ROUTE_RTOL = {"float32": 1e-3, "bfloat16": 5e-2}

STAGES = [(128, 32), (64, 64), (32, 128), (16, 256), (8, 512)]  # (S, C) at batch 2, roi 128^3
FLAT_STAGES = [131072, 32768, 8192, 2048, 512]  # matrices of (8, 512) per stage: 4 shifts x B*heads x windows
NUM_ITERS = 5
N_BLOCKS, N_SHIFTS = 9, 4  # blocks of the bundles' networks, shifts per mixer

# Published peaks of one H100 SXM at 700 W: HBM bytes/s, and FLOP/s of the
# units a kernel's operations run on: f32 outside the tensor cores, dense TF32
# and bf16 in them.  A bound takes the peak of the units its kernel runs on.
PEAK_BYTES, PEAK_FLOPS = 3.35e12, {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def bound_ms(n_bytes: float, flops: float, dtype, units: str | None = None) -> tuple[float, str]:
    """The least time the card could take: each input read and output written once, or the operations at the
    peak of ``units`` (default: the activations' dtype)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_FLOPS[units or dname(dtype)]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_work(x, n_shifts: int, backward: bool, grad_steps: int = NUM_ITERS, mu: bool = False) -> tuple[float, float]:
    """(bytes, flops) of K1 on ``x``, whose solve runs on the f32 CUDA cores whatever the dtype.  Per element
    and shift the solve does two mat-vecs (4 flops) per iteration and the rank-1 product and the shift sum
    (2); the backward adds the seed's two mat-vecs (4) and, per differentiated iteration, two mat-vecs and two
    rank-1 updates of dX (8; MU recomputes one more mat-vec, 10).  Forward: x read once, y written once (the
    kernels read x once per shift and write and read the f32 factors, (d + p^3) / (d p^3) of the volume per
    shift, between their two passes; the bound counts neither).  Backward: x and g read, dx written."""
    n = x.numel()
    flops = 4 * NUM_ITERS + 2
    if backward:
        flops += 4 + (10 if mu else 8) * grad_steps
    return (3 if backward else 2) * n * x.element_size(), float(n_shifts * n * flops)


def k1_pass_work(x, U, V, n_shifts: int, factors: bool) -> tuple[float, float]:
    """(bytes, flops) of one of K1's forward passes.  Factors pass: x read, the factors written, the solve's
    4 flops per element, shift and iteration.  Reconstruct pass: the factors read, y written, the product and
    the shift sum (2 flops per element and shift)."""
    n, f_bytes = x.numel(), 4 * (U.numel() + V.numel())
    if factors:
        return n * x.element_size() + f_bytes, float(n_shifts * n * 4 * NUM_ITERS)
    return f_bytes + n * x.element_size(), float(n_shifts * n * 2)


def k4_work(x, rank: int, backward: bool, grad_steps: int = NUM_ITERS, mu: bool = False) -> tuple[float, float]:
    """(bytes, flops) of K4 on ``x (..., M, N)``.  Per element the solve does two products with the factors
    (4 R flops) per iteration and the reconstruction (2 R); the R x R Gram matrices and the sweeps over a row's
    R columns add 2 R^2 (M + N + 2) / (M N) per element, left out.  The rank-1 backward adds the seed's two
    products (4) and, per differentiated iteration, two products and two rank-1 updates of dX (8; MU 10).
    Forward: x read, y written.  Backward: x and g read, dx written."""
    n = x.numel()
    flops = (4 * NUM_ITERS + 2) * rank
    if backward:
        flops += 4 + (10 if mu else 8) * grad_steps
    return (3 if backward else 2) * n * x.element_size(), float(n * flops)


def k2_work(x, hidden: int, backward: bool) -> tuple[float, float, str]:
    """(bytes, flops, units) of K2 on ``x (..., C)``: two products of 2 C H flops per token forward, five
    backward; x read and y written (backward: x and g read, dx written), the f32 parameters read (and their
    gradients written) once.  The operations are counted at the tensor cores' peak for the activations' type,
    TF32's for f32 and bf16's for bf16, in both directions: the function's products take bf16 operands for
    bf16 activations, as the JAX kernels' do.  The kernels' three-pass TF32 split (which the backward also
    takes for bf16, to hold its parameter gradients' band) is their own cost, not work the function needs, so
    it is not counted."""
    import torch

    c = x.shape[-1]
    tokens = x.numel() // c
    n_params = 3 * c + hidden + 2 * c * hidden
    n_bytes = (3 if backward else 2) * x.numel() * x.element_size() + (2 if backward else 1) * 4 * n_params
    flops = float(tokens * (10 if backward else 4) * c * hidden)
    return n_bytes, flops, "tf32" if x.dtype == torch.float32 else "bfloat16"


def k3_work(x, taps: int, dw: bool) -> tuple[float, float]:
    """(bytes, flops) of K3 on ``x (B, *S, C)``: one multiply-add per tap and element.  Forward: x read, y
    written, the f32 taps read.  dw: x and g read, the f32 taps' gradient written."""
    n_taps = x.shape[0] * taps * x.shape[-1]
    return 2 * x.numel() * x.element_size() + 4 * n_taps, float(2 * taps * x.numel())

BRATS_SHIFTS = (None, 2, 4, 6)
# Published NVLink rate of an H100 SXM to one neighbour, each way; the halo's time at it is computed, not measured.
NVLINK_BYTES = 450e9


def kernel_counters() -> dict:
    """Kernel name -> (the wrapper that counts its launches, the attribute that holds the count)."""
    from factorizer_tpu_torch.ops.kernels import (
        depthwise_conv, depthwise_conv_dw, nmf_reconstruct, nmf_reconstruct_backward, prenorm_mlp,
        prenorm_mlp_backward, windowed_nmf_backward, windowed_nmf_factors, windowed_nmf_multi_spatial,
        windowed_nmf_reconstruct,
    )

    return {"windowed_nmf_factors": (windowed_nmf_factors, "launches"),
            "windowed_nmf_reconstruct": (windowed_nmf_reconstruct, "launches"),
            "windowed_nmf_bwd": (windowed_nmf_backward, "launches"),
            "prenorm_mlp": (prenorm_mlp, "launches"), "prenorm_mlp_bwd": (prenorm_mlp_backward, "launches"),
            "depthwise_conv": (depthwise_conv, "launches"), "depthwise_conv_dw": (depthwise_conv_dw, "launches"),
            "nmf_reconstruct": (nmf_reconstruct, "launches"), "nmf_reconstruct_bwd": (nmf_reconstruct_backward, "launches"),
            "windowed_nmf_slab": (windowed_nmf_multi_spatial, "launches"),
            "windowed_nmf_slab_bwd": (windowed_nmf_multi_spatial, "backward_launches")}


def reset_counters(counters: dict) -> None:
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)


def read_counters(counters: dict) -> dict:
    return {name: getattr(wrapper, attr) for name, (wrapper, attr) in counters.items()}


def synthetic_batch(b: int, c_in: int, c_out: int, size: int, seed: int) -> dict:
    """A ``randn`` image and the labels of a thresholded smooth random field, made on the card from ``seed``."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    image = torch.randn(b, c_in, size, size, size, device="cuda", generator=gen)
    field = F.interpolate(torch.randn(b, c_out, 8, 8, 8, device="cuda", generator=gen), size=(size,) * 3,
                          mode="trilinear", align_corners=False)
    return {"image": image, "label": (field > 0.3).float()}


def brats23_stage0(factorize_options=None):
    """Stage 0 of ``brats23_network()`` on its own: one block of 32 channels on 128^3, weights from seed 0."""
    import torch

    from factorizer_tpu_torch.models.factorizer import FactorizerStage
    from factorizer_tpu_torch.ops.reshape import SWMatricize

    return FactorizerStage(
        32, 32, (128, 128, 128), depth=1, pos_embed=False, mlp_ratio=4,
        reshape=(SWMatricize, {"head_dim": 8, "patch_size": 8, "shifts": list(BRATS_SHIFTS)}), act="relu",
        factorize_kwargs=dict(rank=1, num_iters=NUM_ITERS, init_method="uniform", solver="hals"),
        factorize_options=factorize_options, device="cuda", generator=torch.Generator().manual_seed(0),
    )


def join_group_on_the_card(rank: int, world: int, init_method: str) -> str:
    """A worker's start: its card, TF32 off, and the process group.  With a card per process each takes its own
    and the group is NCCL's; else all share card 0 and the group is gloo's."""
    import torch

    from factorizer_tpu_torch.parallel import initialize_distributed

    own_card = torch.cuda.device_count() >= world
    torch.cuda.set_device(rank if own_card else 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    backend = initialize_distributed(init_method, world, rank)
    check(backend == ("nccl" if own_card else "gloo"), f"{world} processes on {torch.cuda.device_count()} card(s) took {backend}")
    return f"{backend}, {'a card per process' if own_card else 'halos and shards staged through the host'}"


def spatial_worker(rank: int, world: int, init_method: str) -> dict:
    """Stage 0 of the bundle with ``spatial_mesh`` on this process's slab: forward and backward of a sum of squares,
    once to warm up and once timed; the first process holds the gathered results against the one-process stage."""
    import torch

    from factorizer_tpu_torch.ops.kernels import windowed_nmf_multi_spatial
    from factorizer_tpu_torch.parallel import all_gather_cat, make_mesh

    backend = join_group_on_the_card(rank, world, init_method)
    mesh = make_mesh({"model": world})
    counters = kernel_counters()
    stage = brats23_stage0({"spatial_mesh": mesh, "spatial_axis": "model"})
    x = torch.randn(2, 128, 128, 128, 32, device="cuda", generator=torch.Generator(device="cuda").manual_seed(41))
    mine = x.chunk(world, 1)[rank].contiguous().requires_grad_(True)
    seconds = []
    for _ in range(2):
        stage.zero_grad(set_to_none=True)
        mine.grad = None
        reset_counters(counters)
        windowed_nmf_multi_spatial.tail_launches = windowed_nmf_multi_spatial.bytes_sent = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = stage(mine)
        (y.float() ** 2).sum().backward()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    report = {"backend": backend, "seconds": seconds[1], "warmup_seconds": seconds[0], "counts": read_counters(counters),
              "tail_launches": windowed_nmf_multi_spatial.tail_launches, "bytes_sent": windowed_nmf_multi_spatial.bytes_sent,
              "finite": bool(torch.isfinite(y).all()) and bool(torch.isfinite(mine.grad).all())}
    # Every process takes part in the gathers; the first one alone compares.
    y_all, dx_all = all_gather_cat(y.detach(), mesh, "model", 1), all_gather_cat(mine.grad, mesh, "model", 1)
    grads = {k: p.grad.clone() for k, p in stage.named_parameters()}
    for g in grads.values():
        torch.distributed.all_reduce(g, group=mesh.group("model"))
    if rank == 0:
        whole = brats23_stage0()
        xw = x.clone().requires_grad_(True)
        for _ in range(2):  # warm-up, then timed, as above
            whole.zero_grad(set_to_none=True)
            xw.grad = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = whole(xw)
            (ref.float() ** 2).sum().backward()
            torch.cuda.synchronize()
            report["whole_seconds"] = time.perf_counter() - t0
        report["y"], report["dx"] = compare(y_all, ref.detach()), compare(dx_all, xw.grad)
        report["params"] = {k: compare(grads[k], p.grad)[1] for k, p in whole.named_parameters()}
    return report


def train_dp_worker(rank: int, world: int, init_method: str, settings: dict, n_steps: int, global_batch: int) -> dict:
    """``n_steps`` data-parallel steps of the bundle's network on the whole synthetic batch, one shard per process."""
    import torch

    from factorizer_tpu_torch.parallel import data_parallel_mesh
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step
    from factorizer_tpu_torch.zoo_scripts import brats23_network

    backend = join_group_on_the_card(rank, world, init_method)
    torch.backends.cudnn.benchmark = True
    mesh = data_parallel_mesh()
    counters = kernel_counters()
    state = create_train_state(brats23_network(generator=torch.Generator().manual_seed(0)), **settings)
    step = make_train_step(state.model, mesh=mesh)
    batch = synthetic_batch(global_batch, 4, 3, 128, seed=7)
    losses, norms, seconds, counts = [], [], [], []
    for i in range(n_steps):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        reset_counters(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        counts.append(read_counters(counters))
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    report = {"backend": backend, "losses": losses, "norms": norms, "seconds": seconds, "counts": counts,
              "peak_memory": torch.cuda.max_memory_allocated()}
    if rank == 0:
        report["params"] = {k: p.detach().cpu() for k, p in state.model.named_parameters()}
    else:  # a digest is enough to show that both processes made the same update
        report["param_sum"] = sum(p.detach().double().sum().item() for p in state.model.parameters())
    return report

def shared_card_note(world: int) -> str:
    import torch

    if torch.cuda.device_count() >= world:
        return f"{world} processes, one card each"
    return f"{world} processes share one card: the time shows that the path runs, not how it scales"


def spatial_slice(world: int) -> dict:
    """Phase 20: ``world`` processes run stage 0 of the bundle on slabs of ``128 / world`` rows; the launches of
    all processes, by kernel."""
    import torch

    from factorizer_tpu_torch.parallel import run_processes
    from factorizer_tpu_torch.zoo_scripts import brats23_network

    stage_ref, bundle_stage = brats23_stage0(), brats23_network(device="meta").encoder.blocks[0].block
    check({k: v.shape for k, v in stage_ref.state_dict().items()} == {k: v.shape for k, v in bundle_stage.state_dict().items()}
          and stage_ref.blocks[0].fact.windowed == bundle_stage.blocks[0].fact.windowed,
          "spatial: the stage built here is not stage 0 of brats23_network()")
    del stage_ref, bundle_stage
    t0 = time.perf_counter()
    reports = run_processes(spatial_worker, world, timeout=300)
    expected = {"windowed_nmf_slab": N_SHIFTS, "windowed_nmf_slab_bwd": N_SHIFTS, "prenorm_mlp": 1, "prenorm_mlp_bwd": 1}
    halo_rows = sum(s for s in BRATS_SHIFTS if s)
    sent = halo_rows * 2 * 128 * 128 * 32 * 4 * 5  # per process: forward a halo and rows back, backward two halos and rows back
    launches = dict.fromkeys(kernel_counters(), 0)
    for rank, r in enumerate(reports):
        made = {k: v for k, v in r["counts"].items() if v}
        check(r["finite"], f"spatial rank {rank}: non-finite output or gradient")
        check(made == expected and r["tail_launches"] == 6, f"spatial rank {rank}: launches {made}, tails {r['tail_launches']}")
        check(r["bytes_sent"] == sent, f"spatial rank {rank}: {r['bytes_sent']} bytes sent, expected {sent}")
        for k, v in r["counts"].items():
            launches[k] += v
    r = reports[0]
    worst = max(r["params"], key=r["params"].get)
    print(f"[spatial] stage 0 of brats23_network() on {world} slabs of {128 // world} rows ({r['backend']}), float32: forward+backward "
          f"{' / '.join(f'{q['seconds']:.4f}' for q in reports)} s per process, one-process stage on the whole volume "
          f"{r['whole_seconds']:.4f} s (warm-up {r['warmup_seconds']:.2f} s; {time.perf_counter() - t0:.1f} s with start-up), "
          f"{sent / 1e6:.1f} MB sent per process, launches per process {expected} + 6 tails; gathered against the one-process stage: "
          f"y max_rel={r['y'][1]:.3e} (tol {KERNEL_RTOL['float32']:.1e}) dx max_rel={r['dx'][1]:.3e} (tol {K1_BWD_RTOL['float32']:.1e}) "
          f"parameter gradients summed over processes max_rel={r['params'][worst]:.3e} at {worst} (tol {K2_PARAM_RTOL:.1e}). "
          + shared_card_note(world))
    check(r["y"][1] <= KERNEL_RTOL["float32"] and r["dx"][1] <= K1_BWD_RTOL["float32"] and r["params"][worst] <= K2_PARAM_RTOL,
          f"spatial: differs from the one-process stage: y {r['y']}, dx {r['dx']}, parameters {r['params']}")
    return launches


def train_dp_slice(world: int, settings: dict, n_steps: int) -> dict:
    """Phase 21: ``world`` processes take ``n_steps`` data-parallel steps on a global batch of ``max(2, world)``,
    held against the one-process steps on the whole batch; the launches of all processes and steps, by kernel."""
    import torch

    from factorizer_tpu_torch.parallel import run_processes
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step
    from factorizer_tpu_torch.zoo_scripts import brats23_network

    dev = torch.device("cuda", torch.cuda.current_device())
    global_batch = max(2, world)
    t0 = time.perf_counter()
    reports = run_processes(train_dp_worker, world, settings, n_steps, global_batch, timeout=400)
    started = time.perf_counter() - t0
    state = create_train_state(brats23_network(generator=torch.Generator().manual_seed(0)), **settings)
    step = make_train_step(state.model)
    batch = synthetic_batch(global_batch, 4, 3, 128, seed=7)
    ref_losses, ref_norms, ref_seconds = [], [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ref_seconds.append(time.perf_counter() - t0)
        ref_losses.append(metrics["loss"].item())
        ref_norms.append(metrics["grad_norm"].item())
    per_step = {"windowed_nmf_factors": N_BLOCKS, "windowed_nmf_reconstruct": N_BLOCKS,
                "windowed_nmf_bwd": N_BLOCKS * N_SHIFTS, "prenorm_mlp": N_BLOCKS, "prenorm_mlp_bwd": N_BLOCKS}
    launches = dict.fromkeys(kernel_counters(), 0)
    for rank, r in enumerate(reports):
        for counts in r["counts"]:
            check({k: v for k, v in counts.items() if v} == per_step, f"train dp rank {rank}: launches {counts}")
            for k, v in counts.items():
                launches[k] += v
        check(r["losses"] == reports[0]["losses"] and r["norms"] == reports[0]["norms"],
              f"train dp: the processes report different metrics: {r['losses']} / {reports[0]['losses']}")
    r = reports[0]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], ref_losses))
    norm_rel = max(abs(a - b) / b for a, b in zip(r["norms"], ref_norms))
    # Each AdamW update moves an entry by about lr whatever the gradient's size, so where a gradient is within
    # rounding of zero the two summation orders may step apart by up to 2 lr per step; elsewhere they agree closely.
    lr = settings["lr"]
    diffs = {k: (r["params"][k].to(dev) - p.detach()).abs() for k, p in state.model.named_parameters()}
    worst = max(diffs, key=lambda k: diffs[k].max().item())
    far = sum((d > 0.1 * lr).sum().item() for d in diffs.values()) / sum(d.numel() for d in diffs.values())
    digest = sum(p.double().sum().item() for p in r["params"].values())
    print(f"[train dp] make_train_step(brats23_network(), mesh=data_parallel_mesh()) ({r['backend']}), global batch {global_batch} x "
          f"128^3, float32: {' / '.join(f'{statistics.mean(q['seconds'][1:]):.4f}' for q in reports)} s/step per process, "
          f"one-process step on the whole batch {statistics.mean(ref_seconds[1:]):.4f} s (after a {r['seconds'][0]:.2f} s warm-up step; "
          f"{started:.1f} s with start-up), peak memory per process {r['peak_memory'] / 2**30:.2f} GiB, loss "
          f"{' -> '.join(f'{v:.6f}' for v in r['losses'])}, launches per step and process {per_step}; against the one-process "
          f"steps on the whole batch: loss rel {loss_rel:.2e} (tol {TRAIN_RTOL['float32']['loss']:.0e}), grad norm rel {norm_rel:.2e} "
          f"(tol {TRAIN_RTOL['float32']['grad']:.0e}), parameters after {n_steps} steps max |diff| {diffs[worst].max().item():.2e} at "
          f"{worst} (tol 2 lr per step = {2 * lr * n_steps:.1e}), share of entries off by more than lr / 10: {far:.2e} (tol 1e-3). "
          + shared_card_note(world))
    check(loss_rel <= TRAIN_RTOL["float32"]["loss"] and norm_rel <= TRAIN_RTOL["float32"]["grad"],
          f"train dp: loss {r['losses']} / {ref_losses}, grad norm {r['norms']} / {ref_norms}")
    check(diffs[worst].max().item() <= 2 * lr * n_steps and far <= 1e-3, f"train dp: parameters differ from the one-process steps: {worst}")
    check(all(abs(q["param_sum"] - digest) <= 1e-9 * abs(digest) for q in reports[1:]),
          "train dp: the processes hold different parameters")
    check(r["losses"][-1] < r["losses"][0], f"train dp: loss did not fall: {r['losses']}")
    return launches


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, default=1,
                        help="above 1: run the two multi-process phases alone, one process per card over NCCL")
    cards = parser.parse_args().cards
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(1)
    if not 1 <= cards <= torch.cuda.device_count():
        fail(f"--cards {cards}, but the host has {torch.cuda.device_count()} CUDA device(s)")

    # The port: imported only once a card is known to be there.
    import torch.nn.functional as F

    from factorizer_tpu_torch.factorization.deconv import Deconv
    from factorizer_tpu_torch.factorization.nmf import MatrixFactorization
    from factorizer_tpu_torch.ops.kernels import (
        build, depthwise_conv, depthwise_conv_dw, depthwise_conv_dw_plain, depthwise_conv_plain,
        nmf_reconstruct, nmf_reconstruct_backward, nmf_reconstruct_backward_plain, nmf_reconstruct_plain, prenorm_mlp, prenorm_mlp_backward, prenorm_mlp_backward_plain, prenorm_mlp_plain,
        reference_kernels, windowed_nmf, windowed_nmf_backward, windowed_nmf_backward_plain, windowed_nmf_factors,
        windowed_nmf_factors_plain, windowed_nmf_multi_spatial, windowed_nmf_multi_spatial_local,
        windowed_nmf_multi_spatial_plain, windowed_nmf_plain, windowed_nmf_reconstruct, windowed_nmf_reconstruct_plain,
    )
    from factorizer_tpu_torch.models.factorizer import Factorizer
    from factorizer_tpu_torch.ops.kernels.depthwise_conv import (
        ROUTES, TILE, _launch_dw, _launch_forward, conv_plan, tile_min_blocks,
    )
    from factorizer_tpu_torch.ops.kernels.mlp_block import forward_shares
    from factorizer_tpu_torch.ops.reshape import SWMatricize
    from factorizer_tpu_torch.train.sliding_window import sliding_window_inference, sliding_window_positions
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step
    from factorizer_tpu_torch.zoo_scripts import (
        brats23_network, brats23_optimizer_settings, deconver_brats23_network, deconver_fives_network,
        deconver_isles22_network, ensemble_predict, factorizer_isles22_network,
    )

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    wrappers = kernel_counters()

    def reset_counts() -> None:
        reset_counters(wrappers)

    def read_counts() -> dict:
        return read_counters(wrappers)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True, check=True, timeout=60)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc {nvcc.stdout.strip().splitlines()[-1]} python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[env] torch.backends.cudnn.allow_tf32=False torch.backends.cuda.matmul.allow_tf32=False")

    # 2. build
    t0 = time.perf_counter()
    build.library()
    seconds, log = build.build_info()
    print(f"[build] {time.perf_counter() - t0:.1f} s (nvcc {'reused an identical build' if seconds is None else f'{seconds:.1f} s'})")
    kernel = ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = kernel_label(entry.group(1))
        if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            print(f"[build] {kernel}: {line.strip()}")

    def last_lines(kernels=None) -> None:
        from factorizer_tpu_torch.parallel import child_processes

        left = child_processes()
        check(not left, f"processes that this run started are still alive: {left}")
        print(smi)
        if kernels is not None:
            print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))

    if cards > 1:  # the multi-process phases across cards, and nothing else
        settings = brats23_optimizer_settings(steps_per_epoch=1)
        spatial_slice(cards)
        torch.backends.cudnn.benchmark = True
        train_dp_slice(cards, {k: settings[k] for k in ("lr", "weight_decay")}, 4)
        last_lines()
        return

    # Per kernel: the errors of every comparison, and the times at the first case, (2,128^3,32) f32.
    results = {name: {"errs": [], "times": None} for name in wrappers}

    def record(name: str, err: float, label: str, ms: float, plain_ms: float, bound: tuple[float, str],
               library_ms: float | None = None) -> None:
        check(ms >= bound[0], f"{name} {label}: {ms:.4f} ms is below its bound {bound[0]:.4f} ms: the bound is wrong")
        results[name]["errs"].append(err)
        if results[name]["times"] is None:
            results[name]["times"] = (label, ms, plain_ms, *bound, library_ms)

    gen = torch.Generator(device=dev)
    four, zero_shift, isles_shifts = (None, 2, 4, 6), ((0, 0, 0),), (None, 1, 2, 3)
    # More shifts than one K1 forward launch takes: each pass launches once per group of eight.
    ten = (None, 1, 2, 3, 4, 5, 6, 7, (1, 2, 3), (3, 2, 1))
    # factorizer_isles22 at batch 8, roi 64^3: patches of 4^3, so K1's run-time-size instance; stages 0 and 3.
    isles_shapes = [(8, 64, 32), (8, 8, 256)]

    # 3. K1 against its plain version
    u0 = torch.rand(8, 1, device=dev, generator=gen.manual_seed(1))
    v0 = {8: torch.rand(512, 1, device=dev, generator=gen), 4: torch.rand(64, 1, device=dev, generator=gen)}
    cases = [(2, s, c, 8, dt, "hals", four) for s, c in STAGES for dt in (torch.float32, torch.bfloat16)]
    cases += [(2, 32, 128, 8, torch.float32, "mu", four), (2, 32, 128, 8, torch.float32, "hals", zero_shift)]
    cases += [(2, 32, 128, 8, dt, "hals", ten) for dt in (torch.float32, torch.bfloat16)]
    cases += [(b, s, c, 4, dt, "hals", isles_shifts) for b, s, c in isles_shapes for dt in (torch.float32, torch.bfloat16)]
    with torch.inference_mode():
        for b, s, c, p, dt, solver, shifts in cases:
            x = torch.relu(torch.randn(b, s, s, s, c, device=dev, generator=gen.manual_seed(s + c))).to(dt)
            args = (x, u0, v0[p], 8, p, shifts, solver, NUM_ITERS)
            out, ref = windowed_nmf(*args), windowed_nmf_plain(*args)
            # Each pass against its plain version on the same inputs: the factors pass on x, the reconstruct
            # pass on the kernel's factors.
            (U, V), (U_ref, V_ref) = windowed_nmf_factors(*args), windowed_nmf_factors_plain(*args)
            rest = (x.shape, dt, 8, p, shifts)
            y_b, y_b_ref = windowed_nmf_reconstruct(U, V, *rest), windowed_nmf_reconstruct_plain(U, V, *rest)
            torch.cuda.synchronize()
            err, rel = compare(out, ref)
            err_u, rel_u = compare(U, U_ref)
            err_v, rel_v = compare(V, V_ref)
            err_b, rel_b = compare(y_b, y_b_ref)
            tol = KERNEL_RTOL[dname(dt)]
            label = f"({b},{s}^3,{c}){'' if p == 8 else f' p={p}'} {dname(dt)} {solver} shifts={len(shifts)}"
            check(out.dtype == dt and out.shape == x.shape, f"K1 {label}: wrong output")
            check(rel <= tol, f"K1 {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
            check(max(rel_u, rel_v) <= KERNEL_RTOL["float32"], f"K1 factors {label}: U max_rel {rel_u:.3e}, V {rel_v:.3e}")
            check(rel_b <= tol, f"K1 reconstruct {label}: max_abs {err_b:.3e} max_rel {rel_b:.3e} above {tol:.1e}")
            ms = cuda_time_ms(lambda: windowed_nmf(*args))
            ms_a = cuda_time_ms(lambda: windowed_nmf_factors(*args))
            ms_b = cuda_time_ms(lambda: windowed_nmf_reconstruct(U, V, *rest))
            plain_ms = cuda_time_ms(lambda: windowed_nmf_plain(*args), warmup=1, runs=5)
            plain_a = cuda_time_ms(lambda: windowed_nmf_factors_plain(*args), warmup=1, runs=5)
            plain_b = cuda_time_ms(lambda: windowed_nmf_reconstruct_plain(U, V, *rest), warmup=1, runs=5)
            bound = bound_ms(*k1_work(x, len(shifts), backward=False), dt, "float32")
            bound_a = bound_ms(*k1_pass_work(x, U, V, len(shifts), factors=True), dt, "float32")
            bound_b = bound_ms(*k1_pass_work(x, U, V, len(shifts), factors=False), dt, "float32")
            check(ms >= bound[0], f"K1 {label}: {ms:.4f} ms is below its bound {bound[0]:.4f} ms")
            print(f"[K1] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}) "
                  f"kernels {ms:.3f} ms plain {plain_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]}); "
                  f"factors pass U max_rel={rel_u:.2e} V max_rel={rel_v:.2e} {ms_a:.3f} ms plain {plain_a:.3f} bound "
                  f"{bound_a[0]:.3f} ({bound_a[1]}); reconstruct pass max_rel={rel_b:.2e} {ms_b:.3f} ms plain {plain_b:.3f} "
                  f"bound {bound_b[0]:.3f} ({bound_b[1]}); factors {4 * (U.numel() + V.numel()) / 1e6:.1f} MB")
            record("windowed_nmf_factors", max(err_u, err_v), label, ms_a, plain_a, bound_a)
            record("windowed_nmf_reconstruct", err_b, label, ms_b, plain_b, bound_b)
            del x, out, ref, U, V, U_ref, V_ref, y_b, y_b_ref

    # 4. K2 against its plain version
    def mlp_params(c: int) -> tuple:
        h = 4 * c
        return (
            1 + 0.1 * torch.randn(c, device=dev, generator=gen.manual_seed(c)),
            0.1 * torch.randn(c, device=dev, generator=gen),
            torch.randn(h, c, device=dev, generator=gen) / c**0.5,
            0.1 * torch.randn(h, device=dev, generator=gen),
            torch.randn(c, h, device=dev, generator=gen) / h**0.5,
            0.1 * torch.randn(c, device=dev, generator=gen),
        )

    with torch.inference_mode():
        for s, c in STAGES:
            params = mlp_params(c)
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(2, s, s, s, c, device=dev, generator=gen).to(dt)
                args = (x, *params)
                out, again, ref = prenorm_mlp(*args), prenorm_mlp(*args), prenorm_mlp_plain(*args)
                torch.cuda.synchronize()
                err, rel = compare(out, ref)
                tol = KERNEL_RTOL[dname(dt)]
                label = f"(2,{s}^3,{c}) H={4 * c} {dname(dt)}"
                check(out.dtype == dt and out.shape == x.shape, f"K2 {label}: wrong output")
                check(rel <= tol, f"K2 {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
                check(torch.equal(out, again), f"K2 {label}: two calls on one input differ")
                ms = cuda_time_ms(lambda: prenorm_mlp(*args))
                plain_ms = cuda_time_ms(lambda: prenorm_mlp_plain(*args), warmup=1, runs=5)
                n_bytes, flops, units = k2_work(x, 4 * c, backward=False)
                bound = bound_ms(n_bytes, flops, dt, units)
                print(f"[K2] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}), equal to itself bit for bit "
                      f"on a second call; kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]}, "
                      f"{units}); {forward_shares(x.numel() // c, c, 4 * c)} share(s) of the hidden width")
                record("prenorm_mlp", err, label, ms, plain_ms, bound)
                del x, out, again, ref

    # 5. the serving slice
    sw_batch, overlap, n_requests = 2, 0.5, 2
    n_blocks, n_shifts = N_BLOCKS, N_SHIFTS
    serve_launches = dict.fromkeys(wrappers, 0)
    brats = dict(volume=(1, 4, 240, 240, 155), roi=(128, 128, 128), out_channels=3)
    isles = dict(volume=(1, 2, 112, 112, 73), roi=(64, 64, 64), out_channels=1)

    def serve_slice(tag: str, network, per_forward: dict, volume=brats["volume"], roi=brats["roi"],
                    out_channels=brats["out_channels"], dtypes=("float32", "bfloat16"), same_function_as=None) -> None:
        """Serve ``n_requests`` synthetic volumes after a warm-up request, per dtype; check the launches per request
        and the first request's logits against the plain versions and, where ``same_function_as`` builds a network
        that computes the same function by another route, against that network from the same seed."""
        n_windows = len(sliding_window_positions(volume[2:], roi, overlap))
        forwards = -(-n_windows // sw_batch)
        expected = {name: forwards * per_forward.get(name, 0) for name in wrappers}
        volumes = [torch.randn(volume, device=dev, generator=gen.manual_seed(100 + i)) for i in range(n_requests + 1)]

        def build_models(factory) -> dict:
            kw = {"float32": {}, "bfloat16": {"dtype": torch.bfloat16}}
            return {name: factory(device=dev, generator=torch.Generator().manual_seed(0), **kw[name]).eval() for name in dtypes}

        models = build_models(network)
        out_shape = (1, out_channels, *volume[2:])
        reset_counts()
        for name, model in models.items():
            ensemble_predict([model], volumes[-1], roi, sw_batch, overlap)  # warm-up request
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            seconds = []
            for i in range(n_requests):
                before = read_counts()
                t0 = time.perf_counter()
                mask, probs = ensemble_predict([model], volumes[i], roi, sw_batch, overlap)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                check(tuple(mask.shape) == out_shape and tuple(probs.shape) == out_shape, f"{tag} {name}: output shape {tuple(mask.shape)}")
                check(bool(torch.isfinite(probs).all()), f"{tag} {name}: non-finite probabilities")
                made = {k: v - before[k] for k, v in read_counts().items()}
                check(made == expected, f"{tag} {name}: launches {made} for {forwards} forwards, expected {expected}")
            mem = torch.cuda.max_memory_allocated(dev)
            mean_s = statistics.mean(seconds)
            print(f"[{tag}] {name}: {mean_s:.3f} s/volume {tuple(volume)} (requests {', '.join(f'{t:.3f}' for t in seconds)} s), "
                  f"{n_windows / mean_s:.2f} windows/s, peak memory {mem / 2**30:.2f} GiB, "
                  f"foreground share {mask.float().mean().item():.4f}, "
                  f"launches per request { {k: v for k, v in expected.items() if v} }")
        for k, v in read_counts().items():
            serve_launches[k] += v
            check(v > 0 or not per_forward.get(k), f"{tag}: kernel {k} of the serving path never launched")

        others = build_models(same_function_as) if same_function_as is not None else {}
        with torch.inference_mode():
            for name, model in models.items():
                logits = sliding_window_inference(volumes[0], roi, model, sw_batch, overlap)
                with reference_kernels():
                    ref = sliding_window_inference(volumes[0], roi, model, sw_batch, overlap)
                torch.cuda.synchronize()
                err, rel = compare(logits, ref)
                print(f"[{tag}] {name} logits vs plain versions: max_abs={err:.3e} max_rel={rel:.3e} "
                      f"(tol {SLICE_RTOL[name]:.1e})")
                check(bool(torch.isfinite(logits).all()), f"{tag} {name}: non-finite logits")
                check(rel <= SLICE_RTOL[name], f"{tag} {name}: logits differ from the plain versions by {rel:.3e}")
                if name in others:
                    ref = sliding_window_inference(volumes[0], roi, others[name], sw_batch, overlap)
                    torch.cuda.synchronize()
                    err, rel = compare(logits, ref)
                    print(f"[{tag}] {name} logits vs {same_function_as.__name__}() from the same seed: max_abs={err:.3e} "
                          f"max_rel={rel:.3e} (tol {ROUTE_RTOL[name]:.1e})")
                    check(rel <= ROUTE_RTOL[name], f"{tag} {name}: the two routes differ by {rel:.3e}")
        del models, others, volumes, mask, probs, logits, ref
        gc.collect()
        torch.cuda.empty_cache()

    def forward_slice(tag: str, model, inputs, expected_launches: dict, out_shape: tuple, what: str) -> None:
        """One timed forward of ``inputs`` after a warm-up: launches, finite logits of ``out_shape``, and the
        logits against the plain versions."""
        check(next(model.parameters()).is_cuda, f"{tag}: the network did not build on the card")
        with torch.inference_mode():
            model(inputs)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            t0 = time.perf_counter()
            logits = model(inputs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            made = read_counts()
            mem = torch.cuda.max_memory_allocated(dev)
            with reference_kernels():
                ref = model(inputs)
            torch.cuda.synchronize()
        expected = {name: expected_launches.get(name, 0) for name in wrappers}
        check(made == expected, f"{tag}: launches {made}, expected {expected}")
        check(tuple(logits.shape) == out_shape and bool(torch.isfinite(logits).all()), f"{tag}: wrong or non-finite logits")
        err, rel = compare(logits, ref)
        print(f"[{tag}] float32: {seconds:.4f} s per forward of {tuple(inputs.shape)} ({what}), peak memory {mem / 2**30:.2f} GiB, "
              f"launches { {k: v for k, v in expected.items() if v} }; logits vs plain versions: max_abs={err:.3e} "
              f"max_rel={rel:.3e} (tol {SLICE_RTOL['float32']:.1e})")
        check(rel <= SLICE_RTOL["float32"], f"{tag}: logits differ from the plain versions by {rel:.3e}")
        for k, v in made.items():
            serve_launches[k] += v

    k1_forward = {"windowed_nmf_factors": n_blocks, "windowed_nmf_reconstruct": n_blocks}
    serve_slice("slice", brats23_network, {**k1_forward, "prenorm_mlp": n_blocks})

    # 6. K1 backward against autograd through the plain version
    # MU runs on a strictly positive input: where a whole row of a window is zero its factor decays to
    # ~eps and 1 / (v b + eps) ~ 1e16 makes the gradient so ill-conditioned that f32 keeps no digit of it,
    # in the kernel and in the plain version alike.
    cases = [(2, s, c, 8, dt, "hals", four, None, False) for s, c in STAGES for dt in (torch.float32, torch.bfloat16)]
    cases += [
        (2, 32, 128, 8, torch.float32, "mu", four, None, False),
        (2, 32, 128, 8, torch.float32, "hals", zero_shift, None, False),
        (2, 32, 128, 8, torch.float32, "hals", four, 2, False),
        (2, 64, 64, 8, torch.float32, "hals", four, None, True),  # a quarter of the volume all zero, as BraTS background
    ]
    cases += [(b, s, c, 4, dt, "hals", isles_shifts, None, False) for b, s, c in isles_shapes for dt in (torch.float32, torch.bfloat16)]
    for b, s, c, p, dt, solver, shifts, grad_steps, zero_windows in cases:
        x = torch.relu(torch.randn(b, s, s, s, c, device=dev, generator=gen.manual_seed(s + c)))
        if solver == "mu":
            x = torch.rand(b, s, s, s, c, device=dev, generator=gen) + 0.05
        if zero_windows:
            x[:, : s // 2, : s // 2] = 0
        x = x.to(dt)
        g = torch.randn(x.shape, device=dev, generator=gen).to(dt)
        args = (x, g, u0, v0[p], 8, p, shifts, solver, NUM_ITERS, 1e-16, grad_steps)
        out, ref = windowed_nmf_backward(*args), windowed_nmf_backward_plain(*args)
        torch.cuda.synchronize()
        err, rel = compare(out, ref)
        tol = K1_BWD_RTOL[dname(dt)]
        label = (f"({b},{s}^3,{c}){'' if p == 8 else f' p={p}'} {dname(dt)} {solver} shifts={len(shifts)}"
                 + (f" num_grad_steps={grad_steps}" if grad_steps is not None else "")
                 + (" zero windows" if zero_windows else "") + (" positive x" if solver == "mu" else ""))
        check(out.dtype == dt and out.shape == x.shape, f"K1 bwd {label}: wrong output")
        check(bool(torch.isfinite(out).all()), f"K1 bwd {label}: non-finite dx")
        check(rel <= tol, f"K1 bwd {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
        del out, ref
        ms = cuda_time_ms(lambda: windowed_nmf_backward(*args))
        plain_ms = cuda_time_ms(lambda: windowed_nmf_backward_plain(*args), warmup=1, runs=3)
        bound = bound_ms(*k1_work(x, len(shifts), True, grad_steps or NUM_ITERS, solver == "mu"), dt, "float32")
        print(f"[K1 bwd] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}) "
              f"kernel {ms:.3f} ms plain forward+backward {plain_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]})")
        record("windowed_nmf_bwd", err, label, ms, plain_ms, bound)
        del x, g, args
        torch.cuda.empty_cache()  # the plain version's graph holds several GB at 128^3 x 32

    # 7. K2 backward against autograd through the plain version
    grad_names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for s, c in STAGES:
        params = mlp_params(c)
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(2, s, s, s, c, device=dev, generator=gen).to(dt)
            g = torch.randn(x.shape, device=dev, generator=gen).to(dt)
            args = (x, g, *params)
            outs, again, refs = prenorm_mlp_backward(*args), prenorm_mlp_backward(*args), prenorm_mlp_backward_plain(*args)
            torch.cuda.synchronize()
            label = f"(2,{s}^3,{c}) H={4 * c} {dname(dt)}"
            check(all(torch.equal(a, b) for a, b in zip(outs, again)), f"K2 bwd {label}: two calls on one input differ")
            rels = {}
            for name, out, ref in zip(grad_names, outs, refs):
                err, rels[name] = compare(out, ref)
                tol = KERNEL_RTOL[dname(dt)] if name == "dx" else K2_PARAM_RTOL
                check(out.dtype == ref.dtype and out.shape == ref.shape, f"K2 bwd {label}: wrong {name}")
                check(rels[name] <= tol, f"K2 bwd {label}: {name} max_abs {err:.3e} max_rel {rels[name]:.3e} above {tol:.1e}")
                if name == "dx":
                    dx_err = err
            del outs, again, refs
            ms = cuda_time_ms(lambda: prenorm_mlp_backward(*args))
            plain_ms = cuda_time_ms(lambda: prenorm_mlp_backward_plain(*args), warmup=1, runs=3)
            n_bytes, flops, units = k2_work(x, 4 * c, backward=True)
            bound = bound_ms(n_bytes, flops, dt, units)
            print(f"[K2 bwd] {label}: dx max_abs={dx_err:.3e} max_rel={rels['dx']:.3e} (tol {KERNEL_RTOL[dname(dt)]:.1e}) "
                  f"params max_rel " + " ".join(f"{n}={rels[n]:.1e}" for n in grad_names[1:]) + f" (tol {K2_PARAM_RTOL:.1e}) "
                  f"kernel {ms:.3f} ms plain forward+backward {plain_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]}, {units}); "
                  "equal to itself bit for bit on a second call")
            record("prenorm_mlp_bwd", dx_err, label, ms, plain_ms, bound)
            del x, g, args
            torch.cuda.empty_cache()

    # 8. the training slice.  The optimiser is the bundle's AdamW (lr 1e-4, weight decay 1e-5) at a
    # constant lr: the bundle's warm-up-cosine schedule starts at lr 0, so its first steps would not move.
    # cuDNN times its algorithms per shape from here on, as a training run with fixed shapes would have it:
    # without it the stem's f32 weight gradient alone takes 92 ms of a step.
    settings = brats23_optimizer_settings(steps_per_epoch=1)
    settings = {k: settings[k] for k in ("lr", "weight_decay")}
    torch.backends.cudnn.benchmark = True
    print(f"[train] AdamW {settings}, constant lr (the bundle's schedule warms up from lr 0), batch 2 x 128^3, DiceCE, "
          "torch.backends.cudnn.benchmark=True")

    batch = synthetic_batch(2, 4, 3, 128, seed=7)
    print(f"[train] label foreground share {batch['label'].mean().item():.4f}")
    train_launches = dict.fromkeys(wrappers, 0)
    n_steps = 4

    def train_slice(tag: str, network, launches_per_step: dict, leaves: dict, batch=batch,
                    dtypes=(torch.float32, torch.bfloat16), recomputes_per_step: int = 0, same_step_as=None) -> dict:
        """1 warm-up and 3 timed steps on ``batch``, per dtype: launches per step (and K4's rank > 1 backward
        recomputes, which are no launches), a falling loss, and the first step's loss and gradients (the norm and
        the ``leaves``) against the same step on the plain versions within ``TRAIN_RTOL``; or, where
        ``same_step_as`` builds a network that takes the same step by another way on the same kernels, the loss,
        the norm and every gradient equal bit for bit to that network's step from the same seed.
        Returns per dtype name (s/step, peak GiB)."""
        per_step = {name: launches_per_step.get(name, 0) for name in wrappers}
        out = {}
        for dt in dtypes:
            name = dname(dt)

            def new_state(factory=network):
                # No device argument: the entry points' default, the card, is what runs.
                model = factory(dtype=None if dt == torch.float32 else dt, generator=torch.Generator().manual_seed(0))
                check(next(model.parameters()).is_cuda, f"{tag}: the network did not build on the card")
                return create_train_state(model, **settings)

            # The first step on the plain versions (or on same_step_as), from the same weights.
            state = new_state(network if same_step_as is None else same_step_as)
            torch.cuda.reset_peak_memory_stats(dev)
            with contextlib.nullcontext() if same_step_as is not None else reference_kernels():
                _, metrics = make_train_step(state.model)(state, batch)
            torch.cuda.synchronize()
            ref_loss, ref_norm = metrics["loss"].item(), metrics["grad_norm"].item()
            ref_grads = {k: p.grad.clone() for k, p in state.model.named_parameters()
                         if k in leaves or same_step_as is not None}
            ref_mem = torch.cuda.max_memory_allocated(dev)
            del state, metrics
            gc.collect()
            torch.cuda.empty_cache()

            state = new_state()
            step = make_train_step(state.model)
            losses, seconds = [], []
            for i in range(n_steps):
                if i == 1:
                    torch.cuda.reset_peak_memory_stats(dev)
                reset_counts()
                nmf_reconstruct_backward.recomputes = 0
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                counts = read_counts()
                check(counts == per_step, f"{tag} {name} step {i + 1}: launches {counts}, expected {per_step}")
                check(nmf_reconstruct_backward.recomputes == recomputes_per_step,
                      f"{tag} {name} step {i + 1}: {nmf_reconstruct_backward.recomputes} backward recomputes, expected {recomputes_per_step}")
                for k, v in counts.items():
                    train_launches[k] += v
                losses.append(metrics["loss"].item())
                grads = dict(state.model.named_parameters())
                bad = [k for k, p in grads.items() if p.grad is None or not bool(torch.isfinite(p.grad).all())]
                check(not bad, f"{tag} {name} step {i + 1}: no finite gradient for {bad[:5]}")
                if i == 0 and same_step_as is not None:
                    norm = metrics["grad_norm"].item()
                    unequal = [k for k, ref in ref_grads.items() if not torch.equal(grads[k].grad, ref)]
                    worst = max((float((grads[k].grad - ref_grads[k]).abs().max()) for k in unequal), default=0.0)
                    print(f"[{tag}] {name} step 1 vs the step of {same_step_as.__name__}: loss {losses[0]!r} / {ref_loss!r}, "
                          f"grad norm {norm!r} / {ref_norm!r}, {len(ref_grads) - len(unequal)} of {len(ref_grads)} "
                          f"gradients equal bit for bit (largest difference {worst:.3e}); reference step peak memory "
                          f"{ref_mem / 2**30:.2f} GiB")
                    check(losses[0] == ref_loss and norm == ref_norm and not unequal and grads.keys() == ref_grads.keys(),
                          f"{tag} {name}: the step differs from the step of {same_step_as.__name__}: loss {losses[0]!r} / "
                          f"{ref_loss!r}, grad norm {norm!r} / {ref_norm!r}, unequal gradients {unequal[:5]}")
                    ref_grads.clear()  # not held through the timed steps, whose peak memory is read
                elif i == 0:
                    tol = TRAIN_RTOL[name]
                    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
                    norm_rel = abs(metrics["grad_norm"].item() - ref_norm) / ref_norm
                    leaf_rel = {short: compare(grads[k].grad, ref_grads[k])[1] for k, short in leaves.items()}
                    print(f"[{tag}] {name} step 1 vs plain versions: loss {losses[0]:.6f} / {ref_loss:.6f} (rel {loss_rel:.2e}, "
                          f"tol {tol['loss']:.0e}), grad norm rel {norm_rel:.2e}, leaves max_rel "
                          + " ".join(f"{k}={v:.2e}" for k, v in leaf_rel.items()) + f" (tol {tol['grad']:.0e}); "
                          f"reference step peak memory {ref_mem / 2**30:.2f} GiB")
                    check(loss_rel <= tol["loss"], f"{tag} {name}: loss differs from the plain versions by {loss_rel:.2e}")
                    check(norm_rel <= tol["grad"] and max(leaf_rel.values()) <= tol["grad"],
                          f"{tag} {name}: gradients differ from the plain versions: norm {norm_rel:.2e}, leaves {leaf_rel}")
            mem = torch.cuda.max_memory_allocated(dev)
            check(all(map(math.isfinite, losses)), f"{tag} {name}: non-finite loss {losses}")
            check(losses[-1] < losses[0], f"{tag} {name}: loss did not fall: {losses}")
            timed = seconds[1:]
            print(f"[{tag}] {name}: {statistics.mean(timed):.4f} s/step (steps {', '.join(f'{s:.4f}' for s in timed)} s after a "
                  f"{seconds[0]:.2f} s warm-up step), peak memory {mem / 2**30:.2f} GiB, loss {' -> '.join(f'{v:.6f}' for v in losses)}, "
                  f"launches per step { {k: v for k, v in per_step.items() if v} }"
                  + (f", K4 backward recomputes in torch operations per step {recomputes_per_step}" if recomputes_per_step else ""))
            out[name] = (statistics.mean(timed), mem / 2**30)
            del state, step, metrics, grads, ref_grads
            gc.collect()
            torch.cuda.empty_cache()
        check(all(train_launches[k] > 0 for k, v in per_step.items() if v), f"{tag}: a kernel of the training path never launched: {train_launches}")
        return out

    brats_leaves = {"stem.weight": "stem", "encoder.blocks.0.block.blocks.0.mlp.block.0.linear.weight": "enc0.fc1",
                    "encoder.blocks.4.block.blocks.0.fact.out_proj.linear.weight": "bottleneck.out_proj"}
    plain_step = train_slice(
        "train", brats23_network,
        {**k1_forward, "windowed_nmf_bwd": n_blocks * n_shifts, "prenorm_mlp": n_blocks, "prenorm_mlp_bwd": n_blocks},
        brats_leaves,
    )
    # The bundle's remat: true.  Each stage block runs under torch.utils.checkpoint, so its forward runs again in
    # the backward: twice the K1 and K2 forward launches, the backward launches unchanged.
    remat_step = train_slice(
        "train remat", functools.partial(brats23_network, remat=True),
        {"windowed_nmf_factors": 2 * n_blocks, "windowed_nmf_reconstruct": 2 * n_blocks,
         "windowed_nmf_bwd": n_blocks * n_shifts, "prenorm_mlp": 2 * n_blocks, "prenorm_mlp_bwd": n_blocks},
        brats_leaves, dtypes=(torch.float32,), same_step_as=brats23_network,
    )
    (s_plain, mem_plain), (s_remat, mem_remat) = plain_step["float32"], remat_step["float32"]
    print(f"[train remat] float32: {s_remat:.4f} s/step and {mem_remat:.2f} GiB peak beside {s_plain:.4f} s/step and "
          f"{mem_plain:.2f} GiB without remat ({s_remat / s_plain:.3f}x the time, {mem_remat / mem_plain:.3f}x the memory)")

    # 9. K3 against its plain version, and beside it the one library call that computes the same function:
    # F.conv{2,3}d with groups = B * C on tensors already laid out as (1, B*C, *S), so that the call is timed
    # without the plain version's two layout transposes.  cuDNN's benchmark mode is off in this phase and the
    # two serving phases below, as in the Factorizer's; the first case times the library call under both modes.
    torch.backends.cudnn.benchmark = False
    k3 = (3, 3, 3)
    # (x shape, kernel size, dtype, a quarter zero, the routes that conv_plan must give forward and dw)
    k3_cases = [((2, s, s, s, c), k3, dt, False, ("tile", "tile")) for s, c in STAGES for dt in (torch.float32, torch.bfloat16)]
    k3_cases += [
        ((16, 512, 512, 32), (7, 7), torch.float32, False, ("tile", "tile")),    # FIVES stage 0
        ((16, 128, 128, 128), (7, 7), torch.float32, False, ("tile", "tile")),   # FIVES stage 2
        ((2, 32, 32, 32, 128), (1, 3, 5), torch.float32, False, ("tile", "tile")),
        ((2, 32, 32, 32, 128), (3, 1, 9), torch.float32, False, ("any", "any")),  # k3 above 7: the per-output kernels
        ((2, 64, 64, 64, 48), k3, torch.float32, False, ("tile", "tile")),       # a width the TPU's packed kernel refuses
        ((2, 64, 64, 64, 64), k3, torch.float32, True, ("tile", "tile")),        # a quarter of the volume all zero
        ((8, 64, 64, 64, 32), k3, torch.float32, False, ("tile", "tile")),       # deconver_isles22's train batch, stage 0
        ((2, 5, 7, 9, 12), k3, torch.float32, False, ("tile", "tile")),          # tiles that the volume does not divide
        # The run kernels: widths that no 16-byte vector divides, and a weight gradient of more accumulators than
        # the tiled kernel holds; each also timed through the per-output kernel, the route it would take otherwise.
        ((2, 32, 32, 32, 30), k3, torch.float32, False, ("run", "run")),
        ((2, 32, 32, 32, 20), k3, torch.bfloat16, False, ("run", "run")),
        ((2, 32, 32, 32, 32), (3, 5, 5), torch.float32, False, ("tile", "run")),
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slower_than_library = []  # (line tag, label, per call or device, kernel / library)
    routes_seen = {False: set(), True: set()}

    def k3_plan(shape, ks, dt, routes, dw: bool, label: str):
        """The case's plan, checked: the route the case names, and for a tiled plan the mirror of
        csrc/depthwise_conv.cuh against the library (its constants, the plan's shared memory, tile_plan_ok)."""
        plan = conv_plan(shape, ks, dt, sms, dw=dw)
        tag = "K3 dw" if dw else "K3"
        check(plan.route == routes[dw], f"{tag} {label}: conv_plan chose the {plan.route} route, not {routes[dw]}")
        routes_seen[dw].add(plan.route)
        if plan.route == "tile":
            k1, k2, k3_ = plan.ks
            query = (ctypes.c_int * 7)()
            build.library().ftt_depthwise_conv_tile_query(*plan.shape[1:], k1, k2, k3_, dt.itemsize, int(dw), plan.t2,
                                                           plan.t3, plan.cb, plan.planes, query)
            mirror = (*TILE, tile_min_blocks(k2, k3_, dw), plan.smem)
            check(tuple(query) == mirror, f"{tag} {label}: the plan's constants and shared memory {mirror} differ "
                                          f"from the header's {tuple(query)}")
        return plan

    def k3_inputs(shape, ks, dt, zero_quarter):
        x = torch.randn(shape, device=dev, generator=gen.manual_seed(sum(shape))).to(dt)
        if zero_quarter:
            x[:, : shape[1] // 2, : shape[2] // 2] = 0
        g = torch.randn(shape, device=dev, generator=gen).to(dt)
        w = torch.randn(shape[0], math.prod(ks), shape[-1], device=dev, generator=gen)
        return x, g, w

    def k3_label(shape, ks, dt, zero_quarter) -> str:
        cube = len(shape) == 5 and len(set(shape[1:4])) == 1
        size = f"{shape[1]}^3" if cube else "x".join(map(str, shape[1:-1]))
        return (f"({shape[0]},{size},{shape[-1]}) k={'x'.join(map(str, ks))} {dname(dt)}"
                + (" zero quarter" if zero_quarter else ""))

    def channels_first(t):
        """``(1, B*C, *S)``, contiguous and f32: the layout the library call takes."""
        b, c = t.shape[0], t.shape[-1]
        return t.float().movedim(-1, 1).reshape(1, b * c, *t.shape[1:-1]).contiguous()

    def library_weight(w, ks):
        return w.transpose(1, 2).reshape(-1, 1, *ks).contiguous()

    def against_any(plan, shape, ks, dt, dw: bool, launch, ref, tol: float, label: str, ms: float) -> str:
        """For a run-route case: the per-output kernel (the route the shape would take without the run kernels)
        on the same inputs, held against the plain version and timed beside the run kernel."""
        if plan.route != "run":
            return ""
        tag, other = ("K3 dw" if dw else "K3"), conv_plan(shape, ks, dt, sms, dw=dw, route="any")
        out = launch(other)
        torch.cuda.synchronize()
        _, rel = compare(out, ref)
        check(rel <= tol, f"{tag} {label}: the per-output kernel's max_rel {rel:.3e} above {tol:.1e}")
        any_ms = cuda_time_ms(lambda: launch(other))
        return f"; per-output kernel {any_ms:.3f} ms (max_rel={rel:.3e}; run / per-output {ms / any_ms:.2f})"

    with torch.inference_mode():
        for i, (shape, ks, dt, zero_quarter, routes) in enumerate(k3_cases):
            x, _, w = k3_inputs(shape, ks, dt, zero_quarter)
            label = k3_label(shape, ks, dt, zero_quarter)
            plan = k3_plan(shape, ks, dt, routes, False, label)
            out, ref = depthwise_conv(x, w, ks), depthwise_conv_plain(x, w, ks)
            torch.cuda.synchronize()
            err, rel = compare(out, ref)
            tol = KERNEL_RTOL[dname(dt)]
            check(out.dtype == dt and out.shape == x.shape, f"K3 {label}: wrong output")
            check(rel <= tol, f"K3 {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
            ms = cuda_time_ms(lambda: depthwise_conv(x, w, ks))
            plain_ms = cuda_time_ms(lambda: depthwise_conv_plain(x, w, ks), warmup=1, runs=5)
            conv = F.conv2d if len(ks) == 2 else F.conv3d
            xc, wc, pad, groups = channels_first(x), library_weight(w, ks), tuple(k // 2 for k in ks), shape[0] * shape[-1]
            library_ms = cuda_time_ms(lambda: conv(xc, wc, None, 1, pad, 1, groups), warmup=1, runs=5)
            bound = bound_ms(*k3_work(x, math.prod(ks), dw=False), dt)
            dev_ms = graph_time_ms(lambda: depthwise_conv(x, w, ks))
            dev_library_ms = graph_time_ms(lambda: conv(xc, wc, None, 1, pad, 1, groups))
            slower_than_library += [("K3", label, "per call", ms / library_ms)] if ms > library_ms else []
            slower_than_library += [("K3", label, "device", dev_ms / dev_library_ms)] if dev_ms > dev_library_ms else []
            line = (f"[K3] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}) kernel {ms:.3f} ms "
                    f"plain {plain_ms:.3f} ms library {library_ms:.3f} ms (kernel / library {ms / library_ms:.2f}); "
                    f"device (CUDA graph) kernel {dev_ms:.4f} ms library {dev_library_ms:.4f} ms "
                    f"({dev_ms / dev_library_ms:.2f}); bound {bound[0]:.3f} ms ({bound[1]}); "
                    f"plan: {plan.describe()}")
            line += against_any(plan, shape, ks, dt, False, lambda p: _launch_forward(x, w, ks, p), ref, tol, label, ms)
            if i == 0:
                torch.backends.cudnn.benchmark = True
                tuned_ms = cuda_time_ms(lambda: conv(xc, wc, None, 1, pad, 1, groups), warmup=2, runs=5)
                torch.backends.cudnn.benchmark = False
                line += f" library with cudnn.benchmark {tuned_ms:.3f} ms"
            print(line)
            record("depthwise_conv", err, label, ms, plain_ms, bound, library_ms)
            del x, w, out, ref, xc, wc
            torch.cuda.empty_cache()

    # 10. K3 dw against autograd through the plain version; the library call is the grouped convolution's
    # weight gradient alone (aten::convolution_backward with only that output asked for).
    for i, (shape, ks, dt, zero_quarter, routes) in enumerate(k3_cases):
        x, g, w = k3_inputs(shape, ks, dt, zero_quarter)
        label = k3_label(shape, ks, dt, zero_quarter)
        plan = k3_plan(shape, ks, dt, routes, True, label)
        out, again, ref = depthwise_conv_dw(x, g, ks), depthwise_conv_dw(x, g, ks), depthwise_conv_dw_plain(x, g, ks)
        torch.cuda.synchronize()
        err, rel = compare(out, ref)
        check(out.dtype == torch.float32 and out.shape == w.shape, f"K3 dw {label}: wrong output")
        check(rel <= K3_DW_RTOL, f"K3 dw {label}: max_abs {err:.3e} max_rel {rel:.3e} above {K3_DW_RTOL:.1e}")
        check(torch.equal(out, again), f"K3 dw {label}: two runs on one input differ")
        # dx and dw through the autograd function against autograd through the plain version
        xg, wg = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
        before = depthwise_conv.launches, depthwise_conv_dw.launches
        dx, dw = torch.autograd.grad(depthwise_conv(xg, wg, ks), (xg, wg), g)
        check((depthwise_conv.launches - before[0], depthwise_conv_dw.launches - before[1]) == (2, 1),
              f"K3 dw {label}: the autograd function did not launch forward, dx and dw kernels")
        dx_ref, dw_ref = torch.autograd.grad(depthwise_conv_plain(xg, wg, ks), (xg, wg), g)
        torch.cuda.synchronize()
        (_, dx_rel), (_, dw_rel) = compare(dx, dx_ref), compare(dw, dw_ref)
        check(dx.dtype == dt and dx_rel <= KERNEL_RTOL[dname(dt)] and dw_rel <= K3_DW_RTOL,
              f"K3 dw {label}: autograd dx max_rel {dx_rel:.3e}, dw max_rel {dw_rel:.3e}")
        del out, again, xg, wg, dx, dw, dx_ref, dw_ref
        ms = cuda_time_ms(lambda: depthwise_conv_dw(x, g, ks))
        plain_ms = cuda_time_ms(lambda: depthwise_conv_dw_plain(x, g, ks), warmup=1, runs=3)
        nd, groups = len(ks), shape[0] * shape[-1]
        xc, gc_, wc = channels_first(x), channels_first(g), library_weight(w, ks)

        def library_dw():
            return torch.ops.aten.convolution_backward(gc_, xc, wc, None, [1] * nd, [k // 2 for k in ks], [1] * nd,
                                                       False, [0] * nd, groups, [False, True, False])[1]

        lib_err = compare(library_dw().reshape(shape[0], shape[-1], -1).transpose(1, 2), depthwise_conv_dw(x, g, ks))[1]
        check(lib_err <= K3_DW_RTOL, f"K3 dw {label}: the library call computes another function ({lib_err:.3e})")
        library_ms = cuda_time_ms(library_dw, warmup=1, runs=3)
        bound = bound_ms(*k3_work(x, math.prod(ks), dw=True), dt)
        dev_ms, dev_library_ms = graph_time_ms(lambda: depthwise_conv_dw(x, g, ks)), graph_time_ms(library_dw)
        slower_than_library += [("K3 dw", label, "per call", ms / library_ms)] if ms > library_ms else []
        slower_than_library += [("K3 dw", label, "device", dev_ms / dev_library_ms)] if dev_ms > dev_library_ms else []
        line = (f"[K3 dw] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {K3_DW_RTOL:.1e}) bit-identical twice; autograd "
                f"dx max_rel={dx_rel:.3e} dw max_rel={dw_rel:.3e}; kernel {ms:.3f} ms plain forward+backward {plain_ms:.3f} ms "
                f"library {library_ms:.3f} ms (kernel / library {ms / library_ms:.2f}); device (CUDA graph) kernel "
                f"{dev_ms:.4f} ms library {dev_library_ms:.4f} ms ({dev_ms / dev_library_ms:.2f}); bound {bound[0]:.3f} ms "
                f"({bound[1]}); plan: {plan.describe()}")
        line += against_any(plan, shape, ks, dt, True, lambda p: _launch_dw(x, g, ks, p), ref, K3_DW_RTOL, label, ms)
        if i == 0:
            torch.backends.cudnn.benchmark = True
            tuned_ms = cuda_time_ms(library_dw, warmup=2, runs=3)
            torch.backends.cudnn.benchmark = False
            line += f" library with cudnn.benchmark {tuned_ms:.3f} ms; {dw_sum_share(lambda: depthwise_conv_dw(x, g, ks))}"
        print(line)
        record("depthwise_conv_dw", err, label, ms, plain_ms, bound, library_ms)
        del x, g, w, xc, gc_, wc, ref
        torch.cuda.empty_cache()

    check(routes_seen == {False: set(ROUTES), True: set(ROUTES)},
          f"K3: the cases do not reach every route in both directions: {routes_seen}")
    print("[K3] kernel slower than its library call at: "
          + ("; ".join(f"{tag} {label}, {how} ({r:.2f}x)" for tag, label, how, r in slower_than_library) or "no case"))

    # The Deconv layer on an input with a quarter all zero (BraTS background after the ReLU): numerator and
    # denominator of the update are both eps there.  Source and gradients, kernels against plain versions.
    layer = Deconv(64, kernel_size=k3, groups=-1, ratio=1, num_iters=1, device=dev, generator=torch.Generator().manual_seed(3))
    x = torch.relu(torch.randn(2, 64, 64, 64, 64, device=dev, generator=gen.manual_seed(11)))
    x[:, :32, :32] = 0
    g = torch.randn(x.shape, device=dev, generator=gen)
    outs = []
    for plain in (False, True):
        xg = x.detach().requires_grad_(True)
        with reference_kernels() if plain else torch.enable_grad():
            y = layer(xg)
            outs.append((y.detach(), *torch.autograd.grad(y, (xg, layer.init.h0, layer.init.linear.linear.weight), g)))
    torch.cuda.synchronize()
    rels = [compare(a, b)[1] for a, b in zip(*outs)]
    check(all(bool(torch.isfinite(t).all()) for t in outs[0]), "Deconv layer, zero quarter: non-finite source or gradient")
    print("[K3 dw] Deconv layer (2,64^3,64) float32, a quarter of the input zero, kernels vs plain versions: max_rel "
          + " ".join(f"{n}={r:.2e}" for n, r in zip(("s", "dx", "dh0", "dlinear"), rels)) + f" (tol {DECONV_RTOL:.1e})")
    check(max(rels) <= DECONV_RTOL, f"Deconv layer, zero quarter: differs from the plain versions: {rels}")
    del layer, x, g, outs, xg, y
    gc.collect()
    torch.cuda.empty_cache()

    # 11. the Deconver serving slice: three depthwise convolutions in each of nine blocks.
    k3_per_forward = 3 * n_blocks
    serve_slice("slice deconver", deconver_brats23_network, {"depthwise_conv": k3_per_forward})

    # 12. the FIVES forward at full width: batch 16 x 3 x 512^2, kernel 7x7 (its serving loop and train step
    # at full width are not driven here).
    fives = deconver_fives_network(generator=torch.Generator().manual_seed(0)).eval()
    images = torch.randn(16, 3, 512, 512, device=dev, generator=gen.manual_seed(21))
    forward_slice("slice fives", fives, images, {"depthwise_conv": k3_per_forward}, (16, 1, 512, 512),
                  "deconver_fives_network(), 16 images")
    del fives, images
    gc.collect()
    torch.cuda.empty_cache()

    # 13. the Deconver training slice: each depthwise convolution's backward is the forward kernel on flipped
    # taps (dx) and the dw kernel, since the input, the source and the taps (through h0) all carry gradients.
    torch.backends.cudnn.benchmark = True
    train_slice(
        "train deconver", deconver_brats23_network,
        {"depthwise_conv": 2 * k3_per_forward, "depthwise_conv_dw": k3_per_forward},
        {"stem.weight": "stem", "encoder.blocks.0.block.blocks.0.dcm.deconv.init.h0": "enc0.h0",
         "encoder.blocks.4.block.blocks.0.dcm.out_proj.linear.weight": "bottleneck.out_proj"},
    )

    # 14. K4 against its plain version.  No single library call computes it: the plain version is a chain of
    # batched products and elementwise passes.
    torch.backends.cudnn.benchmark = False
    k4_cases = [((n, 8, 512), 1, "hals", dt, False) for n in FLAT_STAGES for dt in (torch.float32, torch.bfloat16)]
    k4_cases += [
        ((524288, 8, 64), 1, "hals", torch.float32, False),   # the 2-D model's stage 0: 2 shifts x 16 x 4 heads x 64^2 windows
        ((32768, 8, 64), 1, "hals", torch.float32, False),    # its stage 2
        ((32768, 8, 512), 1, "mu", torch.float32, False),
        ((32768, 8, 512), 2, "hals", torch.float32, False),
        ((32768, 8, 512), 3, "hals", torch.float32, False),
        ((32768, 8, 512), 4, "hals", torch.float32, False),
        ((32768, 8, 512), 2, "mu", torch.float32, False),
        ((131072, 8, 512), 2, "hals", torch.float32, False),  # stage 0 of brats23_network(rank=2)
        ((1000, 5, 37), 3, "hals", torch.float32, False),     # no size a multiple of anything
        ((2048, 8, 4096), 1, "hals", torch.float32, False),   # patches of 16^3: fits the forward kernel alone
        ((32768, 8, 512), 1, "hals", torch.float32, True),    # a quarter of the matrices all zero
    ]

    def k4_inputs(shape, rank, dt, zero_quarter, positive=False):
        if positive:
            x = torch.rand(shape, device=dev, generator=gen.manual_seed(sum(shape) + rank)) + 0.05
        else:
            x = torch.relu(torch.randn(shape, device=dev, generator=gen.manual_seed(sum(shape) + rank)))
        if zero_quarter:
            x[: shape[0] // 4] = 0
        g = torch.randn(shape, device=dev, generator=gen)
        return (x.to(dt), g.to(dt), torch.rand(shape[-2], rank, device=dev, generator=gen),
                torch.rand(shape[-1], rank, device=dev, generator=gen))

    def k4_label(shape, rank, solver, dt, zero_quarter) -> str:
        return f"({','.join(map(str, shape))}) rank {rank} {solver} {dname(dt)}" + (" zero quarter" if zero_quarter else "")

    with torch.inference_mode():
        for shape, rank, solver, dt, zero_quarter in k4_cases:
            x, _, tu, tv = k4_inputs(shape, rank, dt, zero_quarter)
            args = (x, tu, tv, solver, NUM_ITERS)
            out, ref = nmf_reconstruct(*args), nmf_reconstruct_plain(*args)
            torch.cuda.synchronize()
            err, rel = compare(out, ref)
            tol = KERNEL_RTOL[dname(dt)] if rank == 1 else K4_RANK_RTOL
            label = k4_label(shape, rank, solver, dt, zero_quarter)
            check(out.dtype == dt and out.shape == x.shape, f"K4 {label}: wrong output")
            check(bool(torch.isfinite(out).all()), f"K4 {label}: non-finite output")
            check(rel <= tol, f"K4 {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
            ms = cuda_time_ms(lambda: nmf_reconstruct(*args))
            plain_ms = cuda_time_ms(lambda: nmf_reconstruct_plain(*args), warmup=1, runs=5)
            n_bytes, flops = k4_work(x, rank, backward=False)
            bound = bound_ms(n_bytes, flops, dt)
            print(f"[K4] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
                  f"library none bound {bound[0]:.3f} ms ({bound[1]}; {n_bytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP)")
            record("nmf_reconstruct", err, label, ms, plain_ms, bound)
            del x, out, ref, args
            torch.cuda.empty_cache()

    # 15. K4 backward, rank 1, against autograd through the plain version.  MU runs on a strictly positive
    # input, as K1's backward does (its gradient at all-zero rows keeps no digit in f32 on either side).
    k4_bwd_cases = [((n, 8, 512), "hals", dt, None, False) for n in FLAT_STAGES for dt in (torch.float32, torch.bfloat16)]
    k4_bwd_cases += [
        ((524288, 8, 64), "hals", torch.float32, None, False),
        ((32768, 8, 64), "hals", torch.float32, None, False),
        ((32768, 8, 512), "mu", torch.float32, None, False),
        ((32768, 8, 512), "hals", torch.float32, 2, False),
        ((1000, 5, 37), "hals", torch.float32, None, False),
        ((32768, 8, 512), "hals", torch.float32, None, True),
    ]
    for shape, solver, dt, grad_steps, zero_quarter in k4_bwd_cases:
        x, g, tu, tv = k4_inputs(shape, 1, dt, zero_quarter, positive=solver == "mu")
        args = (x, g, tu, tv, solver, NUM_ITERS, 1e-16, grad_steps)
        out, ref = nmf_reconstruct_backward(*args), nmf_reconstruct_backward_plain(*args)
        torch.cuda.synchronize()
        err, rel = compare(out, ref)
        tol = K1_BWD_RTOL[dname(dt)]
        label = (k4_label(shape, 1, solver, dt, zero_quarter) + (f" num_grad_steps={grad_steps}" if grad_steps is not None else "")
                 + (" positive x" if solver == "mu" else ""))
        check(out.dtype == dt and out.shape == x.shape, f"K4 bwd {label}: wrong output")
        check(bool(torch.isfinite(out).all()), f"K4 bwd {label}: non-finite dx")
        check(rel <= tol, f"K4 bwd {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
        del out, ref
        ms = cuda_time_ms(lambda: nmf_reconstruct_backward(*args))
        plain_ms = cuda_time_ms(lambda: nmf_reconstruct_backward_plain(*args), warmup=1, runs=3)
        bound = bound_ms(*k4_work(x, 1, True, grad_steps or NUM_ITERS, solver == "mu"), dt)
        print(f"[K4 bwd] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}) "
              f"kernel {ms:.3f} ms plain forward+backward {plain_ms:.3f} ms library none bound {bound[0]:.3f} ms ({bound[1]})")
        record("nmf_reconstruct_bwd", err, label, ms, plain_ms, bound)
        del x, g, args
        torch.cuda.empty_cache()

    # Through the autograd function: rank 1 launches the backward kernel, rank 2 reruns the solve in torch
    # operations and differentiates that (counted in .recomputes, never in .launches); num_grad_steps=0 is zero.
    for rank in (1, 2):
        x, g, tu, tv = k4_inputs((32768, 8, 512), rank, torch.float32, False)
        xg = x.requires_grad_(True)
        before = nmf_reconstruct.launches, nmf_reconstruct_backward.launches, nmf_reconstruct_backward.recomputes
        (dx,) = torch.autograd.grad(nmf_reconstruct(xg, tu, tv), xg, g)
        made = (nmf_reconstruct.launches - before[0], nmf_reconstruct_backward.launches - before[1],
                nmf_reconstruct_backward.recomputes - before[2])
        check(made == ((1, 1, 0) if rank == 1 else (1, 0, 1)), f"K4 bwd rank {rank}: the autograd function made {made}")
        (dx_ref,) = torch.autograd.grad(nmf_reconstruct_plain(xg, tu, tv), xg, g)
        torch.cuda.synchronize()
        err, rel = compare(dx, dx_ref)
        check(rel <= K1_BWD_RTOL["float32"], f"K4 bwd rank {rank}: autograd dx max_rel {rel:.3e}")
        (zero,) = torch.autograd.grad(nmf_reconstruct(xg, tu, tv, "hals", NUM_ITERS, 1e-16, 0), xg, g)
        check(not bool(zero.any()), f"K4 bwd rank {rank}: num_grad_steps=0 gave a non-zero gradient")
        ms = cuda_time_ms(lambda: torch.autograd.grad(nmf_reconstruct(xg, tu, tv), xg, g), warmup=1, runs=5)
        how = "kernel" if rank == 1 else "recompute in torch operations"
        print(f"[K4 bwd] (32768,8,512) rank {rank} hals float32 through the autograd function ({how}): dx max_abs={err:.3e} "
              f"max_rel={rel:.3e} (tol {K1_BWD_RTOL['float32']:.1e}), forward+backward {ms:.3f} ms, num_grad_steps=0 exactly zero")
        del x, g, xg, dx, dx_ref, zero
        torch.cuda.empty_cache()

    # What must raise on the card instead of giving way to a plain version: a dtype the kernels do not read
    # (through the module, whose route never looks at the dtype), and a gradient at a rank-1 size that only the
    # forward kernel can hold.  Under no_grad that size is served through K4; when a gradient is recorded the
    # module takes its decompose chain, and the wrapper itself refuses.
    before = read_counts()
    layer = MatrixFactorization((8, 512), rank=1, init_method="uniform", solver="hals", device=dev)
    for dt in (torch.float16, torch.float64):
        try:
            layer(torch.rand(64, 8, 512, device=dev).to(dt))
        except TypeError as e:
            print(f"[K4] MatrixFactorization on a {dname(dt)} CUDA tensor raises: {e}")
        else:
            check(False, f"K4: a {dname(dt)} CUDA tensor did not raise")
    big = MatrixFactorization((8, 4096), rank=1, init_method="uniform", solver="hals", device=dev)
    xb = torch.rand(64, 8, 4096, device=dev)
    with torch.no_grad():
        served = big(xb)
    check(nmf_reconstruct.launches == before["nmf_reconstruct"] + 1, "K4: an (8,4096) batch was not served through the kernel")
    try:
        nmf_reconstruct_backward(xb, torch.ones_like(xb), big.init.u0, big.init.v0)
    except ValueError as e:
        print(f"[K4 bwd] (64,8,4096) rank 1 raises: {e}")
    else:
        check(False, "K4 bwd: a size the backward kernel cannot hold did not raise")
    xg = xb.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(big(xg), xg, torch.ones_like(xb))
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in read_counts().items() if v != before[k]}
    check(made == {"nmf_reconstruct": 1}, f"K4: the (8,4096) checks launched {made}")
    err, rel = compare(big(xg).detach(), served)
    check(rel <= KERNEL_RTOL["float32"] and bool(torch.isfinite(dx).all()), f"K4: the decompose chain at (8,4096) differs from the kernel by {rel:.3e}")
    print(f"[K4] (64,8,4096) rank 1: served through the kernel; with a gradient recorded the module takes its decompose chain "
          f"(no launch), output max_rel={rel:.2e} from the kernel's (tol {KERNEL_RTOL['float32']:.1e})")
    del layer, big, xb, xg, dx, served
    torch.cuda.empty_cache()

    # 16. the flat-route serving slices.
    def brats23_flat_network(**kw):
        return brats23_network(factorize_options={"use_windowed": False}, **kw)

    k4_forward = {"nmf_reconstruct": n_blocks, "prenorm_mlp": n_blocks}
    serve_slice("slice flat", brats23_flat_network, k4_forward, same_function_as=brats23_network)

    # A 2-D Swin-Factorizer at the FIVES data shape (RGB in, one mask out, 512^2, batch 16) and the 3-D bundles'
    # widths: 2-D mixers take the flat route, two shifts (0 and half a patch).
    def swin2d_network(**kw):
        kw.setdefault("device", dev)  # the class builds where it is told; only the bundles' factories default to the card
        return Factorizer(
            in_channels=3, out_channels=1, spatial_size=(512, 512), encoder_depth=(1, 1, 1, 1, 1),
            encoder_width=(32, 64, 128, 256, 512), strides=(1, 2, 2, 2, 2), decoder_depth=(1, 1, 1, 1), mlp_ratio=4,
            reshape=(SWMatricize, {"head_dim": 8, "patch_size": 8}), act="relu", rank=1, num_iters=NUM_ITERS,
            init_method="uniform", solver="hals", **kw,
        )

    swin2d = swin2d_network(device=dev, generator=torch.Generator().manual_seed(0)).eval()
    images = torch.randn(16, 3, 512, 512, device=dev, generator=gen.manual_seed(31))
    forward_slice("slice 2d", swin2d, images, k4_forward, (16, 1, 512, 512), "a 2-D Swin-Factorizer, 16 images")
    del swin2d, images

    def brats23_rank2_network(**kw):
        return brats23_network(rank=2, **kw)

    rank2 = brats23_rank2_network(generator=torch.Generator().manual_seed(0)).eval()
    windows = torch.randn(2, 4, 128, 128, 128, device=dev, generator=gen.manual_seed(32))
    forward_slice("slice rank2", rank2, windows, k4_forward, (2, 3, 128, 128, 128), "brats23_network(rank=2), a window pair")
    del rank2, windows
    gc.collect()
    torch.cuda.empty_cache()

    f32_only = ("float32",)
    serve_slice("slice isles", factorizer_isles22_network, {**k1_forward, "prenorm_mlp": n_blocks},
                dtypes=f32_only, **isles)
    serve_slice("slice isles deconver", deconver_isles22_network, {"depthwise_conv": k3_per_forward}, dtypes=f32_only, **isles)

    # 17. the flat-route training slices.
    torch.backends.cudnn.benchmark = True
    factorizer_leaves = {"stem.weight": "stem", "encoder.blocks.0.block.blocks.0.mlp.block.0.linear.weight": "enc0.fc1",
                         "encoder.blocks.4.block.blocks.0.fact.out_proj.linear.weight": "bottleneck.out_proj"}
    train_slice(
        "train flat", brats23_flat_network,
        {"nmf_reconstruct": n_blocks, "nmf_reconstruct_bwd": n_blocks, "prenorm_mlp": n_blocks, "prenorm_mlp_bwd": n_blocks},
        factorizer_leaves,
    )
    # A 2-D step: every mixer's matrices are 8 x 64, which the backward kernel takes in its 64-thread instance.
    images = torch.randn(16, 3, 512, 512, device=dev, generator=gen.manual_seed(33))
    field = F.interpolate(torch.randn(16, 1, 8, 8, device=dev, generator=gen), size=(512, 512), mode="bilinear", align_corners=False)
    train_slice(
        "train 2d", swin2d_network,
        {"nmf_reconstruct": n_blocks, "nmf_reconstruct_bwd": n_blocks, "prenorm_mlp": n_blocks, "prenorm_mlp_bwd": n_blocks},
        factorizer_leaves, batch={"image": images, "label": (field > 0.3).float()}, dtypes=(torch.float32,),
    )
    del images, field
    # A rank-2 step: K4 forward, and its backward as the recompute in torch operations, counted but no launch.
    train_slice(
        "train rank2", brats23_rank2_network, {"nmf_reconstruct": n_blocks, "prenorm_mlp": n_blocks, "prenorm_mlp_bwd": n_blocks},
        factorizer_leaves, dtypes=(torch.float32,), recomputes_per_step=n_blocks,
    )
    isles_batch = synthetic_batch(8, 2, 1, 64, seed=9)
    print(f"[train isles] batch 8 x 64^3, label foreground share {isles_batch['label'].mean().item():.4f}")
    train_slice(
        "train isles", factorizer_isles22_network,
        {**k1_forward, "windowed_nmf_bwd": n_blocks * n_shifts, "prenorm_mlp": n_blocks, "prenorm_mlp_bwd": n_blocks},
        factorizer_leaves, batch=isles_batch, dtypes=(torch.float32,),
    )

    # 18. K5 in one process: every slab of a ring held as a list, the halos wired by hand.  The plain version is
    # the whole ring in torch operations; K1 on the gathered volume is the second reference, bit for bit: the slab
    # kernel runs K1's block, the routed rows are f32 and the passes sum in K1's order.
    torch.backends.cudnn.benchmark = False
    s1_first, s1_none = ((2, 3, 1), None, 6), ((0, 2, 4), (0, 6, 2))
    k5_cases = [(2, 128, 32, 8, dt, "hals", four, n, None) for dt in (torch.float32, torch.bfloat16) for n in (4, 2)]
    k5_cases += [
        (2, 64, 64, 8, torch.float32, "hals", four, 4, None),
        (2, 32, 128, 8, torch.float32, "hals", four, 4, None),
        (8, 64, 32, 4, torch.float32, "hals", isles_shifts, 4, None),  # factorizer_isles22: the run-time-size instance
        (2, 32, 128, 8, torch.float32, "mu", four, 4, None),
        (2, 32, 128, 8, torch.float32, "hals", s1_first, 4, None),     # the first pass already routes rows
        (2, 32, 128, 8, torch.float32, "hals", s1_none, 4, None),      # dims 2 and 3 alone: no byte leaves a slab
        (2, 32, 128, 8, torch.float32, "hals", four, 1, None),         # a ring of one
        (2, 32, 128, 8, torch.float32, "hals", four, 4, 2),            # num_grad_steps: the backward alone differs
    ]
    k5 = windowed_nmf_multi_spatial

    def k5_inputs(b, s, c, p, dt, solver, n):
        x = torch.relu(torch.randn(b, s, s, s, c, device=dev, generator=gen.manual_seed(s + c + n)))
        if solver == "mu":  # strictly positive, as K1's backward check
            x = torch.rand(b, s, s, s, c, device=dev, generator=gen) + 0.05
        x = x.to(dt)
        g = torch.randn(x.shape, device=dev, generator=gen).to(dt)
        return x, g, [t.contiguous() for t in x.chunk(n, 1)], [t.contiguous() for t in g.chunk(n, 1)]

    def k5_label(b, s, c, p, dt, solver, shifts, n, grad_steps) -> str:
        return (f"({b},{s}^3,{c}){'' if p == 8 else f' p={p}'} {dname(dt)} {solver} shifts={list(shifts)} as {n} slab(s) of "
                f"{s // n} rows" + (f" num_grad_steps={grad_steps}" if grad_steps is not None else ""))

    def rows_moved(shifts, p) -> list:
        """Per shift that moves rows between slabs, how many: its first component modulo the patch, where not 0."""
        firsts = [0 if sh is None else (sh if isinstance(sh, int) else sh[0]) % p for sh in shifts]
        return [s1 for s1 in firsts if s1]

    def k5_work(x, shifts, p, backward, grad_steps=NUM_ITERS, mu=False):
        """K1's work on the whole volume, and per row that moves: the halo read (x's dtype; the backward reads
        two), the routed row written in f32 and read again by the neighbour."""
        n_bytes, flops = k1_work(x, len(shifts), backward, grad_steps, mu)
        row_elems = x.numel() // x.shape[1]
        return n_bytes + sum(rows_moved(shifts, p)) * row_elems * ((2 if backward else 1) * x.element_size() + 8), flops

    with torch.inference_mode():
        for case in (c for c in k5_cases if c[-1] is None):
            b, s, c, p, dt, solver, shifts, n, _ = case
            x, _, xs, _ = k5_inputs(b, s, c, p, dt, solver, n)
            args = (u0, v0[p], 8, p, shifts, solver, NUM_ITERS)
            before = (k5.launches, k5.tail_launches, k5.bytes_sent)
            out = torch.cat(windowed_nmf_multi_spatial_local(xs, *args), 1)
            made = (k5.launches - before[0], k5.tail_launches - before[1], k5.bytes_sent - before[2])
            ref = torch.cat(windowed_nmf_multi_spatial_plain(xs, *args), 1)
            whole = windowed_nmf(x, *args)
            torch.cuda.synchronize()
            err, rel = compare(out, ref)
            tol = KERNEL_RTOL[dname(dt)]
            label = k5_label(*case)
            moving = rows_moved(shifts, p)
            sent = n * sum(moving) * (x.numel() // x.shape[1]) * (x.element_size() + 4)
            check(out.dtype == dt and out.shape == x.shape, f"K5 {label}: wrong output")
            check(rel <= tol, f"K5 {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
            check(torch.equal(out, whole), f"K5 {label}: differs from K1 on the whole volume by {compare(out, whole)[0]:.3e}")
            check(made == (n * len(shifts), n * len(moving), sent),
                  f"K5 {label}: launches, tail launches, bytes sent {made}, expected {(n * len(shifts), n * len(moving), sent)}")
            ms = cuda_time_ms(lambda: windowed_nmf_multi_spatial_local(xs, *args))
            k1_ms = cuda_time_ms(lambda: windowed_nmf(x, *args))
            plain_ms = cuda_time_ms(lambda: windowed_nmf_multi_spatial_plain(xs, *args), warmup=1, runs=5)
            n_bytes, flops = k5_work(x, shifts, p, backward=False)
            bound = bound_ms(n_bytes, flops, dt, "float32")
            passes = n * len(shifts)
            per_shift = sent / n / max(len(moving), 1)
            print(f"[K5] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}), equal to K1 on the whole volume bit for bit; "
                  f"ring {ms:.3f} ms = {ms / passes:.4f} ms per slab pass (K1 {k1_ms:.3f} ms = {k1_ms / passes:.4f} per pass and slab's "
                  f"share) plain {plain_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]}; {bound[0] / passes:.4f} ms per slab pass); "
                  f"sent per slab {sent / n / 1e6:.2f} MB, {per_shift / 1e6:.2f} MB per moving shift "
                  f"(= {1e3 * per_shift / NVLINK_BYTES:.4f} ms at NVLink's published 450 GB/s each way, not measured)")
            record("windowed_nmf_slab", err, label, ms, plain_ms, bound)
            del x, xs, out, ref, whole
            torch.cuda.empty_cache()

    # A slab of rows that the patch does not divide raises, on the card as on the CPU.
    bad = [torch.rand(2, 20, 32, 32, 128, device=dev) for _ in range(2)]
    try:
        windowed_nmf_multi_spatial_local(bad, u0, v0[8], 8, 8, four)
    except ValueError as e:
        print(f"[K5] two slabs of 20 rows, patch 8, raise: {e}")
    else:
        check(False, "K5: a slab of rows that the patch does not divide did not raise")
    del bad

    # 19. K5 backward: autograd through the slab kernels against autograd through the plain version, and against
    # K1's backward kernel on the whole volume, bit for bit.
    for case in k5_cases:
        b, s, c, p, dt, solver, shifts, n, grad_steps = case
        x, g, xs, gs = k5_inputs(b, s, c, p, dt, solver, n)
        args = (u0, v0[p], 8, p, shifts, solver, NUM_ITERS, 1e-16, grad_steps)
        leaves = [t.requires_grad_(True) for t in xs]
        before = (k5.backward_launches, k5.tail_launches)
        out = torch.cat(torch.autograd.grad(windowed_nmf_multi_spatial_local(leaves, *args), leaves, gs), 1)
        moving = rows_moved(shifts, p)
        made = (k5.backward_launches - before[0], k5.tail_launches - before[1])
        check(made == (n * len(shifts), 2 * n * len(moving)), f"K5 bwd {k5_label(*case)}: launches {made}")
        ref = torch.cat(torch.autograd.grad(windowed_nmf_multi_spatial_plain(leaves, *args), leaves, gs), 1)
        whole = windowed_nmf_backward(x, g, *args)
        torch.cuda.synchronize()
        err, rel = compare(out, ref)
        tol = K1_BWD_RTOL[dname(dt)]
        label = k5_label(*case)
        check(out.dtype == dt and bool(torch.isfinite(out).all()), f"K5 bwd {label}: wrong or non-finite dx")
        check(rel <= tol, f"K5 bwd {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
        check(torch.equal(out, whole), f"K5 bwd {label}: differs from K1 bwd on the whole volume by {compare(out, whole)[0]:.3e}")
        del out, ref, whole
        ys = windowed_nmf_multi_spatial_local(leaves, *args)
        ms = cuda_time_ms(lambda: torch.autograd.grad(ys, leaves, gs, retain_graph=True))
        k1_ms = cuda_time_ms(lambda: windowed_nmf_backward(x, g, *args))

        def plain_forward_backward():
            torch.autograd.grad(windowed_nmf_multi_spatial_plain(leaves, *args), leaves, gs)

        plain_ms = cuda_time_ms(plain_forward_backward, warmup=1, runs=3)
        n_bytes, flops = k5_work(x, shifts, p, True, grad_steps or NUM_ITERS, solver == "mu")
        bound = bound_ms(n_bytes, flops, dt, "float32")
        passes = n * len(shifts)
        print(f"[K5 bwd] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}), equal to K1 bwd on the whole volume bit for "
              f"bit; ring {ms:.3f} ms = {ms / passes:.4f} ms per slab pass (K1 bwd {k1_ms:.3f} ms = {k1_ms / passes:.4f}) "
              f"plain forward+backward {plain_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]}; {bound[0] / passes:.4f} ms per slab pass)")
        record("windowed_nmf_slab_bwd", err, label, ms, plain_ms, bound)
        del x, g, xs, gs, leaves, ys, args
        torch.cuda.empty_cache()

    # 20., 21. the two multi-process slices, on this one card: gloo, device tensors staged through the host.
    spatial_launches = spatial_slice(2)
    torch.backends.cudnn.benchmark = True
    for k, v in train_dp_slice(2, settings, n_steps).items():
        train_launches[k] += v
    gc.collect()
    torch.cuda.empty_cache()

    sources = {
        "windowed_nmf_factors": ("factorizer_tpu_torch/csrc/windowed_nmf.cu",
                                 "factorizer_tpu/ops/pallas/windowed_nmf_kernel.py:379"),
        "windowed_nmf_reconstruct": ("factorizer_tpu_torch/csrc/windowed_nmf.cu",
                                     "factorizer_tpu/ops/pallas/windowed_nmf_kernel.py:379"),
        "windowed_nmf_bwd": ("factorizer_tpu_torch/csrc/windowed_nmf_bwd.cu",
                             "factorizer_tpu/ops/pallas/windowed_nmf_kernel.py:411"),
        "prenorm_mlp": ("factorizer_tpu_torch/csrc/mlp_block.cu", "factorizer_tpu/ops/pallas/mlp_block.py:183"),
        "prenorm_mlp_bwd": ("factorizer_tpu_torch/csrc/mlp_block_bwd.cu", "factorizer_tpu/ops/pallas/mlp_block.py:197"),
        "depthwise_conv": ("factorizer_tpu_torch/csrc/depthwise_conv.cu", "factorizer_tpu/ops/pallas/depthwise_packed.py:131"),
        "depthwise_conv_dw": ("factorizer_tpu_torch/csrc/depthwise_conv_dw.cu", "factorizer_tpu/ops/pallas/depthwise_packed.py:147"),
        "nmf_reconstruct": ("factorizer_tpu_torch/csrc/nmf.cu", "factorizer_tpu/ops/pallas/nmf_kernel.py:142"),
        "nmf_reconstruct_bwd": ("factorizer_tpu_torch/csrc/nmf_bwd.cu", "factorizer_tpu/ops/pallas/nmf_kernel.py:142"),
        "windowed_nmf_slab": ("factorizer_tpu_torch/csrc/windowed_nmf_slab.cu",
                              "factorizer_tpu/ops/pallas/windowed_sharded.py:112"),
        "windowed_nmf_slab_bwd": ("factorizer_tpu_torch/csrc/windowed_nmf_slab_bwd.cu",
                                  "factorizer_tpu/ops/pallas/windowed_sharded.py:90"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        label, ms, plain_ms, b_ms, b_by, library_ms = results[name]["times"]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": serve_launches[name] + train_launches[name] + spatial_launches[name],
                        "launches_serving": serve_launches[name], "launches_training": train_launches[name],
                        "launches_spatial": spatial_launches[name],
                        "max_abs_err": max(results[name]["errs"]),
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": library_ms, "timed_at": label})
    last_lines(kernels)


if __name__ == "__main__":
    main()
