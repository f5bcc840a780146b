"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check and time its kernels, serve and train the bundles.

Run from the repository root:

    python3 chip_smoke.py

Phases, one or more result lines each:
  1. environment: the card (name, power limit), torch / CUDA / nvcc versions; TF32 off.
  2. build: one nvcc per csrc/*.cu for sm_90a, started together, into factorizer_tpu_torch/build/.
  3. K1 (windowed NMF) against its plain PyTorch version at the five stage shapes
     of a batch-2 128^3 forward, f32 and bf16, plus MU and a single zero shift.
  4. K2 (fused pre-norm MLP) against its plain version at the five block-tail shapes.
  5. the serving slice: the full-width factorizer_brats23 network (random weights
     from a seed) serves 2 synthetic BraTS-native (1, 4, 240, 240, 155) volumes
     through ensemble_predict, in f32 and in bf16; the launch counters show every
     mixer and every block tail on a kernel; the first request's logits are
     compared with the same call on the plain versions.
  6. K1 backward against autograd through the plain version: the five stage shapes,
     f32 and bf16, plus MU, a single zero shift, num_grad_steps=2 and an input
     with whole windows set to zero.
  7. K2 backward (dx and the six parameter gradients) against autograd through the
     plain version at the five shapes, f32 and bf16.
  8. the training slice: brats23_network() -> create_train_state -> make_train_step
     takes 1 warm-up and 3 timed steps on a synthetic batch 2 x 128^3, in f32 and in
     bf16; the launch counters show 36 K1 forward, 36 K1 backward, 9 K2 forward and
     9 K2 backward launches per step; the first step's loss and gradients are
     compared with the same step on the plain versions.
  9. K3 (per-sample depthwise convolution) against its plain version, a grouped F.conv{2,3}d: the five
     stage shapes of a batch-2 128^3 Deconver forward (kernel 3^3), f32 and bf16, the FIVES shapes
     (16,512^2,32) and (16,128^2,128) with kernel 7^2, the non-cubic kernels (1,3,5) and (3,1,9), C = 48 and an input
     with a quarter all zero; beside the kernel's time the one library call that computes the same function.
 10. K3 dw (the weight gradient) against autograd through the plain version at the same shapes, twice
     on one input bit for bit, and dx and dw through the autograd function; then the Deconv layer,
     forward and backward, on an input with a quarter all zero, kernels against plain versions.
 11. the Deconver serving slice: deconver_brats23_network() serves 2 synthetic BraTS-native volumes, f32
     and bf16: 27 K3 launches per forward, none of K1 and K2 (the bundle's InstanceNorm tails are stock torch).
 12. the FIVES forward: deconver_fives_network() on (16, 3, 512, 512) f32, 27 K3 launches, logits against
     the plain versions.
 13. the Deconver training slice: 1 warm-up and 3 timed steps, f32 and bf16: 54 forward-kernel launches
     (27 forward, 27 dx) and 27 dw launches per step; the first step against the plain versions.
Then the card's line, a JSON line with every kernel, and as the last line
{"ok": true, "device": {...}}.  Any failed check raises, so the exit code is
non-zero and no result line is printed.
"""

from __future__ import annotations

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


def kernel_label(mangled: str) -> str:
    """``prenorm_mlp_bwd_kernel<f32,512,16,16,16>`` from the mangled name ptxas reports."""
    found = re.search(r"\d+((?:windowed_nmf|prenorm_mlp|sum_partials|depthwise_conv|sum_dw_partials)\w*?_kernel)(?:I(.+?)EEv)?", mangled)
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

STAGES = [(128, 32), (64, 64), (32, 128), (16, 256), (8, 512)]  # (S, C) at batch 2, roi 128^3
NUM_ITERS = 5

# Published peaks of one H100 SXM at 700 W: HBM bytes/s, f32 FLOP/s outside the
# tensor cores, dense bf16 FLOP/s in them.  A bound takes the peak of the
# activations' dtype.
PEAK_BYTES, PEAK_FLOPS = 3.35e12, {"float32": 67e12, "bfloat16": 989e12}


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple[float, str]:
    """The least time the card could take: each input read and output written once, or the operations at peak."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_FLOPS[dname(dtype)]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_work(x, n_shifts: int, backward: bool, grad_steps: int = NUM_ITERS, mu: bool = False) -> tuple[float, float]:
    """(bytes, flops) of K1 on ``x``.  Per element and shift the solve does two mat-vecs (4 flops) per
    iteration and the rank-1 product and the shift sum (2); the backward adds the seed's two mat-vecs (4)
    and, per differentiated iteration, two mat-vecs and two rank-1 updates of dX (8; MU recomputes one
    more mat-vec, 10).  Forward: x read, y written.  Backward: x and g read, dx written."""
    n = x.numel()
    flops = 4 * NUM_ITERS + 2
    if backward:
        flops += 4 + (10 if mu else 8) * grad_steps
    return (3 if backward else 2) * n * x.element_size(), float(n_shifts * n * flops)


def k2_work(x, hidden: int, backward: bool) -> tuple[float, float]:
    """(bytes, flops) of K2 on ``x (..., C)``: two products of 2 C H flops per token forward, five backward;
    x read and y written (backward: x and g read, dx written), the f32 parameters read (and their
    gradients written) once."""
    c = x.shape[-1]
    tokens = x.numel() // c
    n_params = 3 * c + hidden + 2 * c * hidden
    n_bytes = (3 if backward else 2) * x.numel() * x.element_size() + (2 if backward else 1) * 4 * n_params
    return n_bytes, float(tokens * (10 if backward else 4) * c * hidden)


def k3_work(x, taps: int, dw: bool) -> tuple[float, float]:
    """(bytes, flops) of K3 on ``x (B, *S, C)``: one multiply-add per tap and element.  Forward: x read, y
    written, the f32 taps read.  dw: x and g read, the f32 taps' gradient written."""
    n_taps = x.shape[0] * taps * x.shape[-1]
    return 2 * x.numel() * x.element_size() + 4 * n_taps, float(2 * taps * x.numel())


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(1)

    # The port: imported only once a card is known to be there.
    import torch.nn.functional as F

    from factorizer_tpu_torch.factorization.deconv import Deconv
    from factorizer_tpu_torch.ops.kernels import (
        build, depthwise_conv, depthwise_conv_dw, depthwise_conv_dw_plain, depthwise_conv_plain,
        prenorm_mlp, prenorm_mlp_backward, prenorm_mlp_backward_plain, prenorm_mlp_plain,
        reference_kernels, windowed_nmf, windowed_nmf_backward, windowed_nmf_backward_plain, windowed_nmf_plain,
    )
    from factorizer_tpu_torch.train.sliding_window import sliding_window_inference
    from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step
    from factorizer_tpu_torch.zoo_scripts import (
        brats23_network, brats23_optimizer_settings, deconver_brats23_network, deconver_fives_network, ensemble_predict,
    )

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    wrappers = {"windowed_nmf": windowed_nmf, "windowed_nmf_bwd": windowed_nmf_backward,
                "prenorm_mlp": prenorm_mlp, "prenorm_mlp_bwd": prenorm_mlp_backward,
                "depthwise_conv": depthwise_conv, "depthwise_conv_dw": depthwise_conv_dw}

    def reset_counts() -> None:
        for w in wrappers.values():
            w.launches = 0

    def read_counts() -> dict:
        return {name: w.launches for name, w in wrappers.items()}

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

    # Per kernel: the errors of every comparison, and the times at the first case, (2,128^3,32) f32.
    results = {name: {"errs": [], "times": None} for name in wrappers}

    def record(name: str, err: float, label: str, ms: float, plain_ms: float, bound: tuple[float, str],
               library_ms: float | None = None) -> None:
        results[name]["errs"].append(err)
        if results[name]["times"] is None:
            results[name]["times"] = (label, ms, plain_ms, *bound, library_ms)

    gen = torch.Generator(device=dev)
    four, zero_shift = (None, 2, 4, 6), ((0, 0, 0),)

    # 3. K1 against its plain version
    u0 = torch.rand(8, 1, device=dev, generator=gen.manual_seed(1))
    v0 = torch.rand(512, 1, device=dev, generator=gen)
    cases = [(s, c, dt, "hals", four) for s, c in STAGES for dt in (torch.float32, torch.bfloat16)]
    cases += [(32, 128, torch.float32, "mu", four), (32, 128, torch.float32, "hals", zero_shift)]
    with torch.inference_mode():
        for s, c, dt, solver, shifts in cases:
            x = torch.relu(torch.randn(2, s, s, s, c, device=dev, generator=gen.manual_seed(s + c))).to(dt)
            args = (x, u0, v0, 8, 8, shifts, solver, NUM_ITERS)
            out, ref = windowed_nmf(*args), windowed_nmf_plain(*args)
            torch.cuda.synchronize()
            err, rel = compare(out, ref)
            tol = KERNEL_RTOL[dname(dt)]
            label = f"(2,{s}^3,{c}) {dname(dt)} {solver} shifts={len(shifts)}"
            check(out.dtype == dt and out.shape == x.shape, f"K1 {label}: wrong output")
            check(rel <= tol, f"K1 {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
            ms = cuda_time_ms(lambda: windowed_nmf(*args))
            plain_ms = cuda_time_ms(lambda: windowed_nmf_plain(*args), warmup=1, runs=5)
            bound = bound_ms(*k1_work(x, len(shifts), backward=False), dt)
            print(f"[K1] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}) "
                  f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]})")
            record("windowed_nmf", err, label, ms, plain_ms, bound)
            del x, out, ref

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
                out, ref = prenorm_mlp(*args), prenorm_mlp_plain(*args)
                torch.cuda.synchronize()
                err, rel = compare(out, ref)
                tol = KERNEL_RTOL[dname(dt)]
                label = f"(2,{s}^3,{c}) H={4 * c} {dname(dt)}"
                check(out.dtype == dt and out.shape == x.shape, f"K2 {label}: wrong output")
                check(rel <= tol, f"K2 {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
                ms = cuda_time_ms(lambda: prenorm_mlp(*args))
                plain_ms = cuda_time_ms(lambda: prenorm_mlp_plain(*args), warmup=1, runs=5)
                bound = bound_ms(*k2_work(x, 4 * c, backward=False), dt)
                print(f"[K2] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}) "
                      f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]})")
                record("prenorm_mlp", err, label, ms, plain_ms, bound)
                del x, out, ref

    # 5. the serving slice
    roi, sw_batch, overlap, n_requests = (128, 128, 128), 2, 0.5, 2
    n_windows = 3 * 3 * 2
    forwards = -(-n_windows // sw_batch)
    n_blocks, n_shifts = 9, 4
    serve_launches = dict.fromkeys(wrappers, 0)

    def serve_slice(tag: str, network, per_forward: dict) -> None:
        """Serve ``n_requests`` synthetic BraTS-native volumes after a warm-up request, f32 and bf16; check the
        launches per request and the first request's logits against the plain versions."""
        expected = {name: forwards * per_forward.get(name, 0) for name in wrappers}
        volumes = [torch.randn(1, 4, 240, 240, 155, device=dev, generator=gen.manual_seed(100 + i)) for i in range(n_requests + 1)]
        models = {
            "float32": network(device=dev, generator=torch.Generator().manual_seed(0)).eval(),
            "bfloat16": network(dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(0)).eval(),
        }
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
                check(tuple(mask.shape) == (1, 3, 240, 240, 155) and tuple(probs.shape) == tuple(mask.shape),
                      f"{tag} {name}: output shape {tuple(mask.shape)}")
                check(bool(torch.isfinite(probs).all()), f"{tag} {name}: non-finite probabilities")
                made = {k: v - before[k] for k, v in read_counts().items()}
                check(made == expected, f"{tag} {name}: launches {made} for {forwards} forwards, expected {expected}")
            mem = torch.cuda.max_memory_allocated(dev)
            mean_s = statistics.mean(seconds)
            print(f"[{tag}] {name}: {mean_s:.3f} s/volume (requests {', '.join(f'{s:.3f}' for s in seconds)} s), "
                  f"{n_windows / mean_s:.2f} windows/s, peak memory {mem / 2**30:.2f} GiB, "
                  f"foreground share {mask.float().mean().item():.4f}, "
                  f"launches per request { {k: v for k, v in expected.items() if v} }")
        for k, v in read_counts().items():
            serve_launches[k] += v
            check(v > 0 or not per_forward.get(k), f"{tag}: kernel {k} of the serving path never launched")

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
        del models, volumes, mask, probs, logits, ref
        gc.collect()
        torch.cuda.empty_cache()

    serve_slice("slice", brats23_network, {"windowed_nmf": n_blocks * n_shifts, "prenorm_mlp": n_blocks})

    # 6. K1 backward against autograd through the plain version
    # MU runs on a strictly positive input: where a whole row of a window is zero its factor decays to
    # ~eps and 1 / (v b + eps) ~ 1e16 makes the gradient so ill-conditioned that f32 keeps no digit of it,
    # in the kernel and in the plain version alike.
    cases = [(s, c, dt, "hals", four, None, False) for s, c in STAGES for dt in (torch.float32, torch.bfloat16)]
    cases += [
        (32, 128, torch.float32, "mu", four, None, False),
        (32, 128, torch.float32, "hals", zero_shift, None, False),
        (32, 128, torch.float32, "hals", four, 2, False),
        (64, 64, torch.float32, "hals", four, None, True),  # a quarter of the volume all zero, as BraTS background
    ]
    for s, c, dt, solver, shifts, grad_steps, zero_windows in cases:
        x = torch.relu(torch.randn(2, s, s, s, c, device=dev, generator=gen.manual_seed(s + c)))
        if solver == "mu":
            x = torch.rand(2, s, s, s, c, device=dev, generator=gen) + 0.05
        if zero_windows:
            x[:, : s // 2, : s // 2] = 0
        x = x.to(dt)
        g = torch.randn(x.shape, device=dev, generator=gen).to(dt)
        args = (x, g, u0, v0, 8, 8, shifts, solver, NUM_ITERS, 1e-16, grad_steps)
        out, ref = windowed_nmf_backward(*args), windowed_nmf_backward_plain(*args)
        torch.cuda.synchronize()
        err, rel = compare(out, ref)
        tol = K1_BWD_RTOL[dname(dt)]
        label = (f"(2,{s}^3,{c}) {dname(dt)} {solver} shifts={len(shifts)}"
                 + (f" num_grad_steps={grad_steps}" if grad_steps is not None else "")
                 + (" zero windows" if zero_windows else "") + (" positive x" if solver == "mu" else ""))
        check(out.dtype == dt and out.shape == x.shape, f"K1 bwd {label}: wrong output")
        check(bool(torch.isfinite(out).all()), f"K1 bwd {label}: non-finite dx")
        check(rel <= tol, f"K1 bwd {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
        del out, ref
        ms = cuda_time_ms(lambda: windowed_nmf_backward(*args))
        plain_ms = cuda_time_ms(lambda: windowed_nmf_backward_plain(*args), warmup=1, runs=3)
        bound = bound_ms(*k1_work(x, len(shifts), True, grad_steps or NUM_ITERS, solver == "mu"), dt)
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
            outs, refs = prenorm_mlp_backward(*args), prenorm_mlp_backward_plain(*args)
            torch.cuda.synchronize()
            label = f"(2,{s}^3,{c}) H={4 * c} {dname(dt)}"
            rels = {}
            for name, out, ref in zip(grad_names, outs, refs):
                err, rels[name] = compare(out, ref)
                tol = KERNEL_RTOL[dname(dt)] if name == "dx" else K2_PARAM_RTOL
                check(out.dtype == ref.dtype and out.shape == ref.shape, f"K2 bwd {label}: wrong {name}")
                check(rels[name] <= tol, f"K2 bwd {label}: {name} max_abs {err:.3e} max_rel {rels[name]:.3e} above {tol:.1e}")
                if name == "dx":
                    dx_err = err
            del outs, refs
            ms = cuda_time_ms(lambda: prenorm_mlp_backward(*args))
            plain_ms = cuda_time_ms(lambda: prenorm_mlp_backward_plain(*args), warmup=1, runs=3)
            bound = bound_ms(*k2_work(x, 4 * c, backward=True), dt)
            print(f"[K2 bwd] {label}: dx max_abs={dx_err:.3e} max_rel={rels['dx']:.3e} (tol {KERNEL_RTOL[dname(dt)]:.1e}) "
                  f"params max_rel " + " ".join(f"{n}={rels[n]:.1e}" for n in grad_names[1:]) + f" (tol {K2_PARAM_RTOL:.1e}) "
                  f"kernel {ms:.3f} ms plain forward+backward {plain_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]})")
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
    image = torch.randn(2, 4, 128, 128, 128, device=dev, generator=gen.manual_seed(7))
    field = F.interpolate(torch.randn(2, 3, 8, 8, 8, device=dev, generator=gen), size=(128, 128, 128),
                          mode="trilinear", align_corners=False)
    batch = {"image": image, "label": (field > 0.3).float()}
    print(f"[train] label foreground share {batch['label'].mean().item():.4f}")
    train_launches = dict.fromkeys(wrappers, 0)
    n_steps = 4

    def train_slice(tag: str, network, launches_per_step: dict, leaves: dict) -> None:
        """1 warm-up and 3 timed steps on ``batch``, f32 and bf16: launches per step, a falling loss, and the
        first step's loss and gradients (the norm and the ``leaves``) against the same step on the plain versions."""
        per_step = {name: launches_per_step.get(name, 0) for name in wrappers}
        for dt in (torch.float32, torch.bfloat16):
            name = dname(dt)

            def new_state():
                # No device argument: the entry points' default, the card, is what runs.
                model = network(dtype=None if dt == torch.float32 else dt, generator=torch.Generator().manual_seed(0))
                check(next(model.parameters()).is_cuda, f"{network.__name__}() did not build on the card")
                return create_train_state(model, **settings)

            # The first step on the plain versions, from the same weights.
            state = new_state()
            torch.cuda.reset_peak_memory_stats(dev)
            with reference_kernels():
                _, metrics = make_train_step(state.model)(state, batch)
            torch.cuda.synchronize()
            ref_loss, ref_norm = metrics["loss"].item(), metrics["grad_norm"].item()
            ref_grads = {k: p.grad.clone() for k, p in state.model.named_parameters() if k in leaves}
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
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                counts = read_counts()
                check(counts == per_step, f"{tag} {name} step {i + 1}: launches {counts}, expected {per_step}")
                for k, v in counts.items():
                    train_launches[k] += v
                losses.append(metrics["loss"].item())
                grads = dict(state.model.named_parameters())
                bad = [k for k, p in grads.items() if p.grad is None or not bool(torch.isfinite(p.grad).all())]
                check(not bad, f"{tag} {name} step {i + 1}: no finite gradient for {bad[:5]}")
                if i == 0:
                    tol = TRAIN_RTOL[name]
                    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
                    norm_rel = abs(metrics["grad_norm"].item() - ref_norm) / ref_norm
                    leaf_rel = {short: compare(grads[k].grad, ref_grads[k])[1] for k, short in leaves.items()}
                    print(f"[{tag}] {name} step 1 vs plain versions: loss {losses[0]:.6f} / {ref_loss:.6f} (rel {loss_rel:.2e}, "
                          f"tol {tol['loss']:.0e}), grad norm rel {norm_rel:.2e}, leaves max_rel "
                          + " ".join(f"{k}={v:.2e}" for k, v in leaf_rel.items()) + f" (tol {tol['grad']:.0e}); "
                          f"plain-version step peak memory {ref_mem / 2**30:.2f} GiB")
                    check(loss_rel <= tol["loss"], f"{tag} {name}: loss differs from the plain versions by {loss_rel:.2e}")
                    check(norm_rel <= tol["grad"] and max(leaf_rel.values()) <= tol["grad"],
                          f"{tag} {name}: gradients differ from the plain versions: norm {norm_rel:.2e}, leaves {leaf_rel}")
            mem = torch.cuda.max_memory_allocated(dev)
            check(all(map(math.isfinite, losses)), f"{tag} {name}: non-finite loss {losses}")
            check(losses[-1] < losses[0], f"{tag} {name}: loss did not fall: {losses}")
            timed = seconds[1:]
            print(f"[{tag}] {name}: {statistics.mean(timed):.4f} s/step (steps {', '.join(f'{s:.4f}' for s in timed)} s after a "
                  f"{seconds[0]:.2f} s warm-up step), peak memory {mem / 2**30:.2f} GiB, loss {' -> '.join(f'{v:.6f}' for v in losses)}, "
                  f"launches per step { {k: v for k, v in per_step.items() if v} }")
            del state, step, metrics, grads, ref_grads
            gc.collect()
            torch.cuda.empty_cache()
        check(all(train_launches[k] > 0 for k, v in per_step.items() if v), f"{tag}: a kernel of the training path never launched: {train_launches}")

    train_slice(
        "train", brats23_network,
        {"windowed_nmf": n_blocks * n_shifts, "windowed_nmf_bwd": n_blocks * n_shifts, "prenorm_mlp": n_blocks, "prenorm_mlp_bwd": n_blocks},
        {"stem.weight": "stem", "encoder.blocks.0.block.blocks.0.mlp.block.0.linear.weight": "enc0.fc1",
         "encoder.blocks.4.block.blocks.0.fact.out_proj.linear.weight": "bottleneck.out_proj"},
    )

    # 9. K3 against its plain version, and beside it the one library call that computes the same function:
    # F.conv{2,3}d with groups = B * C on tensors already laid out as (1, B*C, *S), so that the call is timed
    # without the plain version's two layout transposes.  cuDNN's benchmark mode is off in this phase and the
    # two serving phases below, as in the Factorizer's; the first case times the library call under both modes.
    torch.backends.cudnn.benchmark = False
    k3 = (3, 3, 3)
    k3_cases = [((2, s, s, s, c), k3, dt, False) for s, c in STAGES for dt in (torch.float32, torch.bfloat16)]
    k3_cases += [
        ((16, 512, 512, 32), (7, 7), torch.float32, False),    # FIVES stage 0
        ((16, 128, 128, 128), (7, 7), torch.float32, False),   # FIVES stage 2
        ((2, 32, 32, 32, 128), (1, 3, 5), torch.float32, False),
        ((2, 32, 32, 32, 128), (3, 1, 9), torch.float32, False),  # k3 above 7: the one-output-per-thread kernels
        ((2, 64, 64, 64, 48), k3, torch.float32, False),       # a width the TPU's packed kernel refuses
        ((2, 64, 64, 64, 64), k3, torch.float32, True),        # a quarter of the volume all zero
    ]

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

    with torch.inference_mode():
        for i, (shape, ks, dt, zero_quarter) in enumerate(k3_cases):
            x, _, w = k3_inputs(shape, ks, dt, zero_quarter)
            out, ref = depthwise_conv(x, w, ks), depthwise_conv_plain(x, w, ks)
            torch.cuda.synchronize()
            err, rel = compare(out, ref)
            tol = KERNEL_RTOL[dname(dt)]
            label = k3_label(shape, ks, dt, zero_quarter)
            check(out.dtype == dt and out.shape == x.shape, f"K3 {label}: wrong output")
            check(rel <= tol, f"K3 {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
            ms = cuda_time_ms(lambda: depthwise_conv(x, w, ks))
            plain_ms = cuda_time_ms(lambda: depthwise_conv_plain(x, w, ks), warmup=1, runs=5)
            conv = F.conv2d if len(ks) == 2 else F.conv3d
            xc, wc, pad, groups = channels_first(x), library_weight(w, ks), tuple(k // 2 for k in ks), shape[0] * shape[-1]
            library_ms = cuda_time_ms(lambda: conv(xc, wc, None, 1, pad, 1, groups), warmup=1, runs=5)
            bound = bound_ms(*k3_work(x, math.prod(ks), dw=False), dt)
            line = (f"[K3] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}) kernel {ms:.3f} ms "
                    f"plain {plain_ms:.3f} ms library {library_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]})")
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
    for i, (shape, ks, dt, zero_quarter) in enumerate(k3_cases):
        x, g, w = k3_inputs(shape, ks, dt, zero_quarter)
        out, again, ref = depthwise_conv_dw(x, g, ks), depthwise_conv_dw(x, g, ks), depthwise_conv_dw_plain(x, g, ks)
        torch.cuda.synchronize()
        err, rel = compare(out, ref)
        label = k3_label(shape, ks, dt, zero_quarter)
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
        del out, again, ref, xg, wg, dx, dw, dx_ref, dw_ref
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
        line = (f"[K3 dw] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {K3_DW_RTOL:.1e}) bit-identical twice; autograd "
                f"dx max_rel={dx_rel:.3e} dw max_rel={dw_rel:.3e}; kernel {ms:.3f} ms plain forward+backward {plain_ms:.3f} ms "
                f"library {library_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]})")
        if i == 0:
            torch.backends.cudnn.benchmark = True
            tuned_ms = cuda_time_ms(library_dw, warmup=2, runs=3)
            torch.backends.cudnn.benchmark = False
            line += f" library with cudnn.benchmark {tuned_ms:.3f} ms"
        print(line)
        record("depthwise_conv_dw", err, label, ms, plain_ms, bound, library_ms)
        del x, g, w, xc, gc_, wc
        torch.cuda.empty_cache()

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
    check(next(fives.parameters()).is_cuda, "deconver_fives_network() did not build on the card")
    images = torch.randn(16, 3, 512, 512, device=dev, generator=gen.manual_seed(21))
    with torch.inference_mode():
        fives(images)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        logits = fives(images)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        fives_launches = read_counts()
        mem = torch.cuda.max_memory_allocated(dev)
        with reference_kernels():
            ref = fives(images)
        torch.cuda.synchronize()
    expected = {name: k3_per_forward if name == "depthwise_conv" else 0 for name in wrappers}
    check(fives_launches == expected, f"slice fives: launches {fives_launches}, expected {expected}")
    check(tuple(logits.shape) == (16, 1, 512, 512) and bool(torch.isfinite(logits).all()), "slice fives: wrong or non-finite logits")
    err, rel = compare(logits, ref)
    print(f"[slice fives] float32: {seconds:.4f} s per forward of (16, 3, 512, 512), {16 / seconds:.1f} images/s, peak memory "
          f"{mem / 2**30:.2f} GiB, launches {k3_per_forward} K3; logits vs plain versions: max_abs={err:.3e} max_rel={rel:.3e} "
          f"(tol {SLICE_RTOL['float32']:.1e})")
    check(rel <= SLICE_RTOL["float32"], f"slice fives: logits differ from the plain versions by {rel:.3e}")
    for k, v in fives_launches.items():
        serve_launches[k] += v
    del fives, images, logits, ref
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


    sources = {
        "windowed_nmf": ("factorizer_tpu_torch/csrc/windowed_nmf.cu",
                         "factorizer_tpu/ops/pallas/windowed_nmf_kernel.py:379"),
        "windowed_nmf_bwd": ("factorizer_tpu_torch/csrc/windowed_nmf_bwd.cu",
                             "factorizer_tpu/ops/pallas/windowed_nmf_kernel.py:411"),
        "prenorm_mlp": ("factorizer_tpu_torch/csrc/mlp_block.cu", "factorizer_tpu/ops/pallas/mlp_block.py:183"),
        "prenorm_mlp_bwd": ("factorizer_tpu_torch/csrc/mlp_block_bwd.cu", "factorizer_tpu/ops/pallas/mlp_block.py:197"),
        "depthwise_conv": ("factorizer_tpu_torch/csrc/depthwise_conv.cu", "factorizer_tpu/ops/pallas/depthwise_packed.py:131"),
        "depthwise_conv_dw": ("factorizer_tpu_torch/csrc/depthwise_conv_dw.cu", "factorizer_tpu/ops/pallas/depthwise_packed.py:147"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        label, ms, plain_ms, b_ms, b_by, library_ms = results[name]["times"]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": serve_launches[name] + train_launches[name],
                        "launches_serving": serve_launches[name], "launches_training": train_launches[name],
                        "max_abs_err": max(results[name]["errs"]),
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": library_ms, "timed_at": label})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
