"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check and time its kernels, serve BraTS volumes.

Run from the repository root:

    python3 chip_smoke.py

Phases, one or more result lines each:
  1. environment: the card (name, power limit), torch / CUDA / nvcc versions; TF32 off.
  2. build: nvcc compiles csrc/*.cu for sm_90a into factorizer_tpu_torch/build/.
  3. K1 (windowed NMF) against its plain PyTorch version at the five stage shapes
     of a batch-2 128^3 forward, f32 and bf16, plus MU and a single zero shift.
  4. K2 (fused pre-norm MLP) against its plain version at the five block-tail shapes.
  5. the slice: the full-width factorizer_brats23 network (random weights from a
     seed) serves 3 synthetic BraTS-native (1, 4, 240, 240, 155) volumes through
     ensemble_predict, in f32 and in bf16; the launch counters show every mixer
     and every block tail on a kernel; the first request's logits are compared
     with the same call on the plain versions.
Then a JSON line per kernel, and as the last line {"ok": true, "device": {...}}.
Any failed check raises, so the exit code is non-zero and no result line is printed.
"""

from __future__ import annotations

import json
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
# Whole-network logits, kernels against plain versions: the per-layer
# differences above pass through 9 blocks and 9 convolutions.
SLICE_RTOL = {"float32": 1e-3, "bfloat16": 5e-2}

STAGES = [(128, 32), (64, 64), (32, 128), (16, 256), (8, 512)]  # (S, C) at batch 2, roi 128^3


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(1)

    # The port: imported only once a card is known to be there.
    from factorizer_tpu_torch.ops.kernels import build, prenorm_mlp, prenorm_mlp_plain
    from factorizer_tpu_torch.ops.kernels import reference_kernels, windowed_nmf, windowed_nmf_plain
    from factorizer_tpu_torch.train.sliding_window import sliding_window_inference
    from factorizer_tpu_torch.zoo_scripts import brats23_network, ensemble_predict

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

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
    for line in log.splitlines():
        if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            print(f"[build] {line.strip()}")

    results = {"windowed_nmf": {"errs": [], "times": None}, "prenorm_mlp": {"errs": [], "times": None}}
    gen = torch.Generator(device=dev)

    # 3. K1 against its plain version
    u0 = torch.rand(8, 1, device=dev, generator=gen.manual_seed(1))
    v0 = torch.rand(512, 1, device=dev, generator=gen)
    cases = [(s, c, dt, "hals", (None, 2, 4, 6)) for s, c in STAGES for dt in (torch.float32, torch.bfloat16)]
    cases += [(32, 128, torch.float32, "mu", (None, 2, 4, 6)), (32, 128, torch.float32, "hals", ((0, 0, 0),))]
    with torch.inference_mode():
        for s, c, dt, solver, shifts in cases:
            x = torch.relu(torch.randn(2, s, s, s, c, device=dev, generator=gen.manual_seed(s + c))).to(dt)
            args = (x, u0, v0, 8, 8, shifts, solver, 5)
            out, ref = windowed_nmf(*args), windowed_nmf_plain(*args)
            torch.cuda.synchronize()
            err, rel = compare(out, ref)
            tol = KERNEL_RTOL[dname(dt)]
            label = f"(2,{s}^3,{c}) {dname(dt)} {solver} shifts={len(shifts)}"
            check(out.dtype == dt and out.shape == x.shape, f"K1 {label}: wrong output")
            check(rel <= tol, f"K1 {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
            ms, plain_ms = cuda_time_ms(lambda: windowed_nmf(*args)), cuda_time_ms(lambda: windowed_nmf_plain(*args))
            print(f"[K1] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}) "
                  f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
            results["windowed_nmf"]["errs"].append(err)
            if results["windowed_nmf"]["times"] is None:
                results["windowed_nmf"]["times"] = (label, ms, plain_ms)
            del x, out, ref

    # 4. K2 against its plain version
    with torch.inference_mode():
        for s, c in STAGES:
            h = 4 * c
            gamma = 1 + 0.1 * torch.randn(c, device=dev, generator=gen.manual_seed(c))
            beta = 0.1 * torch.randn(c, device=dev, generator=gen)
            w1 = torch.randn(h, c, device=dev, generator=gen) / c**0.5
            b1 = 0.1 * torch.randn(h, device=dev, generator=gen)
            w2 = torch.randn(c, h, device=dev, generator=gen) / h**0.5
            b2 = 0.1 * torch.randn(c, device=dev, generator=gen)
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(2, s, s, s, c, device=dev, generator=gen).to(dt)
                args = (x, gamma, beta, w1, b1, w2, b2)
                out, ref = prenorm_mlp(*args), prenorm_mlp_plain(*args)
                torch.cuda.synchronize()
                err, rel = compare(out, ref)
                tol = KERNEL_RTOL[dname(dt)]
                label = f"(2,{s}^3,{c}) H={h} {dname(dt)}"
                check(out.dtype == dt and out.shape == x.shape, f"K2 {label}: wrong output")
                check(rel <= tol, f"K2 {label}: max_abs {err:.3e} max_rel {rel:.3e} above {tol:.1e}")
                ms, plain_ms = cuda_time_ms(lambda: prenorm_mlp(*args)), cuda_time_ms(lambda: prenorm_mlp_plain(*args))
                print(f"[K2] {label}: max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.1e}) "
                      f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
                results["prenorm_mlp"]["errs"].append(err)
                if results["prenorm_mlp"]["times"] is None:
                    results["prenorm_mlp"]["times"] = (label, ms, plain_ms)
                del x, out, ref

    # 5. the slice
    roi, sw_batch, overlap, n_requests = (128, 128, 128), 2, 0.5, 3
    n_windows = 3 * 3 * 2
    forwards = -(-n_windows // sw_batch)
    n_blocks, n_shifts = 9, 4
    volumes = [torch.randn(1, 4, 240, 240, 155, device=dev, generator=gen.manual_seed(100 + i)) for i in range(n_requests + 1)]
    models = {
        "float32": brats23_network(device=dev, generator=torch.Generator().manual_seed(0)).eval(),
        "bfloat16": brats23_network(dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(0)).eval(),
    }
    windowed_nmf.launches = prenorm_mlp.launches = 0
    for name, model in models.items():
        ensemble_predict([model], volumes[-1], roi, sw_batch, overlap)  # warm-up request
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        seconds = []
        for i in range(n_requests):
            k1, k2 = windowed_nmf.launches, prenorm_mlp.launches
            t0 = time.perf_counter()
            mask, probs = ensemble_predict([model], volumes[i], roi, sw_batch, overlap)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            check(tuple(mask.shape) == (1, 3, 240, 240, 155) and tuple(probs.shape) == tuple(mask.shape),
                  f"slice {name}: output shape {tuple(mask.shape)}")
            check(bool(torch.isfinite(probs).all()), f"slice {name}: non-finite probabilities")
            dk1, dk2 = windowed_nmf.launches - k1, prenorm_mlp.launches - k2
            check(dk1 == forwards * n_blocks * n_shifts and dk2 == forwards * n_blocks,
                  f"slice {name}: {dk1} K1 / {dk2} K2 launches for {forwards} forwards")
        mem = torch.cuda.max_memory_allocated(dev)
        mean_s = statistics.mean(seconds)
        print(f"[slice] {name}: {mean_s:.3f} s/volume (requests {', '.join(f'{s:.3f}' for s in seconds)} s), "
              f"{n_windows / mean_s:.2f} windows/s, peak memory {mem / 2**30:.2f} GiB, "
              f"foreground share {mask.float().mean().item():.4f}")
    launches = {"windowed_nmf": windowed_nmf.launches, "prenorm_mlp": prenorm_mlp.launches}
    check(all(n > 0 for n in launches.values()), f"a kernel of the path never launched: {launches}")

    with torch.inference_mode():
        for name, model in models.items():
            logits = sliding_window_inference(volumes[0], roi, model, sw_batch, overlap)
            with reference_kernels():
                ref = sliding_window_inference(volumes[0], roi, model, sw_batch, overlap)
            torch.cuda.synchronize()
            err, rel = compare(logits, ref)
            print(f"[slice] {name} logits vs plain versions: max_abs={err:.3e} max_rel={rel:.3e} "
                  f"(tol {SLICE_RTOL[name]:.1e})")
            check(bool(torch.isfinite(logits).all()), f"slice {name}: non-finite logits")
            check(rel <= SLICE_RTOL[name], f"slice {name}: logits differ from the plain versions by {rel:.3e}")

    sources = {
        "windowed_nmf": ("factorizer_tpu_torch/csrc/windowed_nmf.cu",
                         "factorizer_tpu/ops/pallas/windowed_nmf_kernel.py:379"),
        "prenorm_mlp": ("factorizer_tpu_torch/csrc/mlp_block.cu", "factorizer_tpu/ops/pallas/mlp_block.py:183"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        label, ms, plain_ms = results[name]["times"]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": max(results[name]["errs"]),
                        "ms": ms, "plain_ms": plain_ms, "timed_at": label})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
