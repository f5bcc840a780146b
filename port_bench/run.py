"""Run one cell of the benchmark of ``factorizer_tpu_torch`` once and print its result as the last line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the repository's root on a machine with the cell's cards.  The cell,
its configuration, traffic mix, limits and metrics are found by name from
``BENCHMARK.json`` (``port_bench/bench/spec.py``).  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each number
that decided ``correct`` beside its limit, which also end standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it prints no
result and exits with 2.  If the process holds JAX, Flax or the JAX package
``factorizer_tpu`` once the run is over, it names them on standard error,
prints no result and exits with 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Caches the libraries keep on disk, at fixed paths inside the checkout (the program's own kernels build into
# factorizer_tpu_torch/build/): PyTorch's runtime-compiled kernels and the CUDA driver's JIT cache.
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", str(ROOT / "port_bench" / ".cache" / "torch_kernels"))
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "port_bench" / ".cache" / "cuda"))
sys.path.insert(0, str(ROOT))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from port_bench.bench import cell as cells
    from port_bench.bench import program, spec

    bench_cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < bench_cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {bench_cell.chips} CUDA card(s), found {found}", file=sys.stderr)
        return 2
    build_s = program.load_kernels()
    if build_s is not None:
        print(f"run.py: built the program's kernels in {build_s:.1f} s", file=sys.stderr)
    result = cells.run_cell(bench_cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = cells.forbidden_modules()
    if found:
        print(f"run.py: the process holds {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
