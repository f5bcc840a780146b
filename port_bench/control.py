"""Readings that set the limits of ``correct``: the program's, the control's and the faults', seed by seed.

    python3 port_bench/control.py --workload <cell> --seeds <n> [<n> ...] [--program] [--control] [--look]

Run from the repository's root on a machine with a CUDA card, at the cell's own sizes.  For each seed it prints
one JSON line, read in one process (set-up is paid once), from the runner of the cell's kind of traffic
(``kinds/<kind>.py``: ``readings``):

* ``--program``: the program's readings against the reference, as a run reads them (the lower readings);
* ``--control``: the reference put in the program's place at the configuration's ``precision.control``, one
  precision below the one it states, and the kind's planted faults (the upper readings).

Each set of readings is judged against the cell's limits file as a run judges it (``bench.check.judge``): the
line gives each set's numbers, each compared number beside its limit, and ``correct``.  A sound program reads
correct; the control and each fault have to read not correct.  ``--look`` prints the kind's ``look`` instead (the
train kind's: where the program and the reference part after the first step).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def judged(readings: dict, limits: dict) -> dict:
    """name -> {"numbers", "checks", "correct"} of each set of readings, judged as a run judges it."""
    from port_bench.bench import check

    out = {}
    for name, numbers in readings.items():
        ok, shown = check.judge(numbers, limits)
        out[name] = {"numbers": numbers, "checks": shown, "correct": ok}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--look", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from port_bench.bench import cell, program, spec

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    bench_cell = spec.load_cell(args.workload)
    dtype = cell.apply_precision(bench_cell.config["precision"])
    torch.backends.cudnn.benchmark = bool(bench_cell.traffic.get("cudnn_benchmark", False))
    program.load_kernels()
    kind = spec.load_kind(bench_cell.traffic["kind"])
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = cell.Context(seed, 0.0, False, device, t, dtype, spec.load_reference(bench_cell.config), {})
        if args.look:
            out = {"look": kind.look(bench_cell, ctx)}
        else:
            out = judged(kind.readings(bench_cell, ctx, args.program, args.control), bench_cell.limits)
        print(json.dumps({"workload": args.workload, "seed": seed, **out, "seconds": time.perf_counter() - t}), flush=True)
        cell.free_memory()
    return 0


if __name__ == "__main__":
    sys.exit(main())
