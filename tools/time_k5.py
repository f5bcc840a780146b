"""K5's forward and backward rings against K1 on the whole volume, on the card, for two trees in turns.

Times, at ``factorizer_brats23``'s stage 0 ``(2, 128^3, 32)`` f32 with its
shifts ``[None, 2, 4, 6]``, K5's ring held in one process
(``windowed_nmf_multi_spatial_local``) on 4 and on 2 slabs, forward and
backward (autograd through the ring), beside K1 and K1 bwd on the whole
volume, by CUDA events.  Each tree given runs in its own process (the
package's kernels build from that tree's sources), in the order given, so
``--trees parent change change parent`` compares two versions in one call.
Prints one line per tree and run; checks that K5 equals K1 bit for bit.

    python tools/time_k5.py                          # this tree
    python tools/time_k5.py --trees OLD . . OLD      # OLD: another checkout of the repository
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

SHIFTS = (None, 2, 4, 6)
SHAPE = (2, 128, 128, 128, 32)


def timed_ms(fn, warmup: int = 2, runs: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def measure() -> dict:
    """This tree's times (the package on ``sys.path`` first)."""
    import torch

    from factorizer_tpu_torch.ops.kernels import (
        build, windowed_nmf, windowed_nmf_backward, windowed_nmf_multi_spatial_local,
    )

    if not torch.cuda.is_available():
        raise SystemExit("time_k5: no CUDA device")
    build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    u0, v0 = torch.rand(8, 1, device=dev, generator=gen), torch.rand(512, 1, device=dev, generator=gen)
    x = torch.relu(torch.randn(SHAPE, device=dev, generator=gen))
    g = torch.randn(SHAPE, device=dev, generator=gen)
    args = (u0, v0, 8, 8, SHIFTS, "hals", 5)
    with torch.inference_mode():
        out = {"k1_ms": timed_ms(lambda: windowed_nmf(x, *args)),
               "k1_bwd_ms": timed_ms(lambda: windowed_nmf_backward(x, g, *args)),
               "k1": windowed_nmf(x, *args), "k1_dx": windowed_nmf_backward(x, g, *args)}
    result = {"k1_ms": out["k1_ms"], "k1_bwd_ms": out["k1_bwd_ms"], "device": torch.cuda.get_device_name(0)}
    for n in (4, 2):
        leaves = [t.contiguous().requires_grad_(True) for t in x.chunk(n, 1)]
        gs = [t.contiguous() for t in g.chunk(n, 1)]
        ys = windowed_nmf_multi_spatial_local(leaves, *args)
        dxs = torch.autograd.grad(ys, leaves, gs, retain_graph=True)
        equal = (torch.equal(torch.cat([y.detach() for y in ys], 1), out["k1"])
                 and torch.equal(torch.cat(dxs, 1), out["k1_dx"]))
        with torch.inference_mode():
            fwd = timed_ms(lambda: windowed_nmf_multi_spatial_local([t.detach() for t in leaves], *args))
        bwd = timed_ms(lambda: torch.autograd.grad(ys, leaves, gs, retain_graph=True))
        result[f"k5_{n}"] = {"fwd_ms": fwd, "bwd_ms": bwd, "equal_to_k1": equal}
        del leaves, ys, dxs
        torch.cuda.empty_cache()
    return result


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--trees", nargs="+", default=["."], help="checkouts of the repository, run in this order")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        print(json.dumps(measure()))
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    print(f"[time_k5] card: {card}", flush=True)
    for tree in args.trees:
        root = Path(tree).resolve()
        env = {**os.environ, "PYTHONPATH": str(root)}
        done = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child"], env=env, cwd=root,
                              capture_output=True, text=True, check=False)
        if done.returncode != 0:
            raise SystemExit(f"time_k5: {tree} failed ({done.returncode}):\n{done.stdout}\n{done.stderr}")
        r = json.loads(done.stdout.strip().splitlines()[-1])
        rings = "; ".join(f"{n} slabs fwd {r[f'k5_{n}']['fwd_ms']:.3f} ms bwd {r[f'k5_{n}']['bwd_ms']:.3f} ms"
                          f"{'' if r[f'k5_{n}']['equal_to_k1'] else ' NOT EQUAL TO K1'}" for n in (4, 2))
        print(f"[time_k5] {tree} ({r['device']}): K1 {r['k1_ms']:.3f} ms, K1 bwd {r['k1_bwd_ms']:.3f} ms; K5 {rings}",
              flush=True)


if __name__ == "__main__":
    main()
