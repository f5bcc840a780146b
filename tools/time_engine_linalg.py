"""Time the batched ``torch.linalg`` calls of the factorization engine at a mixer's batch of matrices on one card.

The engine's SVD-based paths (``randomized_svd``, ``SVD``, the ``svd`` / ``nndsvd`` inits) and its least-squares
solvers (``ls``, ``nnls``) call ``torch.linalg`` on every matrix of a mixer's folded batch.  At stage 0 of
``factorizer_brats23`` (batch 2, 128^3, 32 channels, head_dim 8, patches of 8^3, 4 shifts) a mixer factorizes
131072 matrices of 8 x 512 at rank 1, so the calls see these shapes:

* ``qr`` of ``(n, 8, 1)`` and ``(n, 512, 1)`` (the randomized range finder's orthonormalisations),
* ``svd`` of ``(n, 1, 512)`` (the small SVD of ``Qᵀ X``),
* ``pinv`` of ``(n, 8, 1)`` (``LeastSquares.update_v``) and ``solve`` of ``(n, 1, 1)`` (``LeastSquares.update_u``).

Each call is timed with CUDA events at a small batch first; it runs at the full batch only where that batch's time,
extrapolated linearly, stays under ``--limit`` seconds, else the extrapolation is printed and marked so.  Prints
one line per call and a JSON line.  Run:

    python3 tools/time_engine_linalg.py [--n 131072] [--limit 60]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=131072, help="matrices in the batch (stage 0 of factorizer_brats23)")
    parser.add_argument("--small", type=int, default=2048, help="the batch timed first")
    parser.add_argument("--limit", type=float, default=60.0, help="largest extrapolated seconds run at the full batch")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_engine_linalg: no CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    eps = torch.finfo(torch.float32).eps
    gen = torch.Generator(device=dev).manual_seed(0)

    def calls(n: int) -> dict:
        x = torch.rand(n, 8, 512, device=dev, generator=gen)
        y8 = torch.rand(n, 8, 1, device=dev, generator=gen)
        y512 = torch.rand(n, 512, 1, device=dev, generator=gen)
        b = torch.rand(n, 1, 512, device=dev, generator=gen)
        vv = torch.rand(n, 1, 1, device=dev, generator=gen) + 1
        a = torch.rand(n, 1, 8, device=dev, generator=gen)
        return {
            "qr (n,8,1)": lambda: torch.linalg.qr(y8),
            "qr (n,512,1)": lambda: torch.linalg.qr(y512),
            "svd (n,1,512)": lambda: torch.linalg.svd(b, full_matrices=False),
            "pinv (n,8,1) rtol=10*8*eps": lambda: torch.linalg.pinv(y8, rtol=10 * 8 * eps),
            "solve (n,1,1)x(n,1,8)": lambda: torch.linalg.solve(vv, a),
            "bmm x @ v (n,8,512)x(n,512,1) (for scale)": lambda: x @ y512,
        }

    def timed(fn, runs: int) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / runs / 1e3

    results = {}
    small = calls(args.small)
    full = calls(args.n)
    for name, fn in small.items():
        t0 = time.perf_counter()
        s_small = timed(fn, 3)
        estimate = s_small * args.n / args.small
        if estimate <= args.limit:
            s_full, how = timed(full[name], 1 if estimate > 1 else 5), "measured"
        else:
            s_full, how = estimate, "extrapolated"
        results[name] = {"n_small": args.small, "s_small": s_small, "n": args.n, "s": s_full, "how": how}
        print(f"[linalg] {name}: {s_small * 1e3:.3f} ms at n={args.small}; {s_full * 1e3:.3f} ms at n={args.n} ({how}); "
              f"wall {time.perf_counter() - t0:.1f} s ({smi})")
    print(json.dumps({"device": smi, "linalg": results}))


if __name__ == "__main__":
    main()
