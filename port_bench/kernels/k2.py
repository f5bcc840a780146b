"""K2, the pre-norm MLP of ``ops/kernels/mlp_block.py``: its launch counters, its device kernels' names and the work
of its launches in a unit, for the ``k2_roofline.*`` readers (``bench.readings.roofline_share``).

One launch per block and direction.  Work: ``bench.work.k2_work`` at each block's shape and hidden width."""

from port_bench.bench import readings
from port_bench.bench.work import bound_ms, k2_work

COUNTERS = {"prenorm_mlp": "factorizer_tpu_torch.ops.kernels:prenorm_mlp.launches",
            "prenorm_mlp_bwd": "factorizer_tpu_torch.ops.kernels:prenorm_mlp_backward.launches"}
NAMES = r"prenorm_mlp|sum_partials|sum_shares|to_bf16"


def work(run, calls: int, backward: bool):
    """(least ms of the traced units' K2 work, launches it assumes)."""
    xs = readings.block_metas(run)
    ratio = run.net["mlp_ratio"]
    bound = 0.0
    for x in xs:
        hidden = int(ratio * x.shape[-1])
        for bwd in (False, True) if backward else (False,):
            n_bytes, flops, units = k2_work(x, hidden, bwd)
            bound += bound_ms(n_bytes, flops, x.dtype, units)[0]
    launches = {"prenorm_mlp": len(xs), **({"prenorm_mlp_bwd": len(xs)} if backward else {})}
    return calls * bound, {k: calls * v for k, v in launches.items()}
