"""K1, the shifted-window NMF of ``ops/kernels/windowed_nmf.py``: its launch counters, its device kernels' names and
the work of its launches in a unit, for the ``k1_roofline.*`` readers (``bench.readings.roofline_share``).

Per mixer and forward: one launch each of the factors' and the reconstruction's pass over all shifts; per mixer and
backward: one launch per shift.  Work: ``bench.work.k1_work`` at each block's shape."""

from port_bench.bench import readings
from port_bench.bench.work import bound_ms, k1_work

COUNTERS = {"windowed_nmf_factors": "factorizer_tpu_torch.ops.kernels:windowed_nmf_factors.launches",
            "windowed_nmf_reconstruct": "factorizer_tpu_torch.ops.kernels:windowed_nmf_reconstruct.launches",
            "windowed_nmf_bwd": "factorizer_tpu_torch.ops.kernels:windowed_nmf_backward.launches"}
# windowed_nmf_shift: the forward's kernel where it launched once per shift, so that an older tree reads alike
NAMES = r"windowed_nmf_(factors|reconstruct|shift)"


def work(run, calls: int, backward: bool):
    """(least ms of the traced units' K1 work, launches it assumes)."""
    shifts = len(run.net["reshape"][1]["shifts"])
    xs = readings.block_metas(run)
    bound = sum(bound_ms(*k1_work(x, shifts, False), x.dtype)[0] for x in xs)
    launches = {"windowed_nmf_factors": len(xs), "windowed_nmf_reconstruct": len(xs)}
    if backward:
        bound += sum(bound_ms(*k1_work(x, shifts, True), x.dtype)[0] for x in xs)
        launches["windowed_nmf_bwd"] = shifts * len(xs)
    return calls * bound, {k: calls * v for k, v in launches.items()}
