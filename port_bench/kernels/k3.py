"""K3, the depthwise convolution of ``ops/kernels/depthwise_conv.py``: its launch counters, its device kernels' names
and the work of its launches in a unit, for the ``k3_roofline.*`` readers (``bench.readings.roofline_share``).

A source update of the deconvolution convolves three times (``x (*) h~``, ``s (*) h``, then ``(*) h~``); the
backward takes dx through the forward kernel and dw through its own.  Work: ``bench.work.k3_work``."""

import math

from port_bench.bench import readings
from port_bench.bench.work import bound_ms, k3_work

COUNTERS = {"depthwise_conv": "factorizer_tpu_torch.ops.kernels:depthwise_conv.launches",
            "depthwise_conv_dw": "factorizer_tpu_torch.ops.kernels:depthwise_conv_dw.launches"}
NAMES = r"depthwise_conv|sum_dw_partials"


def work(run, calls: int, backward: bool):
    """(least ms of the traced units' K3 work, launches it assumes)."""
    convs = 3 * run.net["num_iters"]
    taps = math.prod(run.net["kernel_size"])
    xs = readings.block_metas(run)
    fwd = sum(bound_ms(*k3_work(x, taps, False), x.dtype)[0] for x in xs) * convs
    bound, launches = fwd, {"depthwise_conv": convs * len(xs)}
    if backward:
        bound += fwd + sum(bound_ms(*k3_work(x, taps, True), x.dtype)[0] for x in xs) * convs
        launches = {"depthwise_conv": 2 * convs * len(xs), "depthwise_conv_dw": convs * len(xs)}
    return calls * bound, {k: calls * v for k, v in launches.items()}
