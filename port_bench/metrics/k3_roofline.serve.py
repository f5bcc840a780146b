"""K3's share of its roofline in a case: the bound of its work at the cell's shapes (``kernels/k3.py``) over its
device time in the traced cases (``torch.profiler``); an error where its launches differ from what the work assumes."""

from port_bench.bench import readings

UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "case_s"
LAYER = "K3: ops/kernels/depthwise_conv.py"
KERNEL = "k3"  # kernels/k3.py: its counters, device names and work


def read(run):
    return readings.roofline_share(run, KERNEL) if run.kind == "serve" else None
