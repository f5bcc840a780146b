"""K1's share of its roofline in a step: the bound of its work at the cell's shapes (``kernels/k1.py``) over its
device time in the traced steps (``torch.profiler``); an error where its launches differ from what the work assumes."""

from port_bench.bench import readings

UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "step_s"
LAYER = "K1: ops/kernels/windowed_nmf.py"
KERNEL = "k1"  # kernels/k1.py: its counters, device names and work


def read(run):
    return readings.roofline_share(run, KERNEL) if run.kind == "train" else None
