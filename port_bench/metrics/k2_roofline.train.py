"""K2's share of its roofline in a step: the bound of its work at the cell's shapes (``kernels/k2.py``) over its
device time in the traced steps (``torch.profiler``); an error where its launches differ from what the work assumes."""

from port_bench.bench import readings

UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "step_s"
LAYER = "K2: ops/kernels/mlp_block.py"
KERNEL = "k2"  # kernels/k2.py: its counters, device names and work


def read(run):
    return readings.roofline_share(run, KERNEL) if run.kind == "train" else None
