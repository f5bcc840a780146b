"""The share of the traced steps' window in which no operation ran on the device (``torch.profiler``'s trace)."""

from port_bench.bench import readings

UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "step_s"
LAYER = "device"


def read(run):
    return readings.device_idle(run) if run.kind == "train" else None
