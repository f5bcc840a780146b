"""The share of the traced cases' window in which no operation ran on the device (``torch.profiler``'s trace)."""

from port_bench.bench import readings

UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "case_s"
LAYER = "device"


def read(run):
    return readings.device_idle(run) if run.kind == "serve" else None
