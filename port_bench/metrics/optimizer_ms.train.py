"""Device ms a step in AdamW's fused kernels, from ``torch.profiler`` by kernel name."""

from port_bench.bench import groups, readings

UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "step_s"
LAYER = "training entry: train/trainer.py"


def read(run):
    return readings.per_unit_ms(run, (groups.OPTIMISER,)) if run.kind == "train" else None
