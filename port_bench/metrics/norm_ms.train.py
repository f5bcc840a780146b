"""Device ms a step in the norms' kernels (LayerNorm forward and backward, InstanceNorm's statistics), from
``torch.profiler`` by kernel name."""

from port_bench.bench import groups, readings

UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "step_s"
LAYER = "network: models/ and the norms of layers/basic.py"


def read(run):
    return readings.per_unit_ms(run, groups.NORMS) if run.kind == "train" else None
