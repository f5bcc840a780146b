"""Device ms a step launched inside the program's ``train.backward`` spans (one a micro-batch): each kernel, copy and
set of the traced steps by the span open on the host when its launch ran (``bench/spans.py``)."""

from port_bench.bench import spans

UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "step_s"
LAYER = "training entry: train/trainer.py"
SPANS = ("train.backward",)

spans.install()


def read(run):
    return spans.per_unit_ms(run, SPANS, "device_s") if run.kind == "train" else None
