"""Device idle ms a step that began while the program's ``train.forward`` span was the innermost one open on the
host (``bench/spans.py``): the gaps between the traced steps' device operations, by the phase the host was in."""

from port_bench.bench import spans

UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "step_s"
LAYER = "training entry: train/trainer.py"
SPANS = ("train.forward",)

spans.install()


def read(run):
    return spans.per_unit_ms(run, SPANS, "idle_s") if run.kind == "train" else None
