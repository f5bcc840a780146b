"""Device idle ms a case that began while a serving span other than ``sliding_window.predict`` was the innermost
one open on the host: the host's own work between the forwards (``bench/spans.py``)."""

from port_bench.bench import spans

UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "case_s"
LAYER = "serving entry: zoo_scripts.ensemble_predict, train/sliding_window.py"
SPANS = ("sliding_window.prepare", "sliding_window.gather", "sliding_window.blend", "sliding_window.normalize",
         "serve.combine")

spans.install()


def read(run):
    return spans.per_unit_ms(run, SPANS, "idle_s") if run.kind == "serve" else None
