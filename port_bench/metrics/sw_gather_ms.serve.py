"""Device ms a case launched inside the sliding window's ``sliding_window.prepare`` and ``sliding_window.gather``
spans: the padding, the importance map's copy and the windows' stacking (``bench/spans.py``)."""

from port_bench.bench import spans

UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "case_s"
LAYER = "serving entry: zoo_scripts.ensemble_predict, train/sliding_window.py"
SPANS = ("sliding_window.prepare", "sliding_window.gather")

spans.install()


def read(run):
    return spans.per_unit_ms(run, SPANS, "device_s") if run.kind == "serve" else None
