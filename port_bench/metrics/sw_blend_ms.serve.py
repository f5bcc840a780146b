"""Device ms a case launched inside ``sliding_window.blend``, ``sliding_window.normalize`` and ``serve.combine``:
the blending sums, their division and crop, and the folds' sigmoid, mean and threshold (``bench/spans.py``)."""

from port_bench.bench import spans

UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "case_s"
LAYER = "serving entry: zoo_scripts.ensemble_predict, train/sliding_window.py"
SPANS = ("sliding_window.blend", "sliding_window.normalize", "serve.combine")

spans.install()


def read(run):
    return spans.per_unit_ms(run, SPANS, "device_s") if run.kind == "serve" else None
