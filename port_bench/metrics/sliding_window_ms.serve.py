"""Device ms a case spends outside the networks' forwards: the case's span between CUDA events (from the image's
copy to the mask's) less the spans of the forwards that the benchmark hands to ``ensemble_predict``; the gather,
the blend, the fold mean, the copies and the gaps between them."""

UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "case_s"
LAYER = "serving entry: zoo_scripts.ensemble_predict, train/sliding_window.py"


def read(run):
    return run.outside_forward_ms if run.kind == "serve" else None
