"""Seconds from the start of the command to the first timed unit: imports, the kernels' build or load, the
networks, the inputs and the warm-up (host clock)."""

UNIT, BETTER, SOURCE, LAYER = "s", "lower", "host_clock", None


def read(run):
    return run.setup_s
