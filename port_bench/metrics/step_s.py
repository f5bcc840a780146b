"""Seconds a train step: the window's time over the steps completed in it (host clock, ending in a synchronize)."""

UNIT, BETTER, SOURCE, LAYER = "s", "lower", "host_clock", None


def read(run):
    return run.window_s / run.units if run.kind == "train" else None
