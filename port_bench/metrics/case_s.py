"""Seconds a case of the mix: the window's time over the roi windows served in it, times the cycle's mean windows
a case (host clock).  All the window's work and time: weighing each case by its windows keeps the rate from
jumping with the size of the case that happens to end the window."""

UNIT, BETTER, SOURCE, LAYER = "s", "lower", "host_clock", None


def read(run):
    return run.window_s / run.windows_done * run.mean_windows if run.kind == "serve" else None
