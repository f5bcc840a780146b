"""The window's cases' FLOPs, counted once from the benchmark's reference (``bench.flops``), over the window's
time, as a share of one H100 SXM's published float32 peak of 67 TFLOP/s (at 700 W)."""

from port_bench.bench import readings

UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "case_s"
LAYER = "whole step or case against the chip's peak"


def read(run):
    return readings.mfu(run) if run.kind == "serve" else None
