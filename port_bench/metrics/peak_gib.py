"""GiB of device memory at the window's peak: ``torch.cuda.max_memory_allocated()`` after a reset at its start."""

UNIT, BETTER, SOURCE, LAYER = "GiB", "lower", "host_clock", None


def read(run):
    return run.peak_bytes / 2 ** 30
