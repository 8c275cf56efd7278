"""End to end, `sweep` cells: the window's time over the sweeps
completed, seconds a sweep."""


def read(run):
    return run.span_s / len(run.records)
