"""End to end, `detect` cells: voxels of the completed passes over the
time from the first pass's start to the last pass's end, Mvox/s."""


def read(run):
    voxels = sum(r["voxels"] for r in run.records)
    return voxels / run.span_s / 1e6
