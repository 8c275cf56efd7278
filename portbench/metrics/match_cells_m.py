"""Match colocalisation's assignment work: the distance matrix cells
handed to `linear_sum_assignment` inside `mm.coloc.match` (the `cells` of
its `mm.verify.assign` spans), millions a pass."""

from portbench import spans


def read(run):
    cells = spans.per_root("mm.coloc.match", "mm.verify.assign", "cells")
    return None if cells is None else cells / 1e6
