"""Verification's assignment work: the distance matrix cells handed to
`linear_sum_assignment` (the `cells` of the `mm.verify.assign` spans),
millions a sweep."""

from portbench import spans


def read(run):
    cells = spans.per_root("mm.grid_search", "mm.verify.assign", "cells")
    return None if cells is None else cells / 1e6
