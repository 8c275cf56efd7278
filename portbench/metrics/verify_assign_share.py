"""Verification's assignment: the `mm.verify.assign` spans over the
`mm.grid_search` spans' wall (whole sweeps), percent."""

from portbench import spans


def read(run):
    return spans.share("mm.grid_search", "mm.verify.assign")
