"""The cross-block prune's matching: the `mm.prune.match` spans over the
`mm.detect` spans' wall (whole passes), percent."""

from portbench import spans


def read(run):
    return spans.share("mm.detect", "mm.prune.match")
