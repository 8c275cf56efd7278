"""The cross-block prune's matching work: master x checked pairs that
`detector.remove_close_blobs` compares (the `pairs` of the `mm.prune.match`
spans), millions a pass."""

from portbench import spans


def read(run):
    pairs = spans.per_root("mm.detect", "mm.prune.match", "pairs")
    return None if pairs is None else pairs / 1e6
