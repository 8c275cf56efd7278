"""The cross-block prune on the host: the timing dict's `Pruning` over
the passes' wall, percent."""

from portbench import readers


def read(run):
    return readers.timing_share(run, ("Pruning",))
