"""Host planning and staging: the timing dict's `Gather_host` and
`Stage_h2d` (synchronised) over the passes' wall, percent."""

from portbench import readers


def read(run):
    return readers.timing_share(run, ("Gather_host", "Stage_h2d"))
