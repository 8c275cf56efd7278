"""The block step's pull: the timing dict's `Pull_wait`, the host
waiting for each block's rows, over the passes' wall, percent."""

from portbench import readers


def read(run):
    return readers.timing_share(run, ("Pull_wait",))
