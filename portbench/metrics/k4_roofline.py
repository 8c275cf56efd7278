"""K4 (`kernels/tile_percentiles`): the least time for each traced
call's tile matrix over the kernels' device time, percent of the
roofline."""

from portbench import readers


def read(run):
    return readers.roofline_share(
        run, readers.k4_counts, lambda t: t.kernel_s(*readers.K4))
