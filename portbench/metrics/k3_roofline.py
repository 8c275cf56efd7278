"""K3 (`kernels/prune_overlap`): the least time for the pairs of valid
rows of each traced call over the kernels' device time, percent of the
roofline."""

from portbench import readers


def read(run):
    return readers.roofline_share(
        run, readers.k3_counts, lambda t: t.kernel_s(*readers.K3))
