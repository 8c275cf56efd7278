"""K1 (`kernels/peak_candidates`): the least time for each traced
call's cube and candidates over the kernel's device time, percent of the
roofline."""

from portbench import readers


def read(run):
    return readers.roofline_share(
        run, readers.k1_counts, lambda t: t.kernel_s(*readers.K1))
