"""K2 (`kernels/extract_candidates`): the least time for each traced
call's rows over the kernel's device time, percent of the roofline."""

from portbench import readers


def read(run):
    return readers.roofline_share(
        run, readers.k2_counts, lambda t: t.kernel_s(*readers.K2))
