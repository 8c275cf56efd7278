"""The LoG pyramid (`ops/filters.log_pyramid`): the least time for the
separable taps of each traced call (`counts.log_pyramid`) over the
device time of every kernel launched inside it, percent of the
roofline."""

from portbench import readers


def read(run):
    return readers.roofline_share(
        run, readers.log_counts, lambda t: t.span_s("log_pyramid"))
