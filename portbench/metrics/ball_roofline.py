"""The ball means of intensity colocalisation (`colocalizer._ball_sums`,
whose slabs are the program's `mm.coloc.ball` spans): the least time for
the work of each traced call (`coloc_counts.ball_means`: the distinct
voxels of the blobs' balls read once, a mean a blob written) over the
device time of every operation launched inside it, percent of the
roofline."""

from portbench import coloc_counts, readers


def read(run):
    return readers.roofline_share(
        run, coloc_counts.ball_calls, lambda t: t.span_s("ball_sums"))
