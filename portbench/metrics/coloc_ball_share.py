"""Intensity colocalisation: the program's `mm.coloc` spans
(`colocalizer.colocalize_blobs`: the ball means of every blob in every
channel, and the flags) over the traced passes' wall, percent."""

from portbench import spans


def read(run):
    recs = spans.under(spans.records(), "mm.coloc")
    if run.trace is None or not run.trace.window_s > 0 or not recs:
        return None
    return 100.0 * spans.wall_s(recs, "mm.coloc") / run.trace.window_s
