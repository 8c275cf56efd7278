"""Match colocalisation: the program's `mm.coloc.match` spans
(`colocalizer.match_stack`: the channels' blobs matched over the whole
image, in blocks) over the traced passes' wall, percent."""

from portbench import spans


def read(run):
    recs = spans.under(spans.records(), "mm.coloc.match")
    if run.trace is None or not run.trace.window_s > 0 or not recs:
        return None
    return 100.0 * spans.wall_s(recs, "mm.coloc.match") / run.trace.window_s
