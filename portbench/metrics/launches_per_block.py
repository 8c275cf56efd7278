"""The block step's launches: device operations in the traced window
over the program's `mm.block` spans (one a block and its pull),
operations a block. None without a device trace."""

from portbench import spans


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    blocks = spans.named(spans.under(spans.records(), "mm.detect"),
                         "mm.block")
    if not blocks:
        return None
    return len(run.trace.ops) / len(blocks)
