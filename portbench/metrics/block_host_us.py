"""The block step on the host: the mean microseconds from the start of
a `mm.block` span to the start of its `mm.pull`, which is the enqueue of
preprocessing (K4), the LoG, K1 and K3, with their own waits."""

from portbench import spans


def read(run):
    recs = spans.records()
    if not recs:
        return None
    pull_at = {r.parent: r.start_ns for r in recs
               if r.name == "mm.pull" and r.parent is not None}
    host = [pull_at[i] - r.start_ns for i, r in enumerate(recs)
            if r.name == "mm.block" and i in pull_at]
    if not host:
        return None
    return sum(host) / len(host) / 1e3
