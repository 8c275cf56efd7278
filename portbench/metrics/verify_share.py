"""Verification on the host: the seconds inside the program's
`cv/verifier.verify_stack` (matching each threshold's blobs to the
truth), over the window, percent."""


def read(run):
    if "verify_s" not in run.records[0]:
        return None
    return 100.0 * sum(r["verify_s"] for r in run.records) / run.span_s
