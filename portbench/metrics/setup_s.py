"""End to end, every cell: seconds from the start of the process to
the start of the first measured call (imports, CUDA, the kernel library,
the inputs made on the card, the warm-up call)."""


def read(run):
    return run.setup_s
