"""The device: peak memory allocated on the card during the measured
window, GiB (`torch.cuda.max_memory_allocated`)."""

from portbench import readers


def read(run):
    return readers.peak_gib(run)
