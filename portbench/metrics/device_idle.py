"""The device: percent of the traced window in which no operation ran
on the card."""

from portbench import readers


def read(run):
    return readers.idle(run)
