"""Small traffic for the CPU tests: each cell's files, its shape cut."""

import copy

from portbench import harness


def small(name, shape):
    bench = harness.benchmark()
    cell, config, traffic, limits = harness.cell_parts(bench, name)
    traffic = copy.deepcopy(traffic)
    traffic["params"]["shape"] = shape
    return cell, config, traffic, limits


#: small shapes: detection over 2 x 2 blocks in y and x; the sweep over
#: 36 truth nuclei on its batched path
SMALL = {"detect.ls.cortex": [40, 150, 140],
         "sweep.4xnuc.gridtest": [24, 128, 128]}
