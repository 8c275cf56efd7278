"""On the card: the program's own lower-precision route (the
configuration's ``lower_precision``) is not correct, and the program as
the configuration states it is, at sizes a test run holds."""

import pytest

from portbench import control
from portbench.tests.small import small

#: a quarter of the cortex slab's y and x, one block deep; the sweep ROI
#: at a quarter of its y and x
SHAPES = {"detect.ls.cortex": [156, 512, 512],
          "sweep.4xnuc.gridtest": [64, 256, 256]}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SHAPES))
def test_the_lower_precision_control_is_not_correct(cell, card):
    line = control.readings(cell, 7, True, True, device=card,
                            parts=small(cell, SHAPES[cell]))
    limits = line["limits"]
    assert all(line["sound"][k] <= v for k, v in limits.items()), line
    assert any(line["control"][k] > v for k, v in limits.items()), line
