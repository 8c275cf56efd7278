"""``correct`` comes out false when the timed path is broken underneath:
a run at a small size on the CPU, the harness's look for a card
skipped, with each fault that the cell can have (``faults.py``) planted
in the program."""

import numpy as np
import pytest

from portbench import faults, harness
from portbench.tests.small import SMALL, small

CASES = [(cell, fault) for cell in sorted(SMALL)
         for fault in sorted(faults.FAULTS[cell.split(".")[0]])]


@pytest.mark.parametrize("cell, fault", CASES)
def test_a_broken_path_is_not_correct(cell, fault):
    with faults.planted(cell.split(".")[0], fault):
        out = harness.run_cell(cell, 99, 0.0, False, device="cpu",
                               parts=small(cell, SMALL[cell]),
                               log=lambda *a, **k: None)
    assert out["correct"] is False
    assert out["failed"] == out["attempted"] >= 1


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_sound_path_is_correct(cell):
    out = harness.run_cell(cell, 99, 0.0, False, device="cpu",
                           parts=small(cell, SMALL[cell]),
                           log=lambda *a, **k: None)
    assert out["correct"] is True
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    assert np.isfinite(list(out["metrics"].values())[0]["value"])
