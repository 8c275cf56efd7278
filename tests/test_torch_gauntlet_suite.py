"""The port's gauntlet suite against the reference's, on the CPU.

``run_gauntlet_suite`` at the reference test's configuration
(``tests/test_gauntlet.py:187-190``: (32, 40, 36) pairs with a small
ground-truth warp, ``iters_scale`` 0.03), with one seeded pair and the
truncated pair (the second seed is left out to keep the test short). The
pairs are built from the same seeds, so the ground truth is equal; the
registrations are not bit for bit, since each metric level above 16,384
voxels jitters its samples from the port's ``torch.Generator`` and not
JAX's threefry. So the names and ``passes`` must be equal, and every
scored number lies within the limits below, each about twice the
largest difference measured on this configuration (both seeds; label
minima move most, as one small region's overlap jumps).

The ``slow`` test holds the full-size (160, 240, 200) seed-0 pair,
``run_gauntlet`` with the reference's whole schedule, against the
reference on the CPU (deselected by ``-m 'not slow'``).
"""

import numpy as np
import pytest
import torch

from magellanmapper_torch.atlas import gauntlet
from magellanmapper_tpu.atlas import gauntlet as ref_gauntlet

torch.set_num_threads(1)

SHAPE = (32, 40, 36)
GT_KWARGS = dict(ffd_spacing=20.0, ffd_ctrl_sigma=3.0)
#: each pair's numbers, port against reference (measured at most: dsc
#: 0.0019, stage DSCs 0.0019, gain 0.0021, closure 0.044, label median
#: 0.011, p10 0.022, min 0.030, warp error 0.033, its p95 0.077)
ATOL = {"dsc": 5e-3, "bspline_dsc_gain": 5e-3,
        "bspline_gap_closure": 0.1, "label_dsc_median": 0.025,
        "label_dsc_p10": 0.05, "label_dsc_min": 0.06,
        "warp_err_vox": 0.07, "warp_err_p95_vox": 0.15,
        "gt_disp_vox": 1e-6}
STAGE_ATOL = 5e-3


def _check_pair(got, want, atol):
    for key, tol in atol.items():
        assert got[key] == pytest.approx(want[key], abs=tol), key
    assert set(got["stage_dsc"]) == set(want["stage_dsc"])
    for stage, dsc in want["stage_dsc"].items():
        assert got["stage_dsc"][stage] == pytest.approx(dsc, abs=STAGE_ATOL)
    assert got["passes"] == want["passes"]


def test_suite_matches_reference():
    got = gauntlet.run_gauntlet_suite(
        SHAPE, seeds=(2,), truncated_seed=2, iters_scale=0.03,
        device="cpu", **GT_KWARGS)
    want = ref_gauntlet.run_gauntlet_suite(
        SHAPE, seeds=(2,), truncated_seed=2, iters_scale=0.03, **GT_KWARGS)
    assert list(got["pairs"]) == list(want["pairs"]) == ["seed2", "trunc2"]
    assert got["passes"] == want["passes"] == all(
        r["passes"] for r in got["pairs"].values())
    assert got["wall_s"] == pytest.approx(
        sum(r["wall_s"] for r in got["pairs"].values()))
    for name, pair in want["pairs"].items():
        _check_pair(got["pairs"][name], pair, ATOL)
        # the checks ``chip_smoke.py`` adds to the gate have their inputs
        assert "affine" in got["pairs"][name]["stage_dsc"]


def test_suite_without_a_truncated_pair():
    got = gauntlet.run_gauntlet_suite(
        (20, 28, 28), seeds=(1,), truncated_seed=None, iters_scale=0.01,
        device="cpu", ffd_spacing=12.0, ffd_ctrl_sigma=2.0)
    assert list(got["pairs"]) == ["seed1"]
    assert got["passes"] == got["pairs"]["seed1"]["passes"]


#: full size, the reference's whole schedule: limits for two registrations
#: whose metric samples jitter apart
FULL_SHAPE = (160, 240, 200)
FULL_ATOL = {"dsc": 0.01, "label_dsc_median": 0.02, "label_dsc_p10": 0.05,
             "label_dsc_min": 0.1}


@pytest.mark.slow
def test_full_size_seed0_pair_matches_reference():
    """``run_gauntlet`` on the (160, 240, 200) seed-0 pair, port against
    reference on the CPU: DSC and the label median, p10 and minimum."""
    got = gauntlet.run_gauntlet(gauntlet.build_pair(FULL_SHAPE, seed=0,
                                                    device="cpu"),
                                device="cpu")
    want = ref_gauntlet.run_gauntlet(ref_gauntlet.build_pair(FULL_SHAPE,
                                                             seed=0))
    for key, tol in FULL_ATOL.items():
        assert got[key] == pytest.approx(want[key], abs=tol), key
    assert np.isfinite(got["warp_err_vox"])
