"""The plain reference: its filters against scipy and numpy, its
independence from the program, and its agreement with the program at a
small size on the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from portbench import harness
from portbench.tests.small import SMALL, small
from portbench.reference import filters as rf
from portbench.reference import sweep as ref_sweep

PB = pathlib.Path(__file__).resolve().parents[1]


def test_log_stack_is_scipys_gaussian_laplace():
    vol = np.random.default_rng(0).random((30, 40, 50)).astype(np.float32)
    sigmas = (2.6, 2.8, 3.5)
    got = rf.log_stack(torch.from_numpy(vol), sigmas).numpy()
    for i, s in enumerate(sigmas):
        want = -ndi.gaussian_laplace(vol.astype(np.float64), s) * s * s
        assert np.abs(got[i] - want).max() < 1e-6


def test_gaussian_nearest_and_erosion_and_maximum():
    vol = np.random.default_rng(1).random((3, 25, 25, 25)).astype(
        np.float32)
    t = torch.from_numpy(vol)
    got = rf.gaussian_nearest(t, 8.0).numpy()
    for k in range(3):
        want = ndi.gaussian_filter(vol[k].astype(np.float64), 8.0,
                                   mode="nearest")
        assert np.abs(got[k] - want).max() < 1e-6
    foot = ndi.generate_binary_structure(3, 1)
    np.testing.assert_array_equal(
        rf.erosion_octahedron(t).numpy()[1],
        ndi.grey_erosion(vol[1], footprint=foot, mode="reflect"))
    np.testing.assert_array_equal(
        rf.max_filter_zero(t).numpy(),
        ndi.maximum_filter(vol, size=3, mode="constant", cval=0.0))


def test_percentiles_are_numpys_within_float32_interpolation():
    rows = np.random.default_rng(2).integers(0, 60000, (6, 15625)).astype(
        np.float32)
    got = rf.percentiles(torch.from_numpy(rows), 5, 98.5).numpy()
    want = np.percentile(rows.astype(np.float64), (5, 98.5), axis=1).T
    # float32 rounding of values below 2^16: an ulp is at most 2^-8
    assert np.abs(got - want).max() <= 2 * 2.0 ** -8


def test_harvest_order_caps_a_row_at_eight_and_orders_by_round():
    # 10 peaks in row 0, one in row 1 equal to row 0's brightest
    idx = np.r_[np.arange(10) * 3, 130]
    vals = np.r_[np.linspace(1.0, 0.1, 10), 1.0].astype(np.float32)
    order = ref_sweep.harvest_order(vals, idx)
    assert len(order) == 9
    # equal values: round 0 of row 0 before round 0 of row 1
    assert list(idx[order[:2]]) == [0, 130]
    assert 27 not in idx[order] and 24 not in idx[order]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("folder", ["reference", "traffic"])
def test_reference_and_traffic_import_nothing_of_the_program(folder):
    for path in sorted((PB / folder).glob("*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"magellanmapper_torch", "magellanmapper_tpu",
                           "jax", "jaxlib", "flax"}, path


@pytest.mark.parametrize("name, budget", [
    ("detect.ls.cortex", None), ("detect.ls.cortex", 1_500_000),
    ("sweep.4xnuc.gridtest", None)])
def test_reference_equals_the_program_at_a_small_size(name, budget,
                                                      monkeypatch):
    """``budget``: the program's resident staging budget cut, so that the
    small volume goes through two y slabs as a specimen goes through
    z slabs."""
    if budget is not None:
        from magellanmapper_torch.cv import stack_detect
        monkeypatch.setattr(stack_detect, "_RESIDENT_BYTES_BUDGET", budget)
    parts = small(name, SMALL[name])
    drv = harness.driver_module(parts[2]["driver"]).Driver(
        parts[1], parts[2], 77, "cpu")
    drv.setup()
    rec = drv.once()
    if budget is not None:
        assert rec["timing"]["h2d_bytes"] == 2 * 40 * 128 * 140 * 2
    ref = drv.reference()
    rows = ref if name.startswith("detect") else np.vstack(
        [r for r in ref if r is not None])
    assert len(rows) > 20
    got = drv.check([rec["out"]], ref)[0]
    assert all(v == 0 for v in got.values()), got
