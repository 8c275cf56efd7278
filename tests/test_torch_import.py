"""The PyTorch port imports without jax and without the reference package,
and its copies of the reference's pure-numpy host helpers return what the
reference returns."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from magellanmapper_tpu.cv import blobs as blobs_mod
from magellanmapper_tpu.cv import detector as ref_detector
from magellanmapper_tpu.cv import stack_detect as ref_sd
from magellanmapper_tpu.cv import verifier
from magellanmapper_tpu.ops import filters as ref_filters
from magellanmapper_tpu.settings.roi_prof import ROIProfile
from magellanmapper_torch import testing
from magellanmapper_torch.cv import detector, stack_detect as sd
from magellanmapper_torch.ops import filters

torch.set_num_threads(1)

#: the checkout's root: a fresh interpreter imports the port from there,
#: whatever directory an earlier test left the process in
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import magellanmapper_torch
names = [m.name for m in pkgutil.walk_packages(
    magellanmapper_torch.__path__, "magellanmapper_torch.")]
for name in names:
    importlib.import_module(name)
assert "jax" not in sys.modules, sorted(
    m for m in sys.modules if m.startswith("jax"))
ref = sorted(m for m in sys.modules if m.startswith("magellanmapper_tpu"))
assert not ref, ref
print(len(names))
"""


def test_port_imports_without_jax():
    # conftest imports jax into this process, so import in a fresh one;
    # neither jax nor the reference package may load
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
        timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


@pytest.mark.parametrize("module", [
    "magellanmapper_torch.stats.mlearn", "magellanmapper_torch.io.cli"])
def test_grid_search_modules_import_without_jax(module):
    code = (f"import sys, {module}\n"
            "assert 'jax' not in sys.modules, sorted(\n"
            "    m for m in sys.modules if m.startswith('jax'))\n"
            "ref = sorted(m for m in sys.modules\n"
            "             if m.startswith('magellanmapper_tpu'))\n"
            "assert not ref, ref\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("sigma,order", [
    (0.5, 0), (2.6, 0), (2.8, 2), (8.0, 0), (3.3, 1)])
def test_gaussian_kernel1d_copy(sigma, order):
    np.testing.assert_array_equal(
        filters.gaussian_kernel1d(sigma, order),
        ref_filters.gaussian_kernel1d(sigma, order))


@pytest.mark.parametrize("mode", [
    "reflect", "nearest", "mirror", "constant", "wrap"])
def test_band_matrix_copy(mode):
    k = np.asarray(ref_filters.gaussian_kernel1d(2.6, 2), np.float64)
    for n in (5, 25, 128):
        np.testing.assert_array_equal(
            filters._band_matrix(k.tobytes(), len(k), n, mode, 0.0),
            ref_filters._band_matrix(k.tobytes(), len(k), n, mode, 0.0))


def test_detector_helpers_copy():
    for res in ([1.0, 1.0, 1.0], [[2.0, 0.5, 0.5]], (0.96, 1, 1)):
        np.testing.assert_array_equal(
            detector.calc_scaling_factor(res),
            ref_detector.calc_scaling_factor(res))
        np.testing.assert_array_equal(
            detector.calc_overlap(res), ref_detector.calc_overlap(res))
        np.testing.assert_array_equal(
            detector.calc_overlap(res, 3), ref_detector.calc_overlap(res, 3))
    assert detector.OVERLAP_FACTOR == ref_detector.OVERLAP_FACTOR
    for args in ((2.6, 2.8, 10), (3, 5, 1), (1.0, 4.0, 7)):
        np.testing.assert_array_equal(
            detector.sigma_list(*args), ref_detector.sigma_list(*args))


def _blob_rows(rng, n, lo, hi, channel=0):
    raw = np.column_stack([rng.integers(lo, hi, (n, 3)),
                           rng.uniform(2, 5, n)]).astype(float)
    return blobs_mod.Blobs(raw).format_blobs(channel)


def test_remove_close_blobs_copy():
    rng = np.random.default_rng(3)
    blobs = _blob_rows(rng, 40, 0, 20)
    master = _blob_rows(rng, 30, 0, 20)
    got = detector.remove_close_blobs(blobs.copy(), master.copy(), (2, 2, 2))
    want = ref_detector.remove_close_blobs(
        blobs.copy(), master.copy(), (2, 2, 2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


_PROFILES = ["lightsheet", "lowres", "default"]
_SHAPES = [(48, 192, 192), (300, 700, 650), (20, 100, 90)]


@pytest.mark.parametrize("prof_name", _PROFILES)
@pytest.mark.parametrize("shape", _SHAPES)
def test_block_planning_copy(prof_name, shape):
    prof = ROIProfile()
    if prof_name != "default":
        prof.add_profiles(prof_name)
    res = (1.0, 1.0, 1.0)
    got = sd.setup_blocks(prof, shape, res)
    want = ref_sd.setup_blocks(prof, shape, res)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray) and w.dtype != object:
            np.testing.assert_array_equal(g, w)
        else:
            assert (g is None and w is None) or np.all(g == w)
    block_shape = np.minimum(got.max_pixels + got.overlap, shape)
    voxels = int(np.prod(block_shape))
    assert sd._choose_capacity(prof, voxels) == ref_sd._choose_capacity(
        prof, voxels)
    prof_auto = ROIProfile(max_blobs_per_block=None)
    assert sd._choose_capacity(prof_auto, voxels) == \
        ref_sd._choose_capacity(prof_auto, voxels)
    for coord in np.ndindex(*got.sub_roi_slices.shape):
        np.testing.assert_array_equal(
            sd._window_for_block(shape, got.sub_rois_offsets[coord],
                                 block_shape),
            ref_sd._window_for_block(shape, want.sub_rois_offsets[coord],
                                     block_shape))
    for budget in (1 << 30, 1 << 24, 1 << 20, 1 << 10):
        g = sd._plan_slabs(got.sub_roi_slices.shape, got, block_shape,
                           shape, 2, budget)
        w = ref_sd._plan_slabs(want.sub_roi_slices.shape, want,
                               block_shape, shape, 2, budget)
        assert (g is None) == (w is None)
        if g is not None:
            assert tuple(g) == tuple(w)


@pytest.mark.parametrize("prof_name", ["lightsheet", "default"])
def test_prune_blobs_copy(prof_name):
    """Cross-block pruning on blobs planted in every block, with
    near-duplicates inside the overlap bands."""
    prof = ROIProfile()
    if prof_name != "default":
        prof.add_profiles(prof_name)
    shape = (60, 300, 300)
    blocks = ref_sd.setup_blocks(prof, shape, (1.0, 1.0, 1.0))
    rng = np.random.default_rng(7)
    grid = blocks.sub_roi_slices.shape

    def bounds(coord):
        sl = blocks.sub_roi_slices[coord]
        return (np.asarray([s.start for s in sl]),
                np.asarray([s.stop for s in sl]))

    raws = {}
    for coord in np.ndindex(*grid):
        lo, hi = bounds(coord)
        raws[coord] = [np.column_stack([
            rng.integers(lo, hi, (25, 3)), rng.uniform(2, 5, 25)])]
    for coord in np.ndindex(*grid):
        for axis in range(3):
            if coord[axis] + 1 >= grid[axis]:
                continue
            nb = tuple(c + (i == axis) for i, c in enumerate(coord))
            (lo, hi), (lo_n, hi_n) = bounds(coord), bounds(nb)
            both = np.column_stack([
                rng.integers(np.maximum(lo, lo_n), np.minimum(hi, hi_n),
                             (4, 3)), rng.uniform(2, 5, 4)])
            jitter = both.copy()
            jitter[:, :3] += rng.integers(-1, 2, (4, 3))
            raws[coord].append(both)
            raws[nb].append(jitter)
    seg_rois = np.full(grid, None, dtype=object)
    for coord, parts in raws.items():
        seg_rois[coord] = blobs_mod.Blobs(
            np.vstack(parts).astype(float)).format_blobs(0)
    got = sd.prune_blobs(seg_rois, blocks, shape, [0])
    want = ref_sd.prune_blobs(seg_rois, blocks, shape, [0])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        sd.StackPruner(seg_rois, blocks, shape, [0]).prune(), want)
    assert len(got) < sum(len(r) for r in seg_rois.ravel())


@pytest.mark.parametrize("names", ["lightsheet", "lightsheet,lowres"])
def test_roi_profile_is_the_cli_profile(names):
    want = ROIProfile()
    want.add_profiles(names)
    assert dict(sd.roi_profile(names)) == dict(want)


def test_sens_ppv_matches_the_reference_verifier():
    """The smoke's quality check pairs blobs as the reference verifier's
    ``find_closest_blobs_cdist`` does, tile by tile."""
    rng = np.random.default_rng(11)
    shape, tile, tol = (40, 80, 80), (20, 40, 40), (3, 3, 3)
    truth = rng.integers(0, 80, (300, 3)) % np.asarray(shape)
    det = truth[:250] + rng.integers(-3, 4, (250, 3))
    det = np.vstack([det, rng.integers(0, 40, (40, 3))])
    det = np.clip(det, 0, np.asarray(shape) - 1).astype(float)
    thresh, scaling, *_ = verifier.setup_match_blobs_roi(tol)
    tp = 0
    for lo in np.ndindex(2, 2, 2):
        lo = np.multiply(lo, tile)
        hi = lo + tile
        pick = [a[np.all((a >= lo) & (a < hi), 1)] for a in (det, truth)]
        found, _, _ = verifier.find_closest_blobs_cdist(
            *pick, thresh, scaling)
        tp += len(found)
    want = verifier.calc_sens_ppv(
        len(truth), tp, len(det) - tp, len(truth) - tp)[:2]
    got = testing.sens_ppv(det, truth, shape, tile, tol)
    assert 0 < tp < len(truth)
    assert got == pytest.approx(want, rel=0, abs=0)
