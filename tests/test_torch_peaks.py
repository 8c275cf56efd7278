"""Peak finding (K1) and sphere-overlap pruning (K3) of the port, through
their plain versions on the CPU, against the JAX reference: the jnp
functions and the Pallas kernels in interpret mode. Coordinates, values,
counts and masks must be exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magellanmapper_tpu.ops import pallas_kernels
from magellanmapper_tpu.ops import peaks as ref_peaks
from magellanmapper_torch.kernels import peak_candidates
from magellanmapper_torch.ops import peaks

torch.set_num_threads(1)


def _peak_cube(shape, seed, n=40, ties=()):
    """-0.05 background with isolated planted peaks in distinct (s, z, y)
    rows; each ``ties`` entry plants peaks of one shared value in one
    (s, z) plane at distinct rows, where the reference's candidate order
    and flat-index order agree."""
    rng = np.random.default_rng(seed)
    s, z, y, x = shape
    cube = np.full(shape, -0.05, np.float32)
    rows = rng.permutation(s * z * y)[:n]
    for r, v in zip(rows, rng.uniform(0.2, 1.0, n).astype(np.float32)):
        cube[np.unravel_index(r, (s, z, y)) + (rng.integers(x),)] = v
    for k, value in enumerate(ties):
        si, zi = k % s, (2 * k + 1) % z
        cube[si, zi] = -0.05
        for yi in range(0, y, 6):
            cube[si, zi, yi, (7 * yi + 3) % x] = value
    return cube


def _find_all(cube, thresh, capacity):
    ref = ref_peaks.find_peaks(jnp.asarray(cube), thresh, capacity,
                               fused=False)
    fused = pallas_kernels.find_peaks_fused(
        jnp.asarray(cube), thresh, capacity, interpret=True)
    port = peaks.find_peaks(torch.from_numpy(cube), thresh, capacity)
    return ref, fused, port


@pytest.mark.parametrize("shape,capacity", [
    ((4, 6, 32, 128), 64), ((3, 5, 20, 130), 64), ((3, 7, 24, 128), 16)])
def test_find_peaks_matches_reference(shape, capacity):
    cube = _peak_cube(shape, seed=sum(shape), ties=(0.6, 0.35))
    ref, fused, port = _find_all(cube, 0.1, capacity)
    coords, values, count = port
    for rc, rv, rn in (ref, fused):
        k = int(rn)
        assert count == k
        np.testing.assert_array_equal(coords.numpy()[:k], np.asarray(rc)[:k])
        np.testing.assert_array_equal(values.numpy()[:k], np.asarray(rv)[:k])
    assert np.all(coords.numpy()[count:] == 0)
    assert np.all(np.isneginf(values.numpy()[count:]))


def test_find_peaks_plateau_counts_every_peak():
    """A flat plateau makes every voxel a peak; the count is exact and
    uncapped by lane groups (the reference's JAX paths would keep only 8
    per 128-lane group here)."""
    cube = np.zeros((2, 3, 4, 128), np.float32)
    cube[1, 1] = 0.5
    vals, idx = peak_candidates.peak_candidates(torch.from_numpy(cube), 0.1)
    assert len(vals) == 4 * 128
    coords, values, count = peaks.find_peaks(torch.from_numpy(cube), 0.1, 100)
    assert count == 100
    # ties go to the lower flat index
    np.testing.assert_array_equal(
        coords.numpy()[:, 3], np.arange(100))


def test_select_top_sparse_tie_order():
    """Value ties go to the lower index, as ``lax.top_k`` orders them."""
    vals = torch.tensor([3.0, 1.0, 3.0, 2.0, 3.0])
    idx = torch.tensor([40, 10, 20, 30, 0])
    top_v, top_i = peaks.select_top_sparse(vals, idx, 4)
    np.testing.assert_array_equal(top_i.numpy(), [0, 20, 40, 30])
    np.testing.assert_array_equal(top_v.numpy(), [3, 3, 3, 2])
    ref_v, ref_i = ref_peaks.select_top_sparse(
        jnp.asarray([3.0, 1.0, 3.0, 2.0, 3.0]), 4)
    np.testing.assert_array_equal(np.asarray(ref_i), [0, 2, 4, 3])


def test_find_peaks_tie_order_across_plane_pairs_pin():
    """Fault of the reference's fused path, pinned: it breaks value ties
    by its candidate layout (z plane pair first), not by flat index. The
    port and the reference's unfused path put (s=0, z=2) before
    (s=1, z=0); ``find_peaks_fused`` puts them the other way."""
    cube = np.full((2, 4, 8, 128), -0.05, np.float32)
    cube[1, 0, 3, 5] = 0.7
    cube[0, 2, 3, 5] = 0.7
    ref, fused, port = _find_all(cube, 0.1, 4)
    flat_order = [[0, 2, 3, 5], [1, 0, 3, 5]]
    np.testing.assert_array_equal(port[0].numpy()[:2], flat_order)
    np.testing.assert_array_equal(np.asarray(ref[0])[:2], flat_order)
    np.testing.assert_array_equal(np.asarray(fused[0])[:2], flat_order[::-1])


def _nonpositive_threshold_parity(threshold):
    cube = np.random.default_rng(6).normal(0, 0.1, (3, 4, 8, 128)).astype(
        np.float32)
    with pytest.raises(ValueError):
        peaks.find_peaks(torch.from_numpy(cube), threshold, 8, fused=True)
    rc, rv, rn = ref_peaks.find_peaks(jnp.asarray(cube), threshold, 4096)
    coords, values, count = peaks.find_peaks(
        torch.from_numpy(cube), threshold, 4096)
    assert count == int(rn) > 100
    np.testing.assert_array_equal(coords.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(values.numpy(), np.asarray(rv))


def test_find_peaks_rejects_nonpositive_threshold():
    """Only the fused route (K1) rejects a threshold <= 0; by default a
    threshold of 0 takes the unfused route, as in the reference, and
    equals it (unclamped maxima: skimage semantics for any sign)."""
    _nonpositive_threshold_parity(0.0)


def test_find_peaks_negative_threshold_matches_reference():
    _nonpositive_threshold_parity(-0.05)


def test_max_filter_full_matches_reference():
    cube = np.random.default_rng(5).normal(size=(3, 4, 5, 6)).astype(
        np.float32)
    np.testing.assert_array_equal(
        peaks.max_filter_full(torch.from_numpy(cube)).numpy(),
        np.asarray(ref_peaks.max_filter_full(jnp.asarray(cube))))


def test_max_filter_full_unclamped_matches_reference():
    cube = np.random.default_rng(5).normal(size=(3, 4, 5, 6)).astype(
        np.float32)
    np.testing.assert_array_equal(
        peaks.max_filter_full(torch.from_numpy(cube), False).numpy(),
        np.asarray(ref_peaks.max_filter_full(jnp.asarray(cube), False)))


def _prune_all(coords, sigmas, valid, thresh=0.5):
    args = (jnp.asarray(coords), jnp.asarray(sigmas), jnp.asarray(valid))
    ref = np.asarray(ref_peaks.prune_overlapping_blobs(*args, thresh))
    pallas = np.asarray(pallas_kernels.prune_overlap_pallas(
        *args, thresh, interpret=True))
    port = peaks.prune_overlapping_blobs(
        torch.from_numpy(coords), torch.from_numpy(sigmas),
        torch.from_numpy(valid), thresh).numpy()
    return ref, pallas, port


@pytest.mark.parametrize("k,n_blobs", [(128, 60), (512, 300), (600, 600)])
def test_prune_matches_reference(k, n_blobs):
    rng = np.random.default_rng(k)
    coords = rng.uniform(0, 80, (k, 3)).astype(np.float32)
    sigmas = rng.uniform(1.5, 4.0, k).astype(np.float32)
    valid = np.zeros(k, bool)
    valid[:n_blobs] = True
    ref, pallas, port = _prune_all(coords, sigmas, valid)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, pallas)


def test_prune_dense_field_matches_reference():
    rng = np.random.default_rng(0)
    k = 1024
    coords = rng.uniform(0, 40, (k, 3)).astype(np.float32)
    sigmas = rng.uniform(1.5, 4.0, k).astype(np.float32)
    valid = rng.random(k) < 0.95
    ref, pallas, port = _prune_all(coords, sigmas, valid)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, pallas)
    assert port.sum() < valid.sum() // 2


@pytest.mark.parametrize("case", ["separated", "pair", "equal_radius"])
def test_prune_small_cases(case):
    if case == "separated":
        coords = (np.indices((4, 4, 4)).reshape(3, -1).T * 50).astype(
            np.float32)
        sigmas = np.full(len(coords), 2.0, np.float32)
        expect = np.ones(len(coords), bool)
    elif case == "pair":
        coords = np.array([[10.0, 10, 10], [10, 10, 10.5], [50, 50, 50]],
                          np.float32)
        sigmas = np.array([2.0, 3.0, 2.0], np.float32)
        expect = [False, True, True]
    else:
        # equal radii: the lower index loses, chains resolve pairwise
        coords = np.array([[5.0, 5, 5], [5, 5, 6], [5, 5, 7], [30, 5, 5]],
                          np.float32)
        sigmas = np.full(4, 2.7, np.float32)
        expect = [False, False, True, True]
    valid = np.ones(len(coords), bool)
    ref, pallas, port = _prune_all(coords, sigmas, valid)
    np.testing.assert_array_equal(port, expect)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, pallas)


def test_prune_close_blobs_matches_reference():
    rng = np.random.default_rng(1)
    coords = np.sort(rng.uniform(0, 30, (600, 3)).astype(np.float32), 0)
    valid = rng.random(600) < 0.9
    tol = (2.0, 2.0, 2.0)
    want = np.asarray(ref_peaks.prune_close_blobs(
        jnp.asarray(coords), jnp.asarray(valid), jnp.asarray(tol)))
    got = peaks.prune_close_blobs(
        torch.from_numpy(coords), torch.from_numpy(valid), tol).numpy()
    np.testing.assert_array_equal(got, want)
