"""The port's filters and LoG pyramid against the JAX reference.

Both sides compute in float32 and differ only in the order of their sums,
hence rtol 1e-5 and atol 1e-6 on unit-range inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magellanmapper_tpu.ops import filters as ref_filters
from magellanmapper_torch.ops import filters

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _vol(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("shape,sigmas", [
    ((12, 20, 24), tuple(np.linspace(2.6, 2.8, 10))),
    ((16, 32, 40), (1.0, 2.0, 3.5)),
    ((9, 128, 130), (3.0,)),
])
def test_log_pyramid_matches_reference(shape, sigmas):
    vol = _vol(shape)
    want = np.asarray(ref_filters.log_pyramid(jnp.asarray(vol), sigmas))
    got = filters.log_pyramid(torch.from_numpy(vol), sigmas).numpy()
    assert got.shape == (len(sigmas),) + shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sigma,mode,order", [
    (8.0, "nearest", 0), (2.0, "reflect", 0), (1.5, "mirror", 2),
    (3.0, "constant", 0)])
def test_gaussian_filter_matches_reference(sigma, mode, order):
    vol = _vol((25, 25, 25), 1)
    want = np.asarray(ref_filters.gaussian_filter(
        jnp.asarray(vol), sigma, order=order, mode=mode))
    got = filters.gaussian_filter(
        torch.from_numpy(vol), sigma, order=order, mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_gaussian_filter_batches_leading_axes():
    tiles = _vol((4, 25, 25, 25), 2)
    got = filters.gaussian_filter(
        torch.from_numpy(tiles), 8.0, mode="nearest").numpy()
    for t in range(4):
        want = np.asarray(ref_filters.gaussian_filter(
            jnp.asarray(tiles[t]), 8.0, mode="nearest"))
        np.testing.assert_allclose(got[t], want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(5, 6, 7), (1, 4, 3)])
def test_erosion_matches_reference(shape):
    vol = _vol(shape, 3)
    fp = ref_filters.octahedron_footprint(1)
    np.testing.assert_array_equal(filters.octahedron_footprint(1), fp)
    want = np.asarray(ref_filters.erosion(jnp.asarray(vol), fp))
    got = filters.erosion(torch.from_numpy(vol), fp).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("pads", [
    [(0, 3), (0, 0), (0, 24)], [(1, 1), (2, 2), (1, 1)],
    [(0, 11), (0, 0), (0, 1)]])
def test_pad_symmetric_matches_numpy(dtype, pads):
    vol = (np.random.default_rng(4).random((4, 5, 6)) * 1000).astype(dtype)
    got = filters.pad_symmetric(torch.from_numpy(vol), pads).numpy()
    np.testing.assert_array_equal(got, np.pad(vol, pads, mode="symmetric"))


def test_taps_route_is_not_ported():
    """The taps route past 768 samples is ported now: the (4, 4, 800)
    pyramid this test once saw raise equals the reference's."""
    vol = _vol((4, 4, 800), 5)
    want = np.asarray(ref_filters.log_pyramid(jnp.asarray(vol), (2.0,)))
    got = filters.log_pyramid(torch.from_numpy(vol), (2.0,)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", [
    "reflect", "nearest", "mirror", "constant", "wrap"])
@pytest.mark.parametrize("axis,shape", [(2, (3, 5, 900)), (0, (1000, 3, 4))])
def test_conv1d_taps_matches_reference(mode, axis, shape):
    vol = _vol(shape, 6)
    for order in (0, 2):
        kernel = ref_filters.gaussian_kernel1d(2.5, order)
        want = np.asarray(ref_filters.conv1d(
            jnp.asarray(vol), kernel, axis, mode))
        got = filters.conv1d(torch.from_numpy(vol), kernel, axis, mode)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sigma", [1.5, (1.0, 2.0, 3.0)])
def test_gaussian_laplace_matches_reference(sigma):
    vol = _vol((6, 40, 800), 7)       # y takes the band, x the taps
    want = np.asarray(ref_filters.gaussian_laplace(jnp.asarray(vol), sigma))
    got = filters.gaussian_laplace(torch.from_numpy(vol), sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_log_pyramid_long_axis_matches_reference():
    vol = _vol((5, 24, 1024), 8)
    sigmas = tuple(np.linspace(3, 4, 3))
    want = np.asarray(ref_filters.log_pyramid(jnp.asarray(vol), sigmas))
    got = filters.log_pyramid(torch.from_numpy(vol), sigmas).numpy()
    assert got.shape == (3, 5, 24, 1024)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
