"""``magellanmapper_torch.ops.resize`` against ``magellanmapper_tpu.ops.
resize`` on seeded volumes: order 0 (nearest, dtype kept) exactly, order 1
(``jax.image.resize``'s linear method, antialiased when an axis shrinks)
within 1e-6 absolute on values in [0, 1] (float32 products summed in
another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from magellanmapper_tpu.ops import resize as ref
from magellanmapper_torch.ops import resize

torch.set_num_threads(1)

ATOL = 1e-6

#: (input shape, output shape): each axis grown, shrunk, kept, and mixed
SHAPES = [
    ((9, 13, 17), (18, 26, 34)),     # grow every axis
    ((9, 13, 17), (4, 6, 7)),        # shrink every axis (antialiased)
    ((9, 13, 17), (9, 5, 40)),       # keep z, shrink y, grow x
    ((16, 10, 12), (5, 10, 31)),     # odd factors
    ((3, 20, 2), (7, 3, 1)),         # down to one sample
]


def _vol(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("shape_in,shape_out", SHAPES)
def test_resize_matches_reference(shape_in, shape_out, order):
    vol = _vol(shape_in)
    want = np.asarray(ref.resize(jnp.asarray(vol), shape_out, order=order))
    got = resize.resize(torch.from_numpy(vol), shape_out, order=order)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    if order == 0:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("dtype", [np.int32, np.uint8, np.int64])
def test_nearest_keeps_label_dtype(dtype):
    labels = np.random.default_rng(1).integers(0, 120, (7, 11, 9)).astype(
        dtype)
    want = np.asarray(ref.resize(jnp.asarray(labels), (15, 4, 20), order=0))
    got = resize.resize(torch.from_numpy(labels), (15, 4, 20), order=0)
    assert got.numpy().dtype == labels.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_shrink_is_antialiased_like_the_reference():
    """A linear shrink widens the triangle kernel by the scale factor;
    ``F.interpolate``'s trilinear mode does not, so it misses the
    reference where the port holds it."""
    vol = _vol((24, 24, 24), 2)
    out = (6, 8, 12)
    want = np.asarray(ref.resize(jnp.asarray(vol), out, order=1))
    got = resize.resize(torch.from_numpy(vol), out, order=1).numpy()
    plain = F.interpolate(torch.from_numpy(vol)[None, None], size=out,
                          mode="trilinear", align_corners=False)[0, 0]
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(plain.numpy() - want).max() > 0.05


def test_multichannel_resizes_spatial_axes_only():
    vol = _vol((8, 10, 12, 3), 3)
    want = np.asarray(ref.resize(jnp.asarray(vol), (16, 5, 12), order=1))
    got = resize.resize(torch.from_numpy(vol), (16, 5, 12), order=1)
    assert tuple(got.shape) == (16, 5, 12, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("scale,res", [
    (1.0, (2.0, 1.0, 1.0)), (0.5, (1.0, 0.5, 0.5)),
    ((1.0, 0.7, 0.7), (3.0, 1.0, 1.0))])
def test_make_isotropic_and_rescale_match_reference(scale, res):
    vol = _vol((10, 14, 12), 4)
    np.testing.assert_array_equal(resize.calc_isotropic_factor(scale, res),
                                  ref.calc_isotropic_factor(scale, res))
    for order in (0, 1):
        want = np.asarray(ref.make_isotropic(
            jnp.asarray(vol), scale, res, order=order))
        got = resize.make_isotropic(torch.from_numpy(vol), scale, res,
                                    order=order).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    factor = (0.5, 1.5, 1.0) if np.ndim(scale) else 0.6
    want = np.asarray(ref.rescale(jnp.asarray(vol), factor))
    got = resize.rescale(torch.from_numpy(vol), factor).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
