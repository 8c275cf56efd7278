"""``magellanmapper_torch.cv.segmenter`` and the binary morphology of
``ops.filters`` against ``magellanmapper_tpu`` and ``scipy.ndimage``.

Everything here is held exactly: the watershed (labels, for every
compactness and sweep cap, the host checking for a fixpoint once every
16 sweeps), the markers and stats of the per-label erosion (one erosion
of the whole labels image a radius on the device, where the reference
erodes each label's box with scipy), the binary erosion, dilation,
opening and closing (bit for bit scipy's: a zero border, one iteration),
the grayscale erosion and dilation with the reference's symmetric
border, and the watershed of labels onto edges through every mask
route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from magellanmapper_tpu.atlas import gauntlet as ref_gauntlet
from magellanmapper_tpu.cv import segmenter as ref
from magellanmapper_tpu.ops import filters as ref_filters
from magellanmapper_torch.cv import cv_nd, segmenter
from magellanmapper_torch.ops import filters

torch.set_num_threads(1)

SHAPE = (28, 36, 32)


@pytest.fixture(scope="module")
def anatomy():
    """A brain of 12 regions (a nearest-seed partition), one of them cut
    to a 2-voxel slab that no ball keeps, and the far half's IDs negated
    as in a mirrored atlas; its intensity."""
    intensity, labels = ref_gauntlet.make_anatomy(SHAPE, n_labels=12,
                                                  n_blobs=30, seed=4)
    labels = labels.astype(np.int32)
    labels[labels == 3] = 0
    labels[12:14][labels[12:14] == 5] = 3
    labels[SHAPE[0] // 2:] *= -1
    return intensity.astype(np.float32), labels


def _edges(intensity, labels):
    log = ndimage.gaussian_laplace(intensity, 1.5)
    edges = (ndimage.minimum_filter(log, 3, mode="mirror") < 0) & (
        ndimage.maximum_filter(log, 3, mode="mirror") > 0)
    return (edges & (labels != 0)).astype(np.uint8)


@pytest.mark.parametrize("compactness", [0.0, 0.005, 0.1])
def test_watershed_matches_reference(anatomy, compactness):
    intensity, labels = anatomy
    rng = np.random.default_rng(1)
    elevation = ndimage.gaussian_filter(rng.random(SHAPE), 2).astype(
        np.float32)
    markers = np.zeros(SHAPE, np.int32)
    seeds = rng.integers(0, SHAPE, (20, 3))
    markers[tuple(seeds.T)] = np.arange(1, 21)
    markers[0, 0, 0] = -4   # not a seed: only IDs > 0 flood
    mask = labels != 0
    got = segmenter.watershed(elevation, markers, mask, compactness,
                              device="cpu")
    want = ref.watershed(elevation, markers, mask, compactness)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    edges = _edges(intensity, labels)
    np.testing.assert_array_equal(
        segmenter.watershed(edges == 0, labels, None, compactness,
                            device="cpu"),
        ref.watershed(edges == 0, labels, None, compactness))


@pytest.mark.parametrize("max_iters", [1, 5, 16, 17, 33, 4096])
def test_watershed_sweep_cap_matches_reference(anatomy, max_iters):
    intensity, labels = anatomy
    edges = _edges(intensity, labels)
    markers = np.where(ndimage.binary_erosion(labels != 0, iterations=3),
                       labels, 0)
    markers[markers < 0] *= -1
    mask = labels != 0
    got, sweeps = segmenter._watershed_flood(
        torch.from_numpy((edges == 0).astype(np.float32)),
        torch.from_numpy(markers), torch.from_numpy(mask), 0.005, max_iters)
    want = ref._watershed_flood(
        jnp.asarray(edges == 0, jnp.float32), jnp.asarray(markers),
        jnp.asarray(mask), 0.005, max_iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 1 <= sweeps <= max_iters
    if sweeps < max_iters:
        # the sweep that found nothing to change followed the fixpoint:
        # one sweep fewer gives the same labels
        again, n = segmenter._watershed_flood(
            torch.from_numpy((edges == 0).astype(np.float32)),
            torch.from_numpy(markers), torch.from_numpy(mask), 0.005,
            sweeps - 1)
        assert n == sweeps - 1
        np.testing.assert_array_equal(again.numpy(), got.numpy())
    else:
        assert sweeps == max_iters


@pytest.mark.parametrize("filter_size,min_size,use_min", [
    (8, None, False), (4, None, False), (4, 1, False), (3, None, True),
    (2, 2, False), (0, None, False)])
def test_labels_to_markers_erosion_matches_reference(
        anatomy, filter_size, min_size, use_min):
    _, labels = anatomy
    got, stats = segmenter.labels_to_markers_erosion(
        labels, filter_size, min_size, use_min, device="cpu")
    want, want_stats = ref.labels_to_markers_erosion(
        labels, filter_size, min_size, use_min)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert stats == want_stats
    facade = segmenter.LabelToMarkerErosion(labels).erode_labels(
        filter_size, min_filter_size=min_size, use_min_filter=use_min,
        device="cpu")
    np.testing.assert_array_equal(facade[0], want)


def test_labels_to_markers_erosion_2d(anatomy):
    _, labels = anatomy
    plane = np.ascontiguousarray(labels[10])
    got, stats = segmenter.labels_to_markers_erosion(plane, 3, device="cpu")
    want, want_stats = ref.labels_to_markers_erosion(plane, 3)
    np.testing.assert_array_equal(got, want)
    assert stats == want_stats


def _masks(seed, shape):
    rng = np.random.default_rng(seed)
    mask = ndimage.gaussian_filter(rng.random(shape), 1.5) > 0.5
    mask[0] = mask[:, -1] = True     # touching the border
    return mask


@pytest.mark.parametrize("op", ["erosion", "dilation", "opening",
                                "closing"])
@pytest.mark.parametrize("radius", [1, 2, 3, 5])
def test_binary_morphology_is_scipy(op, radius):
    mask = _masks(radius, (13, 19, 17))
    ball = filters.ball_footprint(radius)
    got = getattr(filters, f"binary_{op}")(torch.from_numpy(mask), ball)
    want = getattr(ndimage, f"binary_{op}")(mask, structure=ball)
    np.testing.assert_array_equal(got.numpy(), want)
    disk = cv_nd.get_selem(2)(radius)
    got = getattr(filters, f"binary_{op}")(torch.from_numpy(mask[6]), disk)
    np.testing.assert_array_equal(
        got.numpy(), getattr(ndimage, f"binary_{op}")(mask[6],
                                                      structure=disk))


def test_binary_morphology_asymmetric_structure():
    st = np.zeros((3, 5, 3), bool)
    st[1, 2, 1:] = st[2, 2, 1] = st[1, 0, 0:2] = st[0, 1:4, 1] = True
    mask = _masks(7, (11, 12, 13))
    for op in ("erosion", "dilation"):
        got = getattr(filters, f"binary_{op}")(torch.from_numpy(mask), st)
        np.testing.assert_array_equal(
            got.numpy(), getattr(ndimage, f"binary_{op}")(mask,
                                                          structure=st))
    holes = np.ones((3, 3, 3), bool)
    holes[1, 1, 1] = False
    with pytest.raises(ValueError, match="one run"):
        filters.binary_erosion(torch.from_numpy(mask), holes)


@pytest.mark.parametrize("maximum", [False, True])
def test_window_reduce_is_a_brute_force_min_max(maximum):
    rng = np.random.default_rng(2)
    vol = rng.integers(0, 9, (9, 10, 11)).astype(np.float32)
    ball = filters.ball_footprint(2)
    got = filters.window_reduce(torch.from_numpy(vol), ball, maximum,
                                fill=-1.0).numpy()
    padded = np.pad(vol, 2, constant_values=-1.0)
    terms = [padded[dz:dz + 9, dy:dy + 10, dx:dx + 11]
             for dz, dy, dx in np.argwhere(ball)]
    want = np.max(terms, axis=0) if maximum else np.min(terms, axis=0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("footprint", ["ball2", "cube3", "octahedron"])
def test_grayscale_morphology_matches_reference(footprint):
    fp = {"ball2": filters.ball_footprint(2),
          "cube3": filters.cube_footprint(3),
          "octahedron": filters.octahedron_footprint(1)}[footprint]
    np.testing.assert_array_equal(fp, {
        "ball2": ref_filters.ball_footprint(2),
        "cube3": ref_filters.cube_footprint(3),
        "octahedron": ref_filters.octahedron_footprint(1)}[footprint])
    vol = np.random.default_rng(3).normal(size=(7, 9, 8)).astype(np.float32)
    for name in ("erosion", "dilation"):
        got = getattr(filters, name)(torch.from_numpy(vol), fp)
        want = getattr(ref_filters, name)(jnp.asarray(vol), fp)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mask_atlas_matches_reference(anatomy):
    intensity, labels = anatomy
    np.testing.assert_array_equal(
        segmenter.mask_atlas(intensity, labels, device="cpu"),
        ref.mask_atlas(intensity, labels))


@pytest.mark.parametrize("route", ["labels_opening", "labels_closing",
                                   "atlas_and_labels"])
def test_segment_from_labels_matches_reference(anatomy, route):
    intensity, labels = anatomy
    edges = _edges(intensity, labels)
    markers, _ = ref.labels_to_markers_erosion(labels, 3)
    kw = {}
    if route == "labels_closing":
        kw = {"mask_filt": "closing", "mask_filt_size": 1}
    elif route == "atlas_and_labels":
        kw = {"atlas_img": intensity}
    got = segmenter.segment_from_labels(edges, markers, labels,
                                        device="cpu", **kw)
    want = ref.segment_from_labels(edges, markers, labels, **kw)
    np.testing.assert_array_equal(got, want)


def test_segment_from_labels_exclude_labels_pin(anatomy):
    """The reference writes the excluded labels back into its watershed's
    read-only result and raises (``segmenter.py:373-374``); the port
    keeps them, and elsewhere equals the reference's watershed of the
    same markers within the mask less the excluded labels."""
    intensity, labels = anatomy
    edges = _edges(intensity, labels)
    markers, _ = ref.labels_to_markers_erosion(labels, 3)
    exclude = [2, -7]
    with pytest.raises(ValueError, match="read-only"):
        ref.segment_from_labels(edges, markers, labels,
                                exclude_labels=exclude)
    got = segmenter.segment_from_labels(edges, markers, labels,
                                        exclude_labels=exclude,
                                        device="cpu")
    excluded = np.isin(labels, exclude)
    mask = ndimage.binary_opening(labels != 0, structure=cv_nd.get_selem(
        3)(2)) & ~excluded
    kept = np.where(np.isin(markers, exclude), 0, markers)
    want = np.array(ref.watershed(edges == 0, kept, mask=mask,
                                  compactness=0.005))
    want[excluded] = labels[excluded]
    np.testing.assert_array_equal(got, want)


def test_fma32_is_the_reference_fused_multiply_add():
    """``_fma32`` equals the reference's compiled ``cost + c * d2`` (XLA
    fuses it into one multiply-add on the CPU) on random values, integer
    distances, exact ties and infinities."""
    import jax

    rng = np.random.default_rng(5)
    x = np.concatenate([rng.integers(0, 5000, 4000).astype(np.float32),
                        rng.random(4000).astype(np.float32) * 50])
    y = np.concatenate([rng.random(4000).astype(np.float32) * 30,
                        rng.integers(0, 3, 4000).astype(np.float32)])
    y[::97] = np.inf
    for c in (0.005, 0.1, 1e-7, 3.0):
        want = jax.jit(lambda a, b: b + jnp.float32(c) * a)(
            jnp.asarray(x), jnp.asarray(y))
        got = segmenter._fma32(c, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the exact value rounded once
    got = segmenter._fma32(0.005, torch.tensor([3.0]), torch.tensor([1.0]))
    exact = float(np.float32(0.005)) * 3.0 + 1.0
    assert float(got) == float(np.float32(exact))


def test_sub_segmenter_matches_reference(anatomy):
    intensity, labels = anatomy
    edges = _edges(intensity, labels)
    want = ref.sub_segment_labels(labels, edges)
    np.testing.assert_array_equal(
        segmenter.sub_segment_labels(labels, edges, device="cpu"), want)
    np.testing.assert_array_equal(
        segmenter.SubSegmenter(labels, edges, "cpu").sub_segment(100),
        ref.SubSegmenter(labels, edges).sub_segment(100))
