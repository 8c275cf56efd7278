"""The random walker, the distance watershed and the blob markers of
``magellanmapper_torch.cv.segmenter`` against the JAX reference, on the
CPU.

Tolerances: the walker's probabilities within ``PROB_ATOL`` = 1e-5 of the
reference's (200 conjugate-gradient steps whose sums reduce in another
order, and XLA fuses the updates into multiply-adds; measured ~2e-7);
its masks exactly, except at voxels whose reference probability lies
within ``PROB_ATOL`` of 0.5, which are counted (none on these fixtures);
watershed labels, markers and labelled components exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magellanmapper_tpu.cv import segmenter as ref_seg
from magellanmapper_torch import testing
from magellanmapper_torch.cv import segmenter

torch.set_num_threads(1)

PROB_ATOL = 1e-5


@pytest.fixture(scope="module")
def nuclei():
    vol, centres = testing.make_nuclei_volume((24, 64, 64), seed=0)
    blobs = np.zeros((len(centres), 4), np.float32)
    blobs[:, :3] = centres
    blobs[:, 3] = 3.0
    return vol.astype(np.float32), blobs


def _near_half(prob):
    return np.abs(prob - 0.5) <= PROB_ATOL


def _seeds(norm, kind):
    if kind == "thresholds":
        return norm >= 0.65, norm < 0.6
    rng = np.random.default_rng(1)
    fg = rng.random(norm.shape) < 0.002
    bg = (rng.random(norm.shape) < 0.01) & ~fg
    return fg, bg


@pytest.mark.parametrize("kind,beta,iters", [
    ("thresholds", 50.0, 200), ("sparse", 130.0, 200), ("sparse", 50.0, 7)])
def test_random_walker_cg_matches_reference(nuclei, kind, beta, iters):
    vol = nuclei[0]
    norm = vol / vol.max()
    fg, bg = _seeds(norm, kind)
    want = np.asarray(ref_seg._random_walker_cg(
        jnp.asarray(vol), jnp.asarray(fg), jnp.asarray(bg), beta, iters))
    got = segmenter._random_walker_cg(
        torch.from_numpy(vol), torch.from_numpy(fg), torch.from_numpy(bg),
        beta, iters).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)
    np.testing.assert_array_equal(got[fg], 1.0)
    np.testing.assert_array_equal(got[bg], 0.0)
    near = _near_half(want)
    print(f"voxels within {PROB_ATOL} of 0.5: {int(near.sum())}")
    assert np.array_equal((got >= 0.5)[~near], (want >= 0.5)[~near])


def _ref_probs(roi, channel=None, beta=50.0, vmin=0.6, vmax=0.65,
               blobs=None, **_):
    """The reference's foreground probability of each channel that
    ``segment_rw`` segments, seeded as it seeds them."""
    multichannel = roi.ndim > 3
    channels = (range(roi.shape[3]) if multichannel else [0]) \
        if channel is None else np.atleast_1d(channel)
    probs = []
    for chl in channels:
        seg = np.asarray(roi[..., chl] if multichannel else roi, np.float32)
        if blobs is None:
            fg, bg = seg >= vmax, seg < vmin
        else:
            fg = np.zeros(seg.shape, bool)
            coords = np.clip(blobs[:, :3].astype(int), 0,
                             np.asarray(seg.shape) - 1)
            fg[tuple(coords.T)] = True
            bg = (seg < np.percentile(seg, 25)) & ~fg
        probs.append(np.asarray(ref_seg._random_walker_cg(
            jnp.asarray(seg), jnp.asarray(fg), jnp.asarray(bg),
            float(beta))))
    return probs


def _assert_masks(got, want, prob):
    """Masks equal except where the reference's probability lies within
    ``PROB_ATOL`` of 0.5 (counted and printed)."""
    assert len(got) == len(want)
    for g, w, p in zip(got, want, prob):
        assert g.dtype == w.dtype and g.shape == w.shape
        near = _near_half(p)
        print(f"voxels within {PROB_ATOL} of 0.5: {int(near.sum())}")
        np.testing.assert_array_equal(g[~near], w[~near])


@pytest.mark.parametrize("kwargs", [
    {}, {"vmin": 0.3, "vmax": 0.5}, {"blobs": True},
    {"blobs": True, "remove_small": 30}, {"erosion": 1},
    {"get_labels": True}, {"blobs": True, "get_labels": True,
                           "remove_small": 5}])
def test_segment_rw_matches_reference(nuclei, kwargs):
    vol, blobs = nuclei
    roi = vol / vol.max()
    kw = dict(kwargs)
    if kw.pop("blobs", False):
        kw["blobs"] = blobs
    want = ref_seg.segment_rw(roi, **kw)
    got = segmenter.segment_rw(roi, device="cpu", **kw)
    _assert_masks(got, want, _ref_probs(roi, **kw))
    if not kwargs:
        assert np.any(got[0] == 1) and np.any(got[0] == 2)


def test_segment_rw_multichannel_matches_reference(nuclei):
    vol = nuclei[0] / nuclei[0].max()
    roi = np.stack([vol, np.roll(vol, 5, axis=2)], axis=-1)
    for channel in (None, [1]):
        want = ref_seg.segment_rw(roi, channel=channel)
        got = segmenter.segment_rw(roi, channel=channel, device="cpu")
        _assert_masks(got, want, _ref_probs(roi, channel=channel))


@pytest.mark.parametrize("kwargs", [
    {}, {"num_peaks": 5}, {"num_peaks": 0}, {"compactness": 0.5},
    {"markers": True}, {"mask": True, "compactness": 0.1}])
def test_watershed_distance_matches_reference(nuclei, kwargs):
    vol, blobs = nuclei
    fg = vol > np.percentile(vol, 85)
    kw = dict(kwargs)
    if kw.pop("markers", False):
        kw["markers"] = segmenter._markers_from_blobs(fg, blobs)
    if kw.pop("mask", False):
        kw["mask"] = np.roll(fg, 2, axis=1) | fg
    want = ref_seg.watershed_distance(fg, **kw)
    got = segmenter.watershed_distance(fg, device="cpu", **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert kw.get("num_peaks") == 0 or got.max() > 1


def test_watershed_distance_tie_order():
    """Plateau peaks of equal distance: the cut to ``num_peaks`` keeps
    numpy's ``argsort`` order."""
    fg = np.zeros((9, 24, 24), bool)
    for c in ((4, 5, 5), (4, 5, 17), (4, 17, 5), (4, 17, 17)):
        fg[tuple(slice(x - 3, x + 4) for x in c)] = True
    for n in (1, 2, 3):
        np.testing.assert_array_equal(
            segmenter.watershed_distance(fg, num_peaks=n, device="cpu"),
            ref_seg.watershed_distance(fg, num_peaks=n))


@pytest.mark.parametrize("kwargs", [
    {}, {"blobs": True}, {"thresholded": True}, {"channel": [0, 1]}])
def test_segment_ws_matches_reference(nuclei, kwargs):
    vol, blobs = nuclei
    kw = dict(kwargs)
    roi = vol
    if kw.pop("blobs", False):
        kw["blobs"] = blobs
    if kw.pop("thresholded", False):
        kw["thresholded"] = vol > np.percentile(vol, 90)
    if "channel" in kw:
        roi = np.stack([vol, np.roll(vol, 7, axis=1)], axis=-1)
    want = ref_seg.segment_ws(roi, **kw)
    got = segmenter.segment_ws(roi, device="cpu", **kw)
    assert got.dtype == want.dtype and got.max() > 1
    np.testing.assert_array_equal(got, want)


def test_markers_from_blobs_matches_reference(nuclei):
    vol, blobs = nuclei
    blobs = np.vstack([blobs, [[-3, 70, 2, 1], [5.9, 10.2, 63.99, 2]],
                       blobs[:2]])
    np.testing.assert_array_equal(
        segmenter._markers_from_blobs(vol, blobs),
        ref_seg._markers_from_blobs(vol, blobs))


@pytest.mark.parametrize("case", ["watershed", "signed", "single",
                                  "empty"])
def test_labels_to_markers_blob_matches_reference(nuclei, case):
    vol, blobs = nuclei
    if case == "watershed":
        labels = ref_seg.segment_ws(vol, blobs=blobs)
    elif case == "signed":
        rng = np.random.default_rng(4)
        ids = np.asarray([-7, -2, 0, 3, 9, 1000], np.int32)
        labels = ids[rng.integers(0, len(ids), (12, 20, 16))]
        labels[:, 10:] = np.abs(labels[:, 10:])
    elif case == "single":
        labels = np.zeros((7, 9, 11), np.int64)
        labels[2:5, 1:8, 3] = 4
        labels[6, 8, 10] = 4
    else:
        labels = np.zeros((5, 6, 7), np.int32)
    got = segmenter.labels_to_markers_blob(labels, device="cpu")
    want = ref_seg.labels_to_markers_blob(labels)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if case != "empty":
        assert np.any(got != 0)


def test_segmentation_entry_points_ask_for_the_card(nuclei):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    vol, blobs = nuclei
    fg = vol > np.percentile(vol, 90)
    for call in (lambda: segmenter.segment_rw(vol),
                 lambda: segmenter.segment_ws(vol),
                 lambda: segmenter.watershed_distance(fg),
                 lambda: segmenter.labels_to_markers_blob(fg.astype(int))):
        with pytest.raises(RuntimeError):
            call()
