"""Whole-image transform and preprocessing (``atlas/transformer``) of
``magellanmapper_torch`` against the JAX reference, on seeded images.

Tolerances: ``transpose_img``'s output within rtol 1e-6 (both resize in
float32 with the same weights and passes, the port's products summing in
another order), its shape, path and metadata equal, the metadata's
near-min/max (percentiles of that output) within rtol 1e-6; a plane swap
without rescaling exactly. ``preprocess_img``: rotate90 and remap
exactly; saturate and denoise within 1e-5 on values in [0, 1], the
preprocessing tests' tolerance (the reference forms its percentile ranks
in float32, and the blur and means sum in another order). The path and
modifier helpers, ``rotate_img`` and the order-0 rescale exactly; the
order-1 rescale within rtol 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from magellanmapper_tpu.atlas import transformer as ref_transformer
from magellanmapper_tpu.cv import cv_nd as ref_cv_nd
from magellanmapper_tpu.io import np_io as ref_np_io
from magellanmapper_torch import testing
from magellanmapper_torch.atlas import transformer
from magellanmapper_torch.cv import cv_nd
from magellanmapper_torch.io import np_io

torch.set_num_threads(1)

RTOL = 1e-6
PREPROC_ATOL = 1e-5


def _transpose_both(tmp_path, arr, res, **kwargs):
    """``transpose_img`` of the reference and of the port, each on its own
    copy of ``arr``; returns both outputs as ``(img5d, path)``."""
    outs = []
    for name, io, fn in (
            ("ref", ref_np_io, ref_transformer.transpose_img),
            ("port", np_io,
             lambda *a, **k: transformer.transpose_img(*a, device="cpu",
                                                       **k))):
        where = tmp_path / name
        where.mkdir()
        path = str(where / "vol.npy")
        io.write_npy(path, arr, resolutions=res)
        out = fn(path, **kwargs)
        outs.append((np_io.read_file(out), out))
    return outs


def _assert_same_output(want, got, exact=False):
    (want5d, want_path), (got5d, got_path) = want, got
    assert os.path.basename(got_path) == os.path.basename(want_path)
    assert got5d.img.shape == want5d.img.shape
    assert got5d.img.dtype == want5d.img.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(got5d.img, want5d.img)
    else:
        np.testing.assert_allclose(got5d.img, want5d.img, rtol=RTOL, atol=0)
    meta_got, meta_want = dict(got5d.meta), dict(want5d.meta)
    for key in ("near_min", "near_max"):
        np.testing.assert_allclose(meta_got.pop(key), meta_want.pop(key),
                                   rtol=RTOL, atol=0)
    assert meta_got == meta_want


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
@pytest.mark.parametrize("plane", [None, "xz", "yz"])
def test_transpose_img_matches_reference(tmp_path, plane, dtype):
    rng = np.random.default_rng(0)
    arr = (rng.random((1, 16, 32, 24)) * 1000).astype(dtype)
    want, got = _transpose_both(tmp_path, arr, [[2.0, 1.0, 0.5]],
                                plane=plane, rescale=0.5, chunk_z=7)
    _assert_same_output(want, got)


@pytest.mark.parametrize("plane", ["xz", "yz"])
def test_plane_swap_without_rescale_is_exact(tmp_path, plane):
    arr = np.random.default_rng(1).random((1, 8, 16, 24)).astype(np.float32)
    want, got = _transpose_both(tmp_path, arr, [[2.0, 1.0, 0.5]],
                                plane=plane)
    _assert_same_output(want, got, exact=True)


def test_transpose_img_target_size_channels_and_times(tmp_path):
    rng = np.random.default_rng(2)
    arr = rng.random((2, 12, 20, 18, 2)).astype(np.float32)
    want, got = _transpose_both(tmp_path, arr, [[1.0, 1.0, 1.0]],
                                plane="xz", target_size=(9, 7, 10),
                                chunk_z=4)
    _assert_same_output(want, got)
    # a transform that changes nothing returns the image itself
    path = str(tmp_path / "same.npy")
    np_io.write_npy(path, arr[0, ..., 0])
    assert transformer.transpose_img(path, device="cpu") == path


def test_transpose_pass2_in_column_blocks(tmp_path, monkeypatch):
    """Pass 2 (z) streams column blocks of the intermediate through the
    device; several blocks give the reference's result as one does."""
    arr = np.random.default_rng(3).random((1, 20, 30, 16)).astype(np.float32)
    monkeypatch.setattr(transformer, "PASS2_VOXELS", 20 * 16 * 2)
    want, got = _transpose_both(tmp_path, arr, [[1.0, 1.0, 1.0]],
                                rescale=0.4, chunk_z=6)
    _assert_same_output(want, got)


def test_transpose_img_mesh_raises(tmp_path):
    """``mesh=`` (ROADMAP item 10, now ported) in a world of one: the
    sharded resize writes the unsharded output within 1e-6."""
    arr = np.random.default_rng(5).random((1, 12, 14, 10)).astype(
        np.float32)
    paths = [str(tmp_path / f"{n}.npy") for n in ("plain", "mesh")]
    for path in paths:
        np_io.write_npy(path, arr, resolutions=[[2.0, 1.0, 1.0]])
    want = transformer.transpose_img(paths[0], rescale=0.5, device="cpu")
    with testing.world_of_one("cpu") as mesh:
        got = transformer.transpose_img(paths[1], rescale=0.5, mesh=mesh,
                                        device="cpu")
    a = np.load(np_io.make_filenames(want)[0])
    b = np.load(np_io.make_filenames(got)[0])
    assert a.shape == b.shape == (1, 6, 7, 5)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


@pytest.mark.parametrize("tasks", [
    ["saturate"], ["denoise"], ["remap"], ["rotate90"],
    ["saturate", "denoise", "rotate90"]])
def test_preprocess_img_matches_reference(tmp_path, tasks):
    vol = (np.random.default_rng(4).random((1, 10, 16, 18)) * 900).astype(
        np.float32)
    want = ref_transformer.preprocess_img(vol, tasks)
    got = transformer.preprocess_img(
        vol, tasks, out_path=str(tmp_path / "pre.npy"), device="cpu")
    assert got.shape == want.shape
    if set(tasks) <= {"remap", "rotate90"}:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=PREPROC_ATOL)
    np.testing.assert_array_equal(
        np_io.read_file(str(tmp_path / "pre.npy")).img, got)


def test_preprocess_img_per_channel():
    vol = np.random.default_rng(5).random((1, 6, 8, 10, 2)).astype(
        np.float32)
    for channel in (None, 1):
        want = ref_transformer.preprocess_img(vol, ["remap"],
                                              channel=channel)
        got = transformer.preprocess_img(vol, ["remap"], channel=channel,
                                         device="cpu")
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown"):
        transformer.preprocess_img(vol, ["sharpen"], device="cpu")


def test_path_and_modifier_helpers_copy():
    cases = [dict(scale=0.5), dict(scale=0.25, plane="yz"),
             dict(target_size=(10, 20, 30)), dict(plane="xz"),
             dict(plane="xy"), dict()]
    for kwargs in cases:
        for path in ("/d/brain.npy", "rel/x.ome.tif", "noext"):
            assert transformer.get_transposed_image_path(path, **kwargs) \
                == ref_transformer.get_transposed_image_path(path, **kwargs)
    for plane in ("xz", "yz"):
        assert transformer.make_modifier_plane(plane) == \
            ref_transformer.make_modifier_plane(plane)
    for scale in (0.25, 2, 1.5):
        assert transformer.make_modifier_scale(scale) == \
            ref_transformer.make_modifier_scale(scale)
    assert transformer.make_modifier_resized((4, 5, 6)) == \
        ref_transformer.make_modifier_resized((4, 5, 6))


def test_rotate_img_and_rescale_match_reference():
    rng = np.random.default_rng(6)
    img = rng.random((12, 14, 16)).astype(np.float32)
    labels = rng.integers(0, 5, img.shape).astype(np.int32)
    rotate = {"rotation": [(10, 0), (-5, 2)], "resize": False}
    np.testing.assert_array_equal(
        transformer.rotate_img(img, rotate),
        ref_transformer.rotate_img(img, rotate))
    np.testing.assert_array_equal(
        transformer.rotate_img(labels, dict(rotate, resize=True), order=0),
        ref_transformer.rotate_img(labels, dict(rotate, resize=True),
                                   order=0))
    for kwargs in (dict(scale=0.5), dict(target_size=(8, 9, 6))):
        got = transformer.Downsampler(labels, device="cpu").rescale(
            order=0, **kwargs)
        want = ref_transformer.Downsampler(labels).rescale(order=0,
                                                           **kwargs)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        got = transformer.Downsampler(img, device="cpu").rescale(**kwargs)
        want = ref_transformer.Downsampler(img).rescale(**kwargs)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    u16 = rng.integers(0, 60000, (6, 8, 2)).astype(np.uint16)
    got = cv_nd.rescale_resize(u16, 2.0, multichannel=True, order=0,
                               device="cpu")
    want = ref_cv_nd.rescale_resize(u16, 2.0, multichannel=True, order=0)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_remap_intensity_copy():
    roi = np.random.default_rng(7).normal(5, 2, (5, 6, 7)).astype(np.float32)
    np.testing.assert_array_equal(cv_nd.remap_intensity(roi),
                                  ref_cv_nd.remap_intensity(roi))
    flat = np.full((3, 3, 3), 2.0, np.float32)
    np.testing.assert_array_equal(cv_nd.remap_intensity(flat),
                                  ref_cv_nd.remap_intensity(flat))


def test_specimen_shrinks_back_to_its_pair(tmp_path):
    """``testing.make_specimen``: nuclei only in the pair's brain, seeded,
    the z lattice on multiples of 20; transformed at 1/factor it is the
    pair's shape again, in the port as in the reference."""
    from magellanmapper_torch import testing
    from magellanmapper_torch.atlas import gauntlet

    pair = gauntlet.build_pair((20, 28, 28), seed=0, device="cpu",
                               ffd_spacing=16.0, ffd_ctrl_sigma=3.0)
    vol, centres = testing.make_specimen(pair, 4, 0, device="cpu")
    again, _ = testing.make_specimen(pair, 4, 0, device="cpu")
    np.testing.assert_array_equal(vol, again)
    assert vol.shape == (80, 112, 112) and vol.dtype == np.uint16
    assert len(centres) > 0
    assert np.all(pair["labels_fixed_gt"][tuple((centres // 4).T)] > 0)
    z_off = (centres[:, 0] + 10) % 20 - 10
    assert np.all(np.abs(z_off) <= 4)
    assert vol[tuple(centres.T)].min() > vol.mean()
    want, got = _transpose_both(tmp_path, vol, [[1.0, 1.0, 1.0]],
                                rescale=0.25)
    assert got[0].img.shape == (1,) + pair["fixed"].shape
    _assert_same_output(want, got)


def test_specimen_z_phases_spread_the_nuclei_over_every_plane():
    """``testing.make_specimen(z_lattice=False)``: each (y, x) column of
    the lattice at its own z phase, so centres fall between the
    lattice's planes too, still 12 planes or more apart in a column, in
    the brain and seeded; y and x keep the lattice's offset."""
    from magellanmapper_torch import testing
    from magellanmapper_torch.atlas import gauntlet

    pair = gauntlet.build_pair((20, 28, 28), seed=0, device="cpu",
                               ffd_spacing=16.0, ffd_ctrl_sigma=3.0)
    vol, centres = testing.make_specimen(pair, 4, 0, device="cpu",
                                         z_lattice=False)
    again, _ = testing.make_specimen(pair, 4, 0, device="cpu",
                                     z_lattice=False)
    np.testing.assert_array_equal(vol, again)
    assert vol.shape == (80, 112, 112) and vol.dtype == np.uint16
    assert np.all(pair["labels_fixed_gt"][tuple((centres // 4).T)] > 0)
    assert np.all((centres[:, 0] >= 16) & (centres[:, 0] < 74))
    # the lattice keeps every centre within 4 planes of a multiple of 20
    z_off = (centres[:, 0] + 10) % 20 - 10
    assert np.mean(np.abs(z_off) > 4) > 0.25
    yx_off = (centres[:, 1:] % 20) - 10
    assert np.all(np.abs(yx_off) <= 4)
    for yx in np.unique(centres[:, 1:] // 20, axis=0):
        col = np.sort(centres[np.all(centres[:, 1:] // 20 == yx, 1), 0])
        assert np.all(np.diff(col) >= 12)
    assert vol[tuple(centres.T)].min() > vol.mean()
