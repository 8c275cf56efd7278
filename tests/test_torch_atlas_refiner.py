"""``magellanmapper_torch.atlas.atlas_refiner`` and the atlas-refinement
functions of ``cv.cv_nd`` against ``magellanmapper_tpu``, on a
one-sided atlas of 12 regions and on the reference's tapering lateral
columns.

Held exactly: truncated, mirrored and extended labels and the symmetry
checks; smoothed labels in every mode and their metrics tables; curated
atlas and labels and their metrics; the files ``import_atlas`` writes
(byte for byte); bounding boxes, crops, structuring elements, zero
crossings, exteriors, surface areas and compactness; lost labels and
foregrounds. Resized images (``transpose_img``) within 1e-6 relative, the
clipped LoG image within 1e-6 relative to its range (its percentiles are
numpy's of the port's own LoG, which sums in another order).
"""

import filecmp
import os

import numpy as np
import pandas as pd
import pytest
import torch

from magellanmapper_tpu.atlas import atlas_refiner as ref
from magellanmapper_tpu.atlas import gauntlet as ref_gauntlet
from magellanmapper_tpu.cv import cv_nd as ref_cv_nd
from magellanmapper_tpu.io import sitk_io as ref_sitk
from magellanmapper_tpu.settings import atlas_prof as ref_prof
from magellanmapper_torch.atlas import atlas_refiner
from magellanmapper_torch.cv import cv_nd
from magellanmapper_torch.io import sitk_io
from magellanmapper_torch.settings import atlas_prof

torch.set_num_threads(1)

LOG_RTOL = 1e-6


@pytest.fixture(scope="module")
def one_sided():
    """A (32, 36, 30) brain of 12 regions, its intensity in counts,
    labelled on its first half only, the two outermost labelled planes
    cleared."""
    intensity, labels = ref_gauntlet.make_anatomy((32, 36, 30), n_labels=12,
                                                  n_blobs=30, seed=2)
    atlas = (intensity * 100).astype(np.float32)
    atlas[16:] = atlas[15::-1]
    labels = labels.astype(np.int32)
    labels[16:] = 0
    first = int(np.flatnonzero(labels.reshape(32, -1).any(axis=1))[0])
    labels[first:first + 2] = 0
    return atlas, labels


def test_truncate_and_mirror_match_reference(one_sided):
    atlas, labels = one_sided
    for frac in (dict(x_frac=(0.2, 0.8)), dict(z_frac=(0.1, 0.7),
                                               y_frac=(0.3, 1.0))):
        np.testing.assert_array_equal(
            atlas_refiner.truncate_labels(np.array(labels), **frac),
            ref.truncate_labels(np.array(labels), **frac))
    for kw in (dict(start=16, mirror_mult=-1), dict(start=12),
               dict(start=20, mirror_mult=-1),
               dict(start=16, start_dup=0.2, mirror_mult=-1),
               dict(start=16, start_dup=0.2, rand_dup=3),
               dict(start=10, resize=False, mirror_mult=-1)):
        got = atlas_refiner.mirror_planes(np.array(labels), **kw)
        want = ref.mirror_planes(np.array(labels), **kw)
        np.testing.assert_array_equal(got, want)
        mult = kw.get("mirror_mult", 1)
        assert atlas_refiner.check_mirrorred(got, mult) == \
            ref.check_mirrorred(want, mult)
        assert atlas_refiner.find_symmetric_axis(got, mult) == \
            ref.find_symmetric_axis(want, mult)


@pytest.mark.parametrize("in_paint", [True, False])
@pytest.mark.parametrize("start", [0, 4, 12])
def test_extend_edge_matches_reference(one_sided, in_paint, start):
    atlas, labels = one_sided
    got = atlas_refiner.extend_edge(labels, atlas, 10.0, start,
                                    in_paint=in_paint, device="cpu")
    want = ref.extend_edge(labels, atlas, 10.0, start, in_paint=in_paint)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, labels)


def test_extend_edge_tapering_columns_match_reference():
    """The reference's lateral-recursion fixture
    (``tests/test_atlas.py::TestExtendEdgeLateral``)."""
    shape = (8, 40, 40)
    atlas = np.zeros(shape, np.float32)
    labels = np.zeros(shape, np.int32)
    for z in range(shape[0]):
        r = 4 + z
        atlas[z, 10 - r // 2:10 + r // 2, 8 - r // 2:8 + r // 2] = 1.0
        atlas[z, 28 - r // 2:28 + r // 2, 30 - r // 2:30 + r // 2] = 1.0
    labels[4:, 4:16, 2:14] = 7
    labels[4:, 22:34, 24:36] = 9
    labels[atlas <= 0.5] = 0
    got = atlas_refiner.extend_edge(labels, atlas, 0.5, 0, device="cpu")
    np.testing.assert_array_equal(got, ref.extend_edge(labels, atlas, 0.5, 0))
    np.testing.assert_array_equal(
        atlas_refiner._resize_nearest2d(labels[5], (7, 13)),
        ref._resize_nearest2d(labels[5], (7, 13)))


@pytest.mark.parametrize("mode,size", [("opening", 2), ("opening", 1),
                                       ("gaussian", 1), ("closing", 1),
                                       ("opening", 0)])
def test_smooth_labels_matches_reference(one_sided, mode, size):
    _, labels = one_sided
    noisy = np.array(labels)
    noisy[8, 3, 3] = 4
    noisy[10, 20:22, 5] = 9
    got, want = np.array(noisy), np.array(noisy)
    got_tabs = atlas_refiner.smooth_labels(got, size, mode, metrics=True,
                                           device="cpu")
    want_tabs = ref.smooth_labels(want, size, mode, metrics=True)
    np.testing.assert_array_equal(got, want)
    if not size:
        assert got_tabs == want_tabs == (None, None)
        return
    assert not np.array_equal(got, noisy)
    for g, w in zip(got_tabs, want_tabs):
        pd.testing.assert_frame_equal(g, w)


def test_smooth_labels_rejects_unknown_mode(one_sided):
    with pytest.raises(ValueError, match="unknown smoothing mode"):
        atlas_refiner.smooth_labels(np.array(one_sided[1]), 2, "median",
                                    device="cpu")


def test_label_smoothing_metric_matches_reference(one_sided):
    _, labels = one_sided
    smoothed = np.array(labels)
    smoothed[smoothed == 5] = 0           # a label lost
    smoothed[6:9][labels[6:9] == 2] = 7   # and one grown
    got = atlas_refiner.label_smoothing_metric(labels, smoothed, 3,
                                               (1.0, 2.0, 0.5), "cpu")
    want = ref.label_smoothing_metric(labels, smoothed, 3, (1.0, 2.0, 0.5))
    for g, w in zip(got, want):
        pd.testing.assert_frame_equal(g, w)


def test_overlaps_and_transpose_match_reference(one_sided):
    atlas, labels = one_sided
    assert atlas_refiner.measure_overlap_labels(
        labels, labels[::-1], "cpu") == ref.measure_overlap_labels(
        labels, labels[::-1])
    med = sitk_io.MedImage(atlas, (2.0, 1.0, 0.5))
    ref_med = ref_sitk.MedImage(atlas, (2.0, 1.0, 0.5))
    for kw in (dict(rescale=0.5), dict(plane="xz", target_size=(20, 16, 18)),
               dict(plane="yz", rotate_deg=10), dict(rescale=2, order=0)):
        got = atlas_refiner.transpose_img(med, device="cpu", **kw)
        want = ref.transpose_img(ref_med, **kw)
        assert got.img.dtype == want.img.dtype
        np.testing.assert_allclose(got.img, want.img, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.spacing, want.spacing)


@pytest.mark.parametrize("names", ["abap56", "abap56,smooth2", "abaccfv3",
                                   "abae11pt5", "nomirror,edge"])
def test_match_atlas_labels_matches_reference(one_sided, names):
    atlas, labels = one_sided
    prof, want_prof = atlas_prof.AtlasProfile(), ref_prof.AtlasProfile()
    prof.add_profiles(names)
    want_prof.add_profiles(names)
    got_a, got_l, got_m = atlas_refiner.match_atlas_labels(
        sitk_io.MedImage(atlas), sitk_io.MedImage(labels), prof, "cpu")
    want_a, want_l, want_m = ref.match_atlas_labels(
        ref_sitk.MedImage(atlas), ref_sitk.MedImage(labels), want_prof)
    np.testing.assert_array_equal(got_a.img, want_a.img)
    np.testing.assert_array_equal(got_l.img, want_l.img)
    assert got_m == pytest.approx(want_m, rel=1e-6, nan_ok=True)


def test_import_atlas_files_match_reference(one_sided, tmp_path):
    atlas, labels = one_sided
    for name in ("ref", "port"):
        d = tmp_path / name / "atlas"
        d.mkdir(parents=True)
        for fname, arr in (("atlasVolume", atlas), ("annotation", labels)):
            sitk_io.write_med_img(str(d / f"{fname}.mhd"),
                                  sitk_io.MedImage(arr, (0.025,) * 3))
    prof, want_prof = atlas_prof.AtlasProfile(), ref_prof.AtlasProfile()
    prof.add_profiles("abap56")
    want_prof.add_profiles("abap56")
    got = atlas_refiner.import_atlas(str(tmp_path / "port" / "atlas"), prof,
                                     device="cpu")
    want = ref.import_atlas(str(tmp_path / "ref" / "atlas"), want_prof)
    assert sorted(got) == sorted(want)
    for key, path in want.items():
        assert os.path.basename(got[key]) == os.path.basename(path)
        pairs = [(got[key], path)]
        if path.endswith(".mhd"):
            pairs.append((got[key][:-4] + ".raw", path[:-4] + ".raw"))
        for a, b in pairs:
            assert filecmp.cmp(a, b, shallow=False), b
    imported = sitk_io.read_med_img(got["annotation.mhd"]).img
    assert atlas_refiner.check_mirrorred(imported, -1)[0]


def test_crop_to_orig_and_label_sets_match_reference(one_sided):
    _, labels = one_sided
    grown = np.where(labels == 0, 3, labels).astype(np.int32)
    for crop in (False, 0, 1, 2):
        got, want = np.array(grown), np.array(grown)
        atlas_refiner.crop_to_orig(labels, got, crop, device="cpu")
        ref.crop_to_orig(labels, want, crop)
        np.testing.assert_array_equal(got, want)
    ids = np.unique(labels)
    np.testing.assert_array_equal(
        atlas_refiner.find_labels_lost(ids, ids[::2], labels),
        ref.find_labels_lost(ids, ids[::2], labels))
    np.testing.assert_array_equal(atlas_refiner.make_labels_fg(labels),
                                  ref.make_labels_fg(labels))


def test_refinement_measures_match_reference(one_sided, tmp_path):
    atlas, labels = one_sided
    df_pxs = pd.DataFrame({
        "Filter_size": [1, 2, 3], "Compaction": [0.1, np.nan, 0.3],
        "Displacement": [0.2, 0.1, 0.05], "Vol_orig": [10, 20, 30]})
    for df in (df_pxs, df_pxs.drop(columns="Vol_orig")):
        pd.testing.assert_frame_equal(
            atlas_refiner.aggr_smoothing_metrics(df),
            ref.aggr_smoothing_metrics(df))
    for prof in (None, "x"):
        kw = {}
        if prof:
            kw = {"atlas_profile": ref_prof.AtlasProfile()}
        got = atlas_refiner.measure_atlas_refinement(
            {"Steps": [1]}, atlas, labels, path=str(tmp_path / "m.csv"),
            device="cpu", **({"atlas_profile": atlas_prof.AtlasProfile()}
                             if prof else {}))
        want = ref.measure_atlas_refinement({"Steps": [1]}, atlas, labels,
                                            **kw)
        pd.testing.assert_frame_equal(got, want, check_exact=False,
                                      rtol=1e-6)
    assert (tmp_path / "m.csv").is_file()


# -- cv_nd -------------------------------------------------------------------

def test_boxes_selems_and_crops_match_reference(one_sided):
    atlas, labels = one_sided
    for ndim, r in ((3, 2), (2, 3), (3, 1)):
        np.testing.assert_array_equal(cv_nd.get_selem(ndim)(r),
                                      ref_cv_nd.get_selem(ndim)(r))
    ids = np.unique(labels)
    boxes = cv_nd.label_bboxes(torch.from_numpy(labels),
                               torch.from_numpy(ids))
    for lid, box in zip(ids, boxes):
        want = ref_cv_nd.get_label_bbox(labels, lid)
        assert cv_nd.get_label_bbox(labels, lid) == want
        assert list(box) == want
        assert cv_nd.mask_bbox(torch.from_numpy(labels == lid)) == want
        assert cv_nd.get_bbox_region(want, 3, labels.shape) == \
            ref_cv_nd.get_bbox_region(want, 3, labels.shape)
    assert cv_nd.get_label_bbox(labels, [4, 7]) == \
        ref_cv_nd.get_label_bbox(labels, [4, 7])
    assert cv_nd.get_label_bbox(labels, 999) is None
    assert cv_nd.mask_bbox(torch.zeros(3, 4, 5, dtype=torch.bool)) is None
    for kw in ({}, {"dil_size": 0}, {"padding": 1}):
        got = cv_nd.crop_to_labels(atlas, labels, device="cpu", **kw)
        want = ref_cv_nd.crop_to_labels(atlas, labels, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_surface_and_shell_match_reference(one_sided):
    _, labels = one_sided
    mask = labels == 4
    np.testing.assert_array_equal(cv_nd.exterior_nd(mask, device="cpu"),
                                  ref_cv_nd.exterior_nd(mask))
    np.testing.assert_array_equal(
        cv_nd.exterior_nd(mask[10], device="cpu"),
        ref_cv_nd.exterior_nd(mask[10]))
    for spacing in ((1.0, 1.0, 1.0), (2.0, 0.5, 1.5)):
        assert cv_nd.surface_area_3d(mask, spacing) == \
            ref_cv_nd.surface_area_3d(mask, spacing)
        assert cv_nd.compactness_3d(mask, spacing) == \
            ref_cv_nd.compactness_3d(mask, spacing)


def test_log_image_and_zero_crossings_match_reference(one_sided):
    atlas, labels = one_sided
    for kw in ({"labels_img": labels}, {"thresh": 20.0}, {}):
        got = cv_nd.laplacian_of_gaussian_img(atlas, 2.0, device="cpu",
                                              **kw)
        want = ref_cv_nd.laplacian_of_gaussian_img(atlas, 2.0, **kw)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=0, atol=LOG_RTOL * np.ptp(
            want))
    rng = np.random.default_rng(0)
    field = rng.normal(size=(9, 10, 11)).astype(np.float32)
    for fs in (1, 2):
        np.testing.assert_array_equal(
            cv_nd.zero_crossing(field, fs, device="cpu"),
            ref_cv_nd.zero_crossing(field, fs))
        np.testing.assert_array_equal(
            cv_nd.zero_crossing(field[4], fs, device="cpu"),
            ref_cv_nd.zero_crossing(field[4], fs))
    assert cv_nd.zero_crossing_t(torch.from_numpy(field)).dtype == \
        torch.bool
