"""The rest of ``cv/cv_nd`` (border and signed distances, radial
distances, adaptive filtering, contour interpolation, shears and
rotations, region properties, compactness, thresholded regions, the
surface-net mesh) and the host helpers of ``cv/detector``, ``cv/blobs``,
``cv/colocalizer`` and ``cv/verifier`` of ``magellanmapper_torch`` against
the JAX reference, on the CPU.

Tolerances: masks, labels, indices, meshes (vertex and face order
included), blobs and counts exactly; distances exactly (the same
jump-flooding transform and float32 square roots); float64 host results
exactly (the same numpy calls).
"""


import numpy as np
import pytest
import torch
from scipy import ndimage as scipy_ndi

from magellanmapper_tpu.cv import blobs as ref_blobs
from magellanmapper_tpu.cv import colocalizer as ref_coloc
from magellanmapper_tpu.cv import cv_nd as ref_nd
from magellanmapper_tpu.cv import detector as ref_detector
from magellanmapper_tpu.cv import verifier as ref_verifier
from magellanmapper_tpu.io import sqlite as ref_sqlite
from magellanmapper_torch import testing
from magellanmapper_torch.cv import blobs, colocalizer, cv_nd, detector
from magellanmapper_torch.cv import verifier
from magellanmapper_torch.io import sqlite

torch.set_num_threads(1)


def _masks(shape=(12, 20, 18), seed=0):
    rng = np.random.default_rng(seed)
    fg = scipy_ndi.gaussian_filter(rng.random(shape), 2) > 0.5
    return fg, np.roll(fg, (1, 2), axis=(1, 2))


def _perim(mask):
    return ref_nd.perimeter_nd(mask)


@pytest.mark.parametrize("kwargs", [
    {}, {"spacing": (2.0, 1.0, 0.5)}, {"filter_size": 3},
    {"mask": True, "filter_size": 2}])
def test_borders_distance_matches_reference(kwargs):
    fg, shifted = _masks()
    kw = dict(kwargs)
    if kw.pop("mask", False):
        kw["mask_orig"] = fg
    got = cv_nd.borders_distance(_perim(fg), _perim(shifted), device="cpu",
                                 **kw)
    want = ref_nd.borders_distance(_perim(fg), _perim(shifted), **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("borders,indices", [(True, False), (False, True),
                                             (True, True)])
def test_signed_distance_transform_matches_reference(borders, indices):
    fg, _ = _masks(seed=1)
    b = _perim(fg) if borders else None
    got = cv_nd.signed_distance_transform(
        b, fg, return_indices=indices, spacing=(1.0, 2.0, 1.0),
        device="cpu")
    want = ref_nd.signed_distance_transform(
        b, fg, return_indices=indices, spacing=(1.0, 2.0, 1.0))
    for g, w in zip(got if indices else [got], want if indices else [want]):
        np.testing.assert_array_equal(g, w)


def test_radial_distances_match_reference():
    fg, shifted = _masks(seed=2)
    b0, b1 = _perim(fg), _perim(shifted)
    cent = (5.5, 9.25, 8.0)
    np.testing.assert_array_equal(cv_nd.radial_dist(b0, cent),
                                  ref_nd.radial_dist(b0, cent))
    r0, r1 = cv_nd.radial_dist_map(b0, cent), cv_nd.radial_dist_map(b1, cent)
    np.testing.assert_array_equal(r0, ref_nd.radial_dist_map(b0, cent))
    _, idx, _ = ref_nd.borders_distance(b0, b1)
    np.testing.assert_array_equal(
        cv_nd.radial_dist_diff(r0, r1, idx),
        ref_nd.radial_dist_diff(ref_nd.radial_dist_map(b0, cent),
                                ref_nd.radial_dist_map(b1, cent), idx))


@pytest.mark.parametrize("selem", [np.ones((3, 3, 3), bool),
                                   np.ones((1, 5, 3), bool)])
def test_remove_bg_from_dil_fg_matches_reference(selem):
    fg, _ = _masks(seed=3)
    fg &= np.random.default_rng(3).random(fg.shape) > 0.8
    img = np.random.default_rng(4).random(fg.shape).astype(np.float32)
    got, want = img.copy(), img.copy()
    cv_nd.remove_bg_from_dil_fg(got, fg, selem, device="cpu")
    ref_nd.remove_bg_from_dil_fg(want, fg, selem)
    np.testing.assert_array_equal(got, want)
    assert np.any(got == 0) and np.any(got != 0)


@pytest.mark.parametrize("fn,size,ratio", [
    (scipy_ndi.binary_erosion, 4, 0.2), (scipy_ndi.binary_opening, 3, 0.5),
    (scipy_ndi.binary_erosion, 6, 0.99)])
def test_filter_adaptive_size_matches_reference(fn, size, ratio):
    for mask in (_masks(seed=5)[0], _masks(seed=5)[0][5]):
        got = cv_nd.filter_adaptive_size(mask, fn, size,
                                         min_size_ratio=ratio)
        want = ref_nd.filter_adaptive_size(mask, fn, size,
                                           min_size_ratio=ratio)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_contour_interpolation_matches_reference():
    labels = np.zeros((9, 24, 24), np.int32)
    labels[1, 4:10, 5:12] = 3
    labels[7, 12:20, 8:22] = 3
    labels[4, 2:5, 2:5] = 8
    for frac in (0.25, 0.5, 0.8):
        np.testing.assert_array_equal(
            cv_nd.interpolate_contours(labels[1] == 3, labels[7] == 3, frac,
                                       device="cpu"),
            ref_nd.interpolate_contours(labels[1] == 3, labels[7] == 3,
                                        frac))
    for axis, bounds in ((0, (1, 7)), (2, (3, 20))):
        np.testing.assert_array_equal(
            cv_nd.interpolate_label_between_planes(labels, 3, axis, bounds,
                                                   device="cpu"),
            ref_nd.interpolate_label_between_planes(labels, 3, axis,
                                                    bounds))


def test_shears_rotations_and_angles_match_reference():
    img = np.arange(6 * 7 * 8).reshape(6, 7, 8)
    for args in ((0, 2, (0, 3), ((1, 5), (0, 7), (2, 8))),
                 (1, 0, (2.6, -1.4), ((0, 6), (1, 6), (0, 8))),
                 (2, 1, (-3, 3), ((0, 6), (0, 7), (0, 8)))):
        np.testing.assert_array_equal(cv_nd.affine_nd(img, *args),
                                      ref_nd.affine_nd(img, *args))
    for shape, offset, angle in (((20, 30), (2, 3), 30.0),
                                 ((15, 15), (14, 0), -45.0),
                                 ((8, 40), (0, 39), 180.0)):
        for g, w in zip(cv_nd.angle_indices(shape, offset, angle),
                        ref_nd.angle_indices(shape, offset, angle)):
            np.testing.assert_array_equal(g, w)
    multi = np.arange(2 * 3 * 4 * 2).reshape(2, 3, 4, 2)
    for roi, rot, axes, mc in ((img, 1, None, False), (img, 3, (0, 2), False),
                               (multi, 2, None, True), (None, 1, None, False),
                               (img, 0, None, False)):
        got = cv_nd.rotate90(roi, rot, axes, mc)
        want = ref_nd.rotate90(roi, rot, axes, mc)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)


def test_region_properties_match_reference():
    labels = np.zeros((10, 12, 14), np.int16)
    labels[2:6, 3:9, 1:5] = 4
    labels[7, 10, 12] = 4
    labels[1:3, 1:3, 8:13] = 9
    for lid in (4, 9, [4, 9], (9,), np.asarray([4]), 5):
        got = cv_nd.get_label_props(labels, lid)
        want = ref_nd.get_label_props(labels, lid)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.bbox, g.area, g.centroid) == (w.bbox, w.area,
                                                    w.centroid)
            np.testing.assert_array_equal(g.image, w.image)
        g_reg, g_sl = cv_nd.extract_region(labels, lid)
        w_reg, w_sl = ref_nd.extract_region(labels, lid)
        assert g_sl == w_sl
        if w_reg is not None:
            np.testing.assert_array_equal(g_reg, w_reg)
    mask = labels == 4
    g, w = (m.meas_region(mask, (2.0, 1.0, 0.5)) for m in (cv_nd, ref_nd))
    np.testing.assert_array_equal(g[0], w[0])
    assert g[1] == w[1] and g[2][0].bbox == w[2][0].bbox
    for args in ((2, 12, 9), (3, 40.0, 50.0), (3, 5, 0)):
        g, w = cv_nd.calc_compactness(*args), ref_nd.calc_compactness(*args)
        assert g == w or (np.isnan(g) and np.isnan(w))
    border = _perim(mask)
    assert cv_nd.compactness_count(border, mask) == \
        ref_nd.compactness_count(border, mask)


@pytest.mark.parametrize("kwargs", [
    {}, {"threshold": 0.3, "min_size": 3, "sort_reverse": True},
    {"threshold": None}])
def test_get_thresholded_regionprops_matches_reference(kwargs):
    rng = np.random.default_rng(6)
    img = scipy_ndi.gaussian_filter(rng.random((14, 30, 30)), 1.5) * 40
    if kwargs.get("threshold", 0) is None:
        img = img > 20
    elif "threshold" in kwargs:
        img = img / 40
    got = cv_nd.get_thresholded_regionprops(img, **kwargs)
    want = ref_nd.get_thresholded_regionprops(img, **kwargs)
    assert len(got) == len(want) > 0
    for (gp, ga), (wp, wa) in zip(got, want):
        assert ga == wa and gp.bbox == wp.bbox and gp.centroid == wp.centroid


@pytest.mark.parametrize("case", ["nuclei", "sphere", "empty", "slab"])
def test_surface_net_mesh_matches_reference(case):
    if case == "nuclei":
        vol = testing.make_nuclei_volume((20, 40, 40), seed=7)[0]
        level, iters = float(np.percentile(vol, 95)), 2
    elif case == "sphere":
        zz, yy, xx = np.indices((17, 19, 21))
        vol = 9.0 - np.sqrt((zz - 8) ** 2 + (yy - 9) ** 2 + (xx - 10) ** 2)
        level, iters = 0.0, 3
    elif case == "empty":
        vol, level, iters = np.zeros((5, 6, 7)), 0.5, 2
    else:
        vol = np.zeros((6, 8, 9))
        vol[2:4] = 1
        level, iters = 0.5, 0
    gv, gf = cv_nd.surface_net_mesh(vol, level, iters)
    wv, wf = ref_nd.surface_net_mesh(vol, level, iters)
    assert gv.dtype == wv.dtype and gf.dtype == wf.dtype
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gf, wf)
    assert case == "empty" or len(gf) > 0


def _blob_rows(n=60, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 10), np.float32)
    rows[:, :3] = rng.integers(0, 12, (n, 3))
    rows[:, 3] = rng.uniform(1, 3, n)
    rows[:, 6] = rng.integers(0, 2, n)
    rows[:, 7:10] = rows[:, :3] + rng.integers(0, 3, (n, 3))
    return rows


def test_detector_helpers_match_reference(capsys):
    rows = _blob_rows()
    for tol in ((1, 1, 1), (2, 0, 3)):
        np.testing.assert_array_equal(
            detector.remove_close_blobs_within_sorted_array(rows.copy(), tol),
            ref_detector.remove_close_blobs_within_sorted_array(
                rows.copy(), tol))
        for region in (slice(0, 3), slice(7, 10)):
            np.testing.assert_array_equal(
                detector.remove_close_blobs_within_array(rows, region, tol),
                ref_detector.remove_close_blobs_within_array(
                    rows, region, tol))
    assert detector.remove_close_blobs_within_sorted_array(None, (1,) * 3) \
        is None
    assert detector.remove_close_blobs_within_array(None, None, 1) is None
    empty = np.zeros((0, 10))
    assert detector.remove_close_blobs_within_sorted_array(
        empty, (1, 1, 1)) is empty
    roi = np.arange(14 * 15 * 16, dtype=np.float32).reshape(14, 15, 16)
    for blob in rows[:6]:
        for plane in (False, True):
            np.testing.assert_array_equal(
                detector.blob_surroundings(blob, roi, 2, plane),
                ref_detector.blob_surroundings(blob, roi, 2, plane))
    detector.show_blob_surroundings(rows[:2], roi)
    got = capsys.readouterr().out
    ref_detector.show_blob_surroundings(rows[:2], roi)
    assert got == capsys.readouterr().out and got
    for args in ((10, 4, 8), (0, 1, 2), (5, 5, 0)):
        assert detector.meas_pruning_ratio(*args) == \
            ref_detector.meas_pruning_ratio(*args)


def test_blob_helpers_and_archive_options_match_reference(tmp_path):
    rows = _blob_rows(seed=1)
    rows = np.vstack([rows, rows[:5]])
    for region in (slice(0, 3), slice(0, 4)):
        np.testing.assert_array_equal(
            blobs.remove_duplicate_blobs(rows, region),
            ref_blobs.remove_duplicate_blobs(rows, region))
    for g, w in zip(blobs.sort_blobs(rows), ref_blobs.sort_blobs(rows)):
        np.testing.assert_array_equal(g, w)
    saved = {}
    for name, mod in (("port", blobs), ("ref", ref_blobs)):
        path = str(tmp_path / f"{name}.npz")
        b = mod.Blobs(rows, path=path)
        b.save_archive()
        b.save_archive({"extra": np.arange(3), "none": None}, update=True)
        merged = mod.Blobs().load_blobs(path)
        with np.load(path, allow_pickle=True) as arc:
            saved[name] = {k: arc[k] for k in arc.files}
        np.testing.assert_array_equal(merged.blobs, rows)
        b.save_archive({"only": np.ones(2)})
        with np.load(path, allow_pickle=True) as arc:
            saved[name + "_only"] = sorted(arc.files)
    assert sorted(saved["port"]) == sorted(saved["ref"])
    for key in saved["ref"]:
        np.testing.assert_array_equal(saved["port"][key], saved["ref"][key])
    assert saved["port_only"] == saved["ref_only"] == ["only"]


def test_get_blobs_all_matches_reference():
    rows = _blob_rows(4, seed=2)
    matches = [(rows[i], rows[i + 1], 0.5 * i) for i in range(3)]
    got = colocalizer.BlobMatch(matches).get_blobs_all()
    want = ref_coloc.BlobMatch(matches).get_blobs_all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert colocalizer.BlobMatch().get_blobs_all() is None
    assert ref_coloc.BlobMatch().get_blobs_all() is None


def test_verify_rois_matches_reference(tmp_path):
    rng = np.random.default_rng(3)
    truth = _blob_rows(50, seed=3)
    truth[:, :3] = rng.integers(0, 30, (50, 3))
    det = truth.copy()
    det[:, :3] += rng.integers(-1, 2, det[:, :3].shape)
    det = np.vstack([det[5:], _blob_rows(8, seed=4)])
    det[:, 4] = -1
    rois = [{"offset_x": 0, "offset_y": 0, "offset_z": 0, "size_x": 16,
             "size_y": 20, "size_z": 30},
            {"offset_x": 10, "offset_y": 5, "offset_z": 3, "size_x": 20,
             "size_y": 25, "size_z": 20}]
    out = {}
    for name, ver, sql in (("port", verifier, sqlite),
                           ("ref", ref_verifier, ref_sqlite)):
        db = sql.ClrDB()
        db.load_db(str(tmp_path / f"{name}.db"))
        for channel in (None, [1]):
            stats, msg = ver.verify_rois(rois, det.copy(), truth.copy(),
                                         (2, 2, 2), db, "exp", channel)
            out[name, channel is None] = (stats.tolist(), msg)
        exp_id = db.select_or_insert_experiment("exp")
        out[name, "rows"] = [
            db.select_blobs_by_roi(db.select_or_insert_roi(
                exp_id, 0, (r["offset_x"], r["offset_y"], r["offset_z"]),
                (r["size_x"], r["size_y"], r["size_z"]))[0]).tolist()
            for r in rois]
        db.close()
    for key in (True, False, "rows"):
        assert out["port", key] == out["ref", key]
    assert out["port", True][0][1] > 0
