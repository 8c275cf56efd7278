"""The port's own copies of the reference's host-side code (profiles, blob
model and archive, block geometry, verification, image and database I/O,
the command line) against the reference, the port's entry points asking
for the card by default, and every command-line task in an interpreter
without jax or the reference package."""

import os
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
import torch

from magellanmapper_tpu.atlas import ontology as ref_ontology
from magellanmapper_tpu.cv import blobs as ref_blobs
from magellanmapper_tpu.cv import chunking as ref_chunking
from magellanmapper_tpu.cv import verifier as ref_verifier
from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.io import importer as ref_importer
from magellanmapper_tpu.io import np_io as ref_np_io
from magellanmapper_tpu.io import sqlite as ref_sqlite
from magellanmapper_tpu.io import yaml_io as ref_yaml_io
from magellanmapper_tpu.settings import grid_search_prof as ref_gs_prof
from magellanmapper_tpu.settings import roi_prof as ref_roi_prof
from magellanmapper_tpu.utils import libmag as ref_libmag
from magellanmapper_torch import entry, testing
from magellanmapper_torch.atlas import (
    atlas_refiner, edge_seg, gauntlet, ontology, reg_engine, register,
    transformer)
from magellanmapper_torch.cv import blobs, chunking, cv_nd, segmenter
from magellanmapper_torch.cv import (
    classifier, colocalizer, stack_detect, verifier)
from magellanmapper_torch.io import (
    cli, export_regions, export_stack, np_io, sitk_io)
from magellanmapper_torch.io import pipelines, sqlite, tiff, yaml_io
from magellanmapper_torch.ops import render3d
from magellanmapper_torch.plot import plot_3d
from magellanmapper_torch.settings import (
    atlas_prof, grid_search_prof, roi_prof)
from magellanmapper_torch.stats import clustering, mlearn, vols
from magellanmapper_torch.stitch import stitcher
from magellanmapper_torch.utils import libmag

torch.set_num_threads(1)

#: the checkout's root: a fresh interpreter imports the port from there,
#: whatever directory an earlier test left the process in
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- profiles ---------------------------------------------------------------

@pytest.mark.parametrize(
    "name", ["default"] + sorted(ref_roi_prof.ROIProfile().profiles))
def test_roi_profile_copy(name):
    got, want = roi_prof.ROIProfile(), ref_roi_prof.ROIProfile()
    assert got.profiles == want.profiles
    got.add_profiles(name)
    want.add_profiles(name)
    assert dict(got) == dict(want)


@pytest.mark.parametrize(
    "name", sorted(ref_gs_prof.GridSearchProfile().profiles))
def test_grid_search_profile_copy(name):
    got = grid_search_prof.GridSearchProfile()
    want = ref_gs_prof.GridSearchProfile()
    got.add_profiles(name)
    want.add_profiles(name)
    assert dict(got) == dict(want)
    assert got.get_param_grid() == want.get_param_grid()


def test_profile_chains_and_yaml_files_copy(tmp_path):
    path = str(tmp_path / "roi_custom.yml")
    ref_yaml_io.save_yaml(path, {"detection_threshold": 0.2,
                                 "segment_size": np.int64(80)})
    assert yaml_io.load_yaml(path) == ref_yaml_io.load_yaml(path)
    for names in ("lightsheet,4xnuc", "lowres,minpreproc,2p20x", path):
        got, want = roi_prof.ROIProfile(), ref_roi_prof.ROIProfile()
        got.add_profiles(names)
        want.add_profiles(names)
        assert dict(got) == dict(want)
    with pytest.raises(KeyError):
        roi_prof.ROIProfile().add_profiles("no_such_profile")
    a, b = roi_prof.ROIProfile(), roi_prof.ROIProfile(segment_size=9)
    assert roi_prof.is_identical_block_settings([a, b]) == \
        ref_roi_prof.is_identical_block_settings([a, b])


# -- blob model, block geometry, verification -------------------------------

def _raw(rng, n, ncols=4):
    return np.column_stack([rng.integers(0, 50, (n, 3)),
                            rng.uniform(1, 4, (n, ncols - 3))]).astype(float)


@pytest.mark.parametrize("ncols,channel", [(4, 0), (4, None), (7, 2)])
def test_blobs_methods_copy(ncols, channel):
    rng = np.random.default_rng(ncols)
    raw = _raw(rng, 12, ncols)
    got = blobs.Blobs(raw.copy()).format_blobs(channel)
    want = ref_blobs.Blobs(raw.copy()).format_blobs(channel)
    np.testing.assert_array_equal(got, want)
    offset = (3, -2, 5)
    for name in ("shift_blob_rel_coords", "shift_blob_abs_coords",
                 "multiply_blob_rel_coords"):
        np.testing.assert_array_equal(
            getattr(blobs.Blobs, name)(got.copy(), offset),
            getattr(ref_blobs.Blobs, name)(want.copy(), offset))
    np.testing.assert_array_equal(blobs.Blobs.get_blobs_channel(got),
                                  ref_blobs.Blobs.get_blobs_channel(want))
    np.testing.assert_array_equal(blobs.Blobs.get_blob_abs_coords(got),
                                  ref_blobs.Blobs.get_blob_abs_coords(want))
    assert blobs.COL_IND[blobs.BlobCols.ABS_X] == \
        ref_blobs.COL_IND[ref_blobs.BlobCols.ABS_X]
    assert [c.value for c in blobs.BlobCols] == [
        c.value for c in ref_blobs.BlobCols]


def test_blob_archive_reads_in_the_reference(tmp_path):
    rng = np.random.default_rng(5)
    port = blobs.Blobs(_raw(rng, 20))
    port.format_blobs(1)
    port.resolutions = np.array([[2.0, 1.0, 1.0]])
    port.basename = "vol"
    port.path = str(tmp_path / "vol_blobs.npz")
    port.save_archive()
    port.save_archive()     # the first archive is backed up, not lost
    assert os.path.exists(tmp_path / "vol_blobs(1).npz")
    back = ref_blobs.Blobs().load_blobs(port.path)
    np.testing.assert_array_equal(back.blobs, port.blobs)
    np.testing.assert_array_equal(back.resolutions, port.resolutions)
    assert back.cols == port.cols and back.basename == "vol"
    ref = ref_blobs.Blobs(port.blobs.copy())
    ref.resolutions, ref.basename = port.resolutions, port.basename
    ref.path = str(tmp_path / "ref_blobs.npz")
    ref.save_archive()
    with np.load(ref.path, allow_pickle=True) as a, \
            np.load(port.path, allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("shape,max_pixels,overlap", [
    ((48, 192, 192), (150, 123, 123), (5, 5, 5)),
    ((300, 700, 650), (64, 100, 128), (3, 0, 7)),
    ((20, 100, 90), (25, 25, 25), None)])
def test_stack_splitter_and_merge_blobs_copy(shape, max_pixels, overlap):
    got = chunking.stack_splitter(shape, max_pixels, overlap)
    want = ref_chunking.stack_splitter(shape, max_pixels, overlap)
    assert got[0].shape == want[0].shape and np.all(got[0] == want[0])
    np.testing.assert_array_equal(got[1], want[1])
    rng = np.random.default_rng(len(got[0].ravel()))
    rois = np.full(got[0].shape, None, dtype=object)
    for coord in list(np.ndindex(*rois.shape))[::2]:
        rois[coord] = blobs.Blobs(_raw(rng, 3)).format_blobs(0)
    np.testing.assert_array_equal(
        chunking.merge_blobs(rois), ref_chunking.merge_blobs(rois))
    empty = np.full(got[0].shape, None, dtype=object)
    assert chunking.merge_blobs(empty) is None
    assert ref_chunking.merge_blobs(empty) is None


@pytest.mark.parametrize("tol", [(3, 3, 3), (3, 1.2, 1.2), (1, 2, 2)])
def test_verify_stack_copy(tol):
    rng = np.random.default_rng(9)
    truth = rng.integers(0, 60, (80, 3)).astype(float)
    det = np.vstack([truth[:60] + rng.integers(-3, 4, (60, 3)),
                     rng.integers(0, 60, (15, 3))]).astype(float)
    assert verifier.verify_stack(det, truth, tol) == \
        ref_verifier.verify_stack(det, truth, tol)
    got = verifier.find_closest_blobs_cdist(det, truth, 3.0, (1, 2, 2))
    want = ref_verifier.find_closest_blobs_cdist(det, truth, 3.0, (1, 2, 2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(verifier.setup_match_blobs_roi(tol),
                    ref_verifier.setup_match_blobs_roi(tol)):
        np.testing.assert_array_equal(g, w)
    assert verifier.calc_sens_ppv(10, 7, 2, 3) == \
        ref_verifier.calc_sens_ppv(10, 7, 2, 3)


def test_path_helpers_copy(tmp_path):
    for base, suffix in (("a/b/vol.npy", "blobs.npz"), ("vol", ".csv"),
                         ("x.nii.gz", "meta.yml"), (None, "s.npz")):
        assert libmag.combine_paths(base, suffix) == \
            ref_libmag.combine_paths(base, suffix)
    assert libmag.splitext("a.ome.tif") == ref_libmag.splitext("a.ome.tif")
    path = tmp_path / "f.txt"
    path.write_text("x")
    assert libmag.backup_file(str(path)) == str(tmp_path / "f(1).txt")


def test_reference_blob_archive_reads_in_the_port(tmp_path):
    rng = np.random.default_rng(6)
    ref = ref_blobs.Blobs(_raw(rng, 15))
    ref.format_blobs(2)
    ref.resolutions = np.array([[1.0, 0.5, 0.5]])
    ref.basename, ref.roi_offset, ref.roi_size = "s", [1, 2, 3], [9, 9, 9]
    ref.path = str(tmp_path / "s_blobs.npz")
    ref.save_archive()
    got = blobs.Blobs().load_blobs(ref.path)
    want = ref_blobs.Blobs().load_blobs(ref.path)
    for name in ("blobs", "resolutions", "roi_offset", "roi_size"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert (got.cols, got.basename, got.ver) == (want.cols, want.basename,
                                                 want.ver)
    for channel in (None, 2, [0, 2], 5):
        for mask in (False, True):
            g = blobs.Blobs.blobs_in_channel(got.blobs, channel, mask)
            w = ref_blobs.Blobs.blobs_in_channel(want.blobs, channel, mask)
            for a, b in zip(g if mask else [g], w if mask else [w]):
                np.testing.assert_array_equal(a, b)


# -- ontology -----------------------------------------------------------------

_ABA = {"msg": [{
    "id": 1, "name": "root", "acronym": "rt", "st_level": 0,
    "children": [
        {"id": 2, "name": "cortex", "acronym": "cx", "st_level": 1,
         "children": [
             {"id": 4, "name": "layer1", "acronym": "l1", "st_level": 2,
              "children": []},
             {"id": 5, "name": "layer2", "acronym": "l2", "st_level": 2,
              "children": [{"id": 7, "name": "deep", "acronym": "dp",
                            "st_level": 3}]}]},
        {"id": 3, "name": "thalamus", "acronym": "th", "st_level": 1,
         "children": []}]}]}


def _ontology_files(tmp_path):
    import json
    aba = tmp_path / "ref.json"
    aba.write_text(json.dumps(_ABA))
    csv_path = tmp_path / "ref.csv"
    csv_path.write_text("Region,RegionName,Level\n1,root,0\n2,cortex,1\n"
                        "4,layer1,2\n")
    itk = tmp_path / "ref.txt"
    itk.write_text('# ITK-SNAP label description\n'
                   '    0     0    0    0        0  0  0    "Clear Label"\n'
                   '    2   255    0    0        1  1  1    "cortex"\n'
                   '    3     0  255    0        1  1  1    "thalamus"\n')
    return [str(aba), str(csv_path), str(itk)]


def test_ontology_copy(tmp_path):
    paths = _ontology_files(tmp_path)
    for path in paths:
        got = ontology.LabelsRef(path).load()
        want = ref_ontology.LabelsRef(path).load()
        assert sorted(got.ref_lookup) == sorted(want.ref_lookup)
        for lid, entry in want.ref_lookup.items():
            assert got.ref_lookup[lid][ontology.PARENT_IDS] == \
                entry[ref_ontology.PARENT_IDS]
            assert got.ref_lookup[lid][ontology.MIRRORED] == \
                entry[ref_ontology.MIRRORED]
            for side in (False, True):
                assert ontology.get_label_name(got.ref_lookup[lid], side) \
                    == ref_ontology.get_label_name(entry, side)
        pd_got = got.get_ref_lookup_as_df()
        pd_want = want.get_ref_lookup_as_df()
        assert pd_got.astype(str).equals(pd_want.astype(str))
    with pytest.raises(FileNotFoundError):
        ontology.LabelsRef(str(tmp_path / "none.json")).load()
    got = ontology.LabelsRef(paths[0]).load().ref_lookup
    want = ref_ontology.LabelsRef(paths[0]).load().ref_lookup
    labels = np.array([[[4, 5, 3, 0], [-7, -4, 2, 1]]], np.int32)
    for level in (None, 0, 1, 2, 3):
        assert ontology.labels_to_parent(got, level) == \
            ref_ontology.labels_to_parent(want, level)
        if level is not None:
            np.testing.assert_array_equal(
                ontology.make_labels_level(labels, got, level),
                ref_ontology.make_labels_level(labels, want, level))
        for lid in (4, -7, 99):
            a = ontology.get_label_at_level(lid, got, level)
            b = ref_ontology.get_label_at_level(lid, want, level)
            assert (a is None and b is None) or a[ontology.NODE] == \
                b[ref_ontology.NODE]
    for lid in (2, -2, 7, 99):
        for incl, both in ((True, False), (False, True)):
            assert ontology.get_children_from_id(got, lid, incl, both) == \
                ref_ontology.get_children_from_id(want, lid, incl, both)
    for ids in (4, [-4, -5], [3, -3], []):
        assert ontology.get_label_side(ids) == \
            ref_ontology.get_label_side(ids)
    big = np.zeros((6, 8, 8), np.int32)
    big[1:4, 2:6, 2:7] = 4
    big[3:5, 1:3, 1:4] = -5
    for args in (([4], False), ([5], True), ([2], True)):
        a, b = (mod.get_region_middle(lk, args[0], big,
                                      (2.0, 1.0, 1.0), args[1])
                for mod, lk in ((ontology, got), (ref_ontology, want)))
        assert a[0] == b[0] and a[2] == b[2]
        np.testing.assert_array_equal(a[1], b[1])
    coord = (2, 3, 4)
    for kwargs in ({}, {"scaling": (0.5, 0.6, 0.7), "rounding": True},
                   {"level": 1}):
        a = ontology.get_label(coord, big, got, **kwargs)
        b = ref_ontology.get_label(coord, big, want, **kwargs)
        assert (a is None and b is None) or a[ontology.NODE] == \
            b[ref_ontology.NODE]
    rng = np.random.default_rng(11)
    coords = rng.uniform(0, 40, (200, 3))
    for clip in (None, big.shape):
        np.testing.assert_array_equal(
            ontology.scale_coords(coords, (0.15, 0.2, 0.19), clip),
            ref_ontology.scale_coords(coords, (0.15, 0.2, 0.19), clip))
    scaled = ontology.scale_coords(coords, (0.15, 0.2, 0.19), big.shape)
    np.testing.assert_array_equal(
        ontology.get_label_ids_from_position(scaled, big),
        ref_ontology.get_label_ids_from_position(scaled, big))
    import pandas as pd
    swap = pd.DataFrame({"Region": [4, -5], "RegionTo": [3, 3]})
    for clear in (False, True):
        np.testing.assert_array_equal(
            ontology.replace_labels(big, swap, clear),
            ref_ontology.replace_labels(big, swap, clear))
    tree = pd.DataFrame({"Region": [1, 2, 3, 4], "Parent": [0, 1, 1, 2]})
    assert ontology.get_children_from_id_df(tree, 1) == \
        ref_ontology.get_children_from_id_df(tree, 1)
    assert ontology.rel_to_abs_ages(["E18.5", "P4"]) == \
        ref_ontology.rel_to_abs_ages(["E18.5", "P4"])
    assert [c.value for c in ontology.LabelColumns] == [
        c.value for c in ref_ontology.LabelColumns]
    assert ontology.get_label_item(got[4], ontology.ABA_NAME) == \
        ref_ontology.get_label_item(want[4], ref_ontology.ABA_NAME)


def test_np_io_scaling_and_blob_regions_copy():
    rng = np.random.default_rng(12)
    labels = rng.integers(0, 9, (8, 10, 12)).astype(np.int32)
    scaling = np_io.find_scaling((1, 32, 40, 48)[1:], labels.shape)
    np.testing.assert_array_equal(
        scaling, ref_np_io.find_scaling((32, 40, 48), labels.shape))
    for ncols in (10, 11):
        rows = np.column_stack([rng.uniform(0, 31, (30, 3)),
                                rng.uniform(1, 3, (30, ncols - 3))])
        np.testing.assert_array_equal(
            np_io.assign_blob_regions(rows.copy(), labels, scaling),
            ref_np_io.assign_blob_regions(rows.copy(), labels, scaling))


# -- image and database I/O --------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_read_file_of_a_reference_volume(tmp_path, dtype):
    vol = np.random.default_rng(1).integers(0, 900, (6, 20, 24)).astype(dtype)
    path = str(tmp_path / "vol.npy")
    ref_np_io.write_npy(path, vol, resolutions=[[2.0, 0.5, 0.5]])
    got, want = np_io.read_file(path), ref_np_io.read_file(path)
    np.testing.assert_array_equal(got.img, want.img)
    np.testing.assert_array_equal(got.resolutions, want.resolutions)
    assert got.meta == want.meta
    assert (got.path_img, got.path_meta) == (want.path_img, want.path_meta)
    # a sub-image by x,y,z offset and size
    off, size = [3, 2, 1], [10, 8, 4]
    got = np_io.read_file(path, offset=off, size=size)
    want = ref_np_io.read_file(path, offset=off, size=size)
    np.testing.assert_array_equal(got.img, want.img)
    assert list(got.subimg_offset) == list(want.subimg_offset)
    # a plain np.save volume has no metadata: no resolutions
    plain = str(tmp_path / "plain.npy")
    np.save(plain, vol)
    got, want = np_io.read_file(plain), ref_np_io.read_file(plain)
    np.testing.assert_array_equal(got.img, want.img)
    assert got.resolutions is None and want.resolutions is None


def test_write_npy_reads_in_the_reference(tmp_path):
    vol = np.random.default_rng(2).random((4, 9, 11)).astype(np.float32)
    path = str(tmp_path / "port.npy")
    np_io.write_npy(path, vol, resolutions=[[1.5, 1.0, 1.0]])
    got = ref_np_io.read_file(path)
    np.testing.assert_array_equal(got.img[0], vol)
    assert got.meta == ref_np_io.load_metadata(
        ref_np_io.make_filenames(path)[1])[0]
    assert np_io.load_metadata(got.path_meta) == \
        ref_np_io.load_metadata(got.path_meta)
    for off, size in (([1, 2, 3], [4, 5, 6]), ([0, 0, 0], [9, 9, 9])):
        assert np_io.make_subimage_name(path, off, size) == \
            ref_importer.make_subimage_name(path, off, size)


def _schema(path):
    with sqlite3.connect(path) as conn:
        return conn.execute(
            "SELECT type, name, sql FROM sqlite_master ORDER BY name"
        ).fetchall()


def _ref_truth_db(path, centres, shape):
    """The truth ROI of :func:`testing.write_truth_db`, written by the
    reference's database code."""
    n = len(centres)
    rows = np.column_stack([np.asarray(centres, float), np.full(n, 3.0),
                            np.ones(n), np.ones(n), np.zeros(n)])
    db = ref_sqlite.load_db(path)
    exp_id = db.select_or_insert_experiment("truth")
    roi_id, _ = db.select_or_insert_roi(
        exp_id, 0, (0, 0, 0), tuple(int(s) for s in shape[::-1]))
    db.insert_blobs(roi_id, rows)
    db.close()
    return path


def test_truth_db_interchanges_with_the_reference(tmp_path):
    centres = np.random.default_rng(4).integers(0, 40, (50, 3))
    centres = np.unique(centres, axis=0)
    port = testing.write_truth_db(str(tmp_path / "port.db"), centres,
                                  (40, 40, 40))
    ref = _ref_truth_db(str(tmp_path / "ref.db"), centres, (40, 40, 40))
    assert _schema(port) == _schema(ref)
    for reader in (sqlite, ref_sqlite):
        for path in (port, ref):
            db = reader.load_truth_db(path[:-3])
            got = db.select_blobs_confirmed(1)
            db.close()
            assert got.shape == (len(centres), 7)
            np.testing.assert_array_equal(
                got[np.lexsort(got.T[::-1])][:, :3],
                centres[np.lexsort(centres.T[::-1])])


# -- command line ------------------------------------------------------------

_ACCEPTED = [
    ["--img", "v.npy", "--proc", "detect"],
    ["--img", "v.npy", "--proc", "detect", "--roi_profile", "lightsheet",
     "4xnuc", "--channel", "0", "1", "--prefix", "out/p"],
    ["--img", "v.npy", "--proc", "detect", "--series", "2",
     "--subimg_offset", "1,2,3", "--subimg_size", "10,20,30",
     "--set_meta", "resolutions=2.0,0.5,0.5"],
    ["--img", "r.npy", "--grid_search", "gridtest", "--roi_profile",
     "4xnuc", "--truth_db", "verify", "truth.db"],
    ["--img", "r.npy", "--grid_search", "gridtest", "--proc", "detect",
     "--truth_db", "t.db"],
    ["--img", "v.npy", "--proc", "detect_coloc", "--channel", "0", "1"],
    ["--img", "v.npy", "--proc", "detect", "--truth_db", "t.db",
     "--subimg_offset", "1,2,3", "--subimg_size", "10,20,30",
     "--save_subimg"],
    ["--img", "v.npy", "--proc", "classify", "--classifier", "m.pkl"],
    ["--img", "v.npy", "--proc", "coloc_match"],
    ["--img", "s.tif", "--proc", "import_only", "--set_meta",
     "resolutions=5.0,1.5,1.5", "--prefix", "out/s"],
    ["--img", "s.czi", "--proc", "import_only", "--series", "1"],
    ["--img", "v.npy", "--proc", "load", "--subimg_offset", "1,2,3",
     "--subimg_size", "4,5,6"],
    ["--img", "v.npy", "--proc", "export_tif", "--prefix", "out/v"],
    ["--img", "v.npy", "--proc", "export_raw"],
    ["--img", "v.npy", "--proc", "export_blobs", "--prefix", "p"],
    ["--img", "v.npy", "--proc", "extract", "--offset", "1,2,3", "--plane",
     "xz"],
    ["--img", "v.npy", "--proc", "export_rois", "--truth_db", "t.db",
     "--channel", "1"],
    ["--img", "v.npy", "--proc", "export_planes", "--savefig", "jpg"],
    ["--img", "v.npy", "--proc", "export_planes_channels"],
    ["--img", "v.npy", "--proc", "animated", "--slice", "2,10,2", "--delay",
     "150"],
    ["--img", "t.csv", "--plot_2d", "bar_plot", "--plot_labels",
     "x_col=a", "y_col=b", "--prefix", "t.png"],
]


@pytest.mark.parametrize("argv", _ACCEPTED)
def test_cli_parses_as_the_reference(argv):
    got = cli.process_cli_args(argv + ["--device", "cpu"])
    want = ref_cli.process_cli_args(argv)
    for name in ("filenames", "channel", "series", "subimg_offsets",
                 "subimg_sizes", "proc_args", "resolutions", "truth_db",
                 "prefix", "grid_search", "classifier", "save_subimg",
                 "offset", "slice_vals", "delay", "savefig", "plot_labels",
                 "plot_2d_task"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.proc == (want.proc.name.lower() if want.proc else None)
    assert dict(got.roi_profile) == dict(want.roi_profile)
    assert [dict(p) for p in got.roi_profiles] == [
        dict(p) for p in want.roi_profiles]
    assert got.device == "cpu"
    assert cli.process_cli_args(argv).device == "cuda"


@pytest.mark.parametrize("argv,named", [
    (["--proc", "detect", "--register", "zscores"], "--register"),
    (["--proc", "detect", "--mesh", "1,1"], "--mesh"),
    (["--proc", "transform", "--save_subimg"], "--save_subimg"),
    (["--proc", "detect", "--df", "sum"], "--df"),
    (["--proc", "detect", "--plot_2d", "bar"], "--plot_2d"),
    (["--proc", "detect", "--notify", "x"], "--notify"),
    (["--proc", "no_such_task"], "--proc no_such_task"),
    (["--proc", "transform", "--truth_db", "t.db"], "--truth_db"),
    (["--register", "coefvar"], "--register"),
])
def test_cli_rejects_and_names_what_is_not_ported(argv, named):
    with pytest.raises(SystemExit) as err:
        cli.process_cli_args(["--img", "v.npy"] + argv)
    assert named in str(err.value)


def test_cli_detect_reads_subimage_and_resolutions(tmp_path):
    vol = testing.make_nuclei_volume((30, 60, 60), seed=3)[0]
    path = str(tmp_path / "vol.npy")
    np_io.write_npy(path, vol, resolutions=[[1.0, 1.0, 1.0]])
    argv = ["--img", path, "--proc", "detect", "--subimg_offset", "4,6,2",
            "--subimg_size", "50,40,26", "--set_meta",
            "resolutions=1.0,1.0,1.0", "--roi_profile", "lightsheet",
            "--device", "cpu"]
    img5d = cli.load_image(cli.process_cli_args(argv))
    np.testing.assert_array_equal(img5d.img[0], vol[2:28, 6:46, 4:54])
    assert img5d.meta["resolutions"] == [[1.0, 1.0, 1.0]]
    out = cli.main(argv)
    prof = roi_prof.ROIProfile()
    prof.add_profiles("lightsheet")
    direct, _ = stack_detect.detect_blobs_stack(
        np.ascontiguousarray(vol[2:28, 6:46, 4:54]), prof, (1.0, 1.0, 1.0),
        device="cpu")
    np.testing.assert_array_equal(out.blobs, direct.blobs)


# -- the card by default ----------------------------------------------------

@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def _entry_points(tmp_path):
    vol = np.zeros((8, 16, 16), np.uint16)
    labels = np.ones(vol.shape, np.int32)
    prof = roi_prof.ROIProfile()
    img = str(tmp_path / "roi.npy")
    np.save(img, vol.astype(np.float32))
    truth = testing.write_truth_db(str(tmp_path / "t.db"), [(4, 8, 8)],
                                   vol.shape)
    rc = cli.process_cli_args(["--img", img, "--grid_search", "gridtest",
                               "--truth_db", truth])
    blob_rows = np.array([[4.0, 8, 8, 3, -1, -1, 0, 4, 8, 8]])
    cloud = np.random.default_rng(0).integers(0, 8, (12, 3)).astype(float)
    tiles = [vol, vol]
    grid = stitcher.TileGrid(1, 2, vol.shape, 0.5)
    tile_dir = tmp_path / "tiles"
    tile_dir.mkdir()
    for t in range(2):
        tiff.write_tiff(str(tile_dir / f"tile_{t}_ch_0.tif"), vol)
    return {
        "detect_blobs_blocks": lambda: stack_detect.detect_blobs_blocks(
            vol, prof, (1.0, 1.0, 1.0)),
        "detect_blobs_stack": lambda: stack_detect.detect_blobs_stack(
            vol, prof, (1.0, 1.0, 1.0)),
        "StackDetector": lambda: stack_detect.StackDetector(
            vol, prof, (1.0, 1.0, 1.0)).detect_stack(),
        "make_fn_detect_multi": lambda: mlearn.make_fn_detect_multi(
            vol, (1.0, 1.0, 1.0), prof),
        "grid_search_from_cli": lambda: mlearn.grid_search_from_cli(rc),
        "cli.main": lambda: cli.main(["--img", img, "--proc", "detect"]),
        "transpose_img": lambda: transformer.transpose_img(
            img, rescale=0.5),
        "preprocess_img": lambda: transformer.preprocess_img(
            vol[None], ["saturate"]),
        "Downsampler": lambda: transformer.Downsampler(vol).rescale(0.5),
        "build_heat_map": lambda: cv_nd.build_heat_map(
            vol.shape, np.zeros((1, 3))),
        "perimeter_nd": lambda: cv_nd.perimeter_nd(vol > 0),
        "make_density_image": lambda: export_regions.make_density_image(
            img),
        "measure_labels_metrics": lambda: vols.measure_labels_metrics(
            None, vol.astype(np.int32)),
        "cli.main transform": lambda: cli.main(
            ["--img", img, "--proc", "transform", "--transform",
             "rescale=0.5"]),
        "cli.main vol_stats": lambda: cli.main(
            ["--img", img, "--register", "vol_stats"]),
        "register_groupwise": lambda: reg_engine.register_groupwise(
            [vol, vol]),
        "register_group": lambda: register.register_group(
            [vol, vol], atlas_prof.AtlasProfile()),
        "cli.main group": lambda: cli.main(
            ["--img", img, img, "--register", "group"]),
        "import_atlas": lambda: atlas_refiner.import_atlas(
            str(tmp_path), atlas_prof.AtlasProfile()),
        "extend_edge": lambda: atlas_refiner.extend_edge(
            labels, vol, 0.5, 0),
        "smooth_labels": lambda: atlas_refiner.smooth_labels(labels, 2),
        "make_edge_images": lambda: edge_seg.make_edge_images(vol, labels),
        "edge_aware_segmentation": lambda: edge_seg.edge_aware_segmentation(
            vol, labels),
        "make_sub_segmented_labels": lambda:
            edge_seg.make_sub_segmented_labels(labels, labels),
        "labels_to_markers_erosion": lambda:
            segmenter.labels_to_markers_erosion(labels),
        "watershed": lambda: segmenter.watershed(vol, labels),
        "laplacian_of_gaussian_img": lambda:
            cv_nd.laplacian_of_gaussian_img(vol),
        "cli.main make_edge_images": lambda: cli.main(
            ["--img", img, "--register", "make_edge_images"]),
        "colocalize_blobs": lambda: colocalizer.colocalize_blobs(
            vol[..., None], blob_rows),
        "extract_patches": lambda: classifier.extract_patches(
            vol, blob_rows),
        "BlobClassifier": lambda: classifier.BlobClassifier(),
        "detect_blobs_stack classifier": lambda:
            stack_detect.detect_blobs_stack(
                vol, prof, (1.0, 1.0, 1.0), device="cpu",
                classifier_model=classifier.BlobClassifier()),
        "cluster_dbscan": lambda: clustering.cluster_dbscan(
            cloud, 1.0, 5),
        "knn_dist": lambda: clustering.knn_dist(cloud, 5),
        "cluster_blobs": lambda: clustering.cluster_blobs(cloud),
        "cluster_by_label": lambda: clustering.cluster_by_label(
            cloud, labels, (1.0, 1.0, 1.0)),
        "cli.main detect_coloc": lambda: cli.main(
            ["--img", img, "--proc", "detect_coloc"]),
        "cli.main classify": lambda: cli.main(
            ["--img", img, "--proc", "classify"]),
        "cli.main cluster_blobs": lambda: cli.main(
            ["--img", img, "--register", "cluster_blobs"]),
        "phase_correlation": lambda: stitcher.phase_correlation(vol, vol),
        "phase_shifts": lambda: stitcher.phase_shifts(tiles, grid),
        "compute_pairwise_shifts": lambda:
            stitcher.compute_pairwise_shifts(tiles, grid),
        "fuse_tiles": lambda: stitcher.fuse_tiles(
            tiles, np.zeros((2, 3))),
        "stitch": lambda: stitcher.stitch(tiles, grid),
        "run_pipeline": lambda: pipelines.run_pipeline("detection", img),
        "run_pipeline stitching": lambda: pipelines.run_pipeline(
            "stitching", str(tmp_path / "acq.tif"), tile_grid={
                "dir": str(tile_dir), "rows": 1, "cols": 2}),
        "make_tiles": lambda: testing.make_tiles(vol, 1, 2, 0.5),
        "render_volume": lambda: render3d.render_volume(vol, 30, 20),
        "render_isosurface": lambda: render3d.render_isosurface(
            vol, 0.5, 30, 20),
        "render_volume_sw": lambda: render3d.render_volume_sw(vol, 30, 20),
        "render_isosurface_sw": lambda: render3d.render_isosurface_sw(
            vol, 0.5, 30, 20),
        "render_channels_sw": lambda: render3d.render_channels_sw(
            vol, 30, 20),
        "saturate_roi": lambda: plot_3d.saturate_roi(vol),
        "denoise_roi": lambda: plot_3d.denoise_roi(vol),
        "threshold": lambda: plot_3d.threshold(vol),
        "deconvolve": lambda: plot_3d.deconvolve(vol, 2),
        "render_rotation": lambda: export_stack.render_rotation(vol, 2),
        "animate_rotation_3d": lambda: export_stack.animate_rotation_3d(
            vol, str(tmp_path / "o.gif"), 2),
        "build_stack": lambda: export_stack.setup_stack(
            vol[None], rescale=0.5).build_stack(),
        "plot_knns": lambda: clustering.plot_knns([cloud]),
        "segment_rw": lambda: segmenter.segment_rw(vol),
        "segment_ws": lambda: segmenter.segment_ws(vol),
        "watershed_distance": lambda: segmenter.watershed_distance(
            vol > 0),
        "labels_to_markers_blob": lambda:
            segmenter.labels_to_markers_blob(labels),
        "borders_distance": lambda: cv_nd.borders_distance(
            vol > 0, vol > 0),
        "signed_distance_transform": lambda:
            cv_nd.signed_distance_transform(None, vol > 0),
        "remove_bg_from_dil_fg": lambda: cv_nd.remove_bg_from_dil_fg(
            vol, vol > 0, np.ones((3, 3, 3), bool)),
        "interpolate_contours": lambda: cv_nd.interpolate_contours(
            vol[0] > 0, vol[1] > 0, 0.5),
        "measure_label_overlap": lambda: vols.measure_label_overlap(
            labels, labels),
        "labels_distance": lambda: vols.labels_distance(labels, labels),
        "volumes_by_id": lambda: register.volumes_by_id([img]),
        "cli.main labels_diff": lambda: cli.main(
            ["--img", img, img, "--register", "labels_diff"]),
        "run_gauntlet_suite": lambda: gauntlet.run_gauntlet_suite(
            (20, 28, 28), seeds=(0,), truncated_seed=None),
        "entry": lambda: entry.entry(),
    }


@pytest.mark.parametrize("name", [
    "detect_blobs_blocks", "detect_blobs_stack", "StackDetector",
    "make_fn_detect_multi", "grid_search_from_cli", "cli.main",
    "transpose_img", "preprocess_img", "Downsampler", "build_heat_map",
    "perimeter_nd", "make_density_image", "measure_labels_metrics",
    "cli.main transform", "cli.main vol_stats", "register_groupwise",
    "register_group", "cli.main group", "import_atlas", "extend_edge",
    "smooth_labels", "make_edge_images", "edge_aware_segmentation",
    "make_sub_segmented_labels", "labels_to_markers_erosion", "watershed",
    "laplacian_of_gaussian_img", "cli.main make_edge_images",
    "colocalize_blobs", "extract_patches", "BlobClassifier",
    "detect_blobs_stack classifier", "cluster_dbscan", "knn_dist",
    "cluster_blobs", "cluster_by_label", "cli.main detect_coloc", "cli.main classify",
    "cli.main cluster_blobs", "phase_correlation", "phase_shifts",
    "compute_pairwise_shifts", "fuse_tiles", "stitch", "run_pipeline",
    "run_pipeline stitching", "make_tiles", "render_volume",
    "render_isosurface", "render_volume_sw", "render_isosurface_sw",
    "render_channels_sw", "saturate_roi", "denoise_roi", "threshold",
    "deconvolve", "render_rotation", "animate_rotation_3d", "build_stack",
    "plot_knns", "segment_rw", "segment_ws", "watershed_distance",
    "labels_to_markers_blob", "borders_distance",
    "signed_distance_transform", "remove_bg_from_dil_fg",
    "interpolate_contours", "measure_label_overlap", "labels_distance",
    "volumes_by_id", "cli.main labels_diff", "run_gauntlet_suite",
    "entry"])
def test_entry_points_ask_for_the_card(tmp_path, no_card, name):
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points(tmp_path)[name]()


_BOTH_TASKS_ALONE = """
import importlib, pkgutil, sys
import magellanmapper_torch
from magellanmapper_torch.io import cli
names = [m.name for m in pkgutil.walk_packages(
    magellanmapper_torch.__path__, "magellanmapper_torch.")]
for name in names:
    importlib.import_module(name)
img, truth, fixed, atlas, prof, ref = sys.argv[1:7]
blobs = cli.main(["--img", img, "--proc", "detect", "--roi_profile",
                  "lightsheet", "--device", "cpu"])
df = cli.main(["--img", img, "--grid_search", "gridtest", "--roi_profile",
               "4xnuc", "--truth_db", truth, "--device", "cpu"])
reg = cli.main(["--img", fixed, atlas, "--register", "single",
                "--atlas_profile", prof, "--device", "cpu"])
small = cli.main(["--img", fixed, "--proc", "transform", "--transform",
                  "rescale=0.5", "--device", "cpu"])
pre = cli.main(["--img", small, "--proc", "preprocess", "saturate",
                "--prefix", small + "_pre.npy", "--device", "cpu"])
cli.main(["--img", fixed, "--proc", "detect", "--roi_profile", "4xnuc",
          "--device", "cpu"])
heat, _ = cli.main(["--img", fixed, "--register", "make_density_images",
                    "--device", "cpu"])
vols = cli.main(["--img", fixed, "--register", "vol_stats", "--labels",
                 "path_ref=" + ref, "--device", "cpu"])
ids = cli.main(["--register", "export_regions", "--labels",
                "path_ref=" + ref, "--prefix", ref + ".csv", "--device",
                "cpu"])
assert int(heat.sum()) > 0 and int(vols["Nuclei"].sum()) > 0
assert pre.shape[0] == 1 and len(ids) > 0
two = sys.argv[7]
coloc = cli.main(["--img", two, "--proc", "detect_coloc", "--channel", "0",
                  "1", "--roi_profile", "lightsheet", "--device", "cpu"])
matches = cli.main(["--img", two, "--proc", "coloc_match", "--device",
                    "cpu"])
classified = cli.main(["--img", two, "--proc", "classify", "--device",
                       "cpu"])
clusters = cli.main(["--img", two, "--register", "cluster_blobs",
                     "--device", "cpu"])
assert coloc.colocalizations.shape == (len(coloc), 2) and len(matches)
assert len(classified) == len(coloc) == len(clusters)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "magellanmapper_tpu"))
assert not loaded, loaded
print(len(names), len(blobs), len(df), len(reg["paths"]), len(vols))
"""


def test_both_cli_tasks_run_without_the_reference(tmp_path):
    """A fresh interpreter imports every port module and runs detection,
    the grid search, ``--register single`` and the specimen pipeline's
    tasks (transform, preprocess, make_density_images, vol_stats,
    export_regions) and the blob analysis (detect_coloc, coloc_match,
    classify, cluster_blobs) on the CPU; neither jax nor any module of the
    reference package is loaded (conftest imports jax here)."""
    roi, centres = testing.make_grid_roi((24, 48, 48), 0, spacing=12,
                                         jitter=2)
    img = str(tmp_path / "roi.npy")
    np.save(img, roi)
    truth = testing.write_truth_db(str(tmp_path / "truth.db"), centres,
                                   roi.shape)
    pair = gauntlet.build_pair((20, 28, 28), seed=0, device="cpu",
                               ffd_spacing=16.0, ffd_ctrl_sigma=3.0)
    fixed = str(tmp_path / "fixed.npy")
    np_io.write_npy(fixed, pair["fixed"])
    atlas = tmp_path / "atlas"
    atlas.mkdir()
    for name, arr in (("atlasVolume", pair["moving"]),
                      ("annotation", pair["labels"])):
        sitk_io.write_med_img(str(atlas / f"{name}.mhd"),
                              sitk_io.MedImage(arr))
    prof = tmp_path / "atlas_short.yml"
    prof.write_text("reg_translation:\n  max_iter: 16\nreg_affine:\n"
                    "  max_iter: 8\nreg_bspline:\n  max_iter: 4\n")
    two = str(tmp_path / "two.npy")
    np_io.write_npy(two, testing.make_coloc_volume((24, 64, 64), 0)[0][None])
    out = subprocess.run(
        [sys.executable, "-c", _BOTH_TASKS_ALONE, img, truth, fixed,
         str(atlas), str(prof), _ontology_files(tmp_path)[0], two],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n_mods, n_blobs, n_rows, n_paths, n_regions = map(
        int, out.stdout.split()[-5:])
    assert n_mods >= 30 and n_blobs > 0 and n_rows == 4 and n_paths == 4
    assert n_regions > 0


_HOST_TASKS_ALONE = """
import sys
from magellanmapper_torch.io import cli
tif, spec, blobs_base = sys.argv[1:4]
img = cli.main(["--img", tif, "--proc", "import_only", "--set_meta",
                "resolutions=5.0,1.5,1.5"])
loaded = cli.main(["--img", tif, "--proc", "load", "--subimg_offset",
                   "1,2,3", "--subimg_size", "4,5,2"])
out_tif = cli.main(["--img", spec, "--proc", "export_tif"])
out_raw = cli.main(["--img", spec, "--proc", "export_raw", "--prefix",
                    spec + "_raw"])
df = cli.main(["--img", spec, "--proc", "export_blobs", "--prefix",
               blobs_base])
vendor = [cli.main(["--img", src, "--proc", "import_only"]).img.shape
          for src in sys.argv[4:]]
assert len(vendor) == 6, vendor
loaded_mods = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "magellanmapper_tpu"))
assert not loaded_mods, loaded_mods
print(img.img.shape, loaded.img.shape, out_tif, out_raw, len(df), vendor)
"""


def _vendor_files(directory, vol):
    """``vol`` as a CZI, LIF, ND2, OIB, OIF and IMS file each, built by
    the port's writers and ``testing``'s byte-level builders."""
    from magellanmapper_torch.io import czi_lif
    paths = [str(directory / "czi.czi"), str(directory / "lif.lif")]
    czi_lif.write_czi(paths[0], vol, resolutions=(5.0, 1.5, 1.5))
    czi_lif.write_lif(paths[1], vol, resolutions=(5.0, 1.5, 1.5))
    files = {
        "nd2.nd2": testing.nd2_bytes(list(vol), testing.nd2_attributes(
            vol.shape[2], vol.shape[1], n_seq=len(vol))),
        "oib.oib": testing.cfbf_bytes({
            f"s_C001Z{z + 1:03d}.tif": testing.tiff_bytes(vol[z])
            for z in range(len(vol))}),
        "ims.ims": testing.ims_bytes([vol], ext=[(0, 18), (0, 20), (0, 6)]),
    }
    for name, data in files.items():
        (directory / name).write_bytes(data)
        paths.append(str(directory / name))
    paths.insert(4, testing.oif_files(str(directory), vol, name="oif"))
    return paths


def _same_image5d(got, want):
    np.testing.assert_array_equal(np.asarray(got.img), np.asarray(want.img))
    assert got.meta.get("resolutions") == want.meta.get("resolutions")


def test_host_cli_tasks_match_the_reference_without_it(tmp_path):
    """``--proc import_only|load|export_tif|export_raw|export_blobs`` in a
    fresh interpreter, on the host (no ``--device``, no card asked for),
    with neither jax nor the reference package loaded, ``import_only``
    also of a CZI, LIF, ND2, OIB, OIF and IMS file; their files equal
    the reference CLI's on copies of the same inputs."""
    rng = np.random.default_rng(9)
    vol = rng.integers(0, 3000, (6, 20, 18)).astype(np.uint16)
    rows = np.column_stack([rng.integers(0, 6, 5), rng.integers(0, 20, 5),
                            rng.integers(0, 18, 5), np.full(5, 2.5),
                            np.ones((5, 3)), rng.integers(0, 6, (5, 3))])
    paths = {}
    for sub in ("port", "ref"):
        d = tmp_path / sub
        d.mkdir()
        tiff.write_tiff(str(d / "stack.tif"), vol)
        np_io.write_npy(str(d / "spec.npy"), vol[None, ..., None].repeat(
            2, -1), resolutions=[[2.0, 1.0, 1.0]])
        archive = blobs.Blobs(rows.astype(float))
        archive.path = str(d / "p_blobs.npz")
        archive.save_archive()
        paths[sub] = (str(d / "stack.tif"), str(d / "spec.npy"),
                      str(d / "p"))
        vendor = d / "vendor"
        vendor.mkdir()
        paths[sub] += tuple(_vendor_files(vendor, vol))
    out = subprocess.run(
        [sys.executable, "-c", _HOST_TASKS_ALONE, *paths["port"]],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "(1, 6, 20, 18)" in out.stdout and "(1, 2, 5, 4)" in out.stdout
    for got, want in zip(paths["port"][3:], paths["ref"][3:]):
        ref_cli.main(["--img", want, "--proc", "import_only"])
        _same_image5d(np_io.read_file(os.path.splitext(got)[0]),
                      ref_np_io.read_file(os.path.splitext(want)[0]))
    tif, spec, base = paths["ref"][:3]
    ref_cli.main(["--img", tif, "--proc", "import_only", "--set_meta",
                  "resolutions=5.0,1.5,1.5"])
    ref_cli.main(["--img", spec, "--proc", "export_tif"])
    ref_cli.main(["--img", spec, "--proc", "export_raw", "--prefix",
                  spec + "_raw"])
    ref_cli.main(["--img", spec, "--proc", "export_blobs", "--prefix",
                  base])
    for name in ("stack_image5d.npy", "spec.tif", "spec.npy_raw.raw",
                 "p_blobs.csv"):
        with open(tmp_path / "port" / name, "rb") as a, \
                open(tmp_path / "ref" / name, "rb") as b:
            assert a.read() == b.read(), name
    port_meta = np_io.load_metadata(str(tmp_path / "port"
                                        / "stack_meta.yml"))
    ref_meta = ref_np_io.load_metadata(str(tmp_path / "ref"
                                           / "stack_meta.yml"))
    assert port_meta == ref_meta
    loaded = cli.main(["--img", paths["port"][0], "--proc", "load",
                       "--subimg_offset", "1,2,3", "--subimg_size",
                       "4,5,2"])
    ref_loaded = ref_cli.main(["--img", tif, "--proc", "load",
                               "--subimg_offset", "1,2,3",
                               "--subimg_size", "4,5,2"])
    np.testing.assert_array_equal(loaded.img, ref_loaded.img)


_RENDER_ALONE = """
import sys
from magellanmapper_torch.ops import render3d
assert not [m for m in sys.modules if m.split(".")[0] == "matplotlib"]
import numpy as np
from magellanmapper_torch.io import cli, export_stack
from magellanmapper_torch.plot import colormaps, plot_3d, plot_support
vol = np.random.default_rng(0).random((12, 16, 14)).astype(np.float32)
img = render3d.render_volume_sw(vol, 30.0, 20.0, out_hw=(8, 8),
                                device="cpu")
rgb, depth = render3d.render_isosurface(vol, 0.5, 30.0, 20.0, out_hw=(8, 8),
                                        n_steps=16, device="cpu")
frames = export_stack.render_rotation(vol, 2, "isosurface", out_hw=(8, 8),
                                      device="cpu")
est = plot_3d.deconvolve(vol, 2, device="cpu")
no_mpl = not [m for m in sys.modules if m.split(".")[0] == "matplotlib"]
img5d, db, table = sys.argv[1:4]
plane = cli.main(["--img", img5d, "--proc", "extract", "--offset", "0,0,2"])
rois = cli.main(["--img", img5d, "--proc", "export_rois", "--truth_db", db])
no_mpl_cli = not [m for m in sys.modules if m.split(".")[0] == "matplotlib"]
paths = cli.main(["--img", img5d, "--proc", "export_planes"])
gif = cli.main(["--img", img5d, "--proc", "animated", "--delay", "100"])
fig = cli.main(["--img", table, "--plot_2d", "bar_plot"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "magellanmapper_tpu"))
assert not loaded, loaded
assert no_mpl and no_mpl_cli
print(tuple(img.shape), len(frames), plane.shape, len(rois), len(paths), gif)
"""


def test_render_and_export_tasks_run_without_the_reference(tmp_path):
    """A fresh interpreter imports ``ops.render3d`` without matplotlib,
    renders and deconvolves on the CPU and runs ``--proc extract`` and
    ``--proc export_rois`` still without it, then the matplotlib tasks
    (``--proc export_planes``, ``--proc animated``, ``--plot_2d``); neither
    jax nor any module of the reference package is loaded."""
    img = str(tmp_path / "v.npy")
    np_io.write_npy(img, np.random.default_rng(1).integers(
        0, 900, (1, 4, 12, 10)).astype(np.uint16))
    db = testing.write_truth_db(str(tmp_path / "t.db"), [(1, 5, 5)],
                                (4, 12, 10))
    table = str(tmp_path / "t.csv")
    with open(table, "w") as f:
        f.write("a,b\nx,1\ny,3\n")
    out = subprocess.run(
        [sys.executable, "-c", _RENDER_ALONE, img, db, table],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "(8, 8, 3) 2 (12, 10) 1 4" in out.stdout
    assert os.path.isfile(str(tmp_path / "v.gif"))
    assert os.path.isfile(table + ".png")


_SEGMENT_ALONE = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)  # beside the test workers, one thread is fastest
from magellanmapper_torch import testing
from magellanmapper_torch.cv import cv_nd, segmenter
from magellanmapper_torch.io import cli, sitk_io
img, yml, base_a, base_b, ref = sys.argv[1:6]
fast = cli.main(["--img", img, "--proc", "detect", "--roi_profile",
                 "lightsheet," + yml, "--device", "cpu"])
vol = np.load(img)
(walker,), = [segmenter.segment_rw(vol, blobs=fast.blobs, device="cpu")]
ws = segmenter.segment_ws(vol, blobs=fast.blobs, device="cpu")
markers = segmenter.labels_to_markers_blob(ws, device="cpu")
dist = cv_nd.borders_distance(ws > 0, markers > 0, device="cpu")[0]
mesh = cv_nd.surface_net_mesh(vol, float(np.percentile(vol, 95)))
for base, lab in ((base_a, ws), (base_b, markers)):
    sitk_io.write_med_img(sitk_io.reg_out_path(base, "annotation.mhd"),
                          sitk_io.MedImage(lab.astype(np.int32)))
    sitk_io.write_med_img(sitk_io.reg_out_path(base, "atlasVolume.mhd"),
                          sitk_io.MedImage(vol.astype(np.float32)))
outs = [cli.main(["--img", base_a, base_b, "--register", task,
                  "--device", "cpu"]) for task in (
    "vol_compare", "labels_diff", "labels_diff_stats", "labels_dist",
    "merge_images", "merge_images_channels")]
outs.append(cli.main(["--img", base_a, base_b, "--register",
                      "export_common_labels", "--prefix",
                      base_a + "_common.csv", "--device", "cpu"]))
outs.append(cli.main(["--img", base_a, "--register", "make_labels_level",
                      "--labels", "path_ref=" + ref, "level=1",
                      "--device", "cpu"]))
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "magellanmapper_tpu"))
assert not loaded, loaded
print(len(fast), int(np.sum(walker == 1)), int(ws.max()),
      int(np.sum(markers > 0)), len(mesh[1]), len(outs[0]))
"""


def test_segmentation_and_register_tasks_run_without_the_reference(
        tmp_path):
    """A fresh interpreter runs the fast LoG route through the CLI (a
    profile file with ``log_dtype: bfloat16``), the random walker, the
    distance watershed, the blob markers, border distances and the mesh,
    then the new ``--register`` tasks on two samples written from those
    labels, on the CPU; neither jax nor any module of the reference
    package is loaded."""
    vol = testing.make_nuclei_volume((24, 64, 64), seed=2)[0]
    img = str(tmp_path / "nuclei.npy")
    np.save(img, vol)
    yml = tmp_path / "fast.yml"
    yml.write_text("log_dtype: bfloat16\n")
    out = subprocess.run(
        [sys.executable, "-c", _SEGMENT_ALONE, img, str(yml),
         str(tmp_path / "a.npy"), str(tmp_path / "b.npy"),
         _ontology_files(tmp_path)[0]],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n_blobs, n_fg, n_labels, n_markers, n_faces, n_regions = map(
        int, out.stdout.split()[-6:])
    assert n_blobs > 0 and n_fg >= n_blobs and n_labels > 1
    assert n_markers > 0 and n_faces > 0 and n_regions > 0
    assert os.path.isfile(str(tmp_path / "a_annotationDiff.mhd"))
