"""The rest of ``atlas/register`` and ``io/sitk_io``, and the ``--register``
tasks over registered samples and their tables, of ``magellanmapper_torch``
against the JAX reference, on the CPU.

Tolerances: every task's files equal the reference CLI's, CSV and MHD byte
for byte, PNG by pixels (``test_torch_export_stack.assert_same_files``);
tables and arrays of the library calls exactly (DSC and centroid distances
are float64 quotients of exact integer counts and sums in both packages).
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from magellanmapper_tpu.atlas import register as ref_register
from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.io import sitk_io as ref_sitk
from magellanmapper_tpu.stats import vols as ref_vols
from magellanmapper_torch.atlas import register
from magellanmapper_torch.cv import blobs as blobs_mod
from magellanmapper_torch.io import cli, np_io, sitk_io
from magellanmapper_torch.stats import vols

from test_torch_export_stack import assert_same_files
from test_torch_vols import ABA_TREE

torch.set_num_threads(1)

SHAPE = (10, 14, 12)


def _labels(seed, ids=(-3, -2, 0, 2, 3, 4, 5)):
    rng = np.random.default_rng(seed)
    lab = np.asarray(ids, np.int32)[rng.integers(0, len(ids), SHAPE)]
    lab[:2] = 0
    return lab


def _inputs(d):
    """Two registered samples ``a``/``b`` (atlas, annotation, heat map;
    ``a`` also an edited annotation), their blobs, an ontology, an
    ITK-SNAP label file, a smoothing-metrics table."""
    os.makedirs(d)
    rng = np.random.default_rng(0)
    for i, name in enumerate(("a", "b")):
        base = os.path.join(d, f"{name}.npy")
        np_io.write_npy(base, rng.integers(0, 300, SHAPE).astype(np.uint16),
                        resolutions=[[1.0, 1.0, 1.0]])
        imgs = {"atlasVolume.mhd": (rng.random(SHAPE) * 100).astype(
                    np.float32),
                "annotation.mhd": _labels(i),
                "heat.mhd": rng.integers(0, 3, SHAPE).astype(np.int32)}
        if name == "a":
            imgs["annotationEdit.mhd"] = np.roll(_labels(0), 1, axis=2)
        for suffix, img in imgs.items():
            sitk_io.write_med_img(sitk_io.reg_out_path(base, suffix),
                                  sitk_io.MedImage(img, (2.0, 1.0, 1.0)))
        blobs = np.zeros((40, 10), np.float32)
        blobs[:, :3] = rng.uniform(0, 10, (40, 3))
        blobs_mod.Blobs(blobs, path=os.path.join(
            d, f"{name}_blobs.npz")).save_archive()
    with open(os.path.join(d, "ref.json"), "w") as f:
        json.dump(ABA_TREE, f)
    with open(os.path.join(d, "labels.txt"), "w") as f:
        f.write("# ITK-SNAP\n0 0 0 0 0 0 0 \"Clear\"\n"
                "2 255 0 0 1 1 1 \"cortex\"\n4 0 255 0 1 1 1 \"layer1\"\n")
    pd.DataFrame({
        "Label": [2, 3, 4], "Filter_size": [1, 2, 3],
        "Compaction": [0.1, 0.2, 0.4], "Displacement": [0.5, 0.25, 0.1],
        "Smoothing_quality": [0.3, 0.4, 0.5],
        "Compactness": [10.0, 12.5, 9.0], "Vol_orig": [100, 50, 25],
    }).to_csv(os.path.join(d, "smoothing.csv"), index=False)


_TASKS = [
    ["{a}", "{b}", "--register", "export_common_labels", "--prefix",
     "{d}/common.csv"],
    ["{d}/labels.txt", "--register", "convert_itksnap_labels"],
    ["{a}", "--register", "make_labels_level", "--labels",
     "path_ref={d}/ref.json", "level=1"],
    ["{a}", "{b}", "--register", "labels_diff"],
    ["{a}", "{b}", "--register", "labels_diff_stats", "--prefix",
     "{d}/stats.npy"],
    ["{a}", "{b}", "--register", "labels_dist"],
    ["{a}", "--register", "labels_dist"],
    ["{d}/smoothing.csv", "--register", "smoothing_metrics_aggr"],
    ["{a}", "{b}", "--register", "plot_knns"],
    ["{d}/smoothing.csv", "--register", "plot_smoothing_metrics"],
    ["{d}/smoothing.csv", "--register", "export_metrics_compactness",
     "--prefix", "{d}/compact"],
    ["{a}", "{b}", "--register", "vol_compare"],
    ["{a}", "--register", "overlays"],
    ["{a}", "{b}", "--register", "merge_images"],
    ["{a}", "{b}", "--register", "merge_images_channels", "--prefix",
     "{d}/ch.npy"],
]


@pytest.mark.parametrize("argv", _TASKS, ids=lambda a: "-".join(
    w for w in a if not w.startswith(("{", "--"))))
def test_register_task_files_match_reference(tmp_path, argv):
    outs = {}
    for sub, main, extra in (("port", cli.main, ["--device", "cpu"]),
                             ("ref", ref_cli.main, [])):
        d = str(tmp_path / sub)
        _inputs(d)
        args = [w.format(d=d, a=os.path.join(d, "a.npy"),
                         b=os.path.join(d, "b.npy")) for w in argv]
        outs[sub] = main(["--img"] + args + extra)
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "ref"))
    got, want = outs["port"], outs["ref"]
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want)
    elif hasattr(want, "img"):
        np.testing.assert_array_equal(got.img, want.img)
    elif isinstance(want, float):
        assert got == want


def test_register_tasks_are_ported():
    names = ("export_common_labels", "convert_itksnap_labels",
             "make_labels_level", "labels_diff", "labels_diff_stats",
             "labels_dist", "smoothing_metrics_aggr", "plot_knns",
             "plot_smoothing_metrics", "export_metrics_compactness",
             "vol_compare", "overlays", "merge_images",
             "merge_images_channels")
    for name in names:
        rc = cli.process_cli_args(["--img", "a.npy", "--register", name])
        assert rc.register_type.name == name.upper()
        assert rc.register_type in cli.TABLE_TASKS
    assert len(cli.TABLE_TASKS) == len(names)


@pytest.mark.parametrize("kwargs", [
    {}, {"unit_factor": 8.0, "groups": {"Condition": ["x", "y"]}},
    {"combine_sides": False}, {"labels_ref": True, "max_level": 1}])
def test_volumes_by_id_matches_reference(tmp_path, kwargs):
    d = str(tmp_path)
    _inputs(os.path.join(d, "s"))
    paths = [os.path.join(d, "s", f"{n}.npy") for n in ("a", "b")]
    kw = dict(kwargs)
    if kw.pop("labels_ref", False):
        kw["labels_ref_path"] = os.path.join(d, "s", "ref.json")
    got = register.volumes_by_id(paths, out_path=os.path.join(d, "p.csv"),
                                 device="cpu", **kw)
    want = ref_register.volumes_by_id(
        paths, out_path=os.path.join(d, "r.csv"), **kw)
    # the port's moments are float64 where the reference's are float32
    # (ROADMAP section 3; test_torch_vols.py holds each column)
    pd.testing.assert_frame_equal(got, want, check_dtype=False,
                                  check_exact=False, rtol=1e-5)
    assert len(got) > 0


def test_volumes_by_id_compare_and_label_ids_match_reference(tmp_path):
    d = str(tmp_path / "s")
    _inputs(d)
    paths = [os.path.join(d, f"{n}.npy") for n in ("a", "b")]
    pd.testing.assert_frame_equal(
        register.volumes_by_id_compare(paths, device="cpu"),
        ref_register.volumes_by_id_compare(paths))
    lab = _labels(3)
    for combine in (True, False):
        np.testing.assert_array_equal(
            register.make_label_ids_set(lab, combine_sides=combine),
            ref_register.make_label_ids_set(lab, combine_sides=combine))


def test_reg_imgs_repeat_and_scaled_regionprops():
    fields = dict(exp_orig=1, exp=2, atlas=3, labels=4, labels_markers=5,
                  borders=6, exp_mask=7, atlas_mask=8)
    assert vars(register.RegImgs(**fields)) == vars(
        ref_register.RegImgs(**fields))

    class Result:
        def transform_img(self, img, order=1):
            return (img, order)

    for keep in (True, False):
        assert register.register_repeat(Result(), "img", keep) == \
            ref_register.register_repeat(Result(), "img", keep)
    region = np.zeros((9, 12, 10), bool)
    region[2:7, 3:11, 1:4] = True
    region[5, 2, 8] = True
    for scaling in ((1.0, 1.0, 1.0), (0.5, 0.25, 2.0)):
        got = register.get_scaled_regionprops(region, scaling)
        want = ref_register.get_scaled_regionprops(region, scaling)
        assert got[1:] == want[1:]
        assert got[0][0].bbox == want[0][0].bbox
    assert register.get_scaled_regionprops(np.zeros((3, 3, 3), bool),
                                           (1, 1, 1)) == (None, None, None)


def test_overlay_matches_reference(tmp_path):
    outs = {}
    for sub, fn, extra in (("port", register.overlay_registered_imgs,
                            {"device": "cpu"}),
                           ("ref", ref_register.overlay_registered_imgs, {})):
        d = str(tmp_path / sub)
        _inputs(d)
        outs[sub] = fn(os.path.join(d, "a.npy"),
                       out_path=os.path.join(d, "o.png"), **extra)
    assert outs["port"] == outs["ref"]
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "ref"))


def test_sitk_io_rest_matches_reference(tmp_path):
    d = str(tmp_path / "s")
    _inputs(d)
    a = os.path.join(d, "a.npy")
    got = sitk_io.read_sitk_files(a, "annotation.mhd")
    want = ref_sitk.read_sitk_files(a, "annotation.mhd")
    np.testing.assert_array_equal(got.img, want.img)
    assert got.meta == want.meta and got.path_img == want.path_img
    mhd = sitk_io.reg_out_path(a, "atlasVolume.mhd")
    for fn in ("read_img", "read_sitk"):
        g, w = getattr(sitk_io, fn)(mhd), getattr(ref_sitk, fn)(mhd)
        np.testing.assert_array_equal(g.img, w.img)
        assert (g.spacing, g.origin) == (w.spacing, w.origin)
    names = ["atlasVolume.mhd", "annotation.mhd", "missing.mhd"]
    g = sitk_io.load_registered_imgs(a, names)
    w = ref_sitk.load_registered_imgs(a, names)
    assert sorted(g) == sorted(w)
    for key in g:
        np.testing.assert_array_equal(g[key], w[key])
    arr = _labels(5)
    for pkg, sub in ((sitk_io, "p"), (ref_sitk, "r")):
        os.makedirs(os.path.join(d, sub))
        pkg.write_img(os.path.join(d, sub, "w.mhd"), arr, (2.0, 1.0, 0.5))
        pkg.write_registered_image(arr, os.path.join(d, sub, "x.npy"),
                                   "annotation.mhd", (1.0, 2.0, 3.0))
        with pytest.raises(FileExistsError):
            pkg.write_registered_image(arr, os.path.join(d, sub, "x.npy"),
                                       "annotation.mhd")
        pkg.write_pts(os.path.join(d, sub, "pts.txt"),
                      [[1, 2.5, 3], [4.25, 5, 6]], "index")
        np.save(os.path.join(d, sub, "v.npy"), arr[None])
    assert_same_files(os.path.join(d, "p"), os.path.join(d, "r"))
    for rotate in (False, True):
        np.testing.assert_array_equal(
            sitk_io.load_numpy_to_sitk(os.path.join(d, "p", "v.npy"),
                                       rotate).img,
            ref_sitk.load_numpy_to_sitk(os.path.join(d, "r", "v.npy"),
                                        rotate).img)
    src, dst = sitk_io.read_img(mhd), sitk_io.MedImage(arr)
    out = sitk_io.match_world_info(src, dst)
    assert (out.spacing, out.origin) == (src.spacing, src.origin)
    med = sitk_io.replace_sitk_with_numpy(src, arr)
    ref_med = ref_sitk.replace_sitk_with_numpy(ref_sitk.read_img(mhd), arr)
    assert (med.spacing, med.origin) == (ref_med.spacing, ref_med.origin)
    np.testing.assert_array_equal(sitk_io.convert_img(med),
                                  ref_sitk.convert_img(ref_med))
    np.testing.assert_array_equal(sitk_io.convert_img(arr), arr)
    assert sitk_io.sitk_to_itk_img(med) is med
    assert sitk_io.itk_to_sitk_img(med) is med
    paths = [a, os.path.join(d, "b.npy"), os.path.join(d, "none.npy")]
    for fn in (np.sum, np.max, None):
        g = sitk_io.merge_images(paths, "annotation.mhd", fn_combine=fn)
        w = ref_sitk.merge_images(paths, "annotation.mhd", fn_combine=fn)
        np.testing.assert_array_equal(g.img, w.img)
    assert sitk_io.merge_images([paths[2]], "annotation.mhd") is None
    ref_json = os.path.join(d, "ref.json")
    for drawn in (False, True):
        assert sitk_io.find_atlas_labels(ref_json, drawn) == \
            ref_sitk.find_atlas_labels(ref_json, drawn)


def test_label_overlap_with_a_float_heat_map_matches_reference():
    """A float and an integer heat map's nuclei, summed on the host in
    numpy's order, both equal the reference's."""
    a, b = _labels(6), np.roll(_labels(6), 2, axis=1)
    rng = np.random.default_rng(7)
    for heat in (rng.random(SHAPE).astype(np.float32),
                 rng.integers(0, 4, SHAPE).astype(np.int32)):
        for combine in (True, False):
            pd.testing.assert_frame_equal(
                vols.measure_label_overlap(a, b, heat, combine,
                                           device="cpu"),
                ref_vols.measure_label_overlap(a, b, heat, combine))
