"""Region exports (``io/export_regions``), the blob heat map and the
specimen's command-line chain of ``magellanmapper_torch`` against the JAX
reference.

Tolerances: heat maps (int32) exactly, and the files that hold them byte
for byte; the ontology's CSV exports, metric and level images, common
labels and scaled coordinates exactly. The chain (``--register single``
-> ``--proc detect`` -> ``--register make_density_images`` ->
``--register vol_stats``, ``tests/test_cli_exports.py:421-468``) runs
through both command lines on the same inputs: the blobs equal, the heat
maps equal, the registered labels equal in all but 0.1% of voxels (each
engine optimises on its own; ``test_torch_register.py``), and the port's
``vol_stats`` on the reference's registered files gives the reference's
``_vols.csv`` column by column within the tolerances of
``test_torch_vols.py``.
"""

import filecmp
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from magellanmapper_tpu.atlas import ontology as ref_ontology
from magellanmapper_tpu.atlas import transform as ref_transform
from magellanmapper_tpu.cv import cv_nd as ref_cv_nd
from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.io import export_regions as ref_export
from magellanmapper_tpu.io import np_io as ref_np_io
from magellanmapper_tpu.io import sitk_io as ref_sitk
from magellanmapper_torch import testing
from magellanmapper_torch.atlas import ontology
from magellanmapper_torch.cv import blobs, cv_nd
from magellanmapper_torch.io import cli, export_regions, np_io, sitk_io

from test_torch_vols import ABA_TREE, assert_metrics_match

torch.set_num_threads(1)


@pytest.fixture
def aba_path(tmp_path):
    path = tmp_path / "ref.json"
    path.write_text(json.dumps(ABA_TREE))
    return str(path)


def test_build_heat_map_matches_reference():
    rng = np.random.default_rng(0)
    shape = (9, 11, 13)
    coords = np.vstack([
        rng.uniform(-2, 14, (400, 3)),            # some outside the shape
        rng.integers(0, 9, (50, 3)) + 0.5,        # ties round to even
        [[8.5, 10.5, 12.5], [-0.5, 0, 0]]])
    got = cv_nd.build_heat_map(shape, coords, device="cpu")
    want = ref_cv_nd.build_heat_map(shape, coords)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        cv_nd.build_heat_map(shape, np.zeros((0, 3)), device="cpu"),
        ref_cv_nd.build_heat_map(shape, np.zeros((0, 3))))


def test_scale_coords_truncate_in_float64():
    """Blob coordinates scale into the atlas as float64 products truncated
    by ``astype(int)``. From a (640, 960, 800) specimen into the 25 um
    atlas's (528, 320, 456), x scales by 0.57, and the float32 product of
    x = 100 (and 24 more of these coordinates) lands on the other side of
    an integer, so the copy must not use it."""
    shape = (528, 320, 456)
    coords = np.arange(1, 800, dtype=np.float64)[:, None].repeat(3, 1)
    scaling = np_io.find_scaling((640, 960, 800), shape)
    np.testing.assert_array_equal(
        scaling, ref_np_io.find_scaling((640, 960, 800), shape))
    got = ontology.scale_coords(coords, scaling, shape)
    np.testing.assert_array_equal(
        got, ref_ontology.scale_coords(coords, scaling, shape))
    f32 = (coords.astype(np.float32) * scaling.astype(np.float32)).astype(
        int)
    unclipped = ontology.scale_coords(coords, scaling)
    assert np.any(f32 != unclipped)


def _write_sample(where, shape, spacing, blob_rows, atlas_shape=None):
    """An image5d of ``shape``, its blob archive and, with
    ``atlas_shape``, a registered ``atlasVolume.mhd`` at ``spacing``."""
    os.makedirs(where, exist_ok=True)
    path = os.path.join(where, "sample.npy")
    np_io.write_npy(path, np.zeros(shape, np.uint16))
    arc = blobs.Blobs(blob_rows.copy())
    arc.format_blobs()
    arc.path = os.path.join(where, "sample_blobs.npz")
    arc.save_archive()
    if atlas_shape is not None:
        sitk_io.write_med_img(
            os.path.join(where, "sample_atlasVolume.mhd"),
            sitk_io.MedImage(np.zeros(atlas_shape, np.float32), spacing))
    return path


def _blob_rows(rng, n, shape, channels=(0,)):
    rows = np.column_stack([
        rng.uniform(0, 1, (n, 3)) * np.asarray(shape), np.full(n, 2.0),
        np.zeros((n, 2)), rng.choice(channels, n)])
    return rows


@pytest.mark.parametrize("case", ["atlas", "scale", "channel"])
def test_make_density_image_matches_reference(tmp_path, case):
    rng = np.random.default_rng(1)
    shape = (37, 61, 53)
    rows = _blob_rows(rng, 300, shape, channels=(0, 1))
    atlas_shape = (11, 16, 13) if case != "scale" else None
    kwargs = {"scale": 0.3} if case == "scale" else (
        {"channel": [1]} if case == "channel" else {})
    outs = []
    for name, fn in (("ref", ref_export.make_density_image),
                     ("port", lambda p, **k: export_regions.make_density_image(
                         p, device="cpu", **k))):
        path = _write_sample(str(tmp_path / name), shape, (3.5, 3.8, 4.1),
                             rows, atlas_shape)
        heat, out = fn(path, **kwargs)
        outs.append((heat, out))
    (want, want_path), (got, got_path) = outs
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert os.path.basename(got_path) == os.path.basename(want_path)
    for ext in (".mhd", ".raw"):
        assert filecmp.cmp(got_path[:-4] + ext, want_path[:-4] + ext,
                           shallow=False)
    if case != "channel":
        assert int(got.sum()) == len(rows)


def test_make_density_images_for_several_samples(tmp_path):
    rng = np.random.default_rng(2)
    rows = [_blob_rows(rng, 50, (20, 24, 28)) for _ in range(2)]
    paths = {}
    for name in ("ref", "port"):
        paths[name] = [
            _write_sample(str(tmp_path / name / f"s{i}"), (20, 24, 28),
                          (1.0, 1.0, 1.0), r, (10, 12, 14))
            for i, r in enumerate(rows)]
        # a sample without blobs is logged and skipped
        missing = str(tmp_path / name / "none" / "sample.npy")
        os.makedirs(os.path.dirname(missing))
        np_io.write_npy(missing, np.zeros((4, 4, 4), np.uint16))
        paths[name].append(missing)
    want = ref_export.make_density_images_mp(paths["ref"])
    got = export_regions.make_density_images_mp(paths["port"],
                                                device="cpu")
    assert len(got) == len(want) == 2
    for (g, _), (w, _) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_ontology_exports_match_reference(tmp_path, aba_path):
    got_ref = ontology.LabelsRef(aba_path).load()
    want_ref = ref_ontology.LabelsRef(aba_path).load()
    for level in (None, 1):
        got = export_regions.export_region_ids(
            got_ref, str(tmp_path / f"p{level}.csv"), level)
        want = ref_export.export_region_ids(
            want_ref, str(tmp_path / f"r{level}.csv"), level)
        pd.testing.assert_frame_equal(got, want)
        assert filecmp.cmp(tmp_path / f"p{level}.csv",
                           tmp_path / f"r{level}.csv", shallow=False)
    export_regions.export_region_network(got_ref, str(tmp_path / "p.sif"))
    ref_export.export_region_network(want_ref, str(tmp_path / "r.sif"))
    assert filecmp.cmp(tmp_path / "p.sif", tmp_path / "r.sif",
                       shallow=False)
    labels = np.zeros((4, 5, 6), np.int32)
    labels[1], labels[2], labels[3, :2] = 4, -5, 3
    got = export_regions.make_labels_level_img(
        labels, got_ref, 1, str(tmp_path / "p_level.mhd"))
    want = ref_export.make_labels_level_img(
        labels, want_ref, 1, str(tmp_path / "r_level.mhd"))
    np.testing.assert_array_equal(got, want)
    assert filecmp.cmp(tmp_path / "p_level.raw", tmp_path / "r_level.raw",
                       shallow=False)
    df = pd.DataFrame({"Region": [3, 4, 5], "Density": [0.5, 1.5, 2.5]})
    got = export_regions.map_metric_to_labels_img(
        labels, df, "Density", str(tmp_path / "p_metric.mhd"))
    want = ref_export.map_metric_to_labels_img(
        labels, df, "Density", str(tmp_path / "r_metric.mhd"))
    np.testing.assert_array_equal(got, want)
    assert filecmp.cmp(tmp_path / "p_metric.raw", tmp_path / "r_metric.raw",
                       shallow=False)


def test_export_common_labels_matches_reference(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(3):
        path = str(tmp_path / f"s{i}.npy")
        labels = rng.integers(0, 6 + i, (5, 6, 7)).astype(np.int32)
        sitk_io.write_med_img(sitk_io.reg_out_path(path, "annotation.mhd"),
                              sitk_io.MedImage(labels))
        paths.append(path)
    got = export_regions.export_common_labels(paths,
                                              str(tmp_path / "p.csv"))
    want = ref_export.export_common_labels(paths, str(tmp_path / "r.csv"))
    pd.testing.assert_frame_equal(got, want)
    assert filecmp.cmp(tmp_path / "p.csv", tmp_path / "r.csv",
                       shallow=False)


# -- the command-line chain ---------------------------------------------------

def _chain_inputs(where):
    """The reference chain's sample (nuclei on a body) and atlas (the body
    shifted, its labels), under ``where``."""
    rng = np.random.default_rng(2)
    shape = (24, 40, 40)
    zz, yy, xx = np.indices(shape).astype(np.float32)
    body = np.exp(-(((zz - 12) / 9) ** 2 + ((yy - 20) / 15) ** 2
                    + ((xx - 20) / 15) ** 2) * 2).astype(np.float32)
    sample = body.copy()
    for c in rng.uniform(8, 32, (15, 3)):
        sample += 0.5 * np.exp(
            -((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) / 6.0)
    sample /= sample.max()
    moving = np.asarray(ref_transform.resample(
        jnp.asarray(body), {"t": jnp.asarray([-2.0, 1.0, 0.0])},
        "translation", shape))
    labels = (moving > 0.3).astype(np.int32) * 3
    labels[:, :, :20] *= 2                     # two regions
    os.makedirs(where)
    base = os.path.join(where, "s.npy")
    ref_np_io.write_npy(base, sample[None])
    atlas = os.path.join(where, "atlas")
    os.makedirs(atlas)
    ref_sitk.write_med_img(os.path.join(atlas, "atlasVolume.mhd"),
                           ref_sitk.MedImage(moving))
    ref_sitk.write_med_img(os.path.join(atlas, "annotation.mhd"),
                           ref_sitk.MedImage(labels))
    return base, atlas


def test_register_density_volstats_chain_matches_reference(tmp_path):
    runs = {}
    for name, main in (("ref", ref_cli.main),
                       ("port", lambda a: cli.main(a + ["--device", "cpu"]))):
        base, atlas = _chain_inputs(str(tmp_path / name))
        main(["--img", base, atlas, "--register", "single",
              "--atlas_profile", "ncc,noaffine,nobspline,smalliter",
              "--prefix", base])
        det = main(["--img", base, "--proc", "detect", "--roi_profile",
                    "4xnuc"])
        main(["--img", base, "--register", "make_density_images"])
        df = main(["--img", base, "--register", "vol_stats"])
        assert os.path.exists(base[:-4] + "_vols.csv")
        runs[name] = (base, det.blobs, df)
    (ref_base, ref_det, ref_df), (base, det, df) = runs["ref"], runs["port"]
    assert testing.rows_equal(det, ref_det)
    np.testing.assert_array_equal(
        sitk_io.load_registered_img(base, "heat.mhd"),
        ref_sitk.load_registered_img(ref_base, "heat.mhd"))
    labels = sitk_io.load_registered_img(base, "annotation.mhd")
    ref_labels = ref_sitk.load_registered_img(ref_base, "annotation.mhd")
    assert np.mean(labels != ref_labels) <= 1e-3
    assert df["Nuclei"].sum() > 0 and set(df["Region"]) == {3, 6}

    # the port's vol_stats on the reference's registered files
    out = str(tmp_path / "port_on_ref")
    got = cli.main(["--img", ref_base, "--register", "vol_stats",
                    "--prefix", out, "--device", "cpu"])
    atlas_img = ref_sitk.load_registered_img(ref_base, "atlasVolume.mhd")
    heat = ref_sitk.load_registered_img(ref_base, "heat.mhd")
    assert_metrics_match(got, ref_df, ref_labels, atlas_img, heat)
    got_csv = pd.read_csv(out + "_vols.csv")
    want_csv = pd.read_csv(ref_base[:-4] + "_vols.csv")
    assert_metrics_match(got_csv, want_csv, ref_labels, atlas_img, heat)


def test_export_regions_task_matches_reference(tmp_path, aba_path):
    for name, main in (("ref", ref_cli.main),
                       ("port", lambda a: cli.main(a + ["--device", "cpu"]))):
        main(["--register", "export_regions", "--labels",
              f"path_ref={aba_path}", "level=1",
              "--prefix", str(tmp_path / f"{name}.csv")])
    assert filecmp.cmp(tmp_path / "ref.csv", tmp_path / "port.csv",
                       shallow=False)


def test_transform_and_preprocess_tasks_match_reference(tmp_path):
    arr = (np.random.default_rng(4).random((1, 12, 20, 16)) * 500).astype(
        np.float32)
    outs = {}
    for name, main in (("ref", ref_cli.main),
                       ("port", lambda a: cli.main(a + ["--device", "cpu"]))):
        where = tmp_path / name
        where.mkdir()
        base = str(where / "v.npy")
        ref_np_io.write_npy(base, arr, resolutions=[[2.0, 1.0, 1.0]])
        path = main(["--img", base, "--proc", "transform", "--transform",
                     "rescale=0.5", "--plane", "xz"])
        pre = main(["--img", base, "--proc", "preprocess", "rotate90",
                    "remap", "--prefix", str(where / "pre.npy")])
        outs[name] = (path, pre)
    (ref_path, ref_pre), (path, pre) = outs["ref"], outs["port"]
    assert os.path.basename(path) == os.path.basename(ref_path)
    np.testing.assert_allclose(np_io.read_file(path).img,
                               ref_np_io.read_file(ref_path).img,
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(pre, ref_pre)
    shutil.rmtree(tmp_path)
