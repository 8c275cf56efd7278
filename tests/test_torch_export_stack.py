"""The port's plane, animation and ROI exports (``io/export_stack``,
``io/export_rois``, ``io/sqlite.get_rois``) and the new command-line tasks
(``--proc extract|export_rois|export_planes|export_planes_channels|
animated``, ``--plot_2d``) against the reference's on the same inputs:
``.npy`` and CSV files bit for bit, PNG planes and GIF frames as pixel
arrays, the orbit's rendered frames within the render tests' limit."""

import filecmp
import os

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.io import export_rois as ref_export_rois
from magellanmapper_tpu.io import export_stack as ref_export_stack
from magellanmapper_tpu.io import sqlite as ref_sqlite
from magellanmapper_tpu.ops import preproc as ref_preproc
from magellanmapper_tpu.ops import render3d as ref_render3d
from magellanmapper_torch import testing
from magellanmapper_torch.io import cli, export_rois, export_stack, np_io
from magellanmapper_torch.io import sqlite

torch.set_num_threads(1)

#: rendered orbit frames, as ``tests/test_torch_render3d.py``'s images
IMG_ATOL = 1e-4


def frames(path: str) -> list:
    """Every frame of an image file as an RGBA array."""
    out = []
    with Image.open(path) as img:
        for i in range(getattr(img, "n_frames", 1)):
            img.seek(i)
            out.append(np.asarray(img.convert("RGBA")))
    return out


def assert_same_files(got_dir, want_dir):
    """Both trees hold the same files, each equal: images by their frames'
    pixels, anything else byte for byte."""
    got, want = ([os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs]
                 for d in (got_dir, want_dir))
    assert sorted(got) == sorted(want)
    for rel in got:
        a, b = os.path.join(got_dir, rel), os.path.join(want_dir, rel)
        if rel.endswith((".png", ".gif", ".jpg")):
            fa, fb = frames(a), frames(b)
            assert len(fa) == len(fb), rel
            for x, y in zip(fa, fb):
                np.testing.assert_array_equal(x, y, err_msg=rel)
        else:
            assert filecmp.cmp(a, b, shallow=False), rel


def _vol(multichannel=False, shape=(5, 18, 16)):
    rng = np.random.default_rng(3)
    vol = rng.integers(0, 4000, shape + ((2,) if multichannel else ()))
    return vol.astype(np.uint16)


# -- export_stack ---------------------------------------------------------------

@pytest.mark.parametrize("multichannel,kwargs", [
    (False, {}), (True, {}), (True, {"channel": 1}),
    (True, {"separate_channels": True, "ext": "jpg"})])
def test_export_planes_matches_reference(tmp_path, multichannel, kwargs):
    image = _vol(multichannel)[None]
    got = export_stack.export_planes(image, str(tmp_path / "p"), **kwargs)
    want = ref_export_stack.export_planes(image, str(tmp_path / "r"),
                                          **kwargs)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    assert_same_files(str(tmp_path / "p"), str(tmp_path / "r"))


@pytest.mark.parametrize("multichannel,channel,name", [
    (False, None, "a.gif"), (True, None, "a.avi"), (True, 0, "a.mp4")])
def test_animate_imgs_matches_reference(tmp_path, multichannel, channel,
                                        name):
    image = _vol(multichannel)
    os.makedirs(tmp_path / "p")
    os.makedirs(tmp_path / "r")
    got = export_stack.animate_imgs(image, str(tmp_path / "p" / name),
                                    fps=5, channel=channel)
    want = ref_export_stack.animate_imgs(image, str(tmp_path / "r" / name),
                                         fps=5, channel=channel)
    assert os.path.basename(got) == os.path.basename(want)
    assert_same_files(str(tmp_path / "p"), str(tmp_path / "r"))


def _ref_rotation(vol, n_frames, mode, elev, out_hw, level, vmin_frac):
    """The frames the reference's ``animate_rotation_3d`` renders."""
    v = jnp.asarray(vol.astype(np.float32))
    vmax = float(np.max(vol))
    if mode == "isosurface" and level is None:
        level = float(ref_preproc.otsu_threshold(v))
    out = []
    for i in range(n_frames):
        az = 360.0 * i / n_frames
        if mode == "isosurface":
            out.append(np.asarray(ref_render3d.render_isosurface_sw(
                v, level, az, elev, out_hw=out_hw)[0]))
        else:
            out.append(np.asarray(ref_render3d.render_volume_sw(
                v, az, elev, vmin=vmin_frac * vmax, vmax=vmax, out_hw=out_hw,
                mode="mip" if mode == "mip" else "composite")))
    return out


@pytest.mark.parametrize("mode,level", [
    ("mip", None), ("volume", None), ("isosurface", None),
    ("isosurface", 0.4)])
def test_rotation_frames_match_reference(tmp_path, mode, level):
    vol, _ = testing.make_nuclei_volume((24, 40, 32), seed=2, spacing=12,
                                        jitter=2)
    vol = vol.astype(np.float32) / vol.max()
    got = export_stack.render_rotation(vol, 6, mode, 25.0, (32, 40), level,
                                       0.2, device="cpu")
    want = _ref_rotation(vol, 6, mode, 25.0, (32, 40), level, 0.2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=IMG_ATOL)
    out = export_stack.animate_rotation_3d(
        vol, str(tmp_path / "orbit.mov"), n_frames=6, mode=mode,
        out_hw=(32, 40), level=level, vmin_frac=0.2, device="cpu")
    ref_out = ref_export_stack.animate_rotation_3d(
        vol, str(tmp_path / "ref_orbit.mov"), n_frames=6, mode=mode,
        out_hw=(32, 40), level=level, vmin_frac=0.2)
    assert os.path.basename(out) == "orbit.gif"
    assert os.path.basename(ref_out) == "ref_orbit.gif"
    got, want = frames(out), frames(ref_out)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        # rendered frames agree within IMG_ATOL, so the GIF's 8-bit
        # quantisation may move a value on a step boundary by one level
        # (132 of 1,228,800 values at the isosurface's level 0.4)
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_montage_and_registered_planes_match_reference(tmp_path):
    image = _vol(True)[None]
    got = export_stack.stack_to_img(image, str(tmp_path / "m.png"),
                                    slice_range=(1, 5), n_cols=3)
    want = ref_export_stack.stack_to_img(image, str(tmp_path / "r.png"),
                                         slice_range=(1, 5), n_cols=3)
    np.testing.assert_array_equal(frames(got)[0], frames(want)[0])
    rng = np.random.default_rng(4)
    planes = [rng.random((12, 10)), rng.integers(0, 4, (12, 10)),
              rng.integers(0, 2, (12, 10))]
    export_stack.reg_planes_to_img(planes, str(tmp_path / "reg.png"))
    ref_export_stack.reg_planes_to_img(planes, str(tmp_path / "ref.png"))
    np.testing.assert_array_equal(frames(str(tmp_path / "reg.png"))[0],
                                  frames(str(tmp_path / "ref.png"))[0])


@pytest.mark.parametrize("rescale", [1.0, 0.5])
def test_plane_stack_matches_reference(rescale):
    vol = _vol().astype(np.float32)
    labels = np.random.default_rng(5).integers(0, 6, vol.shape).astype(
        np.int32)
    kw = dict(offset=(1, 2, 3), roi_size=(3, 12, 10), slice_vals=(0, 3),
              rescale=rescale, labels_imgs=[labels, None])
    got = export_stack.setup_stack(vol[None], device="cpu", **kw)
    want = ref_export_stack.setup_stack(vol[None], **kw)
    assert got.slice_vals == want.slice_vals and got.rescale == want.rescale
    for sv in (None, (1, 3)):
        for g_planes, w_planes in zip(got.build_stack(sv),
                                      want.build_stack(sv)):
            for g, w in zip(g_planes, w_planes):
                # float32 resizes summed in other orders
                assert g.dtype == w.dtype
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)

    def fn(i, plane):
        return i, plane * 2

    got = export_stack.StackPlaneIO.set_data([vol], fn, device="cpu")
    want = ref_export_stack.StackPlaneIO.set_data([vol], fn)
    for g, w in zip(got.build_stack(), want.build_stack()):
        np.testing.assert_array_equal(g[0], w[0])


# -- ROI exports -------------------------------------------------------------------

def _truth_db(path, shape):
    db = sqlite.load_db(path)
    exp = db.select_or_insert_experiment("roi")
    for offset, size, centres in (((2, 3, 1), (10, 8, 3), [(2, 5, 4)]),
                                  ((0, 0, 0), (16, 18, 5),
                                   [(1, 2, 3), (4, 10, 9)])):
        roi_id, _ = db.select_or_insert_roi(exp, 0, offset, size)
        rows = np.column_stack([np.asarray(centres, float),
                                np.full(len(centres), 2.5),
                                np.ones((len(centres), 3))])
        db.insert_blobs(roi_id, rows)
    db.close()
    return path


def test_get_rois_matches_reference(tmp_path):
    path = _truth_db(str(tmp_path / "t.db"), (5, 18, 16))
    got_db, want_db = sqlite.load_db(path), ref_sqlite.load_db(path)
    try:
        for exp in (None, 1, 2):
            assert [tuple(r) for r in got_db.get_rois(exp)] == [
                tuple(r) for r in want_db.get_rois(exp)]
    finally:
        got_db.close()
        want_db.close()


def test_export_rois_matches_reference(tmp_path):
    vol = _vol()
    path = _truth_db(str(tmp_path / "t.db"), vol.shape)
    got_db, want_db = sqlite.load_db(path), ref_sqlite.load_db(path)
    try:
        got = export_rois.export_rois(vol, got_db, [0], str(tmp_path / "p"),
                                      padding=(0, 1, 1))
        want = ref_export_rois.export_rois(vol, want_db, [0],
                                           str(tmp_path / "r"),
                                           padding=(0, 1, 1))
    finally:
        got_db.close()
        want_db.close()
    pd.testing.assert_frame_equal(got, want)
    assert_same_files(str(tmp_path / "p"), str(tmp_path / "r"))


def test_roi_paths_and_files_match_reference(tmp_path):
    base = str(tmp_path / "img")
    for roi_id in (3, 12):
        d, img, blobs = export_rois.make_roi_paths(base, roi_id,
                                                   make_dirs=True)
        assert (d, img, blobs) == ref_export_rois.make_roi_paths(base,
                                                                 roi_id)
        np.save(img, np.full((2, 3, 4), roi_id))
        np.save(blobs, np.arange(12.0).reshape(3, 4) * roi_id)
    assert export_rois.make_roi_paths(base, "*") == \
        ref_export_rois.make_roi_paths(base, "*")
    got, want = export_rois.load_roi_files(None, base), \
        ref_export_rois.load_roi_files(None, base)
    assert got[0] == want[0]
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        np.testing.assert_array_equal(g, w)


# -- the command line ---------------------------------------------------------------

def _inputs(d, multichannel):
    os.makedirs(d)
    np_io.write_npy(os.path.join(d, "v.npy"), _vol(multichannel)[None],
                    resolutions=[[2.0, 1.0, 1.0]])
    _truth_db(os.path.join(d, "t.db"), (5, 18, 16))
    pd.DataFrame({
        "Region": list("abcd"), "Volume": [3.0, 1.5, 2.25, 4.0],
        "Nuclei": [10, 4, 7, 12], "FDR": [0.1, 0.2, 0.3, 0.5],
        "SENS": [0.6, 0.7, 0.9, 0.95]}).to_csv(
            os.path.join(d, "tab.csv"), index=False)


_CLI_TASKS = [
    (False, ["--proc", "extract"]),
    (True, ["--proc", "extract", "--offset", "1,2,3", "--plane", "xz"]),
    (False, ["--proc", "extract", "--offset", "4,5,6", "--plane", "yz",
             "--prefix", "{d}/out.npy"]),
    (False, ["--proc", "export_rois", "--truth_db", "{d}/t.db"]),
    (True, ["--proc", "export_rois", "--truth_db", "{d}/t.db", "--channel",
            "1"]),
    (False, ["--proc", "export_planes"]),
    (True, ["--proc", "export_planes", "--channel", "1", "--savefig",
            "jpg"]),
    (True, ["--proc", "export_planes_channels"]),
    (False, ["--proc", "animated", "--slice", "1,5", "--delay", "200"]),
    (True, ["--proc", "animated", "--channel", "0"]),
    (True, ["--proc", "animated", "--slice", "0,5,2"]),
]


@pytest.mark.parametrize("multichannel,argv", _CLI_TASKS)
def test_cli_task_outputs_match_reference(tmp_path, multichannel, argv):
    for sub, main in (("port", cli.main), ("ref", ref_cli.main)):
        d = str(tmp_path / sub)
        _inputs(d, multichannel)
        main(["--img", os.path.join(d, "v.npy")]
             + [a.format(d=d) for a in argv])
        os.remove(os.path.join(d, "t.db"))
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "ref"))


@pytest.mark.parametrize("task,labels", [
    ("bar_plot", ["--labels", "x_col=Region", "y_col=Nuclei"]),
    ("line_plot", []), ("scatter_plot", ["--plot_labels", "x_col=Volume",
                                         "y_col=Nuclei"]),
    ("roc_curve", []), ("histogram", []), ("swarm_plot", []),
    ("bar_plot_vols_stats", []), ("cat_plot", [])])
def test_plot_2d_task_matches_reference(tmp_path, task, labels):
    for sub, main in (("port", cli.main), ("ref", ref_cli.main)):
        d = str(tmp_path / sub)
        _inputs(d, False)
        os.remove(os.path.join(d, "t.db"))
        # seaborn's strip plot jitters from numpy's global generator
        np.random.seed(0)
        main(["--img", os.path.join(d, "tab.csv"), "--plot_2d", task]
             + labels)
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "ref"))
