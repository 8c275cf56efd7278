"""The port's session controller (``gui/visualizer.Visualization``)
against the reference's on the same seeded planted-nuclei image: the
same ROI cut (x,y,z sliders over a z,y,x image, a non-cubic ROI), the
reference's blobs from ROI detection (exactly), the same database rows,
3D scenes within the render limits (images 1e-4, depth 1e-3 voxels),
and the other tabs' workflows, enums and adapters. ``HOME`` and the
working directory are a temporary directory, so neither package reads
the user's preferences."""

import json
import os

import numpy as np
import pytest
import torch

from magellanmapper_tpu.gui import visualizer as ref_visualizer
from magellanmapper_tpu.io import np_io as ref_np_io
from magellanmapper_tpu.io import tiff as ref_tiff
from magellanmapper_torch import testing
from magellanmapper_torch.gui import visualizer, vis_3d
from magellanmapper_torch.io import np_io

torch.set_num_threads(1)

SHAPE = (24, 56, 48)


@pytest.fixture
def home(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.fixture(scope="module")
def volume():
    return testing.make_nuclei_volume(SHAPE, 3, spacing=12, jitter=2)


def sessions(home, volume, offset=(4, 6, 2), size=(40, 44, 20)):
    """Both packages' controllers over the same image5d, with the
    ``lightsheet`` profile and an ROI at x,y,z ``offset`` of ``size``."""
    vol, _ = volume
    out = []
    for vis_mod, np_mod, kw in ((visualizer, np_io, {"device": "cpu"}),
                                (ref_visualizer, ref_np_io, {})):
        path = str(home / f"{vis_mod.__name__.split('.')[0]}.npy")
        np_mod.write_npy(path, vol[None], resolutions=[[1.0, 1.0, 1.0]])
        vis = vis_mod.Visualization(**kw)
        vis.load_image(path)
        vis.set_roi_profile("lightsheet")
        vis.roi_offset = offset
        vis.roi_size = size
        out.append(vis)
    return out


def test_roi_cut_and_detection_match_reference(home, volume):
    port, ref = sessions(home, volume)
    roi = port.get_roi()
    np.testing.assert_array_equal(roi, ref.get_roi())
    assert roi.shape == (20, 44, 40)
    np.testing.assert_array_equal(roi, volume[0][2:22, 6:50, 4:44])
    got, want = port.detect_blobs(), ref.detect_blobs()
    assert got is not None and len(got) >= 5
    np.testing.assert_array_equal(got, want)
    _, centres = volume
    inside = centres[np.all((centres >= (2, 6, 4))
                            & (centres < (22, 50, 44)), axis=1)]
    sens, ppv = testing.sens_ppv(got, inside - (2, 6, 4), roi.shape,
                                 roi.shape, 3)
    assert sens > 0.85 and ppv > 0.7
    for vis in (port, ref):
        vis.confirm_blob(0, 1)
        vis.confirm_blob(1, 0)
        vis.open_db(str(home / f"{type(vis).__module__}.db"))
        assert vis.save_blobs("sess", 2) == len(got)
    rows = [vis.db.select_blobs_by_roi(vis.db.get_rois()[0]["id"])
            for vis in (port, ref)]
    np.testing.assert_array_equal(*rows)
    assert tuple(port.db.get_rois()[0]) == tuple(ref.db.get_rois()[0])
    for vis in (port, ref):
        vis.db.close()


def test_channels_as_reference(home, volume):
    port, ref = sessions(home, volume)
    port.channel = ref.channel = [0]
    np.testing.assert_array_equal(port.detect_blobs(), ref.detect_blobs())


def test_roi_under_the_peak_capacity_fails_in_the_reference_pin(
        home, volume):
    """An ROI of fewer LoG voxels than the reference's peak capacity
    (4,096 rows of its top-k) makes the reference's detection raise; the
    port's returns the blobs (ROADMAP section 3)."""
    port, ref = sessions(home, volume, offset=(0, 0, 0), size=(8, 8, 4))
    got = port.detect_blobs()
    assert got is not None and got.shape[1] == 10
    with pytest.raises(ValueError, match="top_k"):
        ref.detect_blobs()
    assert port.save_blobs() == ref.save_blobs() == 0


@pytest.mark.parametrize("style", ["volume", "mip", "isosurface"])
def test_3d_scenes_match_reference(home, volume, style):
    port, ref = sessions(home, volume, size=(24, 24, 12))
    for vis in (port, ref):
        vis.detect_blobs()
    cvs = [port.open_3d_canvas(style), ref.open_3d_canvas(style)]
    for cv3 in cvs:
        cv3.orbit(35.0, -12.0)
    imgs = [np.asarray(cv3.ax.get_images()[0].get_array(), np.float32)
            for cv3 in cvs]
    np.testing.assert_allclose(imgs[0], imgs[1], atol=1e-4, rtol=0)
    if style == "isosurface":
        d0, d1 = cvs[0]._depth, cvs[1]._depth
        fin = np.isfinite(d1)
        assert np.array_equal(np.isfinite(d0), fin)
        np.testing.assert_allclose(d0[fin], d1[fin], atol=1e-3, rtol=0)
    np.testing.assert_allclose(cvs[0].project_blobs(),
                               cvs[1].project_blobs(), atol=1e-5, rtol=0)
    rend = port.open_3d_renderer(style, render_hw=(384, 384))
    assert isinstance(rend, vis_3d.Vis3DRenderer)
    rend.orbit(35.0, -12.0)
    np.testing.assert_array_equal(rend.frame, imgs[0])
    pts = rend.project_blobs()
    vis_idx = np.flatnonzero(pts[:, 2] > 0)
    front = vis_idx[np.argmin(pts[vis_idx, 3])]
    picks = [sc.pick_blob(pts[front, 0], pts[front, 1])
             for sc in (rend, cvs[0], cvs[1])]
    assert picks == [front] * 3
    assert rend.confirm_selected() == cvs[1].confirm_selected() == 0
    for style_2d in ("points",) if style == "mip" else ():
        for vis in (port, ref):
            out = str(home / f"{type(vis).__module__}_pts.png")
            vis.show_3d(out, style=style_2d)
            assert os.path.exists(out)


def test_figures_and_surface_as_reference(home, volume):
    port, ref = sessions(home, volume, size=(24, 24, 12))
    for vis in (port, ref):
        vis.detect_blobs()
        name = type(vis).__module__
        vis.show_roi(str(home / f"{name}_roi.png"), n_cols=4)
        assert os.path.exists(str(home / f"{name}_roi.png"))
        out = vis.show_3d(str(home / f"{name}_vol.png"), style="volume")
        assert os.path.getsize(out) > 0
    figs = [vis.show_3d(str(home / "s.png"), style="surface")
            for vis in (port, ref)]
    np.testing.assert_array_equal(figs[0][1][1], figs[1][1][1])
    np.testing.assert_allclose(figs[0][1][0], figs[1][1][0], atol=1e-12)


def test_other_tabs_as_reference(home, volume, rng):
    src = (np.random.default_rng(9).random((4, 24, 24)) * 1000).astype(
        np.uint16)
    tif = str(home / "import_me.tif")
    ref_tiff.write_tiff(tif, src)
    cache = home / "allen_test_10um_v1.0"
    cache.mkdir()
    ann = np.random.default_rng(8).integers(0, 4, (4, 8, 8)).astype(
        np.uint16)
    ref_tiff.write_tiff(str(cache / "reference.tiff"), src[:, :8, :8])
    ref_tiff.write_tiff(str(cache / "annotation.tiff"), ann)
    (cache / "metadata.json").write_text(
        json.dumps({"resolution": [10.0, 10.0, 10.0]}))
    out = []
    for mod, kw in ((visualizer, {"device": "cpu"}), (ref_visualizer, {})):
        vis = mod.Visualization(**kw)
        name = mod.__name__.split(".")[0]
        (home / name).mkdir()
        img5d = vis.import_file(tif, prefix=str(home / f"imp_{name}"))
        res = [np.asarray(img5d.img), vis.img5d is img5d,
               vis.adjust_image(vmin=10, vmax=500, alpha=0.8),
               vis.adjust_image(vmax=400),
               dict(vis.set_roi_profile("lightsheet,4xnuc")),
               os.path.relpath(vis.save_prefs(str(home / name / "p.yml")),
                               home / name),
               dict(vis.prefs)]
        img, labels, meta = vis.open_brain_globe("allen_test",
                                                 cache_dir=str(home))
        res += [np.asarray(img.img), labels, meta]
        views = vis.open_atlas_editor()
        res.append(sorted(views.canvases))
        with pytest.raises(FileNotFoundError):
            vis.open_brain_globe("nope_atlas", cache_dir=str(home))
        vis.labels_img = None
        with pytest.raises(ValueError, match="no labels"):
            vis.open_atlas_editor()
        out.append(res)
    for g, w in zip(*out):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_prefs_read_from_the_working_directory_as_reference(home):
    (home / "prefs.yaml").write_text("theme: dark\nmax_scroll: 7\n")
    got = visualizer.Visualization(device="cpu").prefs
    want = ref_visualizer.Visualization().prefs
    assert dict(got) == dict(want) and got["theme"] == "dark"


def test_enums_handler_and_adapters_as_reference(home):
    for name in ("ViewerTabs", "StaleFlags", "Styles2D", "RegionOptions",
                 "AtlasEditorOptions", "Vis3dOptions",
                 "BlobsVisibilityOptions", "ProfileCats", "ImportModes",
                 "ColocalizeOptions", "BlobColorStyles", "ControlsTabs"):
        got = [(e.name, e.value) for e in getattr(visualizer, name)]
        assert got == [(e.name, e.value)
                       for e in getattr(ref_visualizer, name)], name
    blob = np.arange(10.0)
    for name in ("SegmentsArrayAdapter", "ProfilesArrayAdapter",
                 "ImportFilesArrayAdapter", "BrainGlobeArrayAdapter"):
        got, want = (getattr(m, name)() for m in (visualizer,
                                                  ref_visualizer))
        assert got.columns == want.columns
    assert visualizer.SegmentsArrayAdapter().table([blob, blob[:7]]) == \
        ref_visualizer.SegmentsArrayAdapter().table([blob, blob[:7]])
    outs = []
    for mod, kw in ((visualizer, {"device": "cpu"}), (ref_visualizer, {})):
        seen = []
        tl = mod.TraitsList([1, 2], fn_changed=seen.append)
        tl.selections = (3, 4)
        tl.selections = None
        vis = mod.Visualization(**kw)
        vis.open_db(str(home / f"{mod.__name__}.db"))
        h = mod.VisHandler(vis)
        h.mark_stale(mod.StaleFlags.IMAGE)
        h.mark_stale(mod.StaleFlags.ZOOM, [mod.ViewerTabs.MAYAVI])
        flags = [h.is_stale(t, f) for t in mod.ViewerTabs
                 for f in mod.StaleFlags]
        h.refresh(mod.ViewerTabs.ROI_ED)
        flags += [h.is_stale(t, f) for t in mod.ViewerTabs
                  for f in mod.StaleFlags]
        outs.append((seen, tl.selections, flags, h.closed(),
                     vis.db.conn is None,
                     mod.MPLFigureEditor("fig").init()))
    assert outs[0] == outs[1]


def test_controller_asks_for_the_card(monkeypatch, home):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        visualizer.Visualization()
    assert visualizer.Visualization(device="cpu").device.type == "cpu"
