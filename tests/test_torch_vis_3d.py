"""The port's 3D scene (``gui/vis_3d``) against the reference's on the same
seeded scenes: the canvas's frames and depth within the render limits
(images 1e-4, depth 1e-3 voxels), the same camera after the same
synthetic matplotlib events, the same picks, confirmations and database
rows, and the headless renderer's frames equal to the canvas's."""

import os

import numpy as np
import pytest
import torch
from matplotlib.backend_bases import KeyEvent, MouseButton, MouseEvent

from magellanmapper_tpu.gui import roi_editor as ref_roi_editor
from magellanmapper_tpu.gui import vis_3d as ref_vis_3d
from magellanmapper_tpu.io import sqlite as ref_sqlite
from magellanmapper_torch.cv import cv_nd
from magellanmapper_torch.gui import roi_editor, vis_3d
from magellanmapper_torch.io import sqlite
from magellanmapper_torch.ops import render3d

torch.set_num_threads(1)

#: render limits (PERF.md section 2): images and depth in voxels
IMG_ATOL = 1e-4
DEPTH_ATOL = 1e-3
HW = (48, 48)


def sphere():
    zz, yy, xx = np.indices((24, 24, 24)).astype(np.float32)
    r = np.sqrt((zz - 11.5) ** 2 + (yy - 11.5) ** 2 + (xx - 11.5) ** 2)
    return np.clip(1.0 - (r - 7.0) / 2.0, 0, 1).astype(np.float32)


def canvases(mode, blobs=None, surfaces=(), **kwargs):
    """The port's and the reference's canvas over the same scene."""
    out = []
    for mod, extra in ((vis_3d, {"device": "cpu"}), (ref_vis_3d, {})):
        vis = mod.Vis3D(sphere())
        if blobs is not None:
            vis.show_blobs(np.array(blobs, float))
        vis.surfaces.extend(surfaces)
        out.append(mod.Vis3DCanvas(vis, figsize=(2, 2), render_mode=mode,
                                   render_hw=HW, **kwargs, **extra))
    return out


def image(cv3):
    imgs = cv3.ax.get_images()
    assert imgs, "a frame mode blits an image"
    return np.asarray(imgs[0].get_array(), np.float32)


def assert_same_frame(port, ref):
    np.testing.assert_allclose(image(port), image(ref), atol=IMG_ATOL,
                               rtol=0)
    if ref._depth is None:
        assert port._depth is None
        return
    want = np.asarray(ref._depth)
    got = np.asarray(port._depth)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=DEPTH_ATOL, rtol=0)


def fire(cv3, name, **kw):
    if name.startswith("key"):
        ev = KeyEvent(name, cv3.canvas, kw["key"])
    else:
        ev = MouseEvent(name, cv3.canvas, kw.get("x", 0), kw.get("y", 0),
                        button=kw.get("button", MouseButton.LEFT),
                        step=kw.get("step", 0))
    cv3.canvas.callbacks.process(name, ev)


def click_at(cv3, row, col):
    cv3.canvas.draw()
    x, y = cv3.ax.transData.transform((col, row))
    for name in ("button_press_event", "button_release_event"):
        cv3.canvas.callbacks.process(name, MouseEvent(
            name, cv3.canvas, x, y, button=MouseButton.LEFT))


def front_blobs(offsets, radius=1.5):
    """Blobs in front of the sphere along the reference's default view,
    shifted by z,y,x ``offsets``."""
    view = np.asarray(render3d.camera_basis(-60.0, 30.0)[0])
    c = np.asarray([11.5, 11.5, 11.5]) - view * 10.0
    return [list(c + np.asarray(o, float)) + [radius] for o in offsets]


@pytest.mark.parametrize("mode", ["volume", "mip", "isosurface"])
def test_frames_follow_the_same_events_as_reference(mode):
    port, ref = canvases(mode)
    assert_same_frame(port, ref)
    for cv3 in (port, ref):
        fire(cv3, "button_press_event", x=10, y=10)
        fire(cv3, "motion_notify_event", x=60, y=30)
        fire(cv3, "button_release_event", x=60, y=30)
        fire(cv3, "scroll_event", step=1)
    assert port.camera_state() == pytest.approx(ref.camera_state())
    assert port.camera_state()["mode"] == mode
    assert_same_frame(port, ref)
    for cv3 in (port, ref):
        fire(cv3, "key_press_event", key="right")
    assert port.ax.get_xlim() == pytest.approx(ref.ax.get_xlim())
    assert port.offset[0] == pytest.approx(
        ref.ax.get_xlim()[0] - (-0.5))
    for cv3 in (port, ref):
        fire(cv3, "key_press_event", key="r")
    assert port.camera_state() == ref.camera_state()
    assert_same_frame(port, ref)
    if mode == "isosurface":
        assert port.iso_level == pytest.approx(ref.iso_level, abs=1e-6)


def test_renderer_is_the_canvas_without_matplotlib():
    """The headless renderer's frames and depth are the canvas's, pose
    by pose."""
    vis = vis_3d.Vis3D(sphere())
    vis.show_blobs(np.array(front_blobs([(0, 8, 0), (0, -8, 0)])))
    rend = vis_3d.Vis3DRenderer(vis, "isosurface", HW, device="cpu")
    cv3 = vis_3d.Vis3DCanvas(vis, figsize=(2, 2), render_mode="isosurface",
                             render_hw=HW, device="cpu")
    for d_az, d_el in ((0, 0), (25, -10), (-40, 70)):
        rend.orbit(d_az, d_el)
        cv3.orbit(d_az, d_el)
        np.testing.assert_array_equal(rend.frame, image(cv3))
        np.testing.assert_array_equal(rend._depth, cv3._depth)
        np.testing.assert_array_equal(rend.project_blobs(),
                                      cv3.project_blobs())
    rend.zoom(0.5)
    assert rend.camera_state()["zoom"] == 2.0
    rend.pan(3, -2)
    assert rend.offset == [3.0, -2.0]
    rend.reset_camera()
    assert rend.camera_state() == {"azim": -60.0, "elev": 30.0,
                                   "zoom": 1.0, "mode": "isosurface"}
    assert rend.offset == [0.0, 0.0]
    with pytest.raises(ValueError, match="render mode"):
        vis_3d.Vis3DRenderer(vis, "surface", device="cpu")


def test_clicks_pick_the_references_blobs():
    blobs = front_blobs([(0, 8, 0), (0, -8, 0)])
    port, ref = canvases("isosurface", blobs)
    pts = ref.project_blobs()
    np.testing.assert_allclose(port.project_blobs(), pts, rtol=0,
                               atol=1e-5)
    assert (pts[:, 2] > 0).all()
    for row, col in ((pts[1, 0], pts[1, 1]), (pts[0, 0], pts[0, 1]),
                     (0.0, 0.0)):
        for cv3 in (port, ref):
            click_at(cv3, row, col)
        assert port.selected_blob == ref.selected_blob
    assert port.selected_blob is None


def test_pick_nearest_and_occluded_as_reference():
    c = [11.5, 11.5, 11.5]
    view = np.asarray(render3d.camera_basis(-60.0, 30.0)[0])
    near = list(np.asarray(c) - view * 11.0) + [2.0]
    mid = list(np.asarray(c) - view * 9.5) + [2.0]
    port, ref = canvases("isosurface", [mid, near, c + [2.0]])
    pts = ref.project_blobs()
    assert pts[2, 2] == 0.0
    got = [cv3.pick_blob(pts[i, 0], pts[i, 1]) for cv3 in (port, ref)
           for i in (1, 2)]
    assert got[:2] == got[2:] == [1, 1]
    port, ref = canvases("isosurface", [c + [2.0]])
    p = ref.project_blobs()
    assert port.pick_blob(p[0, 0], p[0, 1]) is None
    assert ref.pick_blob(p[0, 0], p[0, 1]) is None


def test_surface_splats_as_reference():
    vol = sphere()
    view = np.asarray(render3d.camera_basis(-60.0, 30.0)[0])
    z, y, x = (int(v) for v in np.clip(
        np.asarray([11.5] * 3) - view * 10.0, 2, 20))
    cube = np.zeros_like(vol)
    cube[z - 1:z + 2, y - 1:y + 2, x - 1:x + 2] = 1.0
    buried = np.zeros_like(vol)
    buried[10:13, 10:13, 10:13] = 1.0
    for mesh_vol, visible in ((cube, True), (buried, False)):
        mesh = cv_nd.surface_net_mesh(mesh_vol, 0.5)
        port, ref = canvases("isosurface", surfaces=[mesh])
        offsets = [np.asarray(col.get_offsets())
                   for cv3 in (port, ref) for col in cv3.ax.collections]
        assert len(offsets) == (2 if visible else 0)
        if visible:
            np.testing.assert_allclose(offsets[0], offsets[1], atol=1e-5)


def test_confirm_flow_writes_the_references_rows(tmp_path):
    rows = []
    for mod, ed_mod, sq, extra in (
            (vis_3d, roi_editor, sqlite, {"device": "cpu"}),
            (ref_vis_3d, ref_roi_editor, ref_sqlite, {})):
        vis = mod.Vis3D(sphere())
        cv3 = mod.Vis3DCanvas(vis, figsize=(2, 2), render_mode="isosurface",
                              render_hw=HW, **extra)
        editor = ed_mod.ROIEditor(vis.roi, np.array(front_blobs([(0, 0, 0)])))
        cv3.attach_editor(editor)
        pts = cv3.project_blobs()
        click_at(cv3, pts[0, 0], pts[0, 1])
        assert cv3.selected_blob == 0
        flags = []
        for _ in range(2):
            fire(cv3, "key_press_event", key="c")
            flags.append(int(editor.blobs[0, 4]))
        db = sq.ClrDB(str(tmp_path / f"{mod.__name__}.db")).load_db()
        assert editor.save(db, experiment="pick3d") == 1
        rows.append((flags, db.select_blobs_confirmed(1)))
        db.close()
    assert rows[0][0] == rows[1][0] == [0, 1]
    np.testing.assert_array_equal(rows[0][1], rows[1][1])


def test_mpl_mode_camera_as_reference(tmp_path):
    rng = np.random.default_rng(3)
    roi = rng.random((8, 16, 16)).astype(np.float32)
    cams = []
    for mod, extra in ((vis_3d, {"device": "cpu"}), (ref_vis_3d, {})):
        vis = mod.Vis3D(roi)
        vis.show_blobs(np.array([[4.0, 8, 8, 2]]))
        cv3 = mod.Vis3DCanvas(vis, figsize=(3, 3), max_points=200, **extra)
        states = [cv3.camera_state()]
        fire(cv3, "button_press_event", x=100, y=100)
        fire(cv3, "motion_notify_event", x=140, y=120)
        fire(cv3, "button_release_event", x=140, y=120)
        fire(cv3, "motion_notify_event", x=200, y=200)
        states.append(cv3.camera_state())
        fire(cv3, "scroll_event", step=1)
        fire(cv3, "key_press_event", key="right")
        fire(cv3, "key_press_event", key="up")
        states.append(cv3.camera_state())
        fire(cv3, "key_press_event", key="r")
        states.append(cv3.camera_state())
        assert cv3.pick_blob(1.0, 1.0) is None
        assert os.path.getsize(cv3.save(str(tmp_path / f"{mod.__name__}.png")))
        cams.append(states)
    for got, want in zip(*cams):
        for key in want:
            assert got[key] == pytest.approx(want[key]), key


def test_surface_mesh_and_level_as_reference(tmp_path):
    zz, yy, xx = np.indices((24, 24, 24)).astype(float)
    vol = (((zz - 12) ** 2 + (yy - 12) ** 2 + (xx - 12) ** 2) <= 49
           ).astype(np.float32) * 3.0 + 0.5
    _, (verts, faces) = vis_3d.plot_surface_3d(
        vol, out_path=str(tmp_path / "port.png"), device="cpu")
    _, (ref_verts, ref_faces) = ref_vis_3d.plot_surface_3d(
        vol, out_path=str(tmp_path / "ref.png"))
    np.testing.assert_array_equal(faces, ref_faces)
    np.testing.assert_allclose(verts, ref_verts, rtol=0, atol=1e-12)
    assert len(faces) > 100 and os.path.exists(str(tmp_path / "port.png"))


def test_vis3d_render_with_blobs_pin(tmp_path):
    """The reference's ``Vis3D.render`` passes the volume as the blobs
    and raises; the port plots the blobs (ROADMAP section 3). Without
    blobs both draw the projections."""
    roi = np.random.default_rng(0).random((8, 24, 24)).astype(np.float32)
    blobs = np.array([[2.0, 5, 5, 3, -1, -1, 0], [6.0, 18, 12, 2, -1, -1, 1]])
    ref = ref_vis_3d.Vis3D(roi)
    ref.show_blobs(blobs)
    with pytest.raises(ValueError):
        ref.render(str(tmp_path / "ref.png"))
    port = vis_3d.Vis3D(roi)
    port.show_blobs(blobs)
    port.render(str(tmp_path / "port.png"))
    assert os.path.exists(str(tmp_path / "port.png"))
    for mod in (vis_3d, ref_vis_3d):
        vis = mod.Vis3D(roi)
        vis.render(str(tmp_path / f"{mod.__name__}_mips.png"))
        assert os.path.exists(str(tmp_path / f"{mod.__name__}_mips.png"))
