"""The port's matplotlib canvases (``gui/mpl_canvas``) and Tk app
(``gui/app``) against the reference's: the reference's canvas tests'
synthetic matplotlib events replayed on both packages' canvases over the
same seeded inputs, with the blobs, flags, labels, views and database
rows equal (exactly), and the app's headless message naming the port."""

import numpy as np
import pytest
import torch
from matplotlib.backend_bases import KeyEvent, MouseEvent, PickEvent

from magellanmapper_tpu.gui import app as ref_app
from magellanmapper_tpu.gui import atlas_editor as ref_atlas_editor
from magellanmapper_tpu.gui import mpl_canvas as ref_mpl_canvas
from magellanmapper_tpu.gui import roi_editor as ref_roi_editor
from magellanmapper_tpu.gui import verifier_editor as ref_verifier_editor
from magellanmapper_tpu.io import sqlite as ref_sqlite
from magellanmapper_torch.gui import (
    app, atlas_editor, mpl_canvas, roi_editor, verifier_editor)
from magellanmapper_torch.io import sqlite

torch.set_num_threads(1)

PORT = dict(mpl_canvas=mpl_canvas, roi_editor=roi_editor,
            atlas_editor=atlas_editor, verifier_editor=verifier_editor,
            sqlite=sqlite, app=app, kw={"device": "cpu"})
REF = dict(mpl_canvas=ref_mpl_canvas, roi_editor=ref_roi_editor,
           atlas_editor=ref_atlas_editor, verifier_editor=ref_verifier_editor,
           sqlite=ref_sqlite, app=ref_app, kw={})


def mouse(name, cv, xdata, ydata, button=1, key=None, step=0):
    x, y = cv.ax.transData.transform((xdata, ydata))
    ev = MouseEvent(name, cv.canvas, x, y, button=button, key=key,
                    step=step)
    cv.canvas.callbacks.process(name, ev)
    return ev


def key(cv, name):
    cv.canvas.callbacks.process(
        "key_press_event", KeyEvent("key_press_event", cv.canvas, name))


def pick(cv, artist, xdata, ydata, key_name=None):
    x, y = cv.ax.transData.transform((xdata, ydata))
    me = MouseEvent("button_press_event", cv.canvas, x, y, button=1,
                    key=key_name)
    cv.canvas.callbacks.process(
        "pick_event", PickEvent("pick_event", cv.canvas, me, artist))


def roi_canvas(m):
    rng = np.random.default_rng(0)
    roi = rng.random((8, 40, 40)).astype(np.float32) * 0.2
    blobs = np.zeros((3, 10))
    blobs[0, :4] = (4, 10, 10, 3)
    blobs[1, :4] = (4, 25, 30, 3)
    blobs[2, :4] = (6, 30, 8, 2)
    blobs[:, 4] = -1
    ed = m["roi_editor"].ROIEditor(roi, blobs)
    return ed, m["mpl_canvas"].ROIEditorCanvas(ed, z=4)


def replay_roi_canvas(m, db_path):
    ed, cv = roi_canvas(m)
    out = [sorted(cv.circles)]
    mouse("button_press_event", cv, 20.0, 15.0, key="control")
    out += [ed.blobs.copy(), sorted(cv.circles)]
    mouse("button_press_event", cv, 10.0, 10.0, key="shift")
    mouse("motion_notify_event", cv, 14.0, 12.0, key="shift")
    mouse("button_release_event", cv, 14.0, 12.0, key="shift")
    out.append(np.round(ed.blobs, 6))
    mouse("button_press_event", cv, 30.0, 25.0, key="alt")
    mouse("motion_notify_event", cv, 36.0, 25.0, key="alt")
    mouse("button_release_event", cv, 36.0, 25.0, key="alt")
    out.append(np.round(ed.blobs, 6))
    dc = cv.circles[1]
    for key_name in (None, None, "r", "control"):
        pick(cv, dc.circle, *dc.circle.center, key_name)
        out.append(ed.blobs[1, 4])
    out.append(dc.circle.get_facecolor())
    dc = cv.circles[0]
    pick(cv, dc.circle, *dc.circle.center, "c")
    pick(cv, dc.circle, *dc.circle.center, "d")
    out += [ed.blobs.copy(), [k for _, k in cv.picked], sorted(cv.circles)]
    mouse("scroll_event", cv, 20, 20, step=1)
    mouse("scroll_event", cv, 20, 20, step=1)
    out += [cv.z, sorted(cv.circles)]
    for _ in range(9):
        mouse("scroll_event", cv, 20, 20, step=-1)
    out.append(cv.z)
    cv.z = 4
    cv.refresh()
    for dc in list(cv.circles.values()):
        pick(cv, dc.circle, *dc.circle.center)
    db = m["sqlite"].ClrDB(db_path).load_db()
    out += [cv.save_to_db(db, "exp1"), db.select_blobs_confirmed(0),
            db.select_blobs_by_roi(db.get_rois()[0]["id"])]
    db.close()
    return out


def test_roi_editor_canvas_as_reference(tmp_path):
    got = replay_roi_canvas(PORT, str(tmp_path / "port.db"))
    want = replay_roi_canvas(REF, str(tmp_path / "ref.db"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def plot_canvas(m):
    rng = np.random.default_rng(1)
    img = rng.random((12, 32, 32)).astype(np.float32)
    labels = np.zeros((12, 32, 32), np.int32)
    labels[:, 8:20, 8:20] = 5
    ae = m["atlas_editor"].AtlasEditor(img, labels, **m["kw"])
    pe = ae.make_plot_editor("xy")
    pe.brush_radius = 2.0
    return ae, pe, m["mpl_canvas"].PlotEditorCanvas(pe)


def replay_plot_canvas(m):
    ae, pe, cv = plot_canvas(m)
    out = []
    mouse("button_press_event", cv, 10.0, 10.0, key="control")
    out.append(pe.paint_label_id)
    mouse("button_press_event", cv, 26.0, 26.0)
    for x in (27.0, 28.0):
        mouse("motion_notify_event", cv, x, 26.0)
    mouse("button_release_event", cv, 28.0, 26.0)
    mouse("motion_notify_event", cv, 2.0, 2.0)
    out += [ae.labels_img.copy(), ae.edited]
    mouse("button_press_event", cv, 10.0, 10.0, key="alt")
    mouse("motion_notify_event", cv, 12.0, 11.0, key="alt")
    mouse("button_release_event", cv, 12.0, 11.0, key="alt")
    out.append(ae.labels_img.copy())
    mouse("scroll_event", cv, 16, 16, step=1)
    out.append(pe.index)
    mouse("scroll_event", cv, 16, 16, step=1, key="control")
    out.append(list(pe.view))
    for name in ("down", "right", "up", "left", "left", "[", "]", "]", "q"):
        key(cv, name)
        out.append((list(pe.view), pe.vmin, pe.vmax))
    pe.paint_label_id = 5
    pe.brush_radius = 3.0
    for z in (2, 6):
        ae.set_position(0, z)
        mouse("button_press_event", cv, 26.0, 26.0)
        mouse("button_release_event", cv, 26.0, 26.0)
    ae.set_position(0, 2)
    key(cv, "i")
    out.append(ae.labels_img.copy())
    key(cv, "z")
    out += [ae.labels_img.copy(), np.asarray(cv.ax.get_images()[0]
                                             .get_array())]
    return out


def test_plot_editor_canvas_as_reference():
    got, want = replay_plot_canvas(PORT), replay_plot_canvas(REF)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert g == w
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_atlas_editor_canvases_as_reference():
    def run(m):
        rng = np.random.default_rng(2)
        img = rng.random((10, 20, 20)).astype(np.float32)
        labels = np.zeros((10, 20, 20), np.int32)
        labels[:, 5:15, 5:15] = 3
        ae = m["atlas_editor"].AtlasEditor(img, labels, **m["kw"])
        views = m["mpl_canvas"].AtlasEditorCanvases(ae)
        views.update_coords((3, 7, 9))
        out = [sorted(views.canvases), list(ae.position)]
        views.update_alpha(0.8)
        views.update_intensity(0.1, 0.9)
        out += [[(pe.alpha, pe.vmin, pe.vmax)
                 for pe in views.sync.plot_eds.values()]]
        mouse("scroll_event", views.canvases["xy"], 10, 10, step=1)
        mouse("scroll_event", views.canvases["yz"], 5, 5, step=-1)
        out.append(list(ae.position))
        out += [np.asarray(cv.ax.get_images()[0].get_array())
                for cv in views.canvases.values()]
        return out
    got, want = run(PORT), run(REF)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_verifier_canvas_as_reference():
    def run(m):
        rng = np.random.default_rng(4)
        vol = rng.random((6, 48, 48)).astype(np.float32)
        blobs = np.zeros((12, 10))
        blobs[:, 0] = rng.integers(0, 6, 12)
        blobs[:, 1] = rng.integers(8, 40, 12)
        blobs[:, 2] = rng.integers(8, 40, 12)
        blobs[:, 3] = 3
        blobs[:, 4] = -1
        ed = m["verifier_editor"].VerifierEditor(vol, blobs, nrows=2,
                                                 ncols=2)
        cv = m["mpl_canvas"].VerifierCanvas(ed)
        out = [len(cv.axes_views)]
        for step in range(3):
            ax, view = list(cv.axes_views.items())[step]
            x, y = ax.transData.transform((5, 5))
            for _ in range(step + 1):
                cv.canvas.callbacks.process(
                    "button_press_event", MouseEvent(
                        "button_press_event", cv.canvas, x, y, button=1))
                ax, view = list(cv.axes_views.items())[step]
            for name in ("right", "right", "left", "x"):
                cv.canvas.callbacks.process(
                    "key_press_event",
                    KeyEvent("key_press_event", cv.canvas, name))
            out += [ed.page, [v.index for v in cv.axes_views.values()]]
        out.append(ed._blob_arr[:, 4].copy())
        return out
    got, want = run(PORT), run(REF)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_app_headless_message_names_the_port(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    with pytest.raises(RuntimeError, match="DISPLAY") as err:
        app.MagellanTkApp(vis=None).run()
    assert "magellanmapper_torch.gui.visualizer.Visualization" in str(
        err.value)
    assert "magellanmapper_torch.gui.mpl_canvas" in str(err.value)
    with pytest.raises(RuntimeError, match="DISPLAY") as ref_err:
        ref_app.MagellanTkApp(vis=None).run()
    assert "magellanmapper_torch" not in str(ref_err.value)
    assert str(err.value).replace("magellanmapper_torch.", "").replace(
        '"', "") == str(ref_err.value).replace('"', "")
    assert app.display_available() == ref_app.display_available()


def test_app_actions_as_reference(tmp_path):
    def run(m):
        class VisStub:
            blobs = None
            db = None
            roi_offset = (0, 0, 0)

            def get_roi(self):
                return np.zeros((6, 20, 20), np.float32)

            def detect_blobs(self):
                out = np.zeros((2, 10))
                out[0, :4] = (3, 10, 10, 2)
                out[1, :4] = (4, 5, 15, 3)
                return out

            def open_db(self):
                self.db = m["sqlite"].ClrDB(
                    str(tmp_path / f"{m['app'].__name__}.db")).load_db()

        a = m["app"].MagellanTkApp(VisStub())
        a.roi_canvas = m["mpl_canvas"].ROIEditorCanvas(
            m["roi_editor"].ROIEditor(VisStub().get_roi()), z=3)
        blobs = a.detect()
        out = [blobs, sorted(a.roi_canvas.circles)]
        a.set_plane(99)
        out.append(a.roi_canvas.z)
        a.set_plane(-3)
        out += [a.roi_canvas.z, a.save(),
                a.vis.db.select_blobs_by_roi(1)]
        a.vis.db.close()
        return out
    got, want = run(PORT), run(REF)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
