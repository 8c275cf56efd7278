"""The port's GUI controllers (``gui/roi_editor``, ``atlas_editor``,
``plot_editor``, ``verifier_editor``, ``widgets``, ``threads``,
``roi_review``) against the reference's: the operation sequences of the
reference's editor tests replayed in both packages on the same seeded
inputs, with the blobs, labels, flags, views, renders and database rows
equal (exactly; ``PlotEditor.render`` is the same float arithmetic, so
exact too)."""

import os

import numpy as np
import pytest
import torch

from magellanmapper_tpu.atlas import ontology as ref_ontology
from magellanmapper_tpu.gui import atlas_editor as ref_atlas_editor
from magellanmapper_tpu.gui import roi_editor as ref_roi_editor
from magellanmapper_tpu.gui import roi_review as ref_roi_review
from magellanmapper_tpu.gui import threads as ref_threads
from magellanmapper_tpu.gui import verifier_editor as ref_verifier_editor
from magellanmapper_tpu.gui import widgets as ref_widgets
from magellanmapper_tpu.io import sitk_io as ref_sitk_io
from magellanmapper_tpu.io import sqlite as ref_sqlite
from magellanmapper_tpu.io import tiff as ref_tiff
from magellanmapper_torch.atlas import ontology
from magellanmapper_torch.gui import (
    atlas_editor, roi_editor, roi_review, threads, verifier_editor,
    widgets)
from magellanmapper_torch.io import sitk_io, sqlite

torch.set_num_threads(1)

PORT = {"roi_editor": roi_editor, "atlas_editor": atlas_editor,
        "sqlite": sqlite, "sitk_io": sitk_io, "widgets": widgets,
        "verifier_editor": verifier_editor, "threads": threads,
        "ontology": ontology, "roi_review": roi_review, "dev": "cpu"}
REF = {"roi_editor": ref_roi_editor, "atlas_editor": ref_atlas_editor,
       "sqlite": ref_sqlite, "sitk_io": ref_sitk_io, "widgets": ref_widgets,
       "verifier_editor": ref_verifier_editor, "threads": ref_threads,
       "ontology": ref_ontology, "roi_review": ref_roi_review, "dev": None}


def both(fn):
    """``fn(modules)`` in the port and in the reference."""
    return fn(PORT), fn(REF)


def dev(m):
    return {} if m["dev"] is None else {"device": m["dev"]}


def assert_same(got, want):
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_same(got[k], want[k])
    else:
        assert got == want


def roi_ed(m):
    rng = np.random.default_rng(42)
    roi = rng.random((12, 20, 20)).astype(np.float32)
    blobs = np.array([[3.0, 5, 5, 2], [8, 10, 12, 3]])
    return m["roi_editor"].ROIEditor(roi, blobs, offset=(10, 20, 30))


def atlas_ed(m):
    rng = np.random.default_rng(7)
    img = rng.random((10, 16, 16)).astype(np.float32)
    labels = np.zeros((10, 16, 16), np.int32)
    labels[:, 4:8, 4:8] = 5
    return m["atlas_editor"].AtlasEditor(img, labels, **dev(m))


def test_roi_editor_edits_as_reference(tmp_path):
    def run(m):
        ed = roi_ed(m)
        out = [ed.blobs.copy()]
        idx = ed.add_blob(6, 7, 8, radius=2.5, channel=1)
        ed.move_blob(idx, dz=100)
        ed.move_blob(0, dy=-3.5, dx=30)
        out += [idx, ed.blobs.copy()]
        ed.delete_blob(1)
        out.append(ed.blobs.copy())
        out.append(ed.undo())
        out += [ed.cycle_confirmed(0) for _ in range(4)]
        ed.set_radius(2, 4.5)
        ed.set_confirmed(1, 2)
        out += [ed.blobs.copy(), ed.verified_counts(),
                [ed.blobs_in_plane(z) for z in range(12)],
                ed.blobs_in_plane(8, within_radius=False),
                ed.blobs_absolute()]
        db = m["sqlite"].load_db(str(tmp_path / f"{m['dev']}.db"))
        out.append(ed.save(db, "exp1", 2))
        out.append(ed.save(db, "exp1", 2))
        roi = db.get_rois()[0]
        out += [tuple(roi), db.select_blobs_by_roi(roi["id"])]
        db.close()
        while ed.undo():
            pass
        out.append(ed.blobs)
        return out
    assert_same(*both(run))


def test_atlas_editor_edits_as_reference(tmp_path):
    def run(m):
        ed = atlas_ed(m)
        out = [ed.paint_label(0, 2, (12, 12), 2.0, 7), ed.edited,
               ed.labels_img.copy()]
        out.append(ed.undo())
        ed.erase_label(0, 3, (5, 5), 1.0)
        ed.erase_label(1, 6, (2.5, 6), 2.2)
        ed.paint_label(2, 9, (4, 3), 1.5, 11)
        out += [ed.labels_img.copy(), ed.edit_bookmark]
        ed.set_position(0, 99)
        ed.set_position(2, -4)
        out += [list(ed.position), ed.get_label_at((0, 5, 5)),
                ed.get_label_at(), ed.get_label_name()]
        ed.paint_label(0, 1, (10, 10), 2.5, 9)
        ed.paint_label(0, 6, (10, 10), 2.5, 9)
        out.append(ed.interpolate_from_bookmark(0, 1))
        out.append(ed.interpolate_from_bookmark(1, 1))
        out.append(ed.interpolate_from_bookmark(0, 5))
        out.append(ed.labels_img.copy())
        ed.interpolate_planes(11, 2, (3, 9))
        out += [ed.labels_img.copy(), ed.undo(), ed.labels_img.copy()]
        path = ed.save_atlas(str(tmp_path / f"{m['dev']}_edit.mhd"),
                             spacing=(2.0, 1.0, 0.5))
        med = m["sitk_io"].read_med_img(path)
        out += [med.img, tuple(med.spacing), ed.edited]
        for plane in ("xy", "xz", "yz"):
            out.append(ed.get_plane(atlas_editor.PLANES[plane], 4,
                                    labels=True))
        return out
    assert_same(*both(run))


def test_atlas_editor_label_names_as_reference():
    def run(m):
        o = m["ontology"]
        root = {o.ABA_ID: 1, o.ABA_NAME: "root", o.ABA_LEVEL: 0,
                o.ABA_CHILDREN: [{o.ABA_ID: 5, o.ABA_NAME: "ctx",
                                  o.ABA_LEVEL: 1, o.ABA_CHILDREN: []}]}
        ref = o.LabelsRef()
        ref.loaded_ref = root
        ref.create_ref_lookup()
        ed = atlas_ed(m)
        ed.labels_ref = ref
        ed.set_position(1, 5)
        ed.set_position(2, 5)
        return [ed.get_label_name(), ed.get_label_name(-5),
                ed.get_label_name(99)]
    port, want = both(run)
    assert port == want == ["ctx (R)", "ctx (L)", None]


def test_plot_editor_as_reference():
    def run(m):
        ed = atlas_ed(m)
        out = []
        for plane in ("xy", "xz", "yz"):
            pe = ed.make_plot_editor(plane)
            out += [pe._plane_shape(), pe.index, pe.render()]
            pe.scroll(2)
            pe.zoom(2.0)
            out.append(list(pe.view))
            pe.pan(100, 100)
            out.append(list(pe.view))
            pe.zoom(1.5, center=(3, 4))
            pe.pan(-1.25, 2)
            out += [list(pe.view), pe.render()]
            pe.update_intensity(0.2, 0.7)
            pe.alpha = 0.8
            out.append(pe.render())
            pe.reset_view()
            out += [list(pe.view), pe.pick_label(5, 5)]
            pe.brush_radius = 1.5
            out += [pe.paint(12, 12), pe.erase(5, 5), pe.paint(3, 9, 4),
                    pe.render(), pe.index]
        out.append(ed.labels_img)
        axi = m["atlas_editor"].__name__.replace(
            "atlas_editor", "plot_editor")
        import importlib
        pax = importlib.import_module(axi).PlotAxImg(
            img=np.arange(12.0).reshape(3, 4), vmin=2, vmax=9)
        pax.brightness, pax.contrast = 0.5, 1.5
        out.append(pax.adjusted())
        return out
    assert_same(*both(run))


def test_widgets_as_reference():
    def run(m):
        w = m["widgets"]
        updates = []
        seg = np.array([3.0, 10, 10, 3, -1, -1, 0])
        dc = w.DraggableCircle(
            seg, lambda n, o: updates.append((n.copy(), o.copy())))
        out = [dc.on_press(10, 20), dc.on_press(11, 11)]
        dc.on_motion(13, 12)
        dc.on_release()
        dc.on_motion(50, 50)
        out += [dc.segment.copy(), dc.cycle_confirmed(), dc.color,
                dc.cycle_confirmed(), dc.cycle_confirmed(), dc.color,
                dc.resize(1.0), dc.resize(-10.0), updates]
        dc.cut()
        dc.copy()
        out.append([k for _, k in w.DraggableCircle.picked[-2:]])
        ip = w.InterpolatePlanes()
        labels = np.zeros((8, 10, 10), np.int32)
        labels[1, 4:7, 4:7] = 5
        labels[5, 3:8, 4:6] = 5
        ip.update_plane("xy", 1, 5)
        out.append(ip.ready)
        ip.update_plane("xy", 5, 5)
        out += [ip.ready, list(ip.bounds),
                ip.interpolate(labels, **dev(m))]
        ip.update_plane("xy", 2, 9)
        out.append(ip.ready)
        img = np.arange(100.0).reshape(10, 10)
        pdisp = w.PixelDisplay([img, img.astype(int)], shapes=(20, 20),
                               offset=(3, 4))
        out += [w.PixelDisplay([img])(3, 4), pdisp(3.4, 8.6),
                w.BLOB_COLORS]
        return out
    assert_same(*both(run))


def test_verifier_editor_as_reference():
    def run(m):
        rng = np.random.default_rng(4)
        vol = rng.random((1, 6, 30, 30)).astype(np.float32)
        blobs = np.zeros((10, 10))
        blobs[:, :4] = rng.random((10, 4)) * 5 + 5
        blobs[:, 4] = -1
        seen = []
        ve = m["verifier_editor"].VerifierEditor(
            vol, blobs, nrows=2, ncols=2,
            fn_update_blob=lambda new, old: seen.append(new[4]))
        out = [ve.n_pages, ve.per_page]
        for page in (0, 2, 9):
            views = ve.build_page(page)
            out += [[(v.index, v.patch, v.blob) for v in views], ve.page]
        out += [ve.next_page(), ve.prev_page(), ve.prev_page(),
                ve.flag_blob(0), ve.blob_color(0), ve.flag_blob(0),
                ve.flag_blob(3, 2), ve.blob_color(3), seen]
        return out
    assert_same(*both(run))


def labels_ref(o):
    root = {o.ABA_ID: 1, o.ABA_NAME: "root", o.ABA_LEVEL: 0,
            o.ABA_CHILDREN: [
                {o.ABA_ID: 2, o.ABA_NAME: "ctx", o.ABA_LEVEL: 1,
                 o.ABA_CHILDREN: [{o.ABA_ID: 4, o.ABA_NAME: "l1",
                                   o.ABA_LEVEL: 2, o.ABA_CHILDREN: []}]},
                {o.ABA_ID: 3, o.ABA_NAME: "cb", o.ABA_LEVEL: 1,
                 o.ABA_CHILDREN: []}]}
    ref = o.LabelsRef()
    ref.loaded_ref = root
    ref.create_ref_lookup()
    return ref


def test_threads_as_reference(tmp_path):
    rng = np.random.default_rng(5)
    labels = rng.choice([0, 2, 3, 4, -4, -2], (6, 8, 8)).astype(np.int32)
    src = (rng.random((3, 16, 16)) * 100).astype(np.uint16)

    def run(m):
        ref = labels_ref(m["ontology"])
        t = m["threads"]
        progress, success = [], []
        out = []
        for level in (0, 1, 2):
            task = t.RemapLevelThread(
                labels, ref, level, fn_success=success.append,
                fn_progress=lambda *a: progress.append(a)).start()
            out.append(task.result())
        out += [progress, success,
                t.AnnotateLabels(labels, ref, [2, -4, 3]).start().result()]
        md = t.SetupImportThread(
            {0: ["/d/brain_(1,2,3)x(4,5,6).tif"], 1: "/d/b.tif"}).result()
        out.append(md)
        tif = str(tmp_path / f"{m['dev']}.tif")
        ref_tiff.write_tiff(tif, src)
        img5d = t.ImportThread("tif", str(tmp_path / f"{m['dev']}_out"),
                               {0: [tif]}).start().result()
        out.append(np.asarray(img5d.img))
        bad = t.RemapLevelThread(labels, None, 1).start()
        with pytest.raises(AttributeError):
            bad.result()
        assert not bad.is_running() and bad.wait()

        class Vis:
            loaded = []

            def load_image(self, path):
                self.loaded.append(path)

        h = t.FileOpenHandler(Vis())
        out += [h.handle("a.npy"), h.pending, Vis.loaded,
                t.FileOpenHandler(object()).handle("b.npy")]
        return out
    assert_same(*both(run))


def test_roi_review_as_reference(tmp_path):
    rng = np.random.default_rng(6)
    roi = rng.random((6, 24, 24)).astype(np.float32)
    blobs = np.zeros((3, 10))
    blobs[:, :4] = [[2, 5, 5, 2], [4, 12, 18, 3], [1, 20, 3, 1.5]]
    blobs[:, 4] = [-1, 0, 1]

    def run(m):
        rr = m["roi_review"]
        out_png = str(tmp_path / f"{m['dev']}_grid.png")
        fig = rr.plot_roi_planes(roi, blobs, out_png, n_cols=3)
        patches = [(tuple(p.center), p.radius, p.get_edgecolor())
                   for ax in fig.axes for p in ax.patches]
        db = m["sqlite"].load_db(str(tmp_path / f"{m['dev']}.db"))
        exp = db.select_or_insert_experiment("e")
        roi_id, _ = db.select_or_insert_roi(exp, 0, (0, 0, 0), (24, 24, 6))
        db.insert_blobs(roi_id, blobs)
        conf = rr.confirm_blobs(db, roi_id, [0, 2], flag=1)
        back = db.select_blobs_by_roi(roi_id)
        db.close()
        df = rr.export_verifications(
            [(blobs[0], blobs[1], 1.5), (blobs[2], blobs[0], 2.0)],
            str(tmp_path / f"{m['dev']}.csv"))
        return [patches, os.path.exists(out_png), conf, back,
                df.to_numpy(), list(df.columns), rr.CONFIRMED_COLORS]
    assert_same(*both(run))


@pytest.mark.parametrize("name", [
    "AtlasEditor", "InterpolatePlanes.interpolate"])
def test_editors_take_the_device(monkeypatch, name):
    """Without a card the default device raises; ``device="cpu"`` runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    labels = np.zeros((8, 10, 10), np.int32)
    labels[1, 4:7, 4:7] = 5
    labels[5, 4:7, 4:7] = 5
    ip = widgets.InterpolatePlanes()
    ip.update_plane("xy", 1, 5)
    ip.update_plane("xy", 5, 5)
    make = {"AtlasEditor": lambda **kw: atlas_editor.AtlasEditor(
        labels.astype(np.float32), labels, **kw),
        "InterpolatePlanes.interpolate": lambda **kw: ip.interpolate(
            labels, **kw)}[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    assert make(device="cpu") is not None
