"""Interactive matplotlib canvases over the editor controllers.

Copy of ``magellanmapper_tpu/gui/mpl_canvas.py``: ``DraggableCircle``
blob annotation, the ROI editor's plane with its circles, the editable
plane canvas (paint, pick, pan, zoom, intensity window, two-plane
interpolation), the paged verifier grid and the atlas editor's three
synced views, each binding matplotlib's events onto an Agg (or any)
canvas and handing every change to :mod:`gui.roi_editor`,
:mod:`gui.atlas_editor`, :mod:`gui.plot_editor` or
:mod:`gui.verifier_editor`. matplotlib is imported in the constructors.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class DraggableCircle:
    """Circle artist bound to one blob (reference ``roi_editor.py:39``).

    Interaction (the reference's vocabulary):
      - shift-drag inside the circle moves the blob,
      - alt-drag resizes its radius,
      - plain pick-click cycles the confirmed flag forward
        (``r``-click cycles in reverse),
      - ``d``-click deletes the blob, ``x`` cuts, ``c`` copies
        (cut/copied circles land in the shared ``picked`` list so a
        paste can restore them).
    """

    #: confirmed flag -> face color (reference BLOB_COLORS)
    BLOB_COLORS = {-1: "none", 0: "r", 1: "g", 2: "y"}
    CUT = "cut"
    _COPY = "copy"

    def __init__(self, circle, blob_idx: int, owner, picked: List):
        self.circle = circle
        self.circle.set_picker(True)
        self.blob_idx = blob_idx
        self.owner = owner
        self.picked = picked
        self._press: Optional[Tuple[float, float, float, float]] = None
        self._background = None
        self._cids: List[int] = []

    # -- wiring -----------------------------------------------------------

    def connect(self):
        canvas = self.circle.figure.canvas
        self._cids = [
            canvas.mpl_connect("button_press_event", self.on_press),
            canvas.mpl_connect("button_release_event", self.on_release),
            canvas.mpl_connect("motion_notify_event", self.on_motion),
            canvas.mpl_connect("pick_event", self.on_pick),
        ]

    def disconnect(self):
        if self.circle.figure is None:
            return
        canvas = self.circle.figure.canvas
        for cid in self._cids:
            canvas.mpl_disconnect(cid)
        self._cids = []

    def remove_self(self):
        self.disconnect()
        self.circle.remove()

    # -- drag -------------------------------------------------------------

    def on_press(self, event):
        """Shift-click starts a move; alt-click starts a resize."""
        if (event.key not in ("shift", "alt")
                or event.inaxes != self.circle.axes):
            return
        contains, _ = self.circle.contains(event)
        if not contains:
            return
        x0, y0 = self.circle.center
        self._press = (x0, y0, event.xdata, event.ydata)
        # blit setup: draw everything but this circle once, cache it
        canvas = self.circle.figure.canvas
        ax = self.circle.axes
        self.circle.set_animated(True)
        canvas.draw()
        self._background = canvas.copy_from_bbox(ax.bbox)
        ax.draw_artist(self.circle)
        canvas.blit(ax.bbox)

    def on_motion(self, event):
        if self._press is None or event.inaxes != self.circle.axes:
            return
        x0, y0, xpress, ypress = self._press
        if event.key == "shift":
            self.circle.center = (x0 + event.xdata - xpress,
                                  y0 + event.ydata - ypress)
        elif event.key == "alt":
            self.circle.radius = max(
                abs(event.xdata - x0), abs(event.ydata - y0), 0.5)
        canvas = self.circle.figure.canvas
        ax = self.circle.axes
        canvas.restore_region(self._background)
        ax.draw_artist(self.circle)
        canvas.blit(ax.bbox)

    def on_release(self, event):
        if self._press is None:
            return
        x0, y0 = self._press[:2]
        dx = self.circle.center[0] - x0
        dy = self.circle.center[1] - y0
        if dx or dy:
            self.owner.editor.move_blob(self.blob_idx, 0.0, dy, dx)
        self.owner.editor.set_radius(self.blob_idx, self.circle.radius)
        self._press = None
        self.circle.set_animated(False)
        self._background = None
        self.circle.figure.canvas.draw_idle()

    # -- pick (flag cycling / cut / copy / delete) -------------------------

    def on_pick(self, event):
        if (event.mouseevent.key in ("control", "shift", "alt")
                or event.artist is not self.circle):
            return
        key = event.mouseevent.key
        if key == "x":
            self.picked.append((self, self.CUT))
            self.remove_self()
            self.owner.editor.delete_blob(self.blob_idx)
            self.owner.reindex_after_delete(self.blob_idx)
        elif key == "c":
            self.picked.append((self, self._COPY))
        elif key == "d":
            self.picked.append((self, self.CUT))
            self.remove_self()
            self.owner.editor.delete_blob(self.blob_idx)
            self.owner.reindex_after_delete(self.blob_idx)
        else:
            if key == "r":
                # reverse cycle: step the flag backwards
                cycle = (-1, 0, 1)
                cur = int(self.owner.editor.blobs[self.blob_idx, 4])
                nxt = cycle[(cycle.index(cur) - 1) % len(cycle)] \
                    if cur in cycle else cycle[0]
                self.owner.editor.set_confirmed(self.blob_idx, nxt)
            else:
                nxt = self.owner.editor.cycle_confirmed(self.blob_idx)
            self.circle.set_facecolor(self.BLOB_COLORS.get(int(
                self.owner.editor.blobs[self.blob_idx, 4]), "none"))
        if self.circle.figure:
            self.circle.figure.canvas.draw_idle()


class ROIEditorCanvas:
    """One z-plane of an ROI with draggable blob circles.

    Binds the reference ROI-editor interactions onto a live figure:
    ctrl+click adds a blob at the cursor (confirmed, like the
    reference's manual adds), circles handle their own drag/flag events,
    scrolling changes the displayed plane, and ``save_to_db`` persists
    the curated blobs (reference confirm->sqlite flow).
    """

    def __init__(self, editor, z: Optional[int] = None, figsize=(5, 5)):
        import matplotlib.figure
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib import patches

        self.editor = editor
        self._patches = patches
        self.z = int(z if z is not None else editor.roi.shape[0] // 2)
        self.fig = matplotlib.figure.Figure(figsize=figsize)
        self.canvas = FigureCanvasAgg(self.fig)
        self.ax = self.fig.add_subplot(111)
        self.picked: List = []
        self.circles: Dict[int, DraggableCircle] = {}
        self._cid_press = self.canvas.mpl_connect(
            "button_press_event", self._on_press)
        self._cid_scroll = self.canvas.mpl_connect(
            "scroll_event", self._on_scroll)
        self.refresh()

    def refresh(self):
        """Redraw the plane and rebuild circle artists."""
        for dc in self.circles.values():
            dc.disconnect()
        self.ax.clear()
        self.ax.imshow(
            self.editor.roi[self.z], cmap="gray", origin="upper")
        self.circles = {}
        for idx in self.editor.blobs_in_plane(self.z):
            blob = self.editor.blobs[idx]
            color = DraggableCircle.BLOB_COLORS.get(int(blob[4]), "none")
            circ = self._patches.Circle(
                (blob[2], blob[1]), radius=max(float(blob[3]), 0.5),
                edgecolor="w", facecolor=color, alpha=0.6)
            self.ax.add_patch(circ)
            dc = DraggableCircle(circ, int(idx), self, self.picked)
            dc.connect()
            self.circles[int(idx)] = dc
        self.canvas.draw()

    def reindex_after_delete(self, deleted_idx: int):
        """Controller rows shift after a delete; rebuild the artists."""
        self.refresh()

    def _on_press(self, event):
        if event.inaxes != self.ax or event.key != "control":
            return
        idx = self.editor.add_blob(
            float(self.z), float(event.ydata), float(event.xdata))
        self.refresh()
        return idx

    def _on_scroll(self, event):
        self.z = int(np.clip(
            self.z + (1 if event.step > 0 else -1), 0,
            self.editor.roi.shape[0] - 1))
        self.refresh()

    def save_to_db(self, db, experiment: str = "exp", series: int = 0):
        return self.editor.save(db, experiment, series)


class PlotEditorCanvas:
    """Editable plane canvas: paint / pick / pan / zoom / windowing.

    Binds the reference plot-editor interactions
    (``plot_editor.py:76``) onto a figure over the headless
    :class:`gui.plot_editor.PlotEditor`:
      - left-drag paints the selected label with the brush,
      - ctrl+click picks the label under the cursor (sets the paint
        intensity, reference ``intensity`` attribute),
      - alt+drag erases (paints background),
      - scroll steps planes; ctrl+scroll zooms about the cursor,
      - arrow keys pan; ``[`` / ``]`` widen/narrow the intensity window,
      - ``i`` interpolates the edited label between the bookmarked and
        current planes (reference two-click ``InterpolatePlanes``,
        ``atlas_editor.py:475``).
    """

    def __init__(self, plot_editor, figsize=(5, 5)):
        import matplotlib.figure
        from matplotlib.backends.backend_agg import FigureCanvasAgg

        self.pe = plot_editor
        self.fig = matplotlib.figure.Figure(figsize=figsize)
        self.canvas = FigureCanvasAgg(self.fig)
        self.ax = self.fig.add_subplot(111)
        self._painting = False
        self._erasing = False
        for name, cb in (
                ("button_press_event", self._on_press),
                ("button_release_event", self._on_release),
                ("motion_notify_event", self._on_motion),
                ("scroll_event", self._on_scroll),
                ("key_press_event", self._on_key)):
            self.canvas.mpl_connect(name, cb)
        self.refresh()

    def refresh(self):
        self.ax.clear()
        self.ax.imshow(self.pe.render(), origin="upper")
        self.canvas.draw()

    # -- events -----------------------------------------------------------

    def _on_press(self, event):
        if event.inaxes != self.ax or event.xdata is None:
            return
        y, x = float(event.ydata), float(event.xdata)
        if event.key == "control":
            self.pe.paint_label_id = self.pe.pick_label(y, x)
            return
        if event.key == "alt":
            self._erasing = True
            self.pe.erase(y, x)
        else:
            self._painting = True
            self.pe.paint(y, x)
        self.refresh()

    def _on_motion(self, event):
        if (not (self._painting or self._erasing)
                or event.inaxes != self.ax or event.xdata is None):
            return
        y, x = float(event.ydata), float(event.xdata)
        if self._erasing:
            self.pe.erase(y, x)
        else:
            self.pe.paint(y, x)
        self.refresh()

    def _on_release(self, event):
        self._painting = False
        self._erasing = False

    def _on_scroll(self, event):
        if event.key == "control" and event.xdata is not None:
            self.pe.zoom(1.25 if event.step > 0 else 0.8,
                         center=(event.ydata, event.xdata))
        else:
            self.pe.scroll(1 if event.step > 0 else -1)
        self.refresh()

    def _on_key(self, event):
        pans = {"up": (-5, 0), "down": (5, 0),
                "left": (0, -5), "right": (0, 5)}
        if event.key in pans:
            self.pe.pan(*pans[event.key])
        elif event.key == "[":
            self._window(expand=True)
        elif event.key == "]":
            self._window(expand=False)
        elif event.key == "i":
            self.pe.editor.interpolate_from_bookmark(
                self.pe.axis, self.pe.index)
        elif event.key == "z":
            self.pe.editor.undo()
        else:
            return
        self.refresh()

    def _window(self, expand: bool):
        img = self.pe.editor.img
        lo = float(img.min())
        hi = float(img.max())
        vmin = self.pe.vmin if self.pe.vmin is not None else lo
        vmax = self.pe.vmax if self.pe.vmax is not None else hi
        span = (vmax - vmin) or 1.0
        delta = span * (0.1 if expand else -0.1)
        self.pe.update_intensity(
            max(lo, vmin - delta), min(hi, vmax + delta))


class VerifierCanvas:
    """Paged blob-verification grid with click-to-flag cells.

    Binds the reference VerifierEditor interactions
    (``magmap/gui/verifier_editor.py:21``) onto a figure over the
    headless :class:`gui.verifier_editor.VerifierEditor`: each cell
    shows one blob patch, clicking a cell cycles its confirmed flag
    (border recolors), and left/right arrow keys page through blobs.
    """

    def __init__(self, editor, figsize=(6, 6)):
        import matplotlib.figure
        from matplotlib.backends.backend_agg import FigureCanvasAgg

        self.editor = editor
        self.fig = matplotlib.figure.Figure(figsize=figsize)
        self.canvas = FigureCanvasAgg(self.fig)
        self.axes_views: Dict = {}
        self.canvas.mpl_connect("button_press_event", self._on_press)
        self.canvas.mpl_connect("key_press_event", self._on_key)
        self.refresh()

    def refresh(self):
        self.fig.clf()
        views = self.editor.build_page()
        self.axes_views = {}
        n = self.editor._nrows
        m = self.editor._ncols
        for i, view in enumerate(views):
            ax = self.fig.add_subplot(n, m, i + 1)
            ax.imshow(view.patch, cmap="gray")
            ax.set_xticks([])
            ax.set_yticks([])
            color = self.editor.blob_color(view.index)
            for spine in ax.spines.values():
                spine.set_edgecolor(
                    color if color != "none" else "0.5")
                spine.set_linewidth(3)
            self.axes_views[ax] = view
        self.canvas.draw()

    def _on_press(self, event):
        view = self.axes_views.get(event.inaxes)
        if view is None:
            return
        self.editor.flag_blob(view.index)
        self.refresh()

    def _on_key(self, event):
        if event.key == "right":
            self.editor.next_page()
        elif event.key == "left":
            self.editor.prev_page()
        else:
            return
        self.refresh()


class AtlasEditorCanvases:
    """Three synchronized orthogonal editing views over one AtlasEditor.

    The reference AtlasEditor hosts one PlotEditor per plane and keeps
    their crosshair, label alpha, and intensity window in sync
    (``magmap/gui/atlas_editor.py:22`` + ``plot_support.ImageSyncMixin``).
    All views share the AtlasEditor's position state, so a scroll in one
    view moves the linked plane in the others on the next refresh;
    ``update_coords``/``update_alpha``/``update_intensity`` come from the
    mixin and fan out to every view.
    """

    def __init__(self, atlas_editor, figsize=(4, 4)):
        from magellanmapper_torch.plot.plot_support import ImageSyncMixin
        from magellanmapper_torch.gui.atlas_editor import PLANES

        self.editor = atlas_editor
        self.sync = ImageSyncMixin()
        self.canvases: Dict[str, PlotEditorCanvas] = {}
        for plane in PLANES:
            pe = atlas_editor.make_plot_editor(plane)
            self.sync.plot_eds[plane] = pe
            self.canvases[plane] = PlotEditorCanvas(pe, figsize=figsize)

    def update_coords(self, coords):
        self.sync.update_coords(coords)
        self.refresh_all()

    def update_alpha(self, alpha: float):
        self.sync.update_alpha(alpha)
        self.refresh_all()

    def update_intensity(self, vmin, vmax):
        self.sync.update_intensity(vmin, vmax)
        self.refresh_all()

    def refresh_all(self):
        for cv in self.canvases.values():
            cv.refresh()
