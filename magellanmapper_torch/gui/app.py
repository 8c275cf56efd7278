"""The windowed application: a Tk event loop hosting the ROI editor.

Copy of ``magellanmapper_tpu/gui/app.py``: the ROI editor's canvas
embedded through ``FigureCanvasTkAgg`` (so every interaction of
:mod:`magellanmapper_torch.gui.mpl_canvas` works live), a plane slider,
and Detect and Save buttons driven through the
:class:`magellanmapper_torch.gui.visualizer.Visualization` controller.
tkinter and matplotlib are imported when the window is built. Without a
display :meth:`MagellanTkApp.run` raises, naming the port's controller
and its Agg canvases.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def display_available() -> bool:
    """True when a GUI display is reachable for Tk."""
    return bool(os.environ.get("DISPLAY")) or os.name == "nt"


class MagellanTkApp:
    """Tk window hosting the interactive ROI editor.

    Mirrors the reference app's core workflow panels: image selection is
    assumed done through the session controller; the window shows the
    current ROI plane with draggable blob circles, a plane slider, and
    Detect / Save buttons (reference detection tab + blob save flow,
    ``visualizer.py:2699``).
    """

    def __init__(self, vis, root=None):
        self.vis = vis
        self.root = root
        self.roi_canvas = None
        self._tk_widgets = {}

    # -- construction -------------------------------------------------------

    def build(self, parent) -> None:
        """Create widgets under ``parent`` (a Tk container)."""
        import tkinter as tk
        from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg

        from magellanmapper_torch.gui.mpl_canvas import ROIEditorCanvas
        from magellanmapper_torch.gui.roi_editor import ROIEditor

        roi = self.vis.get_roi()
        roi3d = roi[..., 0] if roi.ndim > 3 else roi
        editor = ROIEditor(
            roi3d, self.vis.blobs, offset=self.vis.roi_offset[::-1])
        self.roi_canvas = ROIEditorCanvas(editor)

        # re-host the Agg figure on a Tk canvas (keeps all mpl handlers)
        tk_canvas = FigureCanvasTkAgg(self.roi_canvas.fig, master=parent)
        self.roi_canvas.canvas = self.roi_canvas.fig.canvas
        tk_canvas.get_tk_widget().pack(fill=tk.BOTH, expand=True)

        controls = tk.Frame(parent)
        controls.pack(fill=tk.X)
        plane = tk.Scale(
            controls, from_=0, to=roi3d.shape[0] - 1,
            orient=tk.HORIZONTAL, label="plane",
            command=lambda v: self.set_plane(int(v)))
        plane.set(self.roi_canvas.z)
        plane.pack(side=tk.LEFT, fill=tk.X, expand=True)
        detect = tk.Button(controls, text="Detect", command=self.detect)
        detect.pack(side=tk.LEFT)
        save = tk.Button(controls, text="Save blobs", command=self.save)
        save.pack(side=tk.LEFT)
        self._tk_widgets = {
            "canvas": tk_canvas, "plane": plane,
            "detect": detect, "save": save}

    # -- actions ------------------------------------------------------------

    def set_plane(self, z: int) -> None:
        self.roi_canvas.z = int(np.clip(
            z, 0, self.roi_canvas.editor.roi.shape[0] - 1))
        self.roi_canvas.refresh()

    def detect(self) -> Optional[np.ndarray]:
        """Run ROI detection through the session controller and show the
        resulting circles (reference ``_blob_detection_fired``)."""
        blobs = self.vis.detect_blobs()
        if blobs is not None:
            self.roi_canvas.editor.blobs = np.asarray(blobs, float)
            self.roi_canvas.refresh()
        return blobs

    def save(self) -> int:
        if self.vis.db is None:
            self.vis.open_db()
        return self.roi_canvas.save_to_db(self.vis.db)

    # -- event loop ----------------------------------------------------------

    def run(self) -> None:
        """Open the window and enter the Tk event loop."""
        if not display_available():
            raise RuntimeError(
                "no $DISPLAY available: the windowed app needs a GUI "
                "session; use the scriptable magellanmapper_torch.gui."
                "visualizer.Visualization controller or the Agg canvases "
                "in magellanmapper_torch.gui.mpl_canvas instead")
        import tkinter as tk

        self.root = tk.Tk()
        self.root.title("MagellanMapper (PyTorch)")
        self.build(self.root)
        self.root.mainloop()


def main(vis=None) -> MagellanTkApp:
    """Launch the windowed app (reference ``visualizer.main :103``)."""
    if vis is None:
        from magellanmapper_torch.gui.visualizer import Visualization
        vis = Visualization()
    app = MagellanTkApp(vis)
    app.run()
    return app
