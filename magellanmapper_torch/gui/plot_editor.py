"""Plot editor: the single-plane view and edit model of the atlas
editor.

Copy of ``magellanmapper_tpu/gui/plot_editor.py`` (the reference's
``PlotEditor``): plane scrolling, pan and zoom, the intensity window,
picking the label under the cursor, and brush strokes forwarded to the
owning :class:`magellanmapper_torch.gui.atlas_editor.AtlasEditor`.
``render()`` returns the RGB composite (windowed intensity blended with
the labels' colours) as an array.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class PlotEditor:
    """One orthogonal plane of an :class:`AtlasEditor`."""

    def __init__(self, editor, axis: int = 0, alpha: float = 0.5):
        self.editor = editor
        self.axis = int(axis)
        #: label overlay opacity (reference alpha slider)
        self.alpha = float(alpha)
        #: intensity window; None = full range
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        #: viewport: (y0, x0, height, width) in plane coordinates
        shape = self._plane_shape()
        self.view = [0.0, 0.0, float(shape[0]), float(shape[1])]
        #: brush radius for paint strokes
        self.brush_radius = 2.0
        #: currently selected label to paint with
        self.paint_label_id = 0
        self.last_pick: Optional[int] = None

    # -- geometry ---------------------------------------------------------

    def _plane_shape(self) -> Tuple[int, int]:
        shape = list(self.editor.labels_img.shape[:3])
        shape.pop(self.axis)
        return tuple(shape)

    @property
    def index(self) -> int:
        return self.editor.position[self.axis]

    def scroll(self, delta: int) -> int:
        """Advance the plane index (mouse wheel)."""
        self.editor.set_position(self.axis, self.index + delta)
        return self.index

    def zoom(self, factor: float,
             center: Optional[Sequence[float]] = None) -> None:
        """Zoom the viewport about ``center`` (plane coords)."""
        y0, x0, h, w = self.view
        cy = y0 + h / 2 if center is None else float(center[0])
        cx = x0 + w / 2 if center is None else float(center[1])
        h2, w2 = h / factor, w / factor
        shape = self._plane_shape()
        h2 = min(h2, shape[0])
        w2 = min(w2, shape[1])
        y0 = np.clip(cy - h2 / 2, 0, shape[0] - h2)
        x0 = np.clip(cx - w2 / 2, 0, shape[1] - w2)
        self.view = [float(y0), float(x0), float(h2), float(w2)]

    def pan(self, dy: float, dx: float) -> None:
        y0, x0, h, w = self.view
        shape = self._plane_shape()
        self.view[0] = float(np.clip(y0 + dy, 0, shape[0] - h))
        self.view[1] = float(np.clip(x0 + dx, 0, shape[1] - w))

    def reset_view(self) -> None:
        shape = self._plane_shape()
        self.view = [0.0, 0.0, float(shape[0]), float(shape[1])]

    # -- display ---------------------------------------------------------

    def update_intensity(self, vmin: Optional[float],
                         vmax: Optional[float]) -> None:
        """Set the intensity window (reference vmin/vmax sliders)."""
        self.vmin, self.vmax = vmin, vmax

    def render(self) -> np.ndarray:
        """RGB composite of the viewport: windowed grayscale intensity
        blended with discrete label colors at :attr:`alpha`."""
        from magellanmapper_torch.plot import colormaps

        img = np.asarray(
            self.editor.get_plane(self.axis, self.index), np.float32)
        labels = self.editor.get_plane(self.axis, self.index, labels=True)
        y0, x0, h, w = (int(round(v)) for v in self.view)
        img = img[y0:y0 + max(h, 1), x0:x0 + max(w, 1)]
        labels = labels[y0:y0 + max(h, 1), x0:x0 + max(w, 1)]

        vmin = np.min(img) if self.vmin is None else self.vmin
        vmax = np.max(img) if self.vmax is None else self.vmax
        denom = max(vmax - vmin, 1e-12)
        gray = np.clip((img - vmin) / denom, 0, 1)
        rgb = np.repeat(gray[..., None], 3, axis=-1)

        ids = np.unique(labels)
        ids = ids[ids != 0]
        if len(ids):
            lut = colormaps.discrete_colors(ids.tolist())
            overlay = np.zeros_like(rgb)
            mask = np.zeros(labels.shape, bool)
            for lid in ids:
                m = labels == lid
                overlay[m] = lut[int(lid)][:3]
                mask |= m
            rgb[mask] = ((1 - self.alpha) * rgb[mask]
                         + self.alpha * overlay[mask])
        return rgb

    # -- interaction -------------------------------------------------------

    def pick_label(self, y: float, x: float) -> int:
        """Label under a click; remembers it as the paint label
        (reference eyedropper/click-to-select)."""
        labels = self.editor.get_plane(self.axis, self.index, labels=True)
        yy = int(np.clip(round(y), 0, labels.shape[0] - 1))
        xx = int(np.clip(round(x), 0, labels.shape[1] - 1))
        lid = int(labels[yy, xx])
        self.last_pick = lid
        self.paint_label_id = lid
        return lid

    def paint(self, y: float, x: float,
              label_id: Optional[int] = None) -> int:
        """Apply a brush stroke at plane coords (forwarded to the
        editor's history-tracked paint)."""
        lid = self.paint_label_id if label_id is None else int(label_id)
        return self.editor.paint_label(
            self.axis, self.index, (y, x), self.brush_radius, lid)

    def erase(self, y: float, x: float) -> int:
        return self.editor.erase_label(
            self.axis, self.index, (y, x), self.brush_radius)


class PlotAxImg:
    """Displayed-image settings record (reference
    ``plot_editor.PlotAxImg :29``): brightness/contrast/alpha applied on
    top of the raw plane, with the adjusted image recomputed on demand."""

    def __init__(self, ax_img=None, vmin=None, vmax=None, img=None):
        self.ax_img = ax_img
        self.vmin = vmin
        self.vmax = vmax
        self.img = img
        self.brightness: float = 0.0
        self.contrast: float = 1.0
        self.alpha = None
        self.alpha_blend = None

    def adjusted(self) -> np.ndarray:
        """Image with brightness/contrast applied."""
        out = np.asarray(self.img, float) * self.contrast \
            + self.brightness
        if self.vmin is not None or self.vmax is not None:
            out = np.clip(
                out,
                self.vmin if self.vmin is not None else out.min(),
                self.vmax if self.vmax is not None else out.max())
        return out
