"""Widget logic of the GUI: draggable blob circles, two-plane label
interpolation, the pixel readout and blit bookkeeping.

Copy of ``magellanmapper_tpu/gui/widgets.py``: the interaction state
machines, with the matplotlib canvas optional. ``InterpolatePlanes``
fills the label between its planes on ``device`` through
``cv.cv_nd.interpolate_label_between_planes``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

#: blob circle edge color per confirmed flag
#: (reference ``DraggableCircle.BLOB_COLORS``)
BLOB_COLORS = {-1: "none", 0: "r", 1: "g", 2: "y"}


class DraggableCircle:
    """Drag/click state machine for one blob circle
    (reference ``roi_editor.DraggableCircle :39``).

    ``segment`` is the blob row ``[z, y, x, r, confirmed, ...]``;
    ``fn_update_seg(new, old)`` mirrors edits back to the blob store.
    """

    CUT = "cut"
    _COPY = "copy"

    #: circles cut/copied awaiting paste (class-level clipboard)
    picked: List = []

    def __init__(self, segment: np.ndarray,
                 fn_update_seg: Callable[[np.ndarray, np.ndarray], None],
                 circle=None):
        self.segment = np.asarray(segment, float)
        self.fn_update_seg = fn_update_seg
        self.circle = circle
        self._press = None  # (y0, x0, event_y, event_x) during drag

    @property
    def color(self) -> str:
        return BLOB_COLORS.get(int(self.segment[4]), "none")

    def on_press(self, y: float, x: float) -> bool:
        """Begin a drag if the press lands inside the circle radius."""
        dy = y - self.segment[1]
        dx = x - self.segment[2]
        if dy * dy + dx * dx > self.segment[3] ** 2:
            return False
        self._press = (self.segment[1], self.segment[2], y, x)
        return True

    def on_motion(self, y: float, x: float) -> None:
        if self._press is None:
            return
        y0, x0, ey, ex = self._press
        old = self.segment.copy()
        self.segment[1] = y0 + (y - ey)
        self.segment[2] = x0 + (x - ex)
        self.fn_update_seg(self.segment, old)

    def on_release(self) -> None:
        self._press = None

    def cycle_confirmed(self) -> int:
        """Advance -1 -> 0 -> 1 -> -1 (circle click)."""
        old = self.segment.copy()
        cycle = (-1, 0, 1)
        cur = int(self.segment[4])
        self.segment[4] = cycle[(cycle.index(cur) + 1) % 3] \
            if cur in cycle else -1
        self.fn_update_seg(self.segment, old)
        return int(self.segment[4])

    def resize(self, dr: float) -> float:
        old = self.segment.copy()
        self.segment[3] = max(self.segment[3] + dr, 0.5)
        self.fn_update_seg(self.segment, old)
        return float(self.segment[3])

    def cut(self) -> None:
        DraggableCircle.picked.append((self, self.CUT))

    def copy(self) -> None:
        DraggableCircle.picked.append((self, self._COPY))


class InterpolatePlanes:
    """Two-click interpolation bookmark
    (reference ``atlas_editor.InterpolatePlanes :475``): remember the
    label/plane of each edit; once two planes of the same label are
    registered, fill the gap."""

    def __init__(self, btn=None):
        self.btn = btn
        self.plane: Optional[str] = None
        self.bounds: Optional[List[Optional[int]]] = None
        self.label_id: Optional[int] = None

    def update_plane(self, plane: str, i: int, label_id: int) -> None:
        """Register an edited plane; resets if plane axis or label
        changed."""
        if self.plane != plane or self.label_id != label_id or \
                self.bounds is None:
            self.plane = plane
            self.label_id = label_id
            self.bounds = [None, None]
        self.bounds[1] = self.bounds[0]
        self.bounds[0] = int(i)
        self.update_btn()

    def update_btn(self) -> None:
        if self.btn is not None and self.bounds and any(
                b is not None for b in self.bounds):
            label = getattr(self.btn, "label", None)
            if label is not None:
                label.set_text(
                    f"Fill {self.plane} {self.bounds}\nID {self.label_id}")

    @property
    def ready(self) -> bool:
        return (self.plane is not None and self.label_id is not None
                and self.bounds is not None
                and all(b is not None for b in self.bounds)
                and abs(self.bounds[0] - self.bounds[1]) >= 2)

    def interpolate(self, labels_img: np.ndarray,
                    axis: Optional[int] = None,
                    device="cuda") -> np.ndarray:
        """Fill the bookmarked label between the two registered planes,
        the contours interpolated on ``device``."""
        from magellanmapper_torch import device as device_mod
        from magellanmapper_torch.cv import cv_nd
        dev = device_mod.resolve(device)
        if not self.ready:
            raise ValueError("need two edited planes >=2 apart")
        if axis is None:
            axis = {"xy": 0, "xz": 1, "yz": 2}.get(self.plane, 0)
        return cv_nd.interpolate_label_between_planes(
            labels_img, self.label_id, axis, sorted(self.bounds),
            device=dev)


class PixelDisplay:
    """Cursor-position intensity readout
    (reference ``pixel_display.PixelDisplay :11``); callable as
    Matplotlib's ``Axes.format_coord``."""

    def __init__(self, imgs: Sequence[np.ndarray], ax_imgs=None,
                 shapes=None, offset=None, cmap_labels=None):
        self.imgs = imgs
        self.ax_imgs = ax_imgs
        self.shapes = shapes
        self.offset = offset
        self.cmap_labels = cmap_labels

    def __call__(self, x: float, y: float) -> str:
        coords = []
        vals = []
        for i, img in enumerate(self.imgs):
            yy, xx = y, x
            if self.shapes is not None:
                # translate from displayed to original image space
                shape = self.shapes[i] if np.ndim(
                    self.shapes) > 1 else self.shapes
                yy = y * shape[0] / img.shape[0]
                xx = x * shape[1] / img.shape[1]
            if self.offset is not None:
                off = self.offset[i] if np.ndim(
                    self.offset) > 1 else self.offset
                yy += off[0]
                xx += off[1]
            yi = int(np.clip(round(y), 0, img.shape[0] - 1))
            xi = int(np.clip(round(x), 0, img.shape[1] - 1))
            vals.append(img[yi, xi])
            if not coords:
                coords = [int(round(yy)), int(round(xx))]
        val_str = ", ".join(
            f"{v:.4g}" if isinstance(v, (float, np.floating)) else str(v)
            for v in vals)
        return f"x={coords[1]}, y={coords[0]}, z=({val_str})"


class Blitter:
    """Matplotlib blit bookkeeping (reference
    ``image_viewer.Blitter``): caches the static background per axes
    and redraws only registered animated artists."""

    def __init__(self, canvas):
        self.canvas = canvas
        self._background = None
        self._artists: List = []

    def add_artist(self, artist) -> None:
        artist.set_animated(True)
        self._artists.append(artist)

    def capture(self) -> None:
        self._background = self.canvas.copy_from_bbox(
            self.canvas.figure.bbox)

    def blit(self) -> None:
        if self._background is None:
            self.capture()
        self.canvas.restore_region(self._background)
        for artist in self._artists:
            artist.axes.draw_artist(artist)
        self.canvas.blit(self.canvas.figure.bbox)
