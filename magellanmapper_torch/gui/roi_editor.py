"""ROI editor: blob curation in the planes of an ROI.

Copy of ``magellanmapper_tpu/gui/roi_editor.py`` (the reference's
``ROIEditor``): add, move and delete blobs, cycle the confirmed flag that
builds truth sets, the blobs seen in each plane (within their radius),
undo, and saving the curated blobs to the database. The plane grid
renders through :mod:`magellanmapper_torch.gui.roi_review`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from magellanmapper_torch.cv import blobs as blobs_mod

#: confirmed-flag cycle: unverified -> incorrect -> correct -> unverified
#: (reference circle-click flow, ``roi_editor.py`` verified states)
CONFIRMED_CYCLE = (-1, 0, 1)


class ROIEditor:
    """Blob curation state for one ROI (reference ``ROIEditor``)."""

    def __init__(self, roi: np.ndarray,
                 blobs: Optional[np.ndarray] = None,
                 offset: Sequence[int] = (0, 0, 0)):
        """``roi``: z,y,x volume; ``blobs``: N x >=4 z,y,x,r rows in ROI-
        relative coordinates; ``offset``: ROI origin in the full image."""
        self.roi = np.asarray(roi)
        self.offset = tuple(int(o) for o in offset)
        if blobs is None:
            blobs = np.zeros((0, 10))
        self.blobs = blobs_mod.Blobs(
            np.asarray(blobs, dtype=float)).format_blobs()
        self._history: List[np.ndarray] = []

    # -- edit ops ------------------------------------------------------------

    def _push(self):
        self._history.append(self.blobs.copy())

    def add_blob(self, z: float, y: float, x: float, radius: float = 3.0,
                 channel: int = 0, confirmed: int = 1) -> int:
        """Add a blob (reference circle-add); returns its index. New
        blobs are marked confirmed=1 like the reference's manual adds."""
        self._push()
        row = np.zeros((1, self.blobs.shape[1]))
        row[0, :4] = (z, y, x, radius)
        row[0, 4] = confirmed
        row[0, 5] = -1          # truth unknown
        row[0, 6] = channel
        row[0, 7:10] = (z, y, x)
        self.blobs = np.concatenate([self.blobs, row], axis=0)
        return len(self.blobs) - 1

    def move_blob(self, index: int, dz: float = 0, dy: float = 0,
                  dx: float = 0) -> None:
        """Shift a blob, clipped to the ROI bounds (circle drag)."""
        self._push()
        pos = self.blobs[index, :3] + (dz, dy, dx)
        self.blobs[index, :3] = np.clip(
            pos, 0, np.subtract(self.roi.shape[:3], 1))
        self.blobs[index, 7:10] = self.blobs[index, :3]

    def delete_blob(self, index: int) -> None:
        self._push()
        self.blobs = np.delete(self.blobs, index, axis=0)

    def set_radius(self, index: int, radius: float) -> None:
        """Resize a blob (alt-drag on its circle)."""
        self.blobs[index, 3] = float(radius)

    def set_confirmed(self, index: int, flag: int) -> None:
        self.blobs[index, 4] = flag

    def cycle_confirmed(self, index: int) -> int:
        """Advance the confirmed flag through -1 -> 0 -> 1 -> -1
        (reference circle click cycle); returns the new flag."""
        cur = int(self.blobs[index, 4])
        nxt = CONFIRMED_CYCLE[
            (CONFIRMED_CYCLE.index(cur) + 1) % len(CONFIRMED_CYCLE)] \
            if cur in CONFIRMED_CYCLE else CONFIRMED_CYCLE[0]
        self.blobs[index, 4] = nxt
        return nxt

    def undo(self) -> bool:
        if not self._history:
            return False
        self.blobs = self._history.pop()
        return True

    # -- queries ---------------------------------------------------------------

    def blobs_in_plane(self, z: int, within_radius: bool = True
                       ) -> np.ndarray:
        """Indices of blobs visible at plane ``z``: within their radius of
        the plane (reference shows a blob across ``2r`` planes)."""
        dz = np.abs(self.blobs[:, 0] - z)
        lim = self.blobs[:, 3] if within_radius else 0.5
        return np.flatnonzero(dz <= lim)

    def verified_counts(self) -> Tuple[int, int, int]:
        """(unverified, incorrect, correct) counts over confirmed flags."""
        conf = self.blobs[:, 4].astype(int)
        return (int((conf == -1).sum()), int((conf == 0).sum()),
                int((conf == 1).sum()))

    def blobs_absolute(self) -> np.ndarray:
        """Blobs shifted into full-image coordinates."""
        out = self.blobs.copy()
        out[:, :3] += self.offset
        return out

    # -- persistence -------------------------------------------------------------

    def save(self, db, experiment: str = "exp", series: int = 0) -> int:
        """Insert the ROI and its curated blobs into a :class:`ClrDB`
        (reference ``_btn_save_segments_fired`` flow)."""
        exp_id = db.select_or_insert_experiment(experiment)
        roi_id, _ = db.select_or_insert_roi(
            exp_id, series, tuple(self.offset[::-1]),
            tuple(int(s) for s in self.roi.shape[:3][::-1]))
        db.delete_blobs(roi_id)
        return db.insert_blobs(roi_id, self.blobs)

    def plot(self, out_path: str, n_cols: int = 5):
        """Render the plane grid with blob overlays."""
        from magellanmapper_torch.gui import roi_review
        return roi_review.plot_roi_planes(
            self.roi, self.blobs, out_path, n_cols=n_cols)
