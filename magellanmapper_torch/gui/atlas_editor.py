"""Atlas editor: label editing over synced orthogonal planes.

Copy of ``magellanmapper_tpu/gui/atlas_editor.py`` (the reference's
``AtlasEditor``): brush edits of the labels, interpolation of a label
between two edited planes (on the editor's device, through
``cv.cv_nd.interpolate_label_between_planes``), undo, and saving the
edited annotation through ``io.sitk_io``. Each plane view is a
:class:`magellanmapper_torch.gui.plot_editor.PlotEditor`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.cv import cv_nd
from magellanmapper_torch.io import sitk_io

#: axis per plane name, z,y,x order (reference config.PLANE)
PLANES = {"xy": 0, "xz": 1, "yz": 2}


class AtlasEditor:
    """Label editing over an intensity image + annotation pair; label
    interpolation runs on ``device``."""

    def __init__(self, img: np.ndarray, labels_img: np.ndarray,
                 labels_ref=None, device="cuda"):
        assert img.shape[:3] == labels_img.shape[:3]
        self.device = device_mod.resolve(device)
        self.img = np.asarray(img)
        self.labels_img = np.array(labels_img)
        self.labels_ref = labels_ref
        #: current plane index per axis (synced crosshair position)
        self.position = [s // 2 for s in self.labels_img.shape[:3]]
        self._history: List[Tuple[np.ndarray, np.ndarray]] = []
        self.edited = False
        #: interpolation bookmark: (label_id, axis, plane) of the last edit
        self.edit_bookmark: Optional[Tuple[int, int, int]] = None

    # -- views -----------------------------------------------------------------

    def make_plot_editor(self, plane: str = "xy"):
        """A linked per-plane editor (reference builds one per axis)."""
        from magellanmapper_torch.gui.plot_editor import PlotEditor
        return PlotEditor(self, PLANES[plane])

    def get_plane(self, axis: int, index: Optional[int] = None,
                  labels: bool = False) -> np.ndarray:
        """Extract a 2D plane from the intensity or labels volume."""
        src = self.labels_img if labels else self.img
        idx = self.position[axis] if index is None else int(index)
        sl = [slice(None)] * 3
        sl[axis] = idx
        return src[tuple(sl)]

    def set_position(self, axis: int, index: int) -> None:
        """Move the synced crosshair along ``axis`` (plane scroll)."""
        self.position[axis] = int(
            np.clip(index, 0, self.labels_img.shape[axis] - 1))

    def get_label_at(self, coords: Optional[Sequence[int]] = None) -> int:
        """Label ID under coords (default: crosshair)."""
        coords = self.position if coords is None else coords
        return int(self.labels_img[tuple(int(c) for c in coords[:3])])

    def get_label_name(self, label_id: Optional[int] = None
                       ) -> Optional[str]:
        """Ontology name for a label, via the attached reference."""
        if self.labels_ref is None or getattr(
                self.labels_ref, "ref_lookup", None) is None:
            return None
        from magellanmapper_torch.atlas import ontology
        lid = self.get_label_at() if label_id is None else int(label_id)
        return ontology.get_label_name(
            self.labels_ref.ref_lookup.get(lid), side=True)

    # -- edits -----------------------------------------------------------------

    def _push_history(self, mask: np.ndarray, axis: int, index: int):
        sl = [slice(None)] * 3
        sl[axis] = index
        prev = self.labels_img[tuple(sl)][mask].copy()
        self._history.append((np.argwhere(mask), prev, axis, index))

    def paint_label(self, axis: int, index: int, center: Sequence[float],
                    radius: float, label_id: int) -> int:
        """Paint a circular brush of ``label_id`` into one plane
        (reference PlotEditor paintbrush); returns voxels changed."""
        plane = self.get_plane(axis, index, labels=True)
        yy, xx = np.indices(plane.shape)
        mask = ((yy - center[0]) ** 2 + (xx - center[1]) ** 2
                <= radius * radius)
        self._push_history(mask, axis, index)
        sl = [slice(None)] * 3
        sl[axis] = int(index)
        region = self.labels_img[tuple(sl)]
        changed = int(np.count_nonzero(region[mask] != label_id))
        region[mask] = label_id
        self.edited = changed > 0 or self.edited
        self.edit_bookmark = (int(label_id), int(axis), int(index))
        return changed

    def erase_label(self, axis: int, index: int, center: Sequence[float],
                    radius: float) -> int:
        """Erase to background (label 0)."""
        return self.paint_label(axis, index, center, radius, 0)

    def interpolate_planes(self, label_id: int, axis: int,
                           bounds: Sequence[int]) -> None:
        """Fill a label between two annotated planes
        (reference ``interpolate_plane`` toolbar action; contour
        interpolation via the signed-EDT blend in ``cv_nd``)."""
        self.labels_img = cv_nd.interpolate_label_between_planes(
            self.labels_img, label_id, axis, bounds, device=self.device)
        self.edited = True

    def interpolate_from_bookmark(self, axis: int, index: int) -> bool:
        """Interpolate the bookmarked label between its last edited
        plane and ``index`` (the reference's two-click flow)."""
        if self.edit_bookmark is None or self.edit_bookmark[1] != axis:
            return False
        lid, _, start = self.edit_bookmark
        lo, hi = sorted((start, int(index)))
        if hi - lo < 2:
            return False
        self.interpolate_planes(lid, axis, (lo, hi))
        return True

    def undo(self) -> bool:
        """Revert the last paint edit."""
        if not self._history:
            return False
        coords, prev, axis, index = self._history.pop()
        sl = [slice(None)] * 3
        sl[axis] = index
        region = self.labels_img[tuple(sl)]
        region[tuple(coords.T)] = prev
        return True

    # -- persistence ---------------------------------------------------------

    def save_atlas(self, out_path: str,
                   spacing: Sequence[float] = (1.0, 1.0, 1.0)) -> str:
        """Write the edited annotation (reference ``save_atlas`` writes
        ``annotationEdit``)."""
        sitk_io.write_med_img(out_path, sitk_io.MedImage(
            self.labels_img.astype(np.int32), tuple(spacing)))
        self.edited = False
        return out_path
