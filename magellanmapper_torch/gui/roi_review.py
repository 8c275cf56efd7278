"""ROI review without a window: plane grids with blob circles, and
confirmations written back to the database.

Copy of ``magellanmapper_tpu/gui/roi_review.py``: figures render to
files (matplotlib's Agg backend, imported when a figure is made), and
confirmations go through the same blob database calls as the ROI editor.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np

from magellanmapper_torch.plot import plot_support

_logger = logging.getLogger(__name__)

#: blob circle colors by confirmed flag (reference ROI editor semantics)
CONFIRMED_COLORS = {-1: "gold", 0: "crimson", 1: "lime", 2: "orange"}


def plot_roi_planes(
        roi: np.ndarray, blobs: Optional[np.ndarray] = None,
        out_path: Optional[str] = None, n_cols: int = 5,
        channel: Optional[int] = None,
        z_range: Optional[Sequence[int]] = None):
    """Serial z-plane grid with blob circles at each plane
    (the ROI Editor's main view).

    Blobs show on planes within their radius of the blob center; the
    circle radius shrinks away from the center plane (reference
    ``roi_editor`` circle scaling).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import patches

    vol = roi[..., channel] if roi.ndim > 3 and channel is not None else roi
    multichannel = vol.ndim > 3
    zs = list(range(vol.shape[0]) if z_range is None else range(*z_range))
    n_rows = -(-len(zs) // n_cols)
    fig, axes = plt.subplots(
        n_rows, n_cols, figsize=(2.2 * n_cols, 2.2 * n_rows))
    axes = np.atleast_1d(axes).ravel()
    for ax in axes:
        ax.axis("off")
    for ax, z in zip(axes, zs):
        plane = vol[z]
        if multichannel:
            plane = plot_support.overlay_images(plane)
        ax.imshow(plane, cmap=None if plane.ndim > 2 else "gray")
        ax.set_title(f"z={z}", fontsize=7)
        if blobs is None:
            continue
        for b in blobs:
            dz = abs(b[0] - z)
            rad = float(b[3])
            if dz > rad:
                continue
            r_plane = float(np.sqrt(max(rad ** 2 - dz ** 2, 0.25)))
            color = CONFIRMED_COLORS.get(int(b[4]), "gold")
            ax.add_patch(patches.Circle(
                (b[2], b[1]), r_plane, fill=False, color=color,
                linewidth=0.8))
    if out_path:
        plot_support.save_fig(fig, out_path)
    plt.close(fig)
    return fig


def confirm_blobs(
        db, roi_id: int, blob_indices: Sequence[int],
        flag: int = 1) -> np.ndarray:
    """Set confirmation flags on blobs of an ROI and persist
    (the ROI Editor's confirm/flag workflow)."""
    blobs = db.select_blobs_by_roi(roi_id)
    blobs[np.asarray(blob_indices, int), 4] = flag
    db.delete_blobs(roi_id)
    db.insert_blobs(roi_id, blobs)
    return blobs


def export_verifications(
        matches, out_path: str) -> "object":
    """Write blob-match review data (verifier_editor workflow)."""
    import pandas as pd
    rows = []
    for blob1, blob2, dist in matches:
        rows.append({
            "truth_z": blob1[0], "truth_y": blob1[1], "truth_x": blob1[2],
            "det_z": blob2[0], "det_y": blob2[1], "det_x": blob2[2],
            "dist": dist})
    df = pd.DataFrame(rows)
    df.to_csv(out_path, index=False)
    return df
