"""ROI and blob exports for training and review.

Copy of ``magellanmapper_tpu/io/export_rois.py``: the blob archive as CSV
(``blobs_to_csv``, which ``--proc export_blobs`` runs), each truth ROI of
a database as an image and a blob CSV (``export_rois``, ``--proc
export_rois``), and the per-ROI paths of the export and their reading
back (``make_roi_paths``, ``load_roi_files``).
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Optional, Sequence

import numpy as np
import pandas as pd

from magellanmapper_torch.cv import blobs as blobs_mod
from magellanmapper_torch.utils import libmag

_logger = logging.getLogger(__name__)


def blobs_to_csv(rc_or_blobs, out_path: Optional[str] = None
                 ) -> pd.DataFrame:
    """Export blobs to CSV: from a parsed command line (its ``prefix``,
    else its first image, names the archive ``<base>_blobs.npz`` and the
    default output ``<base>_blobs.csv``) or from a blob array (columns
    named by :class:`~magellanmapper_torch.cv.blobs.BlobCols`, written
    only when ``out_path`` is given)."""
    if hasattr(rc_or_blobs, "filenames"):
        base = rc_or_blobs.prefix or rc_or_blobs.filenames[0]
        blobs = blobs_mod.Blobs().load_blobs(
            libmag.combine_paths(base, "blobs.npz"))
        arr = blobs.blobs
        out_path = out_path or libmag.combine_paths(base, "blobs.csv")
        cols = blobs.cols
    else:
        arr = np.asarray(rc_or_blobs)
        cols = [c.value for c in blobs_mod.BlobCols][:arr.shape[1]]
    df = pd.DataFrame(arr, columns=cols)
    if out_path:
        df.to_csv(out_path, index=False)
        _logger.info("exported %d blobs to %s", len(df), out_path)
    return df


def export_rois(
        image: np.ndarray, db, channel: Sequence[int],
        out_dir: str, padding: Sequence[int] = (0, 0, 0)) -> pd.DataFrame:
    """Write each ROI of the database ``db`` as ``roi_<id>.npy`` (the z,y,x
    sub-image of ``image``, ``padding`` wider on each side) and its blobs
    as ``roi_<id>_blobs.csv`` into ``out_dir``; returns one row an ROI
    (ID, offset, size, blob count)."""
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for roi in db.get_rois():
        roi_id = roi["id"]
        offset = (roi["offset_z"], roi["offset_y"], roi["offset_x"])
        size = (roi["size_z"], roi["size_y"], roi["size_x"])
        sl = tuple(slice(o - p, o + s + p) for o, s, p in zip(
            offset, size, padding))
        sub = np.asarray(image[sl])
        base = os.path.join(out_dir, f"roi_{roi_id}")
        np.save(base + ".npy", sub)
        blobs = db.select_blobs_by_roi(roi_id)
        blobs_to_csv(blobs, base + "_blobs.csv")
        rows.append({"roi_id": roi_id, "offset": offset, "size": size,
                     "n_blobs": len(blobs)})
    return pd.DataFrame(rows)


def make_roi_paths(path: str, roi_id, channel=0,
                   make_dirs: bool = False):
    """``(directory, image path, blobs path)`` of an ROI's export
    (``*`` as ``roi_id`` gives glob patterns)."""
    path_base = "{}_roi{}".format(
        path, str(roi_id).zfill(5) if roi_id != "*" else "*")
    name_base = os.path.basename(path_base)
    path_img = os.path.join(
        path_base, f"{name_base}_ch{channel}.npy")
    path_blobs = os.path.join(path_base, f"{name_base}_blobs.npy")
    if make_dirs and not os.path.exists(path_base):
        os.makedirs(path_base)
    return path_base, path_img, path_blobs


def load_roi_files(db, path: str):
    """``(glob base, images, blobs)`` of the ROI exports under ``path``,
    each blob array with a last column of -1 added."""
    path_base, path_img, path_blobs = make_roi_paths(path, "*")
    img_paths = sorted(glob.glob(path_img))
    blob_paths = sorted(glob.glob(path_blobs))
    imgs, img_blobs = [], []
    for img_p, blobs_p in zip(img_paths, blob_paths):
        imgs.append(np.load(img_p))
        blobs = np.load(blobs_p)
        img_blobs.append(
            np.insert(blobs, blobs.shape[1], -1, axis=1))
    return path_base, imgs, img_blobs
