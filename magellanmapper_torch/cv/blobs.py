"""Blob data model and its versioned NumPy archive.

Copy of ``magellanmapper_tpu/cv/blobs.py`` as far as the port uses it:
blobs are an ``N x C`` float array whose columns are ``z, y, x, radius,
confirmed, truth, channel, abs_z, abs_y, abs_x[, region]``; archives are
``.npz`` files with keys ``ver/segments/colocs/resolutions/basename/
offset/roi_size/columns`` at version ``BLOBS_NP_VER = 5``, which the
reference's ``Blobs.load_blobs`` reads, and :meth:`Blobs.load_blobs`
reads the reference's archives.
"""

from __future__ import annotations

import os
from enum import Enum
from typing import Optional, Sequence, Tuple

import numpy as np

from magellanmapper_torch.utils import libmag


class BlobCols(Enum):
    """Blob column names, in storage order."""
    Z = "z"
    Y = "y"
    X = "x"
    RADIUS = "radius"
    #: -1 = unconfirmed, 0 = incorrect, 1 = correct.
    CONFIRMED = "confirmed"
    #: -1 = not truth, 0 = unmatched truth, 1 = matched truth.
    TRUTH = "truth"
    CHANNEL = "channel"
    ABS_Z = "abs_z"
    ABS_Y = "abs_y"
    ABS_X = "abs_x"
    REGION = "region"


#: column index shortcuts
COL_IND = {c: i for i, c in enumerate(BlobCols)}
REL_COORD_SLICE = slice(0, 3)
ABS_COORD_SLICE = slice(COL_IND[BlobCols.ABS_Z], COL_IND[BlobCols.ABS_X] + 1)


class Blobs:
    """Blob storage with versioned ``.npz`` archive output."""

    #: archive version (the reference's current one)
    BLOBS_NP_VER = 5

    class Keys(Enum):
        """Archive metadata keys (names match the reference archive)."""
        VER = "ver"
        BLOBS = "segments"
        COLOCS = "colocs"
        RESOLUTIONS = "resolutions"
        BASENAME = "basename"
        ROI_OFFSET = "offset"
        ROI_SIZE = "roi_size"
        COLS = "columns"

    def __init__(
            self, blobs: Optional[np.ndarray] = None,
            blob_matches=None,
            colocalizations: Optional[np.ndarray] = None,
            path: Optional[str] = None,
            cols: Optional[Sequence[str]] = None):
        self.blobs = blobs
        self.blob_matches = blob_matches
        self.colocalizations = colocalizations
        self.path = path
        self.ver = self.BLOBS_NP_VER
        self.roi_offset: Optional[Sequence[int]] = None
        self.roi_size: Optional[Sequence[int]] = None
        self.resolutions: Optional[np.ndarray] = None
        self.basename: Optional[str] = None
        self.cols = cols
        if blobs is not None and self.cols is None:
            self.cols = [c.value for c in BlobCols][:blobs.shape[1]]

    # -- column accessors ----------------------------------------------------

    @staticmethod
    def get_blob_col(blobs: np.ndarray, col: BlobCols) -> np.ndarray:
        return blobs[..., COL_IND[col]]

    @staticmethod
    def set_blob_col(blobs: np.ndarray, col: BlobCols, val) -> np.ndarray:
        blobs[..., COL_IND[col]] = val
        return blobs

    @classmethod
    def get_blobs_channel(cls, blobs: np.ndarray) -> np.ndarray:
        return cls.get_blob_col(blobs, BlobCols.CHANNEL)

    @classmethod
    def set_blob_channel(cls, blobs: np.ndarray, channel) -> np.ndarray:
        return cls.set_blob_col(blobs, BlobCols.CHANNEL, channel)

    @classmethod
    def get_blob_confirmed(cls, blobs: np.ndarray) -> np.ndarray:
        return cls.get_blob_col(blobs, BlobCols.CONFIRMED)

    @classmethod
    def set_blob_confirmed(cls, blobs: np.ndarray, val) -> np.ndarray:
        return cls.set_blob_col(blobs, BlobCols.CONFIRMED, val)

    @classmethod
    def get_blob_truth(cls, blobs: np.ndarray) -> np.ndarray:
        return cls.get_blob_col(blobs, BlobCols.TRUTH)

    @classmethod
    def set_blob_truth(cls, blobs: np.ndarray, val) -> np.ndarray:
        return cls.set_blob_col(blobs, BlobCols.TRUTH, val)

    @staticmethod
    def get_blob_abs_coords(blobs: np.ndarray) -> np.ndarray:
        return blobs[..., ABS_COORD_SLICE]

    @staticmethod
    def set_blob_abs_coords(blobs: np.ndarray, coords) -> np.ndarray:
        blobs[..., ABS_COORD_SLICE] = coords
        return blobs

    @staticmethod
    def shift_blob_rel_coords(blobs: np.ndarray, offset) -> np.ndarray:
        blobs[..., REL_COORD_SLICE] += offset
        return blobs

    @staticmethod
    def shift_blob_abs_coords(blobs: np.ndarray, offset) -> np.ndarray:
        blobs[..., ABS_COORD_SLICE] += offset
        return blobs

    @staticmethod
    def multiply_blob_rel_coords(blobs: np.ndarray, factor) -> np.ndarray:
        blobs[..., REL_COORD_SLICE] = (
            blobs[..., REL_COORD_SLICE] * factor)
        return blobs

    @staticmethod
    def multiply_blob_abs_coords(blobs: np.ndarray, factor) -> np.ndarray:
        blobs[..., ABS_COORD_SLICE] = (
            blobs[..., ABS_COORD_SLICE] * factor)
        return blobs

    @staticmethod
    def blobs_in_channel(
            blobs: np.ndarray, channel, return_mask=False):
        """Filter blobs to the given channel(s); None = all."""
        if channel is None:
            mask = np.ones(len(blobs), dtype=bool)
        else:
            mask = np.isin(
                Blobs.get_blobs_channel(blobs), np.atleast_1d(channel))
        return (blobs[mask], mask) if return_mask else blobs[mask]

    def format_blobs(self, channel=None) -> np.ndarray:
        """Extend ``z,y,x,radius[,...]`` rows to the full column set.

        Added columns default to -1; absolute coordinates are initialized
        from relative ones; optional ``channel`` is stamped.
        """
        shape = self.blobs.shape
        # standard column set is 10 (through abs_x); REGION is optional
        n_cols = COL_IND[BlobCols.ABS_X] + 1
        if shape[1] < n_cols:
            extras = np.full((shape[0], n_cols - shape[1]), -1.0)
            self.blobs = np.concatenate([self.blobs, extras], axis=1)
        self.cols = [c.value for c in BlobCols][:self.blobs.shape[1]]
        self.blobs[:, ABS_COORD_SLICE] = self.blobs[:, REL_COORD_SLICE]
        if channel is not None:
            self.set_blob_channel(self.blobs, channel)
        return self.blobs

    def show_blobs_per_channel(self) -> dict:
        """The number of blobs in each channel, by channel ({} without
        blobs)."""
        if self.blobs is None:
            return {}
        chls, counts = np.unique(
            self.get_blobs_channel(self.blobs), return_counts=True)
        return dict(zip(chls.tolist(), counts.tolist()))

    # -- archive output ------------------------------------------------------

    def load_blobs(self, path: Optional[str] = None) -> "Blobs":
        """Load a blobs ``.npz`` archive, upgrading old versions."""
        if path is not None:
            self.path = path
        with np.load(self.path, allow_pickle=True) as archive:
            info = {k: archive[k] for k in archive.files}

        def _scalar(v):
            return v.item() if isinstance(v, np.ndarray) and v.ndim == 0 \
                else v

        if self.Keys.VER.value in info:
            self.ver = int(_scalar(info[self.Keys.VER.value]))
        if self.Keys.COLS.value in info:
            self.cols = [str(c) for c in np.atleast_1d(
                info[self.Keys.COLS.value])]
        if self.Keys.BLOBS.value in info:
            self.blobs = info[self.Keys.BLOBS.value]
        if self.Keys.COLOCS.value in info:
            self.colocalizations = _scalar(info[self.Keys.COLOCS.value])
        if self.Keys.RESOLUTIONS.value in info:
            self.resolutions = _scalar(info[self.Keys.RESOLUTIONS.value])
        if self.Keys.BASENAME.value in info:
            self.basename = str(_scalar(info[self.Keys.BASENAME.value]))
        if self.Keys.ROI_OFFSET.value in info:
            self.roi_offset = _scalar(info[self.Keys.ROI_OFFSET.value])
        if self.Keys.ROI_SIZE.value in info:
            self.roi_size = _scalar(info[self.Keys.ROI_SIZE.value])
        if self.ver <= 4 and self.cols is not None:
            # <=v4 archives stored 3 extra abs-coord column names that were
            # not present in the data; drop them (reference upgrade path)
            self.cols = self.cols[:len(self.cols) - 3]
        self.ver = self.BLOBS_NP_VER
        return self

    def save_archive(self, to_add: Optional[dict] = None,
                     update: bool = False) -> dict:
        """Save the archive at ``path``, backing up any existing file
        first; returns what was saved. ``to_add`` saves those entries
        instead of the blobs' own; ``update`` merges them into the
        existing archive's."""
        if to_add is None:
            arc = {
                self.Keys.VER.value: self.ver,
                self.Keys.BLOBS.value: self.blobs,
                self.Keys.RESOLUTIONS.value: self.resolutions,
                self.Keys.BASENAME.value: self.basename,
                self.Keys.ROI_OFFSET.value: self.roi_offset,
                self.Keys.ROI_SIZE.value: self.roi_size,
                self.Keys.COLOCS.value: self.colocalizations,
                self.Keys.COLS.value: self.cols,
            }
        else:
            arc = dict(to_add)
        if update and self.path and os.path.exists(self.path):
            with np.load(self.path, allow_pickle=True) as old:
                merged = {k: old[k] for k in old.files}
            merged.update(arc)
            arc = merged
        arc = {k: v for k, v in arc.items() if v is not None}
        libmag.backup_file(self.path)
        np.savez_compressed(self.path, **arc)
        return arc

    def __len__(self) -> int:
        return 0 if self.blobs is None else len(self.blobs)


def get_blobs_in_roi(
        blobs: np.ndarray, offset: Sequence[int], size: Sequence[int],
        margin: Sequence[int] = (0, 0, 0), reverse: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Blobs within an ROI and their mask; ``offset``/``size``/``margin``
    are x,y,z when ``reverse``, else z,y,x."""
    if reverse:
        offset, size, margin = offset[::-1], size[::-1], margin[::-1]
    coords = blobs[:, :3]
    lo = np.asarray(offset) - np.asarray(margin)
    hi = np.asarray(offset) + np.asarray(size) + np.asarray(margin)
    mask = np.all((coords >= lo) & (coords < hi), axis=1)
    return blobs[mask], mask


def get_blobs_interior(
        blobs: np.ndarray, shape: Sequence[int],
        pad_start: Sequence[int], pad_end: Sequence[int]) -> np.ndarray:
    """Blobs inside the region interior after padding in z,y,x."""
    coords = blobs[:, :3]
    lo = np.asarray(pad_start)
    hi = np.asarray(shape) - np.asarray(pad_end)
    return blobs[np.all((coords >= lo) & (coords < hi), axis=1)]


def remove_duplicate_blobs(blobs: np.ndarray, region) -> np.ndarray:
    """Keep only the first of the blobs equal within the column slice
    ``region``, in their order."""
    sub = blobs[:, region]
    _, idx = np.unique(sub, axis=0, return_index=True)
    return blobs[np.sort(idx)]


def sort_blobs(blobs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Blobs sorted by z, then y, then x, and the order."""
    order = np.lexsort((blobs[:, 2], blobs[:, 1], blobs[:, 0]))
    return blobs[order], order
