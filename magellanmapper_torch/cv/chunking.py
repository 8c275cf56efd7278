"""Block geometry for whole-image processing.

Copy of ``stack_splitter`` and ``merge_blobs`` from
``magellanmapper_tpu/cv/chunking.py``: the overlap-halo block
decomposition of a stack and the merge of per-block blob arrays.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def num_units(
        size: Sequence[int], max_pixels: Sequence[int]) -> np.ndarray:
    """Number of blocks per axis covering ``size`` at ``max_pixels`` each."""
    num = np.floor_divide(size, max_pixels)
    num[np.remainder(size, max_pixels) > 0] += 1
    return num.astype(int)


def stack_splitter(
        shape: Sequence[int], max_pixels: Sequence[int],
        overlap: Optional[Sequence[int]] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Split a stack into overlapping blocks.

    Returns ``(sub_roi_slices, sub_rois_offsets)``: an object array of
    z,y,x slice tuples (each block extends ``overlap`` into the next along
    each axis, clipped at the stack edge) and an int array of block start
    offsets.
    """
    shape = np.asarray(shape[:3])
    max_pixels = np.asarray(max_pixels[:3])
    units = num_units(shape, max_pixels)
    slices = np.zeros(tuple(units), dtype=object)
    offsets = np.zeros(tuple(units) + (3,), dtype=int)
    for coord in np.ndindex(*units):
        bounds = []
        for ax in range(3):
            start = coord[ax] * max_pixels[ax]
            end = start + max_pixels[ax]
            if overlap is not None:
                end += overlap[ax]
            bounds.append((int(start), int(min(end, shape[ax]))))
        slices[coord] = tuple(slice(b[0], b[1]) for b in bounds)
        offsets[coord] = [b[0] for b in bounds]
    return slices, offsets


def merge_blobs(blob_rois: np.ndarray) -> Optional[np.ndarray]:
    """Stack per-block blob arrays, tagging rows with block z,y,x coords:
    the final three columns carry the block coordinate so overlap pruning
    can pair adjacent sections."""
    blobs_all = []
    for coord in np.ndindex(*blob_rois.shape[:3]):
        blobs = blob_rois[coord]
        if blobs is None or len(blobs) == 0:
            continue
        extras = np.tile(np.asarray(coord, dtype=float), (len(blobs), 1))
        blobs_all.append(np.concatenate([blobs, extras], axis=1))
    if not blobs_all:
        return None
    return np.vstack(blobs_all)
