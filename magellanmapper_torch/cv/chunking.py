"""Block geometry for whole-image processing.

Copy of ``magellanmapper_tpu/cv/chunking.py``: the overlap-halo block
decomposition of a stack (``stack_splitter``), the merge of per-block
blob arrays (``merge_blobs``) and of per-block images
(``merge_split_stack``, ``merge_split_stack2``,
``get_split_stack_total_shape``), and the multiprocessing helpers
(``get_mp_pool``, ``set_mp_start_method``, ``is_fork``,
``init_shared_container``, ``SharedArrsContainer``) for host pipelines
that use a process pool.
"""

from __future__ import annotations

import multiprocessing as _mp
from collections import namedtuple
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


def get_split_stack_total_shape(
        sub_rois: np.ndarray, overlap: Optional[Sequence[int]] = None
) -> np.ndarray:
    """Merged shape of a chunked (possibly rescaled) stack."""
    size = sub_rois.shape
    ndim_roi = sub_rois[0, 0, 0].ndim
    final = np.zeros(ndim_roi, dtype=int)
    for z in range(size[0]):
        y_shape = np.zeros(3, dtype=int)
        for y in range(size[1]):
            x_total = 0
            edges = None
            for x in range(size[2]):
                coord = (z, y, x)
                edges = list(sub_rois[coord].shape[:3])
                if overlap is not None:
                    for n in range(3):
                        if coord[n] != size[n] - 1:
                            edges[n] -= overlap[n]
                x_total += edges[2]
            if final[2] <= 0:
                final[2] = x_total
            y_shape[1] += edges[1]
        if final[1] <= 0:
            final[1] = y_shape[1]
        final[0] += edges[0]
    if ndim_roi > 3:
        final[3] = sub_rois[0, 0, 0].shape[3]
    return final


def merge_split_stack2(
        sub_rois: np.ndarray, overlap: Optional[Sequence[int]],
        offset: int, output: np.ndarray) -> None:
    """Write trimmed blocks directly into ``output`` (e.g. a memmap).

    Reference ``chunking.merge_split_stack2`` out-of-core merge: each
    block's overlap tail is dropped except at the last block per axis.
    """
    size = sub_rois.shape
    if offset > 0:
        output = output[0]
    pos = np.zeros(3, dtype=int)
    for z in range(size[0]):
        pos[1] = 0
        for y in range(size[1]):
            pos[2] = 0
            for x in range(size[2]):
                coord = (z, y, x)
                sub_roi = sub_rois[coord]
                edges = list(sub_roi.shape[:3])
                if overlap is not None:
                    for n in range(3):
                        if coord[n] != size[n] - 1:
                            edges[n] -= overlap[n]
                trimmed = sub_roi[:edges[0], :edges[1], :edges[2]]
                output[pos[0]:pos[0] + edges[0],
                       pos[1]:pos[1] + edges[1],
                       pos[2]:pos[2] + edges[2]] = trimmed
                pos[2] += edges[2]
            pos[1] += edges[1]
        pos[0] += edges[0]


def merge_split_stack(sub_rois: np.ndarray, max_pixels, overlap
                      ) -> np.ndarray:
    """Merge sub-ROIs without knowing the output size in advance — the
    reference's original concatenation-based merge
    (``chunking.merge_split_stack :259``; see :func:`merge_split_stack2`
    for the preallocated version)."""
    overlap = np.asarray(overlap, int)
    merged = None
    for z in range(sub_rois.shape[0]):
        merged_y = None
        for y in range(sub_rois.shape[1]):
            merged_x = None
            for x in range(sub_rois.shape[2]):
                sub = sub_rois[z, y, x]
                # trim trailing overlap except at the final block
                for ax, idx in enumerate((z, y, x)):
                    if idx < sub_rois.shape[ax] - 1 and overlap[ax]:
                        sl = [slice(None)] * sub.ndim
                        sl[ax] = slice(0, sub.shape[ax] - overlap[ax])
                        sub = sub[tuple(sl)]
                merged_x = sub if merged_x is None else np.concatenate(
                    (merged_x, sub), axis=2)
            merged_y = merged_x if merged_y is None else np.concatenate(
                (merged_y, merged_x), axis=1)
        merged = merged_y if merged is None else np.concatenate(
            (merged, merged_y), axis=0)
    return merged


def set_mp_start_method(val: str = "spawn") -> str:
    """Set the multiprocessing start method, ignoring repeat calls
    (reference ``chunking.set_mp_start_method``)."""
    try:
        _mp.set_start_method(val)
    except RuntimeError:
        pass
    return _mp.get_start_method()


def is_fork() -> bool:
    """True if the start method is fork
    (reference ``chunking.is_fork``)."""
    return _mp.get_start_method(allow_none=True) == "fork"


def get_mp_pool(processes: Optional[int] = None,
                initializer=None, initargs=()) -> "_mp.pool.Pool":
    """Process pool honoring the configured start method
    (reference ``chunking.get_mp_pool``)."""
    return _mp.get_context().Pool(
        processes=processes, initializer=initializer, initargs=initargs)


def init_shared_container(container) -> None:
    """Pool initializer installing a shared-array container's state in
    the worker (reference ``chunking.init_shared_container``)."""
    global _SHARED_CONTAINER
    _SHARED_CONTAINER = container


class SharedArr(namedtuple("SharedArr", ["arr", "shape", "dtype"])):
    """A raw shared-memory buffer with the shape and dtype of its array."""
    __slots__ = ()


class SharedArrsContainer:
    """Arrays shared with pool workers, by key. A forked worker inherits
    ndarrays as they are; ``to_shared`` copies one into raw shared memory
    for a spawned worker, and ``from_shared`` views it again. The arrays
    are kept on the class, as in the reference."""

    shared_arrs: dict = {}

    @classmethod
    def set_data(cls, **arrays) -> None:
        """Replace the shared arrays with ``arrays``."""
        cls.shared_arrs = dict(arrays)

    @classmethod
    def to_shared(cls, key: str, arr: np.ndarray) -> SharedArr:
        """Copy ``arr`` into raw shared memory under ``key``."""
        raw = _mp.RawArray("b", arr.nbytes)
        view = np.frombuffer(raw, dtype=arr.dtype).reshape(arr.shape)
        view[...] = arr
        shared = SharedArr(raw, arr.shape, arr.dtype)
        cls.shared_arrs[key] = shared
        return shared

    @classmethod
    def from_shared(cls, key: str) -> np.ndarray:
        """The array under ``key``: a view of its shared memory, or the
        array itself when it was set as an ndarray."""
        shared = cls.shared_arrs[key]
        if isinstance(shared, SharedArr):
            return np.frombuffer(
                shared.arr, dtype=shared.dtype).reshape(shared.shape)
        return shared
