"""Bytes and operations of the ball means of intensity colocalisation
(``colocalizer._ball_sums``), counted from the work, whatever implements
it: each distinct voxel of every blob's ball in the channel read once (a
voxel past the channel's edge is the voxel numpy's ``symmetric`` padding
reflects it to), each blob's mean written once as float32, and one add
a ball voxel of each blob. ``metrics/ball_roofline.py`` reads them; a
dense stencil's passes over whole slabs are not work the result needs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from portbench.counts import F32, Count
from portbench.reference import coloc as ref_coloc


def ball_voxels(coords: np.ndarray, shape: Sequence[int],
                radius: int) -> int:
    """Distinct voxels of a ``shape`` channel inside the balls of
    ``radius`` around ``coords`` (integer z, y, x), edges reflected."""
    coords = np.asarray(coords, np.int64)
    if not len(coords):
        return 0
    flat = [np.ravel_multi_index(
        [ref_coloc.reflect(coords[:, a] + off[a], shape[a])
         for a in range(3)], tuple(shape))
        for off in ref_coloc.ball_offsets(radius)]
    return len(np.unique(np.concatenate(flat)))


def ball_means(coords: np.ndarray, shape: Sequence[int], itemsize: int,
               radius: int) -> Count:
    """One channel's ball means of ``coords``: the distinct ball voxels
    read, a float32 mean a blob written; an add a ball voxel a blob."""
    n = len(coords)
    k = len(ref_coloc.ball_offsets(radius))
    return (float(ball_voxels(coords, shape, radius) * itemsize + n * F32),
            float(n * k))


def ball_calls(calls: dict):
    """The counts of the traced ``ball_sums`` calls (one a channel)."""
    return [ball_means(c["coords"], c["shape"], c["itemsize"], c["radius"])
            for c in calls.get("ball_sums", [])]
