"""Host-side blob bookkeeping of the reference: frozen copies.

The block geometry (``setup_blocks``, ``stack_splitter``, the clamped
uniform window), a block's rows as blob rows (radius, absolute
coordinates, the interior kept less the border zone), the cross-block
duplicate prune over overlap bands, and whole-set verification against a
truth set, copied from the port's ``cv/stack_detect.py``,
``cv/chunking.py``, ``cv/detector.py``, ``cv/blobs.py`` and
``cv/verifier.py`` (themselves copies of MagellanMapper's), so that they
do not move when the program does. Blob rows are the 10 columns ``z, y,
x, radius, confirmed, truth, channel, abs_z, abs_y, abs_x``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
from scipy import optimize
from scipy.spatial import distance

#: overlap factor for block halos
OVERLAP_FACTOR = 5
#: per-axis cap on the block edge
BLOCK_CAP = 256
CHANNEL_COL = 6
ABS = slice(7, 10)


class Blocks(NamedTuple):
    slices: np.ndarray
    offsets: np.ndarray
    exclude_border: Optional[np.ndarray]
    tol: np.ndarray
    overlap: np.ndarray
    overlap_padding: np.ndarray
    max_pixels: np.ndarray
    denoise_shape: Optional[np.ndarray]


def scaling(res: Sequence[float]) -> np.ndarray:
    return 1.0 / np.asarray(res, dtype=float)


def stack_splitter(shape, max_pixels, overlap):
    """Overlapping blocks: slices and start offsets on the block grid."""
    shape = np.asarray(shape[:3])
    max_pixels = np.asarray(max_pixels[:3])
    units = np.floor_divide(shape, max_pixels)
    units[np.remainder(shape, max_pixels) > 0] += 1
    units = units.astype(int)
    slices = np.zeros(tuple(units), dtype=object)
    offsets = np.zeros(tuple(units) + (3,), dtype=int)
    for coord in np.ndindex(*units):
        bounds = []
        for ax in range(3):
            start = coord[ax] * max_pixels[ax]
            end = min(start + max_pixels[ax] + overlap[ax], shape[ax])
            bounds.append((int(start), int(end)))
        slices[coord] = tuple(slice(a, b) for a, b in bounds)
        offsets[coord] = [b[0] for b in bounds]
    return slices, offsets


def setup_blocks(settings, shape, res) -> Blocks:
    """Block geometry from the profile's values."""
    sf = scaling(res)
    denoise = None
    if settings["denoise_size"]:
        denoise = np.ceil(sf * settings["denoise_size"]).astype(int)
    overlap_base = np.ceil(sf * OVERLAP_FACTOR).astype(int)
    tol = np.multiply(overlap_base, settings["prune_tol_factor"]).astype(int)
    overlap_padding = np.copy(tol)
    overlap = np.copy(overlap_base)
    exclude = settings["exclude_border"]
    if exclude is not None:
        exclude = np.asarray(exclude)
        thresh = 2 * exclude
        less = overlap < thresh
        overlap[less] = thresh[less]
        excluded = exclude > 0
        overlap[excluded] += 1
        overlap_padding[excluded] = 0
    max_pixels = np.minimum(
        np.ceil(sf * settings["segment_size"]).astype(int), BLOCK_CAP)
    for ax in (1, 2):
        window = max_pixels[ax] + overlap[ax]
        aligned = (window // 128) * 128
        if aligned >= 128 and aligned > overlap[ax]:
            max_pixels[ax] = aligned - overlap[ax]
    slices, offsets = stack_splitter(shape, max_pixels, overlap)
    return Blocks(slices, offsets, exclude, tol, overlap, overlap_padding,
                  max_pixels, denoise)


def window_start(shape, start, block_shape) -> np.ndarray:
    """A uniform window's start, clamped so it fits in the volume."""
    return np.maximum(0, np.minimum(start, np.asarray(shape) - block_shape))


def block_rows(raw: np.ndarray, coord, wstart, blocks: Blocks,
               channel: int) -> np.ndarray:
    """A block's float32 ``z, y, x, sigma`` rows as blob rows in the
    volume, only those inside the block's sub-ROI kept (less the border
    zone, except at the volume's outer faces)."""
    raw[:, 3] *= math.sqrt(3)
    extras = np.full((raw.shape[0], 6), -1.0)
    segs = np.concatenate([raw, extras], axis=1)
    segs[:, ABS] = segs[:, 0:3]
    segs[:, CHANNEL_COL] = channel
    segs[:, 0:3] += wstart
    segs[:, ABS] += wstart
    sl = blocks.slices[coord]
    lo = np.asarray([s.start for s in sl])
    hi = np.asarray([s.stop for s in sl])
    if blocks.exclude_border is not None:
        last = np.asarray(blocks.slices.shape) - 1
        exc = np.stack([blocks.exclude_border] * 2)
        exc[0, np.equal(coord, 0)] = 0
        exc[1, np.equal(coord, last)] = 0
        lo = lo + exc[0]
        hi = hi - exc[1]
    keep = np.all((segs[:, :3] >= lo) & (segs[:, :3] < hi), axis=1)
    return segs[keep]


def merge(per_block: np.ndarray) -> Optional[np.ndarray]:
    """Stack the blocks' rows, each tagged with its block's grid coords."""
    out = []
    for coord in np.ndindex(*per_block.shape[:3]):
        rows = per_block[coord]
        if rows is None or len(rows) == 0:
            continue
        out.append(np.concatenate(
            [rows, np.tile(np.asarray(coord, float), (len(rows), 1))], 1))
    return np.vstack(out) if out else None


def remove_close(rows, master, tol):
    """Drop ``rows`` within ``tol`` of a ``master`` row; each matched
    master row moves to the rounded mean of the pair's absolute
    coordinates."""
    if len(rows) < 1 or len(master) < 1:
        return rows, master
    diffs = np.abs(master[:, None, :3] - rows[None, :, :3])
    close_master, close = np.nonzero((diffs <= np.asarray(tol)).all(2))
    pruned = np.delete(rows, close, axis=0)
    if len(close) > 0:
        master[close_master, ABS] = np.around(
            (master[close_master, ABS] + rows[close, ABS]) / 2)
    return pruned, master


def prune_across_blocks(per_block, blocks: Blocks, channels
                        ) -> Optional[np.ndarray]:
    """Cross-block duplicate pruning over the overlap bands."""
    merged = merge(per_block)
    if merged is None:
        return None
    grid = blocks.slices.shape
    out = []
    for chl in channels:
        rows = merged[merged[:, CHANNEL_COL] == chl]
        for axis in range(3):
            n = grid[axis]
            if n <= 1:
                continue
            kept, pruned_parts = [], []
            shift = blocks.overlap[axis] + blocks.overlap_padding[axis]
            for j in range(n):
                coord = [0, 0, 0]
                coord[axis] = j
                coord = tuple(coord)
                off = blocks.offsets[coord][axis]
                sl = blocks.slices[coord][axis]
                size = sl.stop - sl.start
                masks = []
                if j < n - 1:
                    lo = off + size - shift
                    hi = off + size + blocks.overlap_padding[axis]
                    band = rows[(rows[:, axis] >= lo) & (rows[:, axis] < hi)]
                    col = band.shape[1] - 3 + axis
                    master = band[band[:, col] == j]
                    check = band[band[:, col] == j + 1]
                    rest = band[(band[:, col] != j) & (band[:, col] != j + 1)]
                    pruned, master = remove_close(check, master, blocks.tol)
                    pruned_parts.extend(
                        [p for p in (master, pruned, rest) if len(p)])
                    masks.append(rows[:, axis] < lo)
                else:
                    masks.append(rows[:, axis] < off + size)
                masks.append(rows[:, axis] >= off + (shift if j > 0 else 0))
                kept.append(rows[np.all(masks, axis=0)])
            parts = [p for p in kept + pruned_parts if len(p)]
            rows = np.vstack(parts) if parts else rows[:0]
        out.append(rows)
    if not out:
        return None
    rows = np.vstack(out)
    return None if rows.shape[0] == 0 else rows[:, :-3]


def verify(rows: np.ndarray, truth: np.ndarray, tol: Sequence[float]):
    """``(true positives, false positives, false negatives)`` of an
    optimal one-to-one assignment of ``rows`` to ``truth`` on
    tolerance-scaled distance, matches closer than the largest
    tolerance."""
    tol = np.asarray(tol, dtype=float)
    thresh = float(np.amax(tol))
    scale = thresh / tol
    if len(rows) == 0 or len(truth) == 0:
        found = 0
    else:
        a = rows[:, :len(scale)] * scale
        b = truth[:, :len(scale)] * scale
        dists = distance.cdist(a, b)
        ri, ci = optimize.linear_sum_assignment(dists)
        found = int(np.sum(dists[ri, ci] < thresh))
    return found, len(rows) - found, len(truth) - found


def score(rows: Optional[np.ndarray], truth: np.ndarray, tol) -> dict:
    """The grid search's score columns for one threshold's rows:
    ``POS, TP, FP, FN, FDR, SENS, PPV``, as the sweep defines them."""
    n_det = 0 if rows is None else len(rows)
    pos = len(truth)
    if n_det:
        tp, fp, fn = verify(rows, truth, tol)
        sens = tp / (tp + fn) if tp + fn else 0.0
        ppv = tp / (tp + fp) if tp + fp else 0.0
        tp = int(round(sens * pos))
        fp = n_det - tp
    else:
        sens = ppv = 0.0
        tp = fp = 0
    fn = pos - tp
    fdr = fp / n_det if n_det else 0.0
    return {"POS": pos, "TP": tp, "FP": fp, "FN": fn, "FDR": fdr,
            "SENS": sens, "PPV": ppv}
