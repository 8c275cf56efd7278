"""Plain reference of the threshold sweep over one ROI.

From the ROI, the profile's values and the thresholds alone: the
normalised LoG stack of the whole ROI, its local maxima over (sigma, z,
y, x) with a zero border, and for each threshold (rounded to float32)
the peaks above it as the sweep's candidate harvest returns them: the
stack read as rows of 128 values in flat order, at most 8 peaks a row
(the brightest, ties to the lower position), ordered by value, then by
the round they were harvested in, then by row, and cut at the
capacity; then the sphere-overlap prune, and the rows as blob rows.
Then each threshold's score against the truth set.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from portbench.reference import blobs as rb
from portbench.reference import filters as rf
from portbench.reference.detect import sigmas as profile_sigmas

#: values a harvest row holds, and candidates taken from a row
ROW = 128
ROUNDS = 8


def capacity(settings, voxels: int) -> int:
    """Rows a threshold may keep: the profile's per-block capacity, at
    least ``voxels // 1024`` within [4096, 2^17]."""
    cap = int(settings["max_blobs_per_block"] or 0)
    return max(cap, min(1 << 17, max(4096, voxels // 1024)))


def harvest_order(vals: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Positions of the peaks (flat ``idx`` ascending, float32 ``vals``)
    that the harvest keeps, in its order."""
    row = idx // ROW
    # rank in the row: value descending, then position
    by_row = np.lexsort((idx, -vals, row))
    r_sorted = row[by_row]
    start = np.r_[0, np.flatnonzero(np.diff(r_sorted)) + 1]
    counts = np.diff(np.r_[start, len(r_sorted)])
    rank = np.empty(len(idx), np.int64)
    rank[by_row] = np.arange(len(idx)) - np.repeat(start, counts)
    kept = np.flatnonzero(rank < ROUNDS)
    order = np.lexsort((row[kept], rank[kept], -vals[kept]))
    return kept[order]


def sweep(roi: np.ndarray, settings, res, thresholds, device
          ) -> List[Optional[np.ndarray]]:
    """Each threshold's blob rows (None when there are none)."""
    rf.full_float32()
    vol = torch.from_numpy(np.ascontiguousarray(roi, np.float32)).to(device)
    sig = profile_sigmas(settings, res)
    cube = rf.log_stack(vol, sig)
    del vol
    local = cube == rf.max_filter_zero(cube)
    cap = capacity(settings, roi.size)
    s, z, y, x = cube.shape
    sig_t = torch.tensor(sig, dtype=torch.float32, device=device)
    out = []
    for th in np.asarray(thresholds, np.float32):
        peak = local & (cube > float(th))
        idx = torch.nonzero(peak.reshape(-1)).squeeze(1)
        vals = cube.reshape(-1)[idx]
        del peak
        idx_h, vals_h = idx.cpu().numpy(), vals.cpu().numpy()
        take = harvest_order(vals_h, idx_h)[:cap]
        sel = torch.from_numpy(idx_h[take]).to(device)
        coords = torch.stack([(sel // (y * x)) % z, (sel // x) % y,
                              sel % x], dim=1).to(torch.float32)
        sigma = sig_t[sel // (z * y * x)]
        keep = rf.prune_overlap(coords, sigma, float(settings["overlap"]))
        raw = torch.cat([coords, sigma[:, None]], 1)[keep].cpu().numpy()
        if not raw.shape[0]:
            out.append(None)
            continue
        raw[:, 3] *= math.sqrt(3)
        rows = np.concatenate([raw, np.full((len(raw), 6), -1.0)], axis=1)
        rows[:, rb.ABS] = rows[:, 0:3]
        rows[:, rb.CHANNEL_COL] = 0
        out.append(rows)
    return out
