"""Plain reference of two-channel colocalisation: what ``--proc
detect_coloc --channel 0 1`` and then ``--proc coloc_match`` have to
return for a ``(Z, Y, X, C)`` volume.

- Detection: each channel on its own with ``reference/detect.py``, its
  rows stamped with the channel's number.
- Intensity colocalisation, as MagellanMapper describes it: each blob's
  mean over a ball of the radius the configuration states around its
  integer coordinates, in every channel, the channel padded numpy
  ``symmetric``; a blob expresses a channel where its mean there is at
  least the least mean of that channel's own blobs (``"min"``). Blobs
  outside the volume express nothing. On integer channels the sums are
  exact, so the means are compared as integer sums of one ball size.
- Match colocalisation: MagellanMapper's ``StackColocalizer`` semantics
  (``magmap/cv/colocalizer.py``) written out plainly: blocks of the
  stated edge with ``ceil(tol)`` halos; in each, for each pair of
  channels, an optimal assignment (scipy) of the second channel's blobs
  of the block's inner region to the first channel's in the block on
  tolerance-scaled distance, then the first channel's inner blobs left
  unmatched rescued by the second channel's border blobs
  (``verifier.match_blobs_roi``), matches closer than the largest
  tolerance; then each first-channel blob keeps its shortest match.

Imports nothing of the program; device work runs in float32 with TF32
off (``reference/detect.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import optimize
from scipy.spatial import distance

from portbench.reference import blobs as rb
from portbench.reference import detect as rd

CHANNEL = rb.CHANNEL_COL


def detect(volume: np.ndarray, settings, res, device,
           channels: Sequence[int]) -> Optional[np.ndarray]:
    """The blob rows of every channel in ``channels``, channel by
    channel (None when there are none)."""
    parts = [rd.detect(volume[..., c], settings, res, device, channel=c)
             for c in channels]
    parts = [p for p in parts if p is not None]
    return np.vstack(parts) if parts else None


def ball_offsets(radius: int) -> np.ndarray:
    """``(K, 3)`` offsets of the voxels within ``radius`` (Euclidean) of
    a centre."""
    g = np.arange(-radius, radius + 1)
    off = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    return off[(off ** 2).sum(1) <= radius * radius]


def reflect(i: np.ndarray, n: int) -> np.ndarray:
    """Indices past either end of an axis of ``n``, reflected as numpy's
    ``symmetric`` padding reflects them (``-1 -> 0``, ``n -> n - 1``)."""
    i = np.where(i < 0, -i - 1, i)
    return np.where(i >= n, 2 * n - 1 - i, i)


def ball_sums(chl: np.ndarray, coords: np.ndarray, radius: int
              ) -> np.ndarray:
    """Int64 sums of an integer channel over the ball around each of
    ``coords`` (integer z, y, x inside ``chl``)."""
    out = np.zeros(len(coords), np.int64)
    for off in ball_offsets(radius):
        idx = tuple(reflect(coords[:, a] + off[a], chl.shape[a])
                    for a in range(3))
        out += chl[idx].astype(np.int64)
    return out


def flags(volume: np.ndarray, rows: Optional[np.ndarray], radius: int
          ) -> Optional[np.ndarray]:
    """``(n, C)`` uint8: whether each row's blob expresses each channel
    of the ``(Z, Y, X, C)`` volume."""
    if rows is None:
        return None
    shape = np.asarray(volume.shape[:3])
    inside = np.all((rows[:, :3] >= 0) & (rows[:, :3] < shape), axis=1)
    coords = rows[inside, :3].astype(np.int64)
    own = rows[inside, CHANNEL].astype(np.int64)
    out = np.zeros((len(rows), volume.shape[3]), np.uint8)
    for c in range(volume.shape[3]):
        sums = ball_sums(volume[..., c], coords, radius)
        if not np.any(own == c):
            continue
        out[inside, c] = sums >= sums[own == c].min()
    return out


def _in_box(rows: np.ndarray, lo, hi) -> np.ndarray:
    return np.all((rows[:, :3] >= lo) & (rows[:, :3] < hi), axis=1)


def _assign(rows: np.ndarray, base: np.ndarray, thresh: float,
            scaling: np.ndarray):
    """Optimal assignment of ``rows`` to ``base`` on scaled distance:
    row and base indices and distances of the pairs closer than
    ``thresh``."""
    if len(rows) == 0 or len(base) == 0:
        empty = np.zeros(0, int)
        return empty, empty, np.zeros(0)
    d = distance.cdist(rows[:, :3] * scaling, base[:, :3] * scaling)
    ri, ci = optimize.linear_sum_assignment(d)
    dist = d[ri, ci]
    keep = dist < thresh
    return ri[keep], ci[keep], dist[keep]


def match_block(first: np.ndarray, second: np.ndarray, lo, hi,
                tol: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray,
                                               float]]:
    """One block ``[lo, hi)`` (z, y, x): ``(first row, second row,
    distance)`` of each match of ``second``'s rows to ``first``'s."""
    thresh = float(np.amax(tol))
    scaling = thresh / tol
    size = np.asarray(hi) - np.asarray(lo)
    pad = np.clip(np.floor(tol), 0,
                  np.clip(np.ceil(size / 2 - 1), 0, None))
    in_lo, in_hi = np.asarray(lo) + pad, np.asarray(hi) - pad
    sec = second[_in_box(second, lo, hi)].copy()
    sec_inner = _in_box(sec, in_lo, in_hi)
    base = first[_in_box(first, lo, hi)].copy()
    base_inner = _in_box(base, in_lo, in_hi)
    inner, outer = sec[sec_inner], sec[~sec_inner]
    ri, ci, d = _assign(inner, base, thresh, scaling)
    # the first channel's inner rows left unmatched (the truth column, 5,
    # as the semantics marks it: 0 inner, 1 matched)
    base[base_inner, 5] = 0
    base[ci, 5] = 1
    missed = base[base[:, 5] == 0]
    ro, co, do = _assign(outer, missed, thresh, scaling)
    return ([(base[c], inner[r], x) for r, c, x in zip(ri, ci, d)]
            + [(missed[c], outer[r], x) for r, c, x in zip(ro, co, do)])


def match(rows: Optional[np.ndarray], shape: Sequence[int], tol,
          block: int) -> Dict[Tuple[int, int], np.ndarray]:
    """Each channel pair's matches of the whole image in blocks, as
    ``(n, 2, 3)`` float64 z, y, x of the first and the second channel's
    blob, each first-channel blob's shortest match kept."""
    if rows is None:
        return {}
    tol = np.asarray(tol, float)
    pad = np.ceil(tol).astype(int)
    shape = np.asarray(shape[:3], int)
    grid = -(-shape // block)
    chans = np.unique(rows[:, CHANNEL]).astype(int)
    found: Dict[Tuple[int, int], list] = {}
    for coord in np.ndindex(*grid):
        lo = np.asarray(coord) * block
        hi = np.minimum(lo + block + pad, shape)
        sub = rows[_in_box(rows, lo - pad, hi + pad)]
        if len(sub) < 2:
            continue
        for i, c1 in enumerate(chans):
            for c2 in chans[i + 1:]:
                got = match_block(sub[sub[:, CHANNEL] == c1],
                                  sub[sub[:, CHANNEL] == c2], lo, hi, tol)
                if got:
                    found.setdefault((int(c1), int(c2)), []).extend(got)
    out = {}
    for pair, got in found.items():
        dist = np.asarray([g[2] for g in got])
        keys = np.round(np.asarray([g[0][:3] for g in got])).astype(int)
        # MagellanMapper sorts by distance (numpy's quicksort, as pandas
        # sorts one column) and keeps each key's first
        order = np.argsort(dist, kind="quicksort")
        _, first = np.unique(keys[order], axis=0, return_index=True)
        kept = order[np.sort(first)]
        out[pair] = np.asarray([[got[k][0][:3], got[k][1][:3]]
                                for k in kept], float)
    return out
