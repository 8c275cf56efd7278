"""Blob colocalization across channels.

Port of ``magellanmapper_tpu/cv/colocalizer.py``: intensity-based
colocalization (:func:`colocalize_blobs`: each blob's ball-neighbourhood
mean in every channel against that channel's threshold) and match-based
colocalization (:func:`colocalize_blobs_match`, the whole stack in blocks
by :class:`StackColocalizer`: an optimal assignment of one channel's blobs
to another's within tolerance), the :class:`BlobMatch` table, and its rows
in a blob database.

The neighbourhood means run on the device, a z slab at a time: the slab
with its halo, padded as numpy's ``symmetric`` mode pads the whole
channel, and the shifted views of the radius-2 ball added one by one in
``np.argwhere`` order in float32, the reference's chain of adds in its
order, so the card, the CPU and the reference agree bit for bit. A
convolution would sum in another order and can flip the ``>=`` threshold.
Matching is host scipy, as in the reference.
"""

from __future__ import annotations

from enum import Enum
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import pandas as pd
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.cv import blobs as blobs_mod
from magellanmapper_torch.cv import chunking, verifier
from magellanmapper_torch.ops import filters

#: radius of the ball whose mean stands for a blob's intensity
BALL_RADIUS = 2
#: planes of a slab of the neighbourhood means
SLAB_PLANES = 32


class BlobMatch:
    """Blob-match table: one row a match of a blob of one channel
    (``Blob1``) to one of another (``Blob2``) and their distance."""

    class Cols(Enum):
        MATCH_ID = "MatchID"
        ROI_ID = "RoiID"
        BLOB1_ID = "Blob1ID"
        BLOB1 = "Blob1"
        BLOB2_ID = "Blob2ID"
        BLOB2 = "Blob2"
        DIST = "Distance"

    def __init__(self, matches=None, match_id=None, roi_id=None,
                 blob1_id=None, blob2_id=None, df=None):
        self.df: Optional[pd.DataFrame] = None
        self.coords: Optional[np.ndarray] = None
        self.cmap: Optional[np.ndarray] = None
        if df is not None:
            self.df = df
            return
        if matches is None:
            return
        rows = []
        for i, match in enumerate(matches):
            blob1, blob2, dist = match
            rows.append({
                self.Cols.MATCH_ID.value:
                    match_id[i] if match_id is not None else None,
                self.Cols.ROI_ID.value:
                    roi_id[i] if roi_id is not None else None,
                self.Cols.BLOB1_ID.value:
                    blob1_id[i] if blob1_id is not None else None,
                self.Cols.BLOB1.value: np.asarray(blob1),
                self.Cols.BLOB2_ID.value:
                    blob2_id[i] if blob2_id is not None else None,
                self.Cols.BLOB2.value: np.asarray(blob2),
                self.Cols.DIST.value: dist,
            })
        self.df = pd.DataFrame(rows)

    def __len__(self):
        return 0 if self.df is None else len(self.df)

    def get_blobs(self, n: int) -> Optional[np.ndarray]:
        """The blobs of side ``n`` (1 or 2) stacked, or None."""
        col = self.Cols.BLOB1 if n == 1 else self.Cols.BLOB2
        if self.df is None or len(self.df) == 0:
            return None
        return np.vstack(self.df[col.value])

    def get_blobs_all(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Both sides' blobs as ``(blobs1, blobs2)``, or None."""
        out = []
        for n in (1, 2):
            blobs = self.get_blobs(n)
            if blobs is None:
                return None
            out.append(blobs)
        return tuple(out)

    def update_blobs(self, fn, *args):
        """Apply ``fn(blobs, *args)`` to both blob columns."""
        if self.df is None:
            return
        for n, col in ((1, self.Cols.BLOB1), (2, self.Cols.BLOB2)):
            blobs = self.get_blobs(n)
            if blobs is not None:
                self.df[col.value] = list(fn(blobs, *args))


def _ball_sums(chl: np.ndarray, coords: np.ndarray, dev: torch.device,
               radius: int = BALL_RADIUS) -> np.ndarray:
    """Float32 sums over the ball of ``radius`` around each of ``coords``
    (integer z,y,x inside ``chl``), the channel padded symmetrically,
    computed on ``dev`` a slab of :data:`SLAB_PLANES` planes at a time
    (slabs without a blob are skipped)."""
    offsets = np.argwhere(filters.ball_footprint(radius))
    nz = chl.shape[0]
    out = np.zeros(len(coords), np.float32)
    for z0 in range(0, nz, SLAB_PLANES):
        z1 = min(z0 + SLAB_PLANES, nz)
        sel = np.flatnonzero((coords[:, 0] >= z0) & (coords[:, 0] < z1))
        if not len(sel):
            continue
        lo, hi = max(z0 - radius, 0), min(z1 + radius, nz)
        slab = torch.from_numpy(np.array(chl[lo:hi])).to(dev)
        padded = filters.pad_symmetric(slab, [
            (radius - (z0 - lo), radius - (hi - z1)), (radius, radius),
            (radius, radius)]).to(torch.float32)
        shape = (z1 - z0,) + tuple(chl.shape[1:])
        acc = None
        for off in offsets:
            view = padded[tuple(slice(o, o + s) for o, s in zip(off, shape))]
            acc = view.clone() if acc is None else acc.add_(view)
        at = torch.from_numpy(coords[sel] - (z0, 0, 0)).to(dev)
        out[sel] = acc[at[:, 0], at[:, 1], at[:, 2]].cpu().numpy()
    return out


def colocalize_blobs(
        roi: np.ndarray, blobs: np.ndarray, thresh=None,
        device: Union[str, torch.device] = "cuda") -> Optional[np.ndarray]:
    """Intensity-based colocalization on ``device``.

    Each blob's mean over a ball of radius 2 in every channel of ``roi``
    (z, y, x, c) is compared with that channel's threshold: the least mean
    of the channel's own blobs (``"min"``, the default), or the
    ``thresh`` percentile of them (of the whole channel when it has no
    blob). Blob coordinates are truncated to integers.

    Returns an ``(n_blobs, n_channels)`` uint8 matrix (0 for blobs outside
    ``roi``), or None without blobs or channels.
    """
    if blobs is None or roi is None or roi.ndim < 4:
        return None
    dev = device_mod.resolve(device)
    if thresh is None:
        thresh = "min"
    n_chl = roi.shape[3]
    blobs_roi, roi_mask = blobs_mod.get_blobs_in_roi(
        blobs, (0, 0, 0), roi.shape[:3], reverse=False)
    coords = np.clip(
        blobs_roi[:, :3].astype(int), 0,
        np.asarray(roi.shape[:3]) - 1)
    blob_chl = blobs_mod.Blobs.get_blobs_channel(blobs_roi).astype(int)

    # the mean as the reference forms it: the float32 sum over the ball's
    # voxel count
    n_vox = np.float32(filters.ball_footprint(BALL_RADIUS).sum())
    means = np.stack([
        _ball_sums(roi[..., c], coords, dev) / n_vox
        for c in range(n_chl)], axis=1)

    threshs = []
    for c in range(n_chl):
        own = means[blob_chl == c, c]
        if thresh == "min":
            threshs.append(own.min() if own.size else None)
        else:
            src = own if own.size else roi[..., c].reshape(-1)
            threshs.append(np.percentile(src, thresh))

    colocs_roi = np.zeros((len(blobs_roi), n_chl), dtype=np.uint8)
    for c in range(n_chl):
        if threshs[c] is None:
            continue
        colocs_roi[:, c] = (means[:, c] >= threshs[c]).astype(np.uint8)

    colocs = np.zeros((len(blobs), n_chl), dtype=np.uint8)
    colocs[roi_mask] = colocs_roi
    return colocs


def colocalize_blobs_match(
        blobs: np.ndarray, offset: Sequence[int], size: Sequence[int],
        tol: Sequence[float], channels: Optional[Sequence[int]] = None
) -> Dict[Tuple[int, int], BlobMatch]:
    """Match-based colocalization in an ROI (``offset``/``size`` x,y,z):
    for each pair of ``channels`` (default: those present), an optimal
    assignment of the first channel's blobs to the second's within the
    per-axis tolerance ``tol`` (z,y,x).

    Returns a dict mapping ``(chl1, chl2)`` to a :class:`BlobMatch`.
    """
    if blobs is None:
        return {}
    if channels is None:
        channels = np.unique(
            blobs_mod.Blobs.get_blobs_channel(blobs)).astype(int)
    thresh, scaling, inner_padding, *_ = verifier.setup_match_blobs_roi(tol)
    matches_all = {}
    for i, c1 in enumerate(channels):
        for c2 in channels[i + 1:]:
            b1 = blobs_mod.Blobs.blobs_in_channel(blobs, c1)
            b2 = blobs_mod.Blobs.blobs_in_channel(blobs, c2)
            matches = verifier.match_blobs_roi(
                b2, b1, offset, size, thresh, scaling, inner_padding)[-1]
            matches_all[(int(c1), int(c2))] = BlobMatch(matches)
    return matches_all


class StackColocalizer:
    """Match-based colocalization of a whole stack in blocks."""

    @classmethod
    def colocalize_stack(
            cls, shape, blobs: np.ndarray, tol,
            block_size: int = 128,
            channels: Optional[Sequence[int]] = None
    ) -> Dict[Tuple[int, int], BlobMatch]:
        """Match the channel pairs' blobs block by block, each block with
        a halo of the tolerance, then keep the shortest match of each
        first-channel blob that two blocks both matched.

        Args:
            shape: z,y,x stack shape.
            blobs: all blobs (N x >= 7).
            tol: per-axis matching tolerance (z,y,x).
            block_size: block edge length.
            channels: channels to pair; defaults to all present.

        Returns:
            dict ``(chl1, chl2) -> BlobMatch`` without duplicates.
        """
        if channels is None:
            channels = np.unique(
                blobs_mod.Blobs.get_blobs_channel(blobs)).astype(int)
        tol = np.asarray(tol, float)
        pad = np.ceil(tol).astype(int)
        slices, _ = chunking.stack_splitter(shape, (block_size,) * 3, pad)

        collected: dict = {}
        for coord in np.ndindex(*slices.shape):
            sl = slices[coord]
            lo = np.asarray([s.start for s in sl])
            hi = np.asarray([s.stop for s in sl])
            in_block = np.all(
                (blobs[:, :3] >= lo - pad) & (blobs[:, :3] < hi + pad),
                axis=1)
            sub = blobs[in_block]
            if len(sub) < 2:
                continue
            matches = colocalize_blobs_match(
                sub, lo[::-1], (hi - lo)[::-1], tol, channels)
            for pair, bm in matches.items():
                if bm.df is None or not len(bm.df):
                    continue
                collected.setdefault(pair, []).append(bm.df)

        out = {}
        for pair, dfs in collected.items():
            df = pd.concat(dfs, ignore_index=True)
            # a blob matched in two blocks keeps its shortest match
            keys = df[BlobMatch.Cols.BLOB1.value].map(
                lambda b: tuple(np.round(np.asarray(b)[:3]).astype(int)))
            df = df.assign(_key=keys).sort_values(
                BlobMatch.Cols.DIST.value)
            df = df.drop_duplicates("_key").drop(columns="_key")
            out[pair] = BlobMatch(df=df.reset_index(drop=True))
        return out


def _get_roi_id(db, offset, shape, exp_name: str = "exp") -> int:
    """The whole image's ROI row, where its matches are kept."""
    exp_id = db.select_or_insert_experiment(exp_name)
    roi_id, _ = db.select_or_insert_roi(
        exp_id, 0, tuple(offset[::-1]), tuple(shape[::-1]))
    return roi_id


def insert_matches(db, matches: Dict, exp_name: str = "exp") -> None:
    """Write each channel pair's matches, and the blobs they name, for a
    whole image under a zero-sized ROI."""
    roi_id = _get_roi_id(db, (0, 0, 0), (0, 0, 0), exp_name)
    for chl_matches in matches.values():
        blobs_all = chl_matches.get_blobs_all()
        if blobs_all is None:
            continue
        for blobs in blobs_all:
            db.insert_blobs(roi_id, blobs)
        rows = [(row[BlobMatch.Cols.BLOB1.value],
                 row[BlobMatch.Cols.BLOB2.value],
                 row[BlobMatch.Cols.DIST.value])
                for _, row in chl_matches.df.iterrows()]
        db.insert_blob_matches(roi_id, rows)


def select_matches(
        db, channels, offset=None, shape=None,
        exp_name: str = "exp") -> Optional[Dict]:
    """The whole image's matches grouped by channel pair, each side's blob
    row rebuilt from its database ID; None without matches."""
    roi_id = _get_roi_id(
        db, offset or (0, 0, 0), shape or (0, 0, 0), exp_name)
    raw = db.select_blob_matches(roi_id)
    if not raw:
        return None

    def blob_by_id(bid):
        db.cur.execute(
            "SELECT z, y, x, radius, confirmed, truth, channel "
            "FROM blobs WHERE id = ?", (bid,))
        r = db.cur.fetchone()
        if r is None:
            return None
        return np.array([r["z"], r["y"], r["x"], r["radius"],
                         r["confirmed"], r["truth"], r["channel"]],
                        dtype=float)

    grouped: Dict[Tuple[int, int], list] = {}
    for b1_id, b2_id, dist in raw:
        b1 = blob_by_id(b1_id)
        b2 = blob_by_id(b2_id)
        if b1 is None or b2 is None:
            continue
        grouped.setdefault(
            (int(b1[6]), int(b2[6])), []).append((b1, b2, dist))
    return {pair: BlobMatch(matches)
            for pair, matches in grouped.items()} or None
