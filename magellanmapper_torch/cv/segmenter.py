"""Segmentation on PyTorch: the minimax watershed, the random walker and
label markers.

Port of ``magellanmapper_tpu/cv/segmenter.py``:

- :func:`watershed` floods integer markers over an elevation image on
  the device: each sweep relaxes every voxel against its 6 neighbours
  (axis 0 to 2, ``+1`` then ``-1``; a neighbour's cost ``max(cost,
  elevation)`` plus the compactness term ``c * |coords - seed|^2``,
  taken on a strict ``<``) until a sweep changes nothing, at most
  ``max_iters`` sweeps. The reference runs the loop on the device; here
  the host checks for a change once every :data:`_SWEEPS_PER_CHECK`
  sweeps, which is exact because a sweep after the fixpoint changes
  nothing (costs only fall, and a label or seed moves only with its
  cost). The reference's compiler fuses ``cost + c * d2`` into one
  fused multiply-add (rounded once), which decides ties; the port
  computes that same rounding on every device (:func:`_fma32`), so the
  card, the CPU and the reference agree voxel for voxel.
- :func:`labels_to_markers_erosion` erodes every label into a marker by
  a ball, shrinking the ball for a label the erosion would leave with
  under 20% of its voxels. The reference erodes each label's bounding
  box on the host with ``scipy.ndimage.binary_erosion``; here one
  erosion of the whole labels image per radius runs on the device, a
  voxel keeping its label where the ball about it holds that label
  alone (the minimum and maximum of the labels' codes over the ball
  agree, outside the image 0), which is the same set.

- :func:`watershed_distance` floods the peaks of a foreground's
  distance transform (the jump-flooding EDT and the full 3^3 maximum
  filter on the device) over the negated distance; a cut to the
  ``num_peaks`` highest peaks is numpy's own ``argsort`` on the host, so
  ties keep the reference's order. :func:`segment_ws` runs it on an Otsu
  foreground with markers from blobs or from those peaks.
- :func:`segment_rw` is the random walker: the foreground probability is
  solved by exactly 200 conjugate-gradient steps on the grid graph's
  Laplacian (6-neighbour weights ``exp(-beta * d^2)`` of the normalised
  intensities, seeds as Dirichlet conditions), the reference's loop
  written out on the device with every scalar a 0-d device tensor, so
  the loop never waits on the host. Its sums reduce in another order than
  XLA's and XLA fuses its updates into multiply-adds, so probabilities
  agree within a tolerance, not to the bit.
- :func:`labels_to_markers_blob` shrinks each label to the part of it
  inside an ellipsoid about its centroid, every voxel at once on the
  device; the centroids come from exact integer coordinate sums, and the
  ellipsoid test divides tensor by tensor (the card divides by a host
  scalar through its reciprocal), so the markers equal numpy's.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import ndimage as scipy_ndi

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.cv import cv_nd
from magellanmapper_torch.ops import filters, peaks as peaks_ops, preproc

_logger = logging.getLogger(__name__)

#: watershed sweeps between the host's checks for a fixpoint
_SWEEPS_PER_CHECK = 16


def _neighbor_shift(arr: torch.Tensor, ax: int, direction: int,
                    fill) -> torch.Tensor:
    """Each voxel's neighbour along ``ax`` (``direction`` +1: the voxel
    before it, -1: the one after), ``fill`` past the edge."""
    out = torch.full_like(arr, fill)
    n = arr.shape[ax]
    if direction > 0:
        out.narrow(ax, 1, n - 1).copy_(arr.narrow(ax, 0, n - 1))
    else:
        out.narrow(ax, 0, n - 1).copy_(arr.narrow(ax, 1, n - 1))
    return out


def _fma32(c: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``c * x + y`` in float32 rounded once, as a fused multiply-add:
    the product is exact in float64 (24 by 24 bits), the sum is rounded
    to odd there (its exact error from TwoSum), and round-to-odd at 53
    bits then to nearest at 24 gives the correctly rounded result. Inf
    passes through."""
    p = x.to(torch.float64) * float(np.float32(c))
    y64 = y.to(torch.float64)
    s = p + y64
    bp = s - p
    err = (p - (s - bp)) + (y64 - bp)
    inexact = (err != 0) & torch.isfinite(s) & (
        (s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where(inexact, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _flood_sweep(cost, labels, seed_pos, elev, mask, coords,
                 compactness: float):
    """One sweep of the minimax flood over the 6 neighbours."""
    ndim = elev.dim()
    best_cost, best_labels, best_seed = cost, labels, seed_pos
    for ax in range(ndim):
        for d in (1, -1):
            n_cost = _neighbor_shift(cost, ax, d, float("inf"))
            n_lab = _neighbor_shift(labels, ax, d, 0)
            n_seed = _neighbor_shift(seed_pos, ax + 1, d, 0.0)
            cand = torch.maximum(n_cost, elev)
            if compactness:
                diff = coords - n_seed
                sq = diff * diff
                d2 = sq[0]
                for i in range(1, ndim):
                    d2 = d2 + sq[i]
                cand = _fma32(compactness, d2, cand)
            take = (cand < best_cost) & mask & (n_lab > 0)
            best_cost = torch.where(take, cand, best_cost)
            best_labels = torch.where(take, n_lab, best_labels)
            best_seed = torch.where(take[None], n_seed, best_seed)
    return best_cost, best_labels, best_seed


def _watershed_flood(elevation: torch.Tensor, markers: torch.Tensor,
                     mask: torch.Tensor, compactness: float = 0.0,
                     max_iters: int = 4096) -> Tuple[torch.Tensor, int]:
    """Minimax-path flood of ``markers`` (int32, seeds > 0) over
    ``elevation`` within ``mask``, on their device
    (``segmenter.py:42-112``). Returns the labels and the number of
    sweeps the reference's loop runs (the first that changes nothing, or
    ``max_iters``)."""
    elev = elevation.to(torch.float32)
    have_seed = markers > 0
    cost = torch.where(have_seed, elev, float("inf"))
    labels = markers.to(torch.int32)
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(s, dtype=torch.float32, device=elev.device)
          for s in elev.shape], indexing="ij"))
    seed_pos = torch.where(have_seed[None], coords, 0.0)
    sweeps = 0
    while sweeps < max_iters:
        flags = []
        for _ in range(min(_SWEEPS_PER_CHECK, max_iters - sweeps)):
            new_cost, new_labels, seed_pos = _flood_sweep(
                cost, labels, seed_pos, elev, mask, coords, compactness)
            flags.append(torch.any(new_labels != labels)
                         | torch.any(new_cost != cost))
            cost, labels = new_cost, new_labels
        changed = torch.stack(flags).cpu().numpy()
        if not changed.all():
            sweeps += int(np.argmin(changed)) + 1
            break
        sweeps += len(changed)
    return torch.where(mask, labels, 0), sweeps


def watershed(elevation: np.ndarray, markers: np.ndarray,
              mask: Optional[np.ndarray] = None, compactness: float = 0.0,
              device="cuda") -> np.ndarray:
    """Watershed of ``elevation`` from integer ``markers`` on ``device``
    (skimage ``segmentation.watershed`` surface; int32)."""
    dev = device_mod.resolve(device)
    elevation = np.asarray(elevation)
    if mask is None:
        mask = np.ones(elevation.shape, bool)
    labels, sweeps = _watershed_flood(
        torch.from_numpy(elevation.astype(np.float32)).to(dev),
        torch.from_numpy(np.array(markers, np.int32)).to(dev),
        torch.from_numpy(np.array(mask, bool)).to(dev),
        float(compactness))
    _logger.info("watershed flood: %d sweeps over %s voxels", sweeps,
                 elevation.shape)
    return labels.cpu().numpy()


def watershed_distance(
        foreground: np.ndarray, markers: Optional[np.ndarray] = None,
        num_peaks: float = np.inf, compactness: float = 0.0,
        mask: Optional[np.ndarray] = None, device="cuda") -> np.ndarray:
    """Watershed on the distance from the background, on ``device``
    (``segmenter.py:105-128``): without ``markers``, the foreground's
    voxels equal to the 3^3 maximum of the distance are the peaks, cut to
    the ``num_peaks`` highest (numpy's ``argsort`` order on the host) and
    labelled by connected components (``scipy.ndimage.label``); the
    markers then flood ``-distance`` within ``mask``."""
    dev = device_mod.resolve(device)
    foreground = np.asarray(foreground)
    distance = cv_nd.distance_transform_edt(foreground, device=dev)
    if markers is None:
        dist_t = torch.from_numpy(distance).to(dev)
        is_peak = (peaks_ops.max_filter_full(dist_t) == dist_t).cpu().numpy()
        is_peak &= foreground.astype(bool)
        if np.isfinite(num_peaks):
            vals = np.where(is_peak, distance, -np.inf).ravel()
            order = np.argsort(vals)[::-1][:int(num_peaks)]
            keep = np.zeros(is_peak.size, bool)
            keep[order[vals[order] > -np.inf]] = True
            is_peak &= keep.reshape(is_peak.shape)
        markers, _ = scipy_ndi.label(is_peak)
    return watershed(-distance, markers, mask=mask, compactness=compactness,
                     device=dev)


def _lap(x: torch.Tensor, ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """The grid graph's Laplacian applied to ``x``: ``-sum`` over the axes
    of ``pad(d, hi) - pad(d, lo)``, ``d = diff(x) * w``, added axis by
    axis in the reference's order (``segmenter.py:152-163``); the pads
    are written as adds to slices, which differ from adding the zeros
    only in the sign of a zero."""
    out = torch.zeros_like(x)
    for ax, w in enumerate(ws):
        d = torch.diff(x, dim=ax) * w
        n = x.shape[ax]
        out.narrow(ax, 0, n - 1).add_(d)
        out.narrow(ax, 1, n - 1).sub_(d)
    return out.neg_()


def _random_walker_cg(
        img: torch.Tensor, seeds_fg: torch.Tensor, seeds_bg: torch.Tensor,
        beta: float = 50.0, iters: int = 200) -> torch.Tensor:
    """Foreground probability by ``iters`` conjugate-gradient steps on the
    grid Laplacian restricted to the unseeded voxels, seeds fixed at 1
    (foreground) and 0 (``segmenter.py:131-185``): no convergence test,
    as in the reference; ``alpha``, ``rs`` and the denominators stay 0-d
    tensors on the device, clamped as the reference's."""
    img = img.to(torch.float32)
    lo = img.min()
    rng = torch.clamp(img.max() - lo, min=1e-6)
    # tensor by tensor: the card divides by a host scalar through its
    # reciprocal
    norm = (img - lo) / rng
    ws = []
    for ax in range(img.dim()):
        diff = torch.diff(norm, dim=ax)
        ws.append(torch.exp(-beta * diff * diff))
    del norm
    fixed = seeds_fg | seeds_bg
    free = ~fixed
    x0 = torch.where(seeds_fg, 1.0, 0.0)
    zero = x0.new_zeros(())

    def a_op(x):
        return torch.where(free, _lap(torch.where(free, x, zero), ws), zero)

    b = torch.where(free, -_lap(torch.where(fixed, x0, zero), ws), zero)
    x = torch.zeros_like(x0)
    r = b - a_op(x)
    del b
    p = r
    rs = torch.sum(r * r)
    for _ in range(iters):
        ap = a_op(p)
        denom = torch.sum(p * ap)
        alpha = rs / torch.clamp(denom, min=1e-12)
        x = x + alpha * p
        r = r - alpha * ap
        del ap
        rs_new = torch.sum(r * r)
        p = r + (rs_new / torch.clamp(rs, min=1e-12)) * p
        rs = rs_new
    return torch.where(fixed, x0, x)


def segment_rw(
        roi: np.ndarray, channel: Optional[Sequence[int]] = None,
        beta: float = 50.0, vmin: float = 0.6, vmax: float = 0.65,
        remove_small: Optional[int] = None,
        erosion: Optional[int] = None,
        blobs: Optional[np.ndarray] = None,
        get_labels: bool = False, device="cuda") -> List[np.ndarray]:
    """Random-walker segmentation of each channel on ``device``
    (``segmenter.py:188-235``): seeds are the voxels ``>= vmax``
    (foreground) and ``< vmin`` (background), or with ``blobs`` the blobs'
    voxels (foreground) and the voxels below the channel's 25th
    percentile (numpy's, on the host); a voxel is foreground (1) where
    its probability is at least 0.5, else background (2). Foreground
    components under ``remove_small`` voxels become background
    (``scipy.ndimage.label``, host), ``erosion`` erodes the mask by an
    octahedron (symmetric border), and ``get_labels`` returns the
    foreground's components instead. One uint8 mask (or int32 labels)
    a channel."""
    dev = device_mod.resolve(device)
    multichannel = roi.ndim > 3
    channels = (range(roi.shape[3]) if multichannel else [0]) \
        if channel is None else np.atleast_1d(channel)
    out = []
    for chl in channels:
        seg = np.asarray(roi[..., chl] if multichannel else roi, np.float32)
        seg_t = torch.from_numpy(seg).to(dev)
        if blobs is None:
            seeds_fg = seg_t >= vmax
            seeds_bg = seg_t < vmin
        else:
            coords = np.clip(blobs[:, :3].astype(int), 0,
                             np.asarray(seg.shape) - 1)
            seeds_fg = torch.zeros(seg.shape, dtype=torch.bool, device=dev)
            seeds_fg[tuple(torch.from_numpy(coords.T).to(dev))] = True
            seeds_bg = (seg_t < float(np.percentile(seg, 25))) & ~seeds_fg
        prob = _random_walker_cg(seg_t, seeds_fg, seeds_bg, float(beta))
        del seg_t, seeds_fg, seeds_bg
        walker = torch.where(prob >= 0.5, 1, 2).to(torch.uint8)
        del prob
        if remove_small:
            walker = walker.cpu().numpy()
            labeled, _ = scipy_ndi.label(walker == 1)
            counts = np.bincount(labeled.ravel())
            small = np.flatnonzero(counts < remove_small)
            walker[np.isin(labeled, small[small != 0])] = 2
            walker = torch.from_numpy(walker).to(dev)
        if erosion:
            walker = filters.erosion(
                walker.to(torch.float32),
                filters.octahedron_footprint(erosion)).to(torch.uint8)
        walker = walker.cpu().numpy()
        if get_labels:
            labeled, _ = scipy_ndi.label(walker == 1)
            out.append(labeled)
        else:
            out.append(walker)
    return out


def segment_ws(
        roi: np.ndarray, channel: Optional[Sequence[int]] = None,
        thresholded: Optional[np.ndarray] = None,
        blobs: Optional[np.ndarray] = None, device="cuda") -> np.ndarray:
    """Compact watershed (compactness 0.1) of each channel's foreground
    (above its Otsu threshold on ``device``, or ``thresholded``) from
    markers at the blobs' centres, or from the foreground's distance peaks
    without blobs (:func:`watershed_distance`); returns the last
    channel's labels, as the reference does (``segmenter.py:238-261``)."""
    dev = device_mod.resolve(device)
    multichannel = roi.ndim > 3
    channels = (range(roi.shape[3]) if multichannel else [0]) \
        if channel is None else np.atleast_1d(channel)
    labels_ws = None
    for chl in channels:
        seg = roi[..., chl] if multichannel else roi
        if thresholded is None:
            thresh = float(preproc.otsu_threshold(torch.from_numpy(
                np.array(seg, np.float32)).to(dev)))
            fg = np.asarray(seg) > thresh
        else:
            fg = np.asarray(thresholded).astype(bool)
        markers = None if blobs is None else _markers_from_blobs(fg, blobs)
        labels_ws = watershed_distance(fg, markers, compactness=0.1,
                                       device=dev)
    return labels_ws


def _markers_from_blobs(shape_src: np.ndarray, blobs: np.ndarray
                        ) -> np.ndarray:
    """int32 markers ``1..N`` at the blobs' centres (truncated and
    clipped into the image), a later blob overwriting an earlier one at
    the same voxel."""
    markers = np.zeros(np.asarray(shape_src).shape, dtype=np.int32)
    coords = np.clip(
        blobs[:, :3].astype(int), 0, np.asarray(markers.shape) - 1)
    markers[tuple(coords.T)] = np.arange(1, len(blobs) + 1)
    return markers


#: voxels a chunk of :func:`labels_to_markers_blob`'s ellipsoid test
_BLOB_MARKER_CHUNK = 1 << 25


def labels_to_markers_blob(labels_img: np.ndarray,
                           device="cuda") -> np.ndarray:
    """Shrink each label to the voxels of it inside an ellipsoid about its
    centroid whose radii are a fifth of its extent on each axis (at least
    1), on ``device`` (``segmenter.py:274-292``). The reference builds
    the whole image's indices a label; here each voxel is tested against
    its own label's ellipsoid once, in float64 with the reference's
    operations and order, so the markers are the same."""
    dev = device_mod.resolve(device)
    lab = torch.from_numpy(np.array(labels_img)).to(dev)
    ids = torch.unique(lab)
    ids = ids[ids != 0]
    markers = torch.zeros_like(lab)
    if len(ids) == 0:
        return markers.cpu().numpy()
    ndim = lab.dim()
    bbox = cv_nd.label_bboxes(lab, ids)
    sizes, sums = cv_nd.label_coord_sums(lab, ids)
    centroid = sums.astype(np.float64) / sizes[:, None]
    radii = np.maximum((bbox[:, ndim:] - bbox[:, :ndim]) / 5.0, 1.0)
    cen_t = torch.from_numpy(centroid).to(dev)
    rad_t = torch.from_numpy(radii).to(dev)
    plane = int(np.prod(lab.shape[1:]))
    step = max(1, _BLOB_MARKER_CHUNK // max(plane, 1))
    for z0 in range(0, lab.shape[0], step):
        part = lab[z0:z0 + step]
        code, inside = (c.view(part.shape)
                        for c in cv_nd.label_codes(part, ids))
        grids = torch.meshgrid(*[
            torch.arange(z0, z0 + part.shape[0], device=dev)] + [
            torch.arange(n, device=dev) for n in lab.shape[1:]],
            indexing="ij")
        acc = None
        for ax in range(ndim):
            t = (grids[ax].to(torch.float64) - cen_t[code, ax]) \
                / rad_t[code, ax]
            acc = t * t if acc is None else acc + t * t
        markers[z0:z0 + step] = torch.where(inside & (acc <= 1), part, 0)
    return markers.cpu().numpy()


def labels_to_markers_erosion(
        labels_img: np.ndarray, filter_size: int = 8,
        min_filter_size: Optional[int] = None,
        use_min_filter: bool = False,
        skel_eros_filt_size: Optional[int] = None,
        device="cuda") -> Tuple[np.ndarray, list]:
    """Erode each label into an interior marker by a ball of
    ``filter_size``, on ``device`` (``segmenter.py:295-338``): a label the
    ball would leave with under 20% of its voxels (or none) tries the next
    smaller ball; below ``min_filter_size`` (default ``filter_size - 2``)
    it keeps its whole region unless ``use_min_filter``, which goes down
    to radius 1. Returns the markers (the labels' dtype) and per-label
    ``(label, voxels, marker voxels, radius)`` stats in label order."""
    dev = device_mod.resolve(device)
    if min_filter_size is None:
        min_filter_size = max(1, filter_size - 2)
    labels_img = np.asarray(labels_img)
    lab = torch.from_numpy(np.array(labels_img)).to(dev)
    ids, codes, sizes = torch.unique(lab, return_inverse=True,
                                     return_counts=True)
    if len(ids) >= 2 ** 24:
        raise ValueError(f"{len(ids)} labels do not fit float32 codes")
    # codes from 1, so the zero border differs from every label
    codes_f = (codes + 1).to(torch.float32)
    need = torch.clamp(sizes.to(torch.float64) * 0.2, min=1.0)
    n = len(ids)
    fsize = np.full(n, filter_size)
    kept = sizes.cpu().numpy().copy()
    pending = ids.cpu().numpy() != 0
    markers = torch.zeros_like(lab)
    radius = filter_size
    while radius >= 1 and pending.any():
        ball = cv_nd.get_selem(lab.dim())(radius)
        vol = codes_f if lab.dim() == 3 else codes_f[None]
        st = ball if lab.dim() == 3 else ball[None]
        same = (filters.window_reduce(vol, st, maximum=False)
                == filters.window_reduce(vol, st, maximum=True))
        same = same if lab.dim() == 3 else same[0]
        retained = torch.bincount(codes[same], minlength=n)
        ok = (retained.to(torch.float64) >= need).cpu().numpy() & pending
        markers = torch.where(same & torch.from_numpy(ok).to(dev)[codes],
                              lab, markers)
        kept[ok] = retained.cpu().numpy()[ok]
        pending &= ~ok
        radius -= 1
        fsize[pending] = radius
        if radius < min_filter_size and not use_min_filter:
            break
    whole = torch.from_numpy(pending).to(dev)[codes]
    markers = torch.where(whole, lab, markers)
    ids_np = ids.cpu().numpy()
    stats = [(int(lid), int(size), int(k), int(f)) for lid, size, k, f
             in zip(ids_np, sizes.cpu().numpy(), kept, fsize) if lid != 0]
    return markers.cpu().numpy(), stats


class LabelToMarkerErosion:
    """Configuration facade over :func:`labels_to_markers_erosion`
    (reference ``segmenter.LabelToMarkerErosion``)."""

    def __init__(self, labels_img: np.ndarray, wt_dists=None):
        self.labels_img = labels_img
        self.wt_dists = wt_dists

    def erode_labels(self, filter_size: int = 8, **kwargs):
        """Erode all labels to markers; returns ``(markers, stats)``."""
        return labels_to_markers_erosion(
            self.labels_img, filter_size, **kwargs)


def mask_atlas(atlas_img: np.ndarray, labels_img: np.ndarray,
               device="cuda") -> np.ndarray:
    """The atlas above its Otsu threshold (on ``device``) or labelled
    (reference ``segmenter.mask_atlas``)."""
    dev = device_mod.resolve(device)
    thresh = float(preproc.otsu_threshold(torch.from_numpy(
        np.array(atlas_img, np.float32)).to(dev)))
    return (atlas_img > thresh) | (labels_img != 0)


def segment_from_labels(
        edges: np.ndarray, markers: np.ndarray, labels_img: np.ndarray,
        atlas_img: Optional[np.ndarray] = None,
        exclude_labels: Optional[Sequence[int]] = None,
        mask_filt: str = "opening", mask_filt_size: int = 2,
        device="cuda") -> np.ndarray:
    """Watershed the markers onto an edge image, on ``device``: the
    elevation is 1 off the edges and 0 on them, compactness 0.005, within
    the atlas's mask, its carved foreground, or the labels' foreground
    opened (or closed) by a ball of ``mask_filt_size``; ``exclude_labels``
    keep their voxels (reference ``segmenter.segment_from_labels``)."""
    dev = device_mod.resolve(device)
    if atlas_img is not None and labels_img is not None:
        mask = mask_atlas(atlas_img, labels_img, device=dev)
    elif atlas_img is not None:
        _, mask = cv_nd.carve(atlas_img, holes_area=5000, device=dev)
    else:
        mask = labels_img != 0
        if mask_filt_size and mask_filt in ("opening", "closing"):
            selem = cv_nd.get_selem(labels_img.ndim)(mask_filt_size)
            op = (filters.binary_opening if mask_filt == "opening"
                  else filters.binary_closing)
            mask = op(torch.from_numpy(mask).to(dev), selem).cpu().numpy()
    exclude = None
    markers = np.array(markers)
    if exclude_labels is not None:
        exclude = np.isin(labels_img, exclude_labels)
        mask = mask & ~exclude
        markers[np.isin(markers, exclude_labels)] = 0
    ws = watershed(edges == 0, markers, mask=mask, compactness=0.005,
                   device=dev)
    if exclude is not None:
        ws[exclude] = labels_img[exclude]
    return ws


class SubSegmenter:
    """Facade over edge-based sub-segmentation of labels (reference
    ``segmenter.SubSegmenter``), delegating to
    :func:`magellanmapper_torch.atlas.edge_seg.make_sub_segmented_labels`."""

    def __init__(self, labels_img_np: np.ndarray, atlas_edge: np.ndarray,
                 device="cuda"):
        self.labels_img_np = labels_img_np
        self.atlas_edge = atlas_edge
        self.device = device

    def sub_segment(self, sub_seg_mult: int = 100) -> np.ndarray:
        from magellanmapper_torch.atlas import edge_seg
        return edge_seg.make_sub_segmented_labels(
            self.labels_img_np, self.atlas_edge, sub_seg_mult,
            device=self.device)


def sub_segment_labels(labels_img_np: np.ndarray, atlas_edge: np.ndarray,
                       device="cuda") -> np.ndarray:
    """Sub-segment labels along anatomical edges; sub-labels are ``label *
    100 + k`` (reference ``segmenter.sub_segment_labels``)."""
    return SubSegmenter(labels_img_np, atlas_edge, device).sub_segment()
