"""ND image operations on PyTorch.

Port of what registration's curation and the specimen pipeline need from
``magellanmapper_tpu/cv/cv_nd.py``: the jump-flooding Euclidean distance
transform with nearest-seed indices, in-painting from those indices,
carving a foreground by threshold with small holes filled, perimeters (an
erosion on the device), the blob heat map (an integer ``bincount`` on the
device), rescaling through ``ops.resize``, and the host-side plane
rotation (scipy) and intensity remap, as in the reference; and what atlas
refinement needs: structuring elements, label bounding boxes (on the
device for a whole labels image), cropping to the labels, the clipped
LoG image (the LoG on the device, its percentiles numpy's), zero
crossings, exteriors, and surface area and compactness (host copies);
and the rest of the reference module: signed and border distances (the
distance transform and the dilation on the device), removing the
background outside a dilated foreground (on the device), and host
copies of the radial distances, adaptive filtering, contour
interpolation, shears and rotations, region properties, compactness
counts, thresholded regions and the surface-net mesh (numpy's order
and float64 sums, so vertices and faces equal the reference's).

The distance transform keeps the reference's 1+JFA schedule (halving
steps from the next power of two, then one more pass at 1), its offset
order, and the strict ``<`` that lets a candidate replace the nearest
seed, so the nearest-seed indices (integers) equal the reference's and so
does :func:`in_paint`. Connected components stay on the host
(``scipy.ndimage.label``), as in the reference.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import ndimage as scipy_ndi

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.ops import filters, preproc
from magellanmapper_torch.ops import resize as resize_ops
from magellanmapper_torch.utils import libmag

#: the resampling helpers of ``ops.resize``, under the reference's names
calc_isotropic_factor = resize_ops.calc_isotropic_factor
make_isotropic = resize_ops.make_isotropic


def _jfa_offsets(ndim: int) -> np.ndarray:
    """All nonzero {-1,0,1}^ndim neighbor directions."""
    grids = np.meshgrid(*([[-1, 0, 1]] * ndim), indexing="ij")
    offs = np.stack([g.ravel() for g in grids], axis=1)
    return offs[np.any(offs != 0, axis=1)]


def _shift(field: torch.Tensor, axis: int, k: int) -> torch.Tensor:
    """``field`` moved by ``k`` along ``axis``, the vacated positions set
    to -1 (the reference's ``roll`` with its wrapped rows masked)."""
    if k == 0:
        return field
    out = torch.full_like(field, -1)
    n = field.shape[axis]
    if abs(k) < n:
        src = field.narrow(axis, 0, n - k) if k > 0 \
            else field.narrow(axis, -k, n + k)
        dst = out.narrow(axis, k, n - k) if k > 0 \
            else out.narrow(axis, 0, n + k)
        dst.copy_(src)
    return out


def _edt_jfa(seed_mask: torch.Tensor, sampling: Sequence[float]):
    """Jump-flooding nearest-seed field (1+JFA): ``(dist, idx)``, the
    distance to the nearest seed and its coordinates ``(ndim, ...)``
    (int32, -1 where no seed was found)."""
    shape = seed_mask.shape
    ndim = seed_mask.dim()
    dev = seed_mask.device
    samp = torch.tensor([float(s) for s in sampling], dtype=torch.float32,
                        device=dev).reshape((ndim,) + (1,) * ndim)
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(s, dtype=torch.int32, device=dev) for s in shape],
        indexing="ij"))
    coords_f = coords.to(torch.float32)
    nearest = torch.where(seed_mask[None], coords, -1)

    def dist_to(near):
        d = (near.to(torch.float32) - coords_f) * samp
        sq = d[0] * d[0]
        for ax in range(1, ndim):
            sq = sq + d[ax] * d[ax]
        return torch.where(torch.any(near < 0, dim=0), float("inf"),
                           torch.sqrt(sq))

    step_list = []
    s = int(2 ** np.ceil(np.log2(max(shape))))
    while s >= 1:
        step_list.append(s)
        s //= 2
    step_list.append(1)  # 1+JFA extra pass for accuracy
    best = dist_to(nearest)
    for step in step_list:
        for off in _jfa_offsets(ndim):
            shifted = nearest
            for ax in range(ndim):
                shifted = _shift(shifted, ax + 1, int(off[ax]) * step)
            cand = dist_to(shifted)
            take = cand < best
            nearest = torch.where(take[None], shifted, nearest)
            best = torch.where(take, cand, best)
    return best, nearest


def distance_transform_edt(
        mask: np.ndarray, sampling: Optional[Sequence[float]] = None,
        return_indices: bool = False, device="cuda"):
    """Euclidean distance transform on ``device`` (scipy semantics: the
    distance from each True voxel to the nearest False voxel), with the
    nearest False voxel's indices when asked; numpy results."""
    dev = device_mod.resolve(device)
    mask = np.asarray(mask).astype(bool)
    if sampling is None:
        sampling = (1.0,) * mask.ndim
    dist, idx = _edt_jfa(torch.from_numpy(~mask).to(dev), sampling)
    dist = dist.cpu().numpy()
    dist[~mask] = 0.0
    if return_indices:
        return dist, idx.cpu().numpy()
    return dist


def in_paint(roi: np.ndarray, to_fill: np.ndarray,
             device="cuda") -> np.ndarray:
    """Fill ``to_fill`` voxels with their nearest unfilled voxel's value
    (EDT-indices method)."""
    _, idx = distance_transform_edt(to_fill, return_indices=True,
                                    device=device)
    out = np.array(roi)
    fill = np.where(to_fill)
    nearest = tuple(idx[d][fill] for d in range(roi.ndim))
    out[fill] = roi[nearest]
    return out


def carve(roi: np.ndarray, thresh: Optional[float] = None,
          holes_area: Optional[int] = None, return_unfilled: bool = False,
          device="cuda"):
    """Carve the image's foreground: voxels above ``thresh`` (Otsu's on
    ``device`` when None), with background holes smaller than
    ``holes_area`` voxels filled. Returns ``(carved, mask[, unfilled])``."""
    roi_carved = np.copy(roi)
    if thresh is None:
        thresh = float(preproc.otsu_threshold(torch.from_numpy(
            roi_carved.astype(np.float32)).to(device_mod.resolve(device))))
    mask = roi_carved > thresh
    unfilled = None
    if holes_area:
        labeled, _ = scipy_ndi.label(~mask)
        counts = np.bincount(labeled.ravel())
        small = np.flatnonzero(counts < holes_area)
        small = small[small != 0]
        filled = mask | np.isin(labeled, small)
        if return_unfilled:
            unfilled = np.copy(mask)
        mask = filled
    roi_carved[~mask] = 0
    if return_unfilled:
        return roi_carved, mask, unfilled
    return roi_carved, mask


def _as_vol(arr: np.ndarray) -> np.ndarray:
    """``arr`` with leading axes of 1 up to three axes (the port's
    erosion and dilation act on the last three)."""
    return arr.reshape((1,) * (3 - arr.ndim) + arr.shape)


def _morph_nd(img: np.ndarray, footprint: np.ndarray, dilate: bool,
              dev) -> torch.Tensor:
    """Grayscale erosion (or dilation) of a 2D or 3D float32 image by a
    full footprint with a symmetric border, on ``dev``, in 3D."""
    vol = torch.from_numpy(_as_vol(np.asarray(img, np.float32))).to(dev)
    fp = _as_vol(np.asarray(footprint, bool))
    return (filters.dilation if dilate else filters.erosion)(vol, fp)


def perimeter_nd(
        img: np.ndarray, largest_only: bool = False,
        device="cuda") -> np.ndarray:
    """Boundary voxels of a boolean mask: mask XOR eroded(mask), the
    erosion by a full 3^ndim footprint with a symmetric border running on
    ``device`` (reference ``cv_nd.perimeter_nd``)."""
    dev = device_mod.resolve(device)
    mask = np.asarray(img).astype(bool)
    if largest_only:
        labeled, n = scipy_ndi.label(mask)
        if n > 1:
            counts = np.bincount(labeled.ravel())
            counts[0] = 0
            mask = labeled == np.argmax(counts)
    eroded = _morph_nd(mask, np.ones((3,) * mask.ndim, bool), False,
                       dev) > 0.5
    return mask ^ eroded.cpu().numpy().reshape(mask.shape)


def build_heat_map(
        shape: Sequence[int], coords: np.ndarray,
        device="cuda") -> np.ndarray:
    """Count coordinates per voxel on ``device``: coordinates rounded half
    to even, those outside ``shape`` dropped, counted with an integer
    ``bincount`` of their flat indices; int32 as in the reference
    (``cv_nd.build_heat_map``; used for blob density images)."""
    dev = device_mod.resolve(device)
    shape = tuple(int(s) for s in shape)
    pts = torch.round(torch.as_tensor(
        np.asarray(coords, np.float64).reshape(-1, len(shape)),
        device=dev)).to(torch.int64)
    dims = torch.tensor(shape, dtype=torch.int64, device=dev)
    pts = pts[torch.all((pts >= 0) & (pts < dims), dim=1)]
    flat = torch.zeros(len(pts), dtype=torch.int64, device=dev)
    for ax, n in enumerate(shape):
        flat = flat * n + pts[:, ax]
    heat = torch.bincount(flat, minlength=int(np.prod(shape)))
    return heat.reshape(shape).to(torch.int32).cpu().numpy()


def remap_intensity(roi: np.ndarray, channel=None) -> np.ndarray:
    """CLAHE-lite intensity remap: histogram equalization over 256 bins,
    on the host (reference ``cv_nd.remap_intensity``)."""
    out = np.array(roi, np.float32)
    lo, hi = out.min(), out.max()
    if hi > lo:
        flat = ((out - lo) / (hi - lo) * 255).astype(np.uint8)
        hist = np.bincount(flat.ravel(), minlength=256).astype(np.float64)
        cdf = hist.cumsum()
        cdf = cdf / cdf[-1]
        out = cdf[flat].astype(np.float32)
    return out


def rotate_nd(
        img: np.ndarray, angle: float, axis: int = 0, order: int = 1,
        resize: bool = False) -> np.ndarray:
    """Rotate plane by plane about an axis, on the host with scipy
    (reference ``cv_nd.rotate_nd``)."""
    axes = tuple(ax for ax in range(3) if ax != axis)[:2]
    return scipy_ndi.rotate(
        img, angle, axes=axes, reshape=resize, order=order,
        mode="constant")


def rescale_resize(
        roi: np.ndarray, target_size=None, multichannel: bool = False,
        preserve_range: bool = False, device="cuda",
        **kwargs) -> np.ndarray:
    """Rescale by a factor or resize to a shape through ``ops.resize`` on
    ``device`` (reference ``cv_nd.rescale_resize``); ``order=0`` for label
    images. The result is float32 at order 1 unless ``preserve_range``
    casts it back to the input's dtype."""
    dev = device_mod.resolve(device)
    order = kwargs.get("order", 1)
    dtype = roi.dtype
    chan = roi.shape[-1:] if multichannel else ()
    spatial = roi.shape[:-1] if multichannel else roi.shape
    if libmag.is_seq(target_size):
        out_shape = tuple(int(s) for s in target_size)
    else:
        factor = float(target_size)
        out_shape = tuple(
            max(1, int(round(s * factor))) for s in spatial)
    # unsigned types wider than a byte go through a signed type that
    # holds them, which every device's indexing supports
    wide = {np.dtype(np.uint16): np.int32, np.dtype(np.uint32): np.int64}

    def one(vol):
        vol = np.ascontiguousarray(vol)
        if order == 0 and vol.dtype in wide:
            vol = vol.astype(wide[vol.dtype])
        out = resize_ops.resize(
            torch.from_numpy(vol).to(dev), out_shape, order=order)
        out = out.cpu().numpy()
        return out.astype(dtype) if order == 0 else out

    if multichannel:
        out = np.stack([one(roi[..., c]) for c in range(chan[0])], axis=-1)
    else:
        out = one(roi)
    return out.astype(dtype) if preserve_range else out


def exterior_nd(img: np.ndarray, device="cuda") -> np.ndarray:
    """One-voxel shell just outside the mask: the mask's dilation by a
    full 3^ndim footprint (symmetric border, on ``device``) minus the
    mask (reference ``cv_nd.exterior_nd``)."""
    dev = device_mod.resolve(device)
    mask = np.asarray(img).astype(bool)
    dilated = _morph_nd(mask, np.ones((3,) * mask.ndim, bool), True,
                        dev) > 0.5
    return dilated.cpu().numpy().reshape(mask.shape) ^ mask


def surface_area_3d(mask: np.ndarray, spacing=(1.0, 1.0, 1.0)) -> float:
    """Surface area by exposed-face counting with the 2/3 orientation
    factor, on the host (copy of the reference's ``cv_nd.surface_area_3d``,
    which replaces the original's marching cubes)."""
    m = np.asarray(mask).astype(bool)
    area = 0.0
    face = [spacing[1] * spacing[2], spacing[0] * spacing[2],
            spacing[0] * spacing[1]]
    for ax in range(3):
        padded = np.pad(m, [(1, 1) if i == ax else (0, 0)
                            for i in range(3)])
        diff = np.diff(padded.astype(np.int8), axis=ax)
        area += np.abs(diff).sum() * face[ax]
    return float(area) * (2.0 / 3.0)


def compactness_3d(
        mask: np.ndarray, spacing=(1.0, 1.0, 1.0)
) -> Tuple[float, float, float]:
    """``(compactness, surface area, volume)``, compactness ``SA^1.5 /
    volume`` (reference ``cv_nd.compactness_3d``)."""
    sa = surface_area_3d(mask, spacing)
    vol = float(np.sum(mask) * np.prod(spacing))
    comp = sa ** 1.5 / vol if vol > 0 else np.nan
    return comp, sa, vol


def get_bbox_region(bbox: Sequence[int], padding: int = 0, img_shape=None):
    """Slices of a ``[lo..., hi...]`` bounding box, padded and clipped to
    ``img_shape`` (reference ``cv_nd.get_bbox_region``)."""
    ndim = len(bbox) // 2
    lo = np.asarray(bbox[:ndim]) - padding
    hi = np.asarray(bbox[ndim:]) + padding
    if img_shape is not None:
        lo = np.clip(lo, 0, img_shape)
        hi = np.clip(hi, 0, img_shape)
    return [slice(int(a), int(b)) for a, b in zip(lo, hi)]


def get_label_bbox(labels_img: np.ndarray, label_id) -> Optional[list]:
    """Bounding box ``[lo..., hi...]`` (``hi`` exclusive) of a label's
    voxels (or of any of several labels'), None when absent, on the host
    (reference ``cv_nd.get_label_bbox``)."""
    mask = np.isin(labels_img, label_id) if np.ndim(label_id) else (
        labels_img == label_id)
    if not mask.any():
        return None
    coords = np.argwhere(mask)
    return list(coords.min(axis=0)) + list(coords.max(axis=0) + 1)


def mask_bbox(mask: torch.Tensor) -> Optional[List[int]]:
    """:func:`get_label_bbox` of a boolean tensor, on its device: one
    reduction per axis and one copy to the host."""
    lo, hi = [], []
    for ax in range(mask.dim()):
        other = tuple(a for a in range(mask.dim()) if a != ax)
        idx = torch.nonzero(mask.any(dim=other) if other else mask)
        if len(idx) == 0:
            return None
        lo.append(idx[0, 0])
        hi.append(idx[-1, 0] + 1)
    return [int(v) for v in torch.stack(lo + hi).cpu()]


def label_codes(labels: torch.Tensor, ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each voxel's position among the sorted, nonempty ``ids`` and
    whether its label is one of them, both flat."""
    flat = labels.reshape(-1)
    codes = torch.searchsorted(ids, flat).clamp_max(len(ids) - 1)
    return codes, ids[codes] == flat


def label_bboxes(labels: torch.Tensor, ids: torch.Tensor) -> np.ndarray:
    """Bounding boxes ``(len(ids), 2 * ndim)`` (``[lo..., hi...]``, ``hi``
    exclusive) of every label in the sorted ``ids`` in one pass over the
    labels image on its device; an absent ID's row is all 0."""
    codes, found = label_codes(labels, ids)
    codes = codes[found]
    flat = torch.nonzero(found)[:, 0]
    out = torch.zeros((len(ids), 2 * labels.dim()), dtype=torch.int64,
                      device=labels.device)
    for ax in reversed(range(labels.dim())):
        coord = flat % labels.shape[ax]
        flat = flat // labels.shape[ax]
        out[:, ax].scatter_reduce_(0, codes, coord, "amin",
                                   include_self=False)
        out[:, labels.dim() + ax].scatter_reduce_(
            0, codes, coord + 1, "amax", include_self=False)
    return out.cpu().numpy()


def label_coord_sums(labels: torch.Tensor, ids: torch.Tensor
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Voxel counts ``(len(ids),)`` and int64 coordinate sums ``(len(ids),
    ndim)`` of every label in the sorted ``ids``, in one pass over the
    labels on their device. The sums are exact, so ``sums / counts`` in
    float64 is numpy's ``argwhere(...).mean(axis=0)`` to the bit."""
    codes, found = label_codes(labels, ids)
    codes = codes[found]
    flat = torch.nonzero(found)[:, 0]
    del found
    counts = torch.bincount(codes, minlength=len(ids)).cpu().numpy()
    sums = np.zeros((len(ids), labels.dim()), np.int64)
    for ax in reversed(range(labels.dim())):
        coord = flat % labels.shape[ax]
        flat = flat // labels.shape[ax]
        sums[:, ax] = torch.zeros(
            len(ids), dtype=torch.int64, device=labels.device).index_add_(
            0, codes, coord).cpu().numpy()
    return counts, sums


def crop_to_labels(img: np.ndarray, labels_img: np.ndarray, mask=None,
                   dil_size: int = 2, padding: int = 5, device="cuda"):
    """Crop the image and labels to the labels' foreground, dilated by a
    ball of ``dil_size`` (symmetric border, on ``device``) and padded by
    ``padding``; image voxels outside the mask are zeroed. Returns
    ``(img_crop, labels_crop, slices)`` (reference
    ``cv_nd.crop_to_labels``)."""
    if mask is None:
        mask = labels_img != 0
        if dil_size:
            mask = _morph_nd(mask, filters.ball_footprint(dil_size), True,
                             device_mod.resolve(device)) > 0.5
            mask = mask.cpu().numpy().reshape(labels_img.shape)
    bbox = get_label_bbox(mask.astype(np.int8), 1)
    slices = get_bbox_region(bbox, padding, img.shape)
    img_crop = np.array(img[tuple(slices)])
    labels_crop = np.array(labels_img[tuple(slices)])
    img_crop[~mask[tuple(slices)]] = 0
    return img_crop, labels_crop, slices


def log_clip(log: torch.Tensor, img: np.ndarray, labels_img=None,
             thresh: Optional[float] = None) -> np.ndarray:
    """The LoG ``log`` (a tensor) clipped to the 2nd and 98th percentiles
    of its values in the labels' foreground (or above ``thresh`` in
    ``img``, or everywhere) and inverted, ``vmax - clip(log)``: float64
    as in the reference, the percentiles numpy's of the same float32
    values."""
    if labels_img is not None:
        mask = torch.from_numpy(np.asarray(labels_img) != 0)
    elif thresh is not None:
        mask = torch.from_numpy(np.asarray(img) > thresh)
    else:
        mask = torch.ones(log.shape, dtype=torch.bool)
    vals = log[mask.to(log.device)].cpu().numpy()
    vmin, vmax = np.percentile(vals, (2, 98))
    clipped = torch.clamp(log.to(torch.float64), float(vmin), float(vmax))
    return (float(vmax) - clipped).cpu().numpy()


def laplacian_of_gaussian_img(
        img: np.ndarray, sigma: float = 5, labels_img=None,
        thresh: Optional[float] = None, device="cuda") -> np.ndarray:
    """Laplacian of Gaussian of ``img`` on ``device``, clipped to the 2nd
    and 98th percentiles of the labels' foreground and inverted so edges
    are bright (:func:`log_clip`; reference
    ``cv_nd.laplacian_of_gaussian_img``)."""
    dev = device_mod.resolve(device)
    log = filters.gaussian_laplace(
        torch.from_numpy(np.array(img, np.float32)).to(dev), sigma)
    return log_clip(log, img, labels_img, thresh)


def zero_crossing_t(img: torch.Tensor, filter_size: int = 1
                    ) -> torch.Tensor:
    """:func:`zero_crossing` of a 2D or 3D float32 tensor, on its
    device."""
    vol = img.reshape((1,) * (3 - img.dim()) + tuple(img.shape))
    fp = _as_vol(np.ones((2 * filter_size + 1,) * img.dim(), bool))
    out = (filters.erosion(vol, fp) < 0) & (filters.dilation(vol, fp) > 0)
    return out.reshape(img.shape)


def zero_crossing(img: np.ndarray, filter_size: int = 1,
                  device="cuda") -> np.ndarray:
    """Voxels whose ``(2 filter_size + 1)^ndim`` neighbourhood holds both
    signs: the neighbourhood's minimum below 0 and maximum above (grayscale
    erosion and dilation with a symmetric border, on ``device``;
    reference ``cv_nd.zero_crossing``)."""
    dev = device_mod.resolve(device)
    return zero_crossing_t(torch.from_numpy(
        np.array(img, np.float32)).to(dev), filter_size).cpu().numpy()


def get_selem(ndim: int):
    """Structuring-element factory for the dimensionality: a ball for 3D,
    a disk for 2D (reference ``cv_nd.get_selem``)."""
    return filters.ball_footprint if ndim >= 3 else _disk


def _disk(radius: int) -> np.ndarray:
    n = 2 * radius + 1
    grid = ((np.indices((n, n)) - radius) ** 2).sum(axis=0)
    return grid <= radius * radius


def signed_distance_transform(
        borders: Optional[np.ndarray], mask: Optional[np.ndarray] = None,
        return_indices: bool = False, spacing=None, device="cuda"):
    """Distance to ``borders`` (the mask's perimeter when None), negative
    inside ``mask``, with the nearest border voxel's indices when asked;
    the perimeter and the distance transform run on ``device``."""
    if borders is None:
        borders = perimeter_nd(mask, device=device)
    dist, idx = distance_transform_edt(
        ~borders, sampling=spacing, return_indices=True, device=device)
    if mask is not None:
        dist = np.where(mask, -dist, dist)
    return (dist, idx) if return_indices else dist


def borders_distance(
        borders_orig: np.ndarray, borders_shifted: np.ndarray,
        mask_orig: Optional[np.ndarray] = None, spacing=None,
        filter_size: Optional[int] = None, device="cuda"):
    """Distance of each shifted border voxel from the original borders
    (negative inside ``mask_orig``), 0 elsewhere, on ``device``: the
    original borders are first dilated by a ``filter_size`` cube
    (symmetric border) when given. Returns ``(distances, nearest original
    border indices, the borders used)``."""
    dev = device_mod.resolve(device)
    if filter_size:
        fp = np.ones((filter_size,) * borders_orig.ndim, bool)
        borders_orig = (_morph_nd(borders_orig, fp, True, dev) > 0.5
                        ).cpu().numpy().reshape(borders_orig.shape)
    dist, idx = distance_transform_edt(
        ~borders_orig, sampling=spacing, return_indices=True, device=dev)
    if mask_orig is not None:
        dist = np.where(mask_orig, -dist, dist)
    dist_to_orig = np.zeros_like(dist)
    dist_to_orig[borders_shifted] = dist[borders_shifted]
    return dist_to_orig, idx, borders_orig


def radial_dist(
        borders: np.ndarray, centroid: Sequence[float]) -> np.ndarray:
    """Distance of each border voxel (``argwhere`` order) from
    ``centroid``."""
    coords = np.argwhere(borders)
    return np.linalg.norm(coords - np.asarray(centroid), axis=1)


def radial_dist_map(
        borders: np.ndarray, centroid: Sequence[float]) -> np.ndarray:
    """Image-shaped float64 distances of the border voxels from
    ``centroid``, 0 elsewhere."""
    idx = np.indices(borders.shape).astype(np.float64)
    cent = np.asarray(centroid, np.float64).reshape(
        (-1,) + (1,) * borders.ndim)
    dist = np.sqrt(((idx - cent) ** 2).sum(axis=0))
    out = np.zeros_like(dist)
    out[borders] = dist[borders]
    return out


def radial_dist_diff(radial_orig: np.ndarray, radial_shifted: np.ndarray,
                     indices) -> np.ndarray:
    """Shifted radial distance minus the radial distance at the nearest
    original border voxel (``indices``, as from a distance transform);
    0 where the shifted map has none."""
    dist_at_nearest = radial_orig[tuple(indices)]
    dist_at_nearest[radial_shifted <= 0] = 0
    return np.subtract(radial_shifted, dist_at_nearest)


def remove_bg_from_dil_fg(img: np.ndarray, mask: np.ndarray,
                          selem: np.ndarray, device="cuda") -> None:
    """Zero ``img`` in place outside ``mask`` dilated by ``selem``
    (grayscale dilation, symmetric border, on ``device``)."""
    mask_dil = _morph_nd(mask, selem, True, device_mod.resolve(device)) > 0.5
    img[~mask_dil.cpu().numpy().reshape(mask.shape)] = 0


def filter_adaptive_size(
        mask: np.ndarray, fn_filter, filter_size: int,
        min_filter_size: int = 1, min_size_ratio: float = 0.2,
        name: str = "") -> Tuple[np.ndarray, int]:
    """``fn_filter(mask, structure=ball)`` with the ball shrunk from
    ``filter_size`` until at least ``min_size_ratio`` of the region (and
    one voxel) survives; returns the result and the size used (the mask
    and 0 when none does)."""
    size_orig = int(np.sum(mask))
    out = mask
    used = 0
    for fsize in range(filter_size, min_filter_size - 1, -1):
        selem = get_selem(mask.ndim)(fsize)
        try:
            cand = fn_filter(mask, structure=selem)
        except TypeError:
            cand = fn_filter(mask, selem)
        if np.sum(cand) >= max(min_size_ratio * size_orig, 1):
            out = cand
            used = fsize
            break
    return out, used


def interpolate_contours(
        plane_a: np.ndarray, plane_b: np.ndarray, frac: float,
        device="cuda") -> np.ndarray:
    """The plane a fraction ``frac`` of the way from ``plane_a`` to
    ``plane_b``: the blend of their signed distance maps (distance
    transforms on ``device``) at or below 0."""
    def sdf(mask):
        mask = mask.astype(bool)
        inside = distance_transform_edt(mask, device=device)
        outside = distance_transform_edt(~mask, device=device)
        return np.where(mask, -inside, outside)

    blended = (1 - frac) * sdf(plane_a) + frac * sdf(plane_b)
    return blended <= 0


def interpolate_label_between_planes(
        labels_img: np.ndarray, label_id: int, axis: int,
        bounds: Sequence[int], device="cuda") -> np.ndarray:
    """Fill ``label_id`` into the planes strictly between ``bounds`` along
    ``axis`` by contour interpolation of its two bounding planes."""
    out = np.array(labels_img)
    start, stop = int(bounds[0]), int(bounds[1])

    def get_plane(arr, i):
        sl = [slice(None)] * arr.ndim
        sl[axis] = i
        return arr[tuple(sl)]

    plane_a = get_plane(labels_img, start) == label_id
    plane_b = get_plane(labels_img, stop) == label_id
    n = stop - start
    for i in range(1, n):
        interp = interpolate_contours(plane_a, plane_b, i / n, device)
        dst = get_plane(out, start + i)
        dst[interp] = label_id
    return out


def affine_nd(
        img: np.ndarray, axis_along: int, axis_shift: int,
        shift: Sequence[float], bounds: Sequence[Sequence[int]],
        axis_attach: Optional[int] = None) -> np.ndarray:
    """Graded shear within ``bounds``: each plane along ``axis_along``
    rolled along ``axis_shift`` by a shift interpolated from ``shift[0]``
    to ``shift[1]`` (rounded)."""
    out = np.array(img)
    start, stop = bounds[axis_along]
    n = stop - start
    shifts = np.linspace(shift[0], shift[1], max(n, 1))
    for i, plane_i in enumerate(range(start, stop)):
        sl = [slice(b[0], b[1]) for b in bounds]
        sl[axis_along] = plane_i
        region = out[tuple(sl)]
        out[tuple(sl)] = np.roll(
            region, int(round(shifts[i])),
            axis=axis_shift - (1 if axis_shift > axis_along else 0))
    return out


def angle_indices(
        shape: Sequence[int], offset: Sequence[int], angle_deg: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Indices of a line from ``offset`` at ``angle_deg`` within a 2D
    plane of ``shape``."""
    h, w = shape[:2]
    theta = np.deg2rad(angle_deg)
    length = int(np.hypot(h, w))
    t = np.arange(length)
    ys = (offset[0] + t * np.sin(theta)).astype(int)
    xs = (offset[1] + t * np.cos(theta)).astype(int)
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    return ys[keep], xs[keep]


def rotate90(roi: Optional[np.ndarray], rotate: int,
             axes: Optional[Sequence[int]] = None,
             multichannel: bool = False) -> Optional[np.ndarray]:
    """Rotate by ``rotate`` quarter turns, in the xy plane unless
    ``axes``; negative axes shift down by one for a multichannel image, so
    the channel axis stays last."""
    if roi is None or not rotate:
        return roi
    ax = [-2, -1] if axes is None else list(axes)
    if multichannel:
        ax = [a - 1 if a < 0 else a for a in ax]
    return np.rot90(roi, int(rotate), ax)


class RegionProps:
    """``regionprops``-style properties of a boolean mask: ``bbox``
    (``hi`` exclusive), ``area``, ``centroid`` and the bbox's ``image``."""

    def __init__(self, mask: np.ndarray):
        coords = np.argwhere(mask)
        lo = coords.min(axis=0)
        hi = coords.max(axis=0) + 1
        self.bbox = tuple(int(v) for v in lo) + tuple(int(v) for v in hi)
        self.area = int(len(coords))
        self.centroid = tuple(float(c) for c in coords.mean(axis=0))
        self.image = mask[tuple(
            slice(int(a), int(b)) for a, b in zip(lo, hi))]


def get_label_props(labels_img: np.ndarray, label_id) -> list:
    """``[RegionProps]`` of a label (or of the union of several), ``[]``
    when absent."""
    if isinstance(label_id, (tuple, list, np.ndarray)):
        mask = np.isin(labels_img, label_id)
    else:
        mask = labels_img == label_id
    if not mask.any():
        return []
    return [RegionProps(mask)]


def extract_region(labels_img: np.ndarray, label_id):
    """A label's bounding-box view of the labels and its slices, or
    ``(None, None)``."""
    bbox = get_label_bbox(labels_img, label_id)
    if bbox is None:
        return None, None
    slices = get_bbox_region(bbox)
    return labels_img[tuple(slices)], slices


def meas_region(mask: np.ndarray, res: Sequence[float]):
    """A region's bounding-box size in physical units, its volume and its
    ``get_label_props``."""
    props = get_label_props(mask.astype(np.int8), 1)
    ndim = mask.ndim
    bbox = props[0].bbox
    shape = [bbox[ndim + i] - bbox[i] for i in range(ndim)]
    meas = np.multiply(shape, res)
    vol = float(np.prod(res) * np.sum(mask))
    return meas, vol, props


def calc_compactness(ndim: int, size_borders: float, size_object: float):
    """Classical compactness, ``borders^ndim / size^(ndim - 1)``; NaN
    for an empty object."""
    if size_object <= 0:
        return np.nan
    return size_borders ** ndim / size_object ** (ndim - 1)


def compactness_count(mask_borders: np.ndarray, mask_object: np.ndarray):
    """``(compactness, border voxels, object voxels)`` from voxel
    counts."""
    borders_meas = int(np.sum(mask_borders))
    size_object = int(np.sum(mask_object))
    compact = calc_compactness(
        mask_object.ndim, borders_meas, size_object)
    return compact, borders_meas, size_object


def get_thresholded_regionprops(img_np: np.ndarray, threshold=10,
                                sort_reverse: bool = False,
                                min_size: int = 200) -> list:
    """``(RegionProps, area)`` of each connected component of the image
    above ``threshold`` (components under ``min_size`` voxels dropped
    first), sorted by area; labelled on the host
    (``scipy.ndimage.label``)."""
    thresholded = img_np
    if threshold is not None:
        thresholded = img_np > threshold
        labeled, n = scipy_ndi.label(thresholded)
        counts = np.bincount(labeled.ravel())
        small = np.flatnonzero(counts < min_size)
        thresholded = thresholded & ~np.isin(labeled, small)
    labeled, n = scipy_ndi.label(thresholded)
    props = []
    for lid in range(1, n + 1):
        prop = RegionProps(labeled == lid)
        props.append((prop, prop.area))
    return sorted(props, key=lambda p: p[1], reverse=sort_reverse)


def surface_net_mesh(
        vol: np.ndarray, level: float,
        smooth_iters: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Isosurface mesh by naive surface nets, on the host: one vertex at
    the centre of each cell whose eight corners straddle ``level``, two
    triangles per sign-changing voxel edge between four such cells
    (quads in ``argwhere`` order, corners 11, 10, 01, 00), then
    ``smooth_iters`` Laplacian steps toward the face neighbours' mean
    (``np.add.at`` in float64). Returns ``(V, 3)`` float z,y,x vertices
    and ``(F, 3)`` int64 triangles."""
    fg = np.asarray(vol) > level
    z, y, x = fg.shape
    corners = np.zeros((z - 1, y - 1, x - 1), np.int8)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                corners += fg[dz:z - 1 + dz, dy:y - 1 + dy,
                              dx:x - 1 + dx]
    active = (corners > 0) & (corners < 8)
    cell_idx = np.full(active.shape, -1, np.int64)
    acts = np.argwhere(active)
    if not len(acts):
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    cell_idx[tuple(acts.T)] = np.arange(len(acts))
    verts = acts.astype(float) + 0.5

    faces = []
    for ax in range(3):
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[ax] = slice(0, fg.shape[ax] - 1)
        sl_hi[ax] = slice(1, fg.shape[ax])
        crossing = fg[tuple(sl_lo)] != fg[tuple(sl_hi)]
        o1, o2 = [a for a in range(3) if a != ax]
        # interior edges only: all four adjacent cells must exist
        edges = np.argwhere(crossing)
        keep = (edges[:, o1] >= 1) & (edges[:, o1] <= crossing.shape[o1] - 1)
        keep &= (edges[:, o2] >= 1) & (edges[:, o2] <= crossing.shape[o2] - 1)
        keep &= edges[:, ax] <= active.shape[ax] - 1
        edges = edges[keep]
        if not len(edges):
            continue
        quad = []
        for d1 in (1, 0):
            for d2 in (1, 0):
                c = edges.copy()
                c[:, o1] -= d1
                c[:, o2] -= d2
                in_rng = np.all(
                    (c >= 0) & (c < np.asarray(active.shape)), axis=1)
                ids = np.full(len(edges), -1, np.int64)
                ids[in_rng] = cell_idx[tuple(c[in_rng].T)]
                quad.append(ids)
        q = np.stack(quad, axis=1)      # (E, 4): (11, 10, 01, 00)
        q = q[np.all(q >= 0, axis=1)]
        # two triangles per quad: (11, 10, 00) and (11, 00, 01)
        faces.append(np.stack([q[:, 0], q[:, 1], q[:, 3]], axis=1))
        faces.append(np.stack([q[:, 0], q[:, 3], q[:, 2]], axis=1))
    if not faces:
        return verts, np.zeros((0, 3), np.int64)
    faces_arr = np.concatenate(faces)

    for _ in range(int(smooth_iters)):
        acc = np.zeros_like(verts)
        cnt = np.zeros(len(verts))
        for i in range(3):
            j = (i + 1) % 3
            np.add.at(acc, faces_arr[:, i], verts[faces_arr[:, j]])
            np.add.at(cnt, faces_arr[:, i], 1)
        mask = cnt > 0
        verts[mask] = 0.5 * verts[mask] + 0.5 * (
            acc[mask] / cnt[mask, None])
    return verts, faces_arr
