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
crossings, exteriors, and surface area and compactness (host copies).

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


def label_bboxes(labels: torch.Tensor, ids: torch.Tensor) -> np.ndarray:
    """Bounding boxes ``(len(ids), 2 * ndim)`` (``[lo..., hi...]``, ``hi``
    exclusive) of every label in the sorted ``ids`` in one pass over the
    labels image on its device; an absent ID's row is all 0."""
    flat_labels = labels.reshape(-1)
    codes = torch.searchsorted(ids, flat_labels).clamp_max(len(ids) - 1)
    found = ids[codes] == flat_labels
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
