"""ND image operations on PyTorch.

Port of what registration's curation and the specimen pipeline need from
``magellanmapper_tpu/cv/cv_nd.py``: the jump-flooding Euclidean distance
transform with nearest-seed indices, in-painting from those indices,
carving a foreground by threshold with small holes filled, perimeters (an
erosion on the device), the blob heat map (an integer ``bincount`` on the
device), rescaling through ``ops.resize``, and the host-side plane
rotation (scipy) and intensity remap, as in the reference.

The distance transform keeps the reference's 1+JFA schedule (halving
steps from the next power of two, then one more pass at 1), its offset
order, and the strict ``<`` that lets a candidate replace the nearest
seed, so the nearest-seed indices (integers) equal the reference's and so
does :func:`in_paint`. Connected components stay on the host
(``scipy.ndimage.label``), as in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

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
    # the port's erosion acts on the last three axes: a 2D mask gets a
    # leading axis of 1 and a footprint of one plane
    vol = mask.reshape((1,) * (3 - mask.ndim) + mask.shape)
    fp = np.ones((1,) * (3 - mask.ndim) + (3,) * mask.ndim, bool)
    eroded = filters.erosion(
        torch.from_numpy(vol.astype(np.float32)).to(dev), fp) > 0.5
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
