"""ND image operations for label curation on PyTorch.

Port of what registration's curation needs from
``magellanmapper_tpu/cv/cv_nd.py``: the jump-flooding Euclidean distance
transform with nearest-seed indices, in-painting from those indices, and
carving a foreground by threshold with small holes filled.

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
from magellanmapper_torch.ops import preproc


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
