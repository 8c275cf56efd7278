"""3D Laplacian-of-Gaussian blob detection of one block on PyTorch.

Port of ``magellanmapper_tpu/cv/detector.py``: the pure-numpy helpers are
copied, and :func:`blob_log` runs the LoG
pyramid (fp32 GEMMs), peak finding (kernel K1) and sphere-overlap
pruning (kernel K3) on the device of its input. :func:`blob_log_multi`
runs a threshold sweep on one pyramid through the unfused peak route
(kernel K2), then K3 per threshold.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from magellanmapper_torch.cv import blobs as blobs_mod
from magellanmapper_torch.ops import filters, peaks

#: overlap factor for block halos (reference ``detector.py:41``).
OVERLAP_FACTOR = 5


def calc_scaling_factor(resolutions: Sequence[float]) -> np.ndarray:
    """Pixels-per-um factor, ``1 / resolutions`` in z,y,x."""
    res = np.asarray(resolutions, dtype=float)
    if res.ndim > 1:
        res = res[0]
    return 1.0 / res


def calc_overlap(
        resolutions: Sequence[float], factor: Optional[float] = None
) -> np.ndarray:
    """Block halo width in px per axis."""
    if factor is None:
        factor = OVERLAP_FACTOR
    return np.ceil(calc_scaling_factor(resolutions) * factor).astype(int)


def sigma_list(
        min_sigma: float, max_sigma: float, num_sigma: int) -> np.ndarray:
    """Linearly spaced LoG scales (skimage ``blob_log`` semantics)."""
    if num_sigma <= 1:
        return np.asarray([float(min_sigma)])
    return np.linspace(float(min_sigma), float(max_sigma), int(num_sigma))


def blob_log(
        roi: torch.Tensor, sigmas: Sequence[float], threshold: float,
        overlap: float, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """LoG blob detection on a single-channel ``(Z, Y, X)`` block.

    Returns ``blobs`` ``(capacity, 4)`` float32 rows ``z, y, x, sigma``,
    ``valid`` ``(capacity,)`` bool, and the PRE-prune peak count: pruning
    runs after the capacity cut, so a truncated block can show fewer valid
    rows than ``capacity``, and overflow retries gate on this count.
    """
    roi = roi.to(torch.float32)
    cube = filters.log_pyramid(roi, sigmas)
    coords4, _, count = peaks.find_peaks(cube, threshold, capacity)
    valid = torch.arange(capacity, device=roi.device) < count
    sig = filters.sigma_tensor(
        tuple(float(s) for s in sigmas), roi.device)[coords4[:, 0].long()]
    coords = coords4[:, 1:].to(torch.float32).contiguous()
    valid = peaks.prune_overlapping_blobs(
        coords, sig, valid, overlap, ndim=roi.dim())
    return torch.cat([coords, sig[:, None]], dim=1), valid, count


def blob_log_multi(
        roi: torch.Tensor, sigmas: Sequence[float],
        thresholds: Sequence[float], overlap: float, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LoG detection at K thresholds sharing one LoG pyramid
    (``detector.py:96-131``).

    The local-maximum mask is computed once; each threshold masks it,
    and the K masked fields go through one launch of K2
    (``peaks.find_peaks_unfused``). Per threshold the peaks' sigmas are
    looked up and K3 prunes overlapping spheres. Thresholds are rounded
    to float32, as the reference's traced threshold vector is.

    Returns ``(K, capacity, 4)`` float32 rows ``z, y, x, sigma`` and
    ``(K, capacity)`` validity. A row is valid when it is within the
    peak count AND its value is finite: a 128-lane group holding more
    than 8 peaks yields only 8, and the reference (``:124``) keeps the
    missing ones as valid rows at the origin.
    """
    roi = roi.to(torch.float32)
    sigmas = tuple(float(s) for s in sigmas)
    cube = filters.log_pyramid(roi, sigmas)
    sig_lut = filters.sigma_tensor(sigmas, roi.device)
    ths = [float(t) for t in np.asarray(thresholds, np.float32)]
    first = torch.arange(capacity, device=roi.device)
    rows, valids = [], []
    for coords4, values, count in peaks.find_peaks_unfused(
            cube, ths, capacity):
        valid = (first < count) & torch.isfinite(values)
        sig = sig_lut[coords4[:, 0].long()]
        coords = coords4[:, 1:].to(torch.float32).contiguous()
        valid = peaks.prune_overlapping_blobs(
            coords, sig, valid, overlap, ndim=roi.dim())
        rows.append(torch.cat([coords, sig[:, None]], dim=1))
        valids.append(valid)
    return torch.stack(rows), torch.stack(valids)


def remove_close_blobs(
        blobs: np.ndarray, blobs_master: np.ndarray, tol: Sequence[float]
) -> Tuple[np.ndarray, np.ndarray]:
    """Prune blobs within ``tol`` of any master blob; averages abs coords
    (copy of the reference's host helper)."""
    if len(blobs) < 1 or len(blobs_master) < 1:
        return blobs, blobs_master
    diffs = np.abs(blobs_master[:, None, :3] - blobs[None, :, :3])
    close_master, close = np.nonzero((diffs <= np.asarray(tol)).all(2))
    pruned = np.delete(blobs, close, axis=0)
    if len(close) > 0:
        B = blobs_mod.Blobs
        abs_between = np.around((
            B.get_blob_abs_coords(blobs_master[close_master])
            + B.get_blob_abs_coords(blobs[close])) / 2)
        blobs_master[close_master] = B.set_blob_abs_coords(
            blobs_master[close_master], abs_between)
    return pruned, blobs_master
