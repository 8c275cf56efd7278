"""ROI preprocessing for blob detection on PyTorch.

Port of ``magellanmapper_tpu/ops/preproc.py`` (``saturate``, ``denoise``,
``tv_chambolle``). Every function acts on the last three axes; leading
axes are a batch, so a stack of denoise tiles is preprocessed tile by
tile in one call. Percentiles come from kernel K4
(:mod:`magellanmapper_torch.kernels.tile_percentiles`), which computes
``np.percentile``'s linear interpolation exactly.
"""

from __future__ import annotations

from typing import Optional

import torch

from magellanmapper_torch.kernels.tile_percentiles import tile_percentiles
from magellanmapper_torch.ops import filters

_SPATIAL = (-3, -2, -1)


def saturate(
        roi: torch.Tensor, clip_vmin: float, clip_vmax: float,
        max_thresh: Optional[float] = None) -> torch.Tensor:
    """Percentile-clip and rescale each volume of the batch to [0, 1].

    The upper bound is raised to ``max_thresh`` (the channel's near-max
    times ``max_thresh_factor``) where the percentile falls below it;
    degenerate volumes (lower bound >= upper) pass through unchanged.
    Returns float32.
    """
    batch = roi.shape[:-3]
    flat = roi.reshape(-1, roi.shape[-3] * roi.shape[-2] * roi.shape[-1])
    if flat.dtype not in (torch.uint8, torch.uint16, torch.float32):
        flat = flat.to(torch.float32)
    pct = tile_percentiles(flat.contiguous(), clip_vmin, clip_vmax)
    vmin = pct[:, 0].reshape(batch + (1, 1, 1))
    vmax = pct[:, 1].reshape(batch + (1, 1, 1))
    if max_thresh is not None:
        vmax = torch.clamp_min(vmax, float(max_thresh))
    roi = roi.to(torch.float32)
    degenerate = vmin >= vmax
    span = torch.where(degenerate, 1.0, vmax - vmin)
    scaled = (torch.clamp(roi, vmin, vmax) - vmin) / span
    return torch.where(degenerate, roi, scaled)


def denoise(
        roi: torch.Tensor, clip_min: float, clip_max: float,
        tot_var_denoise: Optional[float] = None,
        unsharp_strength: float = 0.0,
        erosion_threshold: float = 0.0) -> torch.Tensor:
    """Clip, then optional total-variation denoising, unsharp masking and
    erosion; the erosion applies only to volumes whose mean before the
    clip exceeds ``erosion_threshold`` (``plot_3d.denoise_roi``)."""
    roi = roi.to(torch.float32)
    saturated_mean = roi.mean(dim=_SPATIAL, keepdim=True)
    out = torch.clamp(roi, clip_min, clip_max)
    if tot_var_denoise:
        weight = 0.1 if tot_var_denoise is True else float(tot_var_denoise)
        out = tv_chambolle(out, weight=weight)
    if unsharp_strength:
        # skimage gaussian defaults: sigma=blur_size(8), mode='nearest'
        blurred = filters.gaussian_filter(out, 8.0, mode="nearest")
        out = 2.0 * out - unsharp_strength * blurred
    if erosion_threshold:
        eroded = filters.erosion(out, filters.octahedron_footprint(1))
        out = torch.where(saturated_mean > erosion_threshold, eroded, out)
    return out


def tv_chambolle(
        img: torch.Tensor, weight: float = 0.1,
        num_iter: int = 10) -> torch.Tensor:
    """Total-variation denoising (Chambolle 2004 dual projection) with a
    fixed iteration count, over the last three axes."""
    img = img.to(torch.float32)
    tau = 1.0 / 2.0 ** len(_SPATIAL)

    def grad(u):
        return torch.stack([
            torch.cat([torch.diff(u, dim=ax),
                       torch.zeros_like(u.narrow(ax, 0, 1))], dim=ax)
            for ax in _SPATIAL])

    def div(p):
        out = torch.zeros_like(img)
        for i, ax in enumerate(_SPATIAL):
            pi = p[i]
            n = pi.shape[ax]
            first = pi.narrow(ax, 0, 1)
            mid = torch.diff(pi.narrow(ax, 0, n - 1), dim=ax)
            last = -pi.narrow(ax, n - 2, 1)
            out = out + torch.cat([first, mid, last], dim=ax)
        return out

    p = torch.zeros((len(_SPATIAL),) + img.shape, dtype=img.dtype,
                    device=img.device)
    for _ in range(num_iter):
        g = grad(img + weight * div(p))
        norm = torch.sqrt(torch.sum(g * g, dim=0, keepdim=True))
        p = (p + (tau / weight) * g) / (1.0 + (tau / weight) * norm)
    return img + weight * div(p)
