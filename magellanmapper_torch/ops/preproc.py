"""ROI preprocessing for blob detection on PyTorch.

Port of ``magellanmapper_tpu/ops/preproc.py`` (``saturate``, ``denoise``,
``tv_chambolle``, ``otsu_threshold``, ``spectral_unmix``). ``saturate``,
``denoise`` and ``tv_chambolle`` act on the last three axes; leading
axes are a batch, so a stack of denoise tiles is preprocessed tile by
tile in one call. Percentiles come from kernel K4
(:mod:`magellanmapper_torch.kernels.tile_percentiles`), which computes
``np.percentile``'s linear interpolation exactly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
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


def _histogram(img: torch.Tensor, nbins: int):
    """``(counts, lo, span)``: exact int64 counts of ``img``'s voxels in
    ``nbins`` bins over ``[lo, lo + span]`` (the reference's bin index,
    ``(x - lo) / span * nbins`` in float32, truncated and clipped), on
    ``img``'s device."""
    flat = img.reshape(-1).to(torch.float32)
    lo, hi = torch.aminmax(flat)
    span = torch.where(hi > lo, hi - lo, 1.0)
    idx = torch.clamp(((flat - lo) / span * nbins).to(torch.int64),
                      0, nbins - 1)
    return torch.bincount(idx, minlength=nbins), lo, span


def otsu_threshold(img: torch.Tensor, nbins: int = 256) -> np.float32:
    """Otsu threshold of ``img`` from a ``nbins`` histogram over
    ``[min, max]``, the reference's bin arithmetic in float32.

    The voxels are counted on ``img``'s device by :func:`_histogram`; the
    between-class variances of the ``nbins`` counts are then formed on the
    host in float32, so the card and the CPU choose the same bin. The
    reference counts with float32 additions, which stop at 2^24 in a bin
    (ROADMAP §3); these counts are exact.
    """
    counts, lo_t, span_t = _histogram(img, nbins)
    f32 = np.float32
    counts = counts.cpu().numpy().astype(f32)
    lo, span = f32(lo_t.item()), f32(span_t.item())
    centers = lo + (np.arange(nbins, dtype=f32) + f32(0.5)) / f32(nbins) \
        * span
    w1 = np.cumsum(counts, dtype=f32)
    w2 = w1[-1] - w1
    s1 = np.cumsum(counts * centers, dtype=f32)
    m1 = s1 / np.maximum(w1, f32(1))
    m2 = (s1[-1] - s1) / np.maximum(w2, f32(1))
    var_between = w1 * w2 * (m1 - m2) ** 2
    var_between = np.where((w1 > 0) & (w2 > 0), var_between, -np.inf)
    return centers[int(np.argmax(var_between))]


def spectral_unmix(roi_chl: torch.Tensor, roi_subtract: torch.Tensor,
                   factor: float) -> torch.Tensor:
    """Subtract ``factor`` times another channel, clamped at zero
    (``preproc.py:141-148``)."""
    return torch.clamp_min(roi_chl - factor * roi_subtract, 0.0)
