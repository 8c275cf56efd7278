"""Registration similarity metrics on PyTorch (differentiable).

Port of ``magellanmapper_tpu/atlas/metrics.py``: normalised
cross-correlation, Mattes mutual information over a cubic-Parzen joint
histogram (one ``(nbins, N) @ (N, nbins)`` fp32 product, TF32 off), the
minimisable loss for an Elastix metric name, and the Dice overlap of
Otsu-thresholded foregrounds.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.ops import preproc


def ncc(fixed: torch.Tensor, moving: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalized cross-correlation in [-1, 1]."""
    f = fixed.reshape(-1)
    m = moving.reshape(-1)
    if mask is not None:
        w = mask.reshape(-1).to(f.dtype)
        n = torch.clamp_min(w.sum(), 1.0)
        fm = (f * w).sum() / n
        mm = (m * w).sum() / n
        fc = (f - fm) * w
        mc = (m - mm) * w
    else:
        fc = f - f.mean()
        mc = m - m.mean()
    num = (fc * mc).sum()
    den = torch.sqrt((fc * fc).sum() * (mc * mc).sum()) + 1e-8
    return num / den


def _parzen_weights(x: torch.Tensor, nbins: int) -> torch.Tensor:
    """Cubic B-spline Parzen window soft binning -> ``(N, nbins)``; ``x``
    is intensity scaled into bin space ``[0, nbins-1]``."""
    bins = torch.arange(nbins, dtype=torch.float32, device=x.device)
    au = torch.abs(x[:, None] - bins[None, :])
    return torch.where(
        au < 1.0, (4 - 6 * au ** 2 + 3 * au ** 3) / 6,
        torch.where(au < 2.0, (2 - au) ** 3 / 6, torch.zeros_like(au)))


def mattes_mi(fixed: torch.Tensor, moving: torch.Tensor, nbins: int = 32,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mattes mutual information via a soft joint histogram."""
    f = fixed.reshape(-1).to(torch.float32)
    m = moving.reshape(-1).to(torch.float32)

    def to_bins(x):
        # amin/amax share the gradient among ties, as jnp.min/max do
        lo, hi = torch.amin(x), torch.amax(x)
        return (x - lo) / torch.clamp_min(hi - lo, 1e-8) * (nbins - 1)

    wf = _parzen_weights(to_bins(f), nbins)
    wm = _parzen_weights(to_bins(m), nbins)
    if mask is not None:
        wf = wf * mask.reshape(-1, 1)
    joint = wf.T @ wm
    joint = joint / torch.clamp_min(joint.sum(), 1e-8)
    pf = joint.sum(dim=1, keepdim=True)
    pm = joint.sum(dim=0, keepdim=True)
    ratio = joint / torch.clamp_min(pf * pm, 1e-12)
    return torch.sum(joint * torch.log(torch.clamp_min(ratio, 1e-12)))


def metric_loss(name: str, fixed: torch.Tensor, moving: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Minimizable loss for an Elastix metric name."""
    if name in ("AdvancedMattesMutualInformation", "mi"):
        return -mattes_mi(fixed, moving, mask=mask)
    if name in ("AdvancedNormalizedCorrelation", "ncc"):
        return -ncc(fixed, moving, mask=mask)
    if name in ("mse", "AdvancedMeanSquares"):
        if mask is not None:
            w = mask.to(fixed.dtype)
            return torch.sum(w * (fixed - moving) ** 2) / torch.clamp_min(
                w.sum(), 1.0)
        return torch.mean((fixed - moving) ** 2)
    raise ValueError(f"unknown metric: {name}")


def dice(mask_a: torch.Tensor, mask_b: torch.Tensor) -> torch.Tensor:
    """Dice similarity coefficient of two boolean masks; the voxels are
    counted as integers."""
    inter = torch.logical_and(mask_a, mask_b).sum().to(torch.float32)
    total = (mask_a.sum() + mask_b.sum()).to(torch.float32)
    return 2.0 * inter / torch.clamp_min(total, 1e-8)


def measure_overlap(img_a, img_b, thresh_a: Optional[float] = None,
                    thresh_b: Optional[float] = None,
                    device="cuda") -> float:
    """DSC of the foregrounds of two intensity images, each above its
    threshold (Otsu's when None). Arrays go to ``device``; tensors stay
    where they are."""
    def to_mask(img, thresh):
        arr = img.to(torch.float32) if torch.is_tensor(img) else \
            torch.from_numpy(np.array(img, np.float32)).to(
                device_mod.resolve(device))
        if thresh is None:
            thresh = float(preproc.otsu_threshold(arr))
        return arr > thresh

    return float(dice(to_mask(img_a, thresh_a), to_mask(img_b, thresh_b)))
