"""K3: sphere-overlap pruning of a fixed-capacity blob buffer.

Replaces ``prune_overlap_pallas`` (``magellanmapper_tpu/ops/
pallas_kernels.py:87``). Row ``i`` of ``K`` blobs loses when another valid
blob ``j`` overlaps it by more than the threshold (lens volume over the
smaller sphere, radius ``sigma * sqrt(ndim)``) and ``j`` wins: larger
radius, or equal radius and ``i < j``. The result is the new validity
mask, and kernel and plain version must agree on it bit for bit, so both
take coordinate differences and round every step as the jnp reference
(``ops/peaks.py:228-245,315-329``) does. The CUDA kernel
(``csrc/prune_overlap.cu``) first compacts the valid rows on the card,
then gives each valid row a warp; the win rule sends each pair of valid
blobs to its loser's row only, where ``r1`` is the row's own radius as
in the plain version.
"""

from __future__ import annotations

import math

import torch

from magellanmapper_torch import device as dev
from magellanmapper_torch.kernels import _build

SOURCE = "magellanmapper_torch/csrc/prune_overlap.cu"
REPLACES = "magellanmapper_tpu/ops/pallas_kernels.py:87"

_SPHERE = 4.0 / 3.0 * math.pi


def _sqrt_ndim(ndim: int) -> float:
    """``sqrt(ndim)`` rounded as the reference's f32 ``jnp.sqrt``."""
    return float(torch.sqrt(torch.tensor(float(ndim), dtype=torch.float32)))


def sphere_overlap_fraction(
        d: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Intersection volume of two spheres over the smaller one's volume:
    0 beyond contact, 1 when one contains the other."""
    rmin = torch.minimum(r1, r2)
    d_safe = torch.clamp_min(d, 1e-12)
    rsum = r1 + r2
    a = rsum - d_safe
    rdiff = r1 - r2
    b = d_safe * d_safe + 2.0 * d_safe * rsum - 3.0 * (rdiff * rdiff)
    lens = math.pi * (a * a) * b / (12.0 * d_safe)
    vol_min = _SPHERE * (rmin * (rmin * rmin))
    frac = lens / torch.clamp_min(vol_min, 1e-12)
    frac = torch.where(d <= torch.abs(rdiff), 1.0, frac)
    return torch.where(d >= rsum, 0.0, frac)


def prune_overlap_plain(
        coords: torch.Tensor, sigmas: torch.Tensor, valid: torch.Tensor,
        overlap_thresh: float, ndim: int = 3) -> torch.Tensor:
    """Plain PyTorch version: the broadcast of every pair of valid rows
    (invalid rows neither lose nor win, so they are left out first; the
    rows keep their order, which the tie rule reads)."""
    valid = valid.to(torch.bool)
    rows = torch.nonzero(valid).squeeze(1)
    pos = coords[rows].to(torch.float32)
    r = sigmas[rows].to(torch.float32) * _sqrt_ndim(ndim)
    diffs = [pos[:, None, ax] - pos[None, :, ax]
             for ax in range(pos.shape[1])]
    d2 = diffs[0] * diffs[0]
    for diff in diffs[1:]:
        d2 = d2 + diff * diff
    frac = sphere_overlap_fraction(torch.sqrt(d2), r[:, None], r[None, :])
    idx = torch.arange(len(rows), device=pos.device)
    overlapping = (idx[:, None] != idx) & (frac > overlap_thresh)
    loses = overlapping & (
        (r[None, :] > r[:, None])
        | ((r[None, :] == r[:, None]) & (idx[:, None] < idx[None, :])))
    out = torch.zeros_like(valid)
    out[rows] = ~torch.any(loses, dim=1)
    return out


def _launch(coords, sigmas, valid, overlap_thresh, ndim):
    k = coords.shape[0]
    if coords.dim() != 2 or coords.shape[1] != 3:
        raise ValueError(
            f"prune_overlap kernel takes (K, 3) coords, got "
            f"{tuple(coords.shape)}")
    if sigmas.shape != (k,) or valid.shape != (k,):
        raise ValueError("sigmas and valid must be (K,) like coords")
    if (coords.dtype, sigmas.dtype, valid.dtype) != (
            torch.float32, torch.float32, torch.bool):
        raise TypeError(
            "prune_overlap kernel takes float32 coords and sigmas and a "
            "bool mask")
    for t in (coords, sigmas, valid):
        if not t.is_contiguous() or t.device != coords.device:
            raise ValueError(
                "prune_overlap kernel needs contiguous inputs on one device")
    if k >= 2 ** 31:
        raise ValueError(f"too many blobs: {k}")
    out = torch.empty(k, dtype=torch.bool, device=coords.device)
    # the compacted valid rows (float4 each), their indices and count
    scratch = torch.empty(k * 20 + 4, dtype=torch.uint8, device=coords.device)
    lib = _build.library()
    with _build.on_device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mm_prune_overlap(
            coords.data_ptr(), sigmas.data_ptr(), valid.data_ptr(), k,
            _sqrt_ndim(ndim), float(overlap_thresh), out.data_ptr(),
            scratch.data_ptr(), stream)
    _build.check(err, "mm_prune_overlap")
    dev.count_launch("prune_overlap")
    return out


def prune_overlap(
        coords: torch.Tensor, sigmas: torch.Tensor, valid: torch.Tensor,
        overlap_thresh: float, ndim: int = 3) -> torch.Tensor:
    """New ``(K,)`` validity mask after sphere-overlap pruning.

    A CUDA tensor runs the kernel (``(K, 3)`` float32 coords, float32
    sigmas, bool mask, all contiguous), a CPU tensor the plain version.
    """
    if coords.device.type == "cuda":
        return _launch(coords, sigmas, valid, overlap_thresh, ndim)
    if coords.device.type == "cpu":
        return prune_overlap_plain(
            coords, sigmas, valid, overlap_thresh, ndim)
    raise ValueError(f"unsupported device {coords.device}")
