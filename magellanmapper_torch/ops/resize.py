"""Resampling on PyTorch.

Port of ``magellanmapper_tpu/ops/resize.py`` (``calc_isotropic_factor``,
``resize``, ``rescale``, ``make_isotropic``), which resizes with
``jax.image.resize``. Order 1 is that function's ``"linear"`` method: per
changed axis a weight matrix of ``scale_and_translate`` (half-pixel
centres, a triangle kernel widened by the shrink factor when an axis
shrinks, since ``antialias`` defaults to True, columns normalised), applied
as one fp32 product per axis. ``F.interpolate`` has no such antialiasing
in 3D, so it is not used. Order 0 is ``"nearest"``: the source index of
output ``i`` is ``floor((i + 0.5) * in / out)`` in float32, and the input
dtype is kept (labels).

``resize_sharded`` is not ported (ROADMAP queue item 10).
"""

from __future__ import annotations

import functools
from typing import Sequence, Union

import numpy as np
import torch


def calc_isotropic_factor(
        scale: Union[float, Sequence[float]],
        res: Sequence[float]) -> np.ndarray:
    """Per-axis resize factor making ``res`` isotropic, times ``scale``."""
    res = np.asarray(res, dtype=float)
    return np.divide(res, res.min()) * np.asarray(scale, dtype=float)


@functools.lru_cache(maxsize=64)
def _linear_weights(m: int, n: int) -> np.ndarray:
    """``(m, n)`` float32 weights taking ``m`` samples to ``n``, with
    ``jax.image.scale_and_translate``'s float32 arithmetic (translation 0,
    antialias on)."""
    f32 = np.float32
    inv_scale = 1.0 / (float(n) / float(m))
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(n, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0), f32(1) - x)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


def _nearest_index(m: int, n: int) -> np.ndarray:
    """Source index of each of ``n`` outputs from ``m`` inputs."""
    f32 = np.float32
    pos = (np.arange(n, dtype=f32) + f32(0.5)) * f32(m) / f32(n)
    return np.floor(pos).astype(np.int64)


def resize(vol: torch.Tensor, shape: Sequence[int],
           order: int = 1) -> torch.Tensor:
    """Resize the leading ``len(shape)`` axes of ``vol`` to ``shape`` on
    its device; 0 = nearest (keeps the dtype), 1 = linear (float32)."""
    out = vol if order == 0 else vol.to(torch.float32)
    for ax, n in enumerate(int(s) for s in shape):
        m = out.shape[ax]
        if m == n:
            continue
        if order == 0:
            idx = torch.from_numpy(_nearest_index(m, n)).to(out.device)
            out = torch.index_select(out, ax, idx)
        else:
            w = torch.from_numpy(_linear_weights(m, n)).to(out.device)
            out = torch.movedim(
                torch.tensordot(out, w, dims=([ax], [0])), -1, ax)
    return out.contiguous()


def rescale(vol: torch.Tensor, factor: Union[float, Sequence[float]],
            order: int = 1) -> torch.Tensor:
    """Rescale spatial axes by ``factor`` (scalar or per-axis)."""
    factor = np.atleast_1d(np.asarray(factor, dtype=float))
    if factor.size == 1:
        factor = np.repeat(factor, min(vol.dim(), 3))
    shape = [int(s * f) for s, f in zip(vol.shape, factor)]
    return resize(vol, shape, order=order)


def make_isotropic(
        vol: torch.Tensor, scale: Union[float, Sequence[float]],
        res: Sequence[float], order: int = 1) -> torch.Tensor:
    """Resample so voxel spacing becomes isotropic (times ``scale``)."""
    factor = calc_isotropic_factor(scale, res)
    shape = (np.asarray(vol.shape[:3]) * factor).astype(int)
    return resize(vol, shape, order=order)
