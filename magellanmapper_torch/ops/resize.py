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

:func:`resize_sharded` runs the same passes with the volume dealt over
the ranks of a mesh.
"""

from __future__ import annotations

import functools
from typing import Sequence, Union

import numpy as np
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.parallel import comm, mesh as mesh_mod


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


def resize_sharded(vol, shape: Sequence[int], mesh, order: int = 1,
                   axis_name=None, device="cuda") -> torch.Tensor:
    """:func:`resize` with the volume dealt over the ranks of a mesh
    (``resize.py:39-94``).

    The resize is separable, so it runs as three 1D passes with one
    reshard between them: the z and y passes run on this rank's x-slab
    (``axis_name``'s share of x; default the largest mesh axis), one
    all-to-all hands each rank its z-slab of every x-slab, and the x pass
    runs on the z-slab. The z-slabs are then gathered, so every rank
    returns the whole resized volume on ``device``. On fewer than three
    spatial dims it is the plain :func:`resize`."""
    dev = device_mod.resolve(device)
    vol = (vol if torch.is_tensor(vol) else torch.from_numpy(
        np.array(vol))).to(dev)
    out_shape = tuple(int(s) for s in shape)
    if len(out_shape) != 3 or vol.dim() < 3:
        return resize(vol, shape, order=order)
    if axis_name is None:
        sizes = mesh_mod.shape(mesh)
        axis_name = max(sizes, key=sizes.get)
    n = mesh_mod.axis_size(mesh, axis_name)
    me = mesh_mod.axis_index(mesh, axis_name)
    x0, x1 = mesh_mod.shard_bounds(vol.shape[2], n, me)
    local = resize(vol[:, :, x0:x1], out_shape[:2], order=order)
    z_bounds = [mesh_mod.shard_bounds(out_shape[0], n, j) for j in range(n)]
    parts = comm.all_to_all(
        [local[a:b].contiguous() for a, b in z_bounds], mesh, axis_name)
    z_slab = resize(torch.cat(parts, dim=2),
                    (z_bounds[me][1] - z_bounds[me][0],) + out_shape[1:],
                    order=order)
    # gather the z-slabs, each padded to the longest
    longest = z_bounds[0][1] - z_bounds[0][0]
    pad = z_slab.new_zeros((longest - z_slab.shape[0],) + z_slab.shape[1:])
    whole = comm.all_gather(torch.cat([z_slab, pad]), mesh, axis_name)
    return torch.cat([whole[j * longest:j * longest + b - a]
                      for j, (a, b) in enumerate(z_bounds)]).contiguous()


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
