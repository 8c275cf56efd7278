"""Spatial transform models for registration on PyTorch.

Port of ``magellanmapper_tpu/atlas/transform.py``. Transforms map
fixed-image voxel coordinates to moving-image voxel coordinates, and
resampling takes the moving image at those coordinates. Parameters are
dicts of float32 tensors on one device: ``t`` (3,), ``W`` (3, 3) (the
affine's linear part minus the identity) and ``grid`` (3, gz, gy, gx), the
B-spline control lattice.

:func:`sample_volume` is ``map_coordinates(mode="constant", cval=0)``
written out as a gather, not ``F.grid_sample``:

- order 1 gathers the 8 corners around each point, with weights from
  ``floor``; a corner outside the volume adds 0, and the corners are
  weighted and summed in the reference's order. Autograd then gives the
  reference's gradient with respect to the coordinates: at an integer
  coordinate ``i`` it is ``v[i+1] - v[i]``, and ``0 - v[i]`` at the upper
  edge;
- order 0 rounds half away from zero (``grid_sample``'s nearest mode
  rounds half to even) and gathers in the volume's own dtype, so integer
  labels keep every bit.

The B-spline products run in fp32 with TF32 off (``device.py``);
:func:`_bspline_basis` builds in float64 and casts to float32, as the
reference does.
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def identity_params(kind: str, grid_shape=None, device="cuda") -> Params:
    """Initial (identity) parameters for a transform stage."""
    zeros = functools.partial(torch.zeros, dtype=torch.float32,
                              device=device)
    if kind == "translation":
        return {"t": zeros(3)}
    if kind == "affine":
        return {"W": zeros((3, 3)), "t": zeros(3)}
    if kind == "bspline":
        if grid_shape is None:
            raise ValueError("a bspline stage needs its grid shape")
        return {"grid": zeros((3,) + tuple(grid_shape))}
    raise ValueError(kind)


def _clamped_starts(shape, stride, offset) -> Tuple[int, ...]:
    """Per-axis jitter starts clamped so the whole strided window stays in
    bounds; ``offset`` holds host integers in ``[0, stride)``."""
    out = []
    for s, st, off in zip(shape, stride, offset):
        n = -(-s // st)
        window = (n - 1) * st + 1
        out.append(min(int(off), max(s - window, 0)))
    return tuple(out)


def _coords(shape: Sequence[int], stride: Sequence[int] = (1, 1, 1),
            offset: Optional[Sequence[int]] = None,
            device="cuda") -> torch.Tensor:
    """Voxel-centre coordinate grid ``(3, Z, Y, X)`` of every
    ``stride``-th voxel, shifted by the clamped jitter ``offset``."""
    starts = (0, 0, 0) if offset is None else _clamped_starts(
        shape, stride, offset)
    ranges = [torch.arange(0, s, st, dtype=torch.float32, device=device)
              + float(start) for s, st, start in zip(shape, stride, starts)]
    return torch.stack(torch.meshgrid(*ranges, indexing="ij"))


def strided_sample(vol: torch.Tensor, stride: Sequence[int] = (1, 1, 1),
                   offset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``vol`` on the (optionally jittered) strided sample grid, the
    fixed-image counterpart of ``resample(..., stride, offset)``."""
    starts = (0, 0, 0) if offset is None else _clamped_starts(
        vol.shape, stride, offset)
    sl = tuple(slice(b, b + (-(-s // st) - 1) * st + 1, st)
               for b, s, st in zip(starts, vol.shape, stride))
    return vol[sl]


def cubic_bspline(u: np.ndarray) -> np.ndarray:
    """Cubic B-spline basis beta^3(u) (support |u| < 2)."""
    au = np.abs(u)
    out = np.zeros_like(au)
    m1 = au < 1
    m2 = (au >= 1) & (au < 2)
    out[m1] = (4 - 6 * au[m1] ** 2 + 3 * au[m1] ** 3) / 6
    out[m2] = (2 - au[m2]) ** 3 / 6
    return out


@functools.lru_cache(maxsize=128)
def _bspline_basis(n_vox: int, n_ctrl: int, spacing: float,
                   stride: int = 1) -> np.ndarray:
    """Dense basis matrix ``B (ceil(n_vox/stride), n_ctrl)``: control
    points sit at ``(j - 1) * spacing``, so the grid pads one point beyond
    each edge; ``stride`` evaluates every ``stride``-th voxel. Callers
    must not write to it."""
    x = np.arange(0, n_vox, stride, dtype=np.float64)
    j = np.arange(n_ctrl, dtype=np.float64)
    u = x[:, None] / spacing - (j[None, :] - 1.0)
    return cubic_bspline(u).astype(np.float32)


def bspline_grid_shape(
        shape: Sequence[int], spacing: Sequence[float]) -> Tuple[int, ...]:
    """Control-grid shape covering ``shape`` with one pad point per side
    plus the two extra support points of the cubic kernel."""
    return tuple(
        int(np.ceil((s - 1) / sp)) + 3 for s, sp in zip(shape, spacing))


def bspline_displacement(
        grid: torch.Tensor, shape: Sequence[int],
        spacing: Sequence[float],
        stride: Sequence[int] = (1, 1, 1)) -> torch.Tensor:
    """Dense displacement field ``(3, Z, Y, X)`` from the control grid
    ``(3, gz, gy, gx)``: three fp32 products, one per axis, each taking a
    control axis to a voxel axis appended at the end. A batch of grids
    ``(K, 3, gz, gy, gx)`` gives ``(K, 3, Z, Y, X)``."""
    out = grid
    first = grid.dim() - 3
    for ax in range(3):
        basis = _basis_on(int(shape[ax]), int(grid.shape[first + ax]),
                          float(spacing[ax]), int(stride[ax]), grid.device)
        out = torch.tensordot(out, basis, dims=([first], [1]))
    return out


@functools.lru_cache(maxsize=128)
def _basis_on(n_vox: int, n_ctrl: int, spacing: float, stride: int,
              device: torch.device) -> torch.Tensor:
    """:func:`_bspline_basis` on ``device``, copied there once (a copy to
    the card waits for it). Callers must not write to it."""
    return torch.from_numpy(
        _bspline_basis(n_vox, n_ctrl, spacing, stride)).to(device)


def _cubic_bspline_t(u: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline basis beta^3(u) of a tensor (differentiable)."""
    au = torch.abs(u)
    return torch.where(
        au < 1.0, (4 - 6 * au ** 2 + 3 * au ** 3) / 6,
        torch.where(au < 2.0, (2 - au) ** 3 / 6, torch.zeros_like(au)))


def bspline_displacement_at(
        grid: torch.Tensor, pts: torch.Tensor,
        spacing: Sequence[float]) -> torch.Tensor:
    """FFD displacement at points ``pts (N, 3)`` -> ``(N, 3)``: per-axis
    ``(N, g_ax)`` basis weights contracted against the control grid (a
    batch of grids ``(K, 3, gz, gy, gx)`` gives ``(K, N, 3)``)."""
    ws = []
    first = grid.dim() - 3
    for ax in range(3):
        j = torch.arange(grid.shape[first + ax], dtype=torch.float32,
                         device=grid.device)
        u = pts[:, ax:ax + 1] / float(np.float32(spacing[ax])) \
            - (j[None, :] - 1.0)
        ws.append(_cubic_bspline_t(u))
    return torch.einsum("ni,nj,nk,...cijk->...nc", ws[0], ws[1], ws[2], grid)


@functools.lru_cache(maxsize=64)
def _center(shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The volume's centre ``(shape - 1) / 2``, copied to ``device`` once.
    Callers must not write to it."""
    return (torch.tensor([float(s) for s in shape], dtype=torch.float32,
                         device=device) - 1) / 2


class _GroupAffine(torch.autograd.Function):
    """A batch of affines (``W (K, 3, 3)``, ``t (K, 3)``) applied to
    centred coordinates ``flat``, ``(3, N)`` shared or ``(K, 3, N)``, plus
    ``center``, one image at a time as a single affine is applied, and
    each image's parameter gradients reduced on a copy of its own rows.
    Each image's warp and gradient thus round alike whatever the batch,
    so ranks that hold some of a group's images round as one process
    holding all of them (a batched product sums each image's gradient in
    another order for another batch size)."""

    @staticmethod
    def forward(ctx, w, t, flat, center):
        eye = torch.eye(3, device=w.device)
        a = eye + w
        out = torch.stack([
            (eye + w[i]) @ (flat if flat.dim() == 2 else flat[i])
            + (center + t[i])[:, None] for i in range(w.shape[0])])
        ctx.save_for_backward(a, flat)
        return out

    @staticmethod
    def backward(ctx, grad):
        a, flat = ctx.saved_tensors
        grad_w, grad_t = [], []
        for i in range(grad.shape[0]):
            g = grad[i].clone()
            grad_w.append(g @ (flat if flat.dim() == 2 else flat[i]).T)
            grad_t.append(g.sum(dim=1))
        grad_flat = None
        if ctx.needs_input_grad[2]:
            grad_flat = a.transpose(1, 2) @ grad
            if flat.dim() == 2:
                grad_flat = grad_flat.sum(dim=0)
        return torch.stack(grad_w), torch.stack(grad_t), grad_flat, None


def _apply_affine(params: Params, coords: torch.Tensor,
                  shape) -> torch.Tensor:
    """The affine ``params`` applied to ``coords (3, ...)``; a batch of
    affines (``W (K, 3, 3)``, ``t (K, 3)``) maps ``coords`` (shared) or
    ``(K, 3, ...)`` to ``(K, 3, ...)`` (:class:`_GroupAffine`)."""
    center = _center(tuple(shape), coords.device)
    lead = coords.shape[:-len(shape) - 1]
    flat = coords.reshape(lead + (3, -1)) - center[:, None]
    w, t = params["W"], params["t"]
    if w.dim() == 3:
        out = _GroupAffine.apply(w, t, flat, center)
    else:
        out = (torch.eye(3, device=coords.device) + w) @ flat \
            + (center + t)[..., None]
    return out.reshape(out.shape[:-2] + coords.shape[-len(shape) - 1:])


def transform_coords(
        params: Params, kind: str, shape: Sequence[int],
        spacing: Optional[Sequence[float]] = None,
        pre_affine: Optional[Params] = None,
        stride: Sequence[int] = (1, 1, 1),
        offset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Map fixed voxel coordinates to moving voxel coordinates,
    ``(3, Z, Y, X)``. ``bspline`` warps first, then applies
    ``pre_affine``; ``stride``/``offset`` map only the (jittered) strided
    metric samples, on which the FFD is evaluated point by point."""
    dev = next(iter(params.values())).device
    coords = _coords(shape, stride, offset, dev)
    if kind == "translation":
        return coords + params["t"][:, None, None, None]
    if kind == "affine":
        return _apply_affine(params, coords, shape)
    if kind == "bspline":
        if offset is None:
            disp = bspline_displacement(
                params["grid"], shape, spacing, stride)
        else:
            pts = coords.reshape(3, -1).T
            disp = bspline_displacement_at(
                params["grid"], pts, spacing).T.reshape(coords.shape)
        warped = coords + disp
        if pre_affine is not None:
            return _apply_affine(pre_affine, warped, shape)
        return warped
    raise ValueError(kind)


def group_coords(
        params: Params, shape: Sequence[int],
        spacing: Optional[Sequence[float]] = None,
        stride: Sequence[int] = (1, 1, 1)) -> torch.Tensor:
    """Moving coordinates ``(K, 3, Z, Y, X)`` of a group of K images on
    the ``stride``-th voxels of ``shape``: each image's affine (``W (K, 3,
    3)``, ``t (K, 3)``) and, when ``params`` holds ``grid (K, 3, gz, gy,
    gx)``, its B-spline warp first (the groupwise registration's transform,
    what the reference maps over the images one by one)."""
    coords = _coords(shape, stride, None, params["t"].device)
    if "grid" in params:
        coords = coords + bspline_displacement(
            params["grid"], shape, spacing, stride)
    return _apply_affine(params, coords, shape)


def transform_points(
        pts: torch.Tensor, params: Params, kind: str, shape: Sequence[int],
        spacing: Optional[Sequence[float]] = None,
        pre_affine: Optional[Params] = None) -> torch.Tensor:
    """Map fixed-space points ``(N, 3)`` to moving-space points (the
    corresponding-points metric)."""
    pts = pts.to(torch.float32)

    def apply_affine_pts(p, x):
        a = torch.eye(3, device=x.device) + p["W"]
        center = _center(tuple(shape), x.device)
        return (x - center) @ a.T + center + p["t"]

    if kind == "translation":
        return pts + params["t"]
    if kind == "affine":
        return apply_affine_pts(params, pts)
    if kind == "bspline":
        warped = pts + bspline_displacement_at(params["grid"], pts, spacing)
        if pre_affine is not None:
            return apply_affine_pts(pre_affine, warped)
        return warped
    raise ValueError(kind)


def resample_grid(
        grid: torch.Tensor, old_spacing: Sequence[float],
        new_grid_shape: Sequence[int],
        new_spacing: Sequence[float]) -> torch.Tensor:
    """Re-lattice an FFD control grid (or a batch ``(K, 3, ...)`` of them):
    the old grid's displacement at the new control points ``(j - 1) *
    new_spacing``."""
    axes = [(torch.arange(n, dtype=torch.float32, device=grid.device) - 1.0)
            * float(np.float32(sp))
            for n, sp in zip(new_grid_shape, new_spacing)]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                      dim=-1).reshape(-1, 3)
    disp = bspline_displacement_at(grid, pts, old_spacing)
    return disp.transpose(-1, -2).reshape(
        grid.shape[:-4] + (3,) + tuple(new_grid_shape))


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (``lax.round``'s default), exactly: the
    fraction ``x - trunc(x)`` is exact in float."""
    t = torch.trunc(x)
    return t + torch.sign(x) * (torch.abs(x - t) >= 0.5).to(x.dtype)


def sample_volume(vol: torch.Tensor, coords: torch.Tensor, order: int = 1,
                  cval: float = 0.0) -> torch.Tensor:
    """``vol`` at ``coords (3, ...)`` with ``map_coordinates(mode=
    "constant")`` semantics: order 0 nearest (in ``vol``'s dtype), order 1
    trilinear (float). A batch of volumes ``(K, Z, Y, X)`` takes
    ``coords (K, 3, ...)``, each volume at its own coordinates, all in one
    gather."""
    shape = vol.shape[-3:]
    flat = vol.reshape(-1)
    fill = float(cval) if vol.is_floating_point() else int(cval)
    base = None
    if vol.dim() == 4:
        coords = coords.movedim(1, 0)
        base = torch.arange(vol.shape[0], device=vol.device).reshape(
            (-1,) + (1,) * (coords.dim() - 2)) * (shape[0] * shape[1]
                                                  * shape[2])

    def gather(idx):
        valid = functools.reduce(torch.logical_and, (
            (i >= 0) & (i < n) for i, n in zip(idx, shape)))
        lin = torch.clamp(idx[0], 0, shape[0] - 1)
        for i, n in zip(idx[1:], shape[1:]):
            lin = lin * n + torch.clamp(i, 0, n - 1)
        if base is not None:
            lin = lin + base
        return torch.where(valid, flat[lin], fill)

    if order == 0:
        return gather([_round_half_away(c).to(torch.int64) for c in coords])
    if order != 1:
        raise ValueError(f"order {order} is not supported (0 or 1)")
    nodes = []
    for c in coords:
        lower = torch.floor(c)
        upper_w = c - lower
        idx = lower.to(torch.int64)
        nodes.append(((idx, 1 - upper_w), (idx + 1, upper_w)))
    out = None
    for corner in itertools.product(*nodes):
        idx, weights = zip(*corner)
        term = functools.reduce(torch.mul, weights) * gather(idx)
        out = term if out is None else out + term
    return out


def resample(
        moving: torch.Tensor, params: Params, kind: str,
        out_shape: Sequence[int],
        spacing: Optional[Sequence[float]] = None,
        pre_affine: Optional[Params] = None, order: int = 1,
        stride: Sequence[int] = (1, 1, 1),
        offset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Resample the moving image into fixed space under the transform."""
    coords = transform_coords(
        params, kind, out_shape, spacing, pre_affine, stride, offset)
    return sample_volume(moving, coords, order=order)
