"""Multi-resolution registration engine on PyTorch: the Elastix
replacement.

Port of the single-device path of ``magellanmapper_tpu/atlas/
reg_engine.py``: the transform models (:mod:`.transform`) against the
similarity metrics (:mod:`.metrics`), optimised with Adam over an image
pyramid, stage by stage (translation, affine, B-spline) from the profile's
``RegParamMap``-style dicts.

The reference runs each pyramid level as one ``lax.fori_loop``; here each
step is launched from Python, so the loop never waits for the card: no
``.item()`` or ``float(loss)`` inside a level, the learning-rate decay is
computed on the host from the step number, and the jittered sample offsets
are drawn from a seeded CPU ``torch.Generator`` (the same offsets on the
card and the CPU; JAX's threefry stream is not reproduced, so parity with
the reference holds where every stride is 1 and there is no jitter). The
gradient comes from autograd instead of ``jax.grad``, and Adam is written
out to match ``optax.adam(1.0)`` (b1 0.9, b2 0.999, eps 1e-8 after the
square root, bias correction from step 1), scaled per leaf by
``_LEARNING_RATES`` times ``0.05 ** (i / iters)``.

Groupwise registration (:func:`register_groupwise`) optimises every
image's transform together against the group's per-voxel variance, the
K images' warps taken as one gather. ``register_duo(checkpoint_dir=...)``
saves each completed stage (:mod:`magellanmapper_torch.utils.checkpoint`)
and restores it on a rerun instead of optimising it again.

With ``mesh``, a level runs over the ranks of a mesh
(:func:`_optimize_level_sharded`): the metric samples are dealt over every
mesh axis, each rank gathers its samples' warp from the whole moving
volume and sums its partial Parzen joint histogram, and one ``all_reduce``
adds the partials; every rank takes the same Adam step. Groupwise
registration deals the subjects over the mesh's first axis.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.atlas import metrics, transform
from magellanmapper_torch.ops import filters
from magellanmapper_torch.parallel import comm, mesh as mesh_mod
from magellanmapper_torch.utils import checkpoint

_logger = logging.getLogger(__name__)

#: default Adam learning rates per parameter kind (voxel-space units for
#: translations/displacements; unitless for the affine linear part)
_LEARNING_RATES = {"t": 1.0, "W": 0.01, "grid": 0.5}

#: within-level LR decay endpoint (fraction of the initial rate reached
#: on a level's final step)
_LR_DECAY_FLOOR = 0.05

#: cap on metric sample points per optimizer step (a strided, jittered
#: grid; Elastix draws ~2048 random samples per iteration)
_MAX_METRIC_SAMPLES = 1 << 14

#: optax.adam's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _tensor(x, dev) -> torch.Tensor:
    """``x`` (an array or a tensor) as float32 on ``dev``."""
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(dev)


def _pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Gaussian pyramid, coarsest first (Elastix recursive pyramid)."""
    out = [img]
    for _ in range(levels - 1):
        smoothed = filters.gaussian_filter(out[0], 1.0, mode="nearest")
        out.insert(0, smoothed[::2, ::2, ::2].contiguous())
    return out


def _smoothing_pyramid(img: torch.Tensor,
                       levels: int) -> List[torch.Tensor]:
    """Constant-shape smoothing pyramid, coarsest first (Elastix
    ``FixedSmoothingImagePyramid``): level ``lvl`` is the image smoothed
    with ``sigma = 2^(levels-1-lvl) / 2``."""
    return [filters.gaussian_filter(img, (2.0 ** (levels - 1 - lvl)) / 2.0,
                                    mode="nearest")
            for lvl in range(levels)]


def _max_filter(vol: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Maximum over a ``size`` window centred on each voxel, the window
    cut at the edges (``max_pool3d`` pads with -inf)."""
    return F.max_pool3d(vol[None, None], kernel_size=tuple(size), stride=1,
                        padding=tuple(s // 2 for s in size))[0, 0]


def _erode_mask_by(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary erosion by a cube of half-width ``radius``, one axis at a
    time; outside the volume counts as inside the mask."""
    outside = (~(mask > 0)).to(torch.float32)
    if radius >= 1:
        w = 2 * radius + 1
        for size in ((w, 1, 1), (1, w, 1), (1, 1, w)):
            outside = _max_filter(outside, size)
    return outside < 0.5


def _scale_params(params: Dict, factor: float, kind: str) -> Dict:
    """Rescale voxel-space parameters between pyramid levels."""
    out = dict(params)
    if "t" in out:
        out["t"] = out["t"] * factor
    if "grid" in out and kind == "bspline":
        out["grid"] = out["grid"] * factor
    return out


def _metric_stride(
        shape, max_samples: int = _MAX_METRIC_SAMPLES
) -> Tuple[int, int, int]:
    stride = [1, 1, 1]
    while np.prod([-(-s // st) for s, st in zip(shape, stride)]) \
            > max_samples:
        ax = int(np.argmax([s / st for s, st in zip(shape, stride)]))
        stride[ax] *= 2
    return tuple(stride)


def _adam_level_loop(loss_fn, params, iters: int, lrs, stride, jitter,
                     decay: bool = True, grad_reduce=None):
    """``iters`` Adam steps (``optax.adam(1.0)``, its moments and bias
    correction in its order of operations) with per-leaf learning rates
    and, with ``decay``, the within-level decay to ``_LR_DECAY_FLOOR``;
    with ``jitter``, each step draws a new offset into the strided sample
    grid from a CPU generator seeded 0. ``grad_reduce`` maps the list of
    gradients before the step (the sharded levels' reduction over ranks).
    Returns the parameters and the loss on the unjittered grid (a tensor:
    nothing here waits for the card)."""
    lr_map = dict(lrs)
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    gen = torch.Generator().manual_seed(0)
    use_jitter = jitter and any(s > 1 for s in stride)
    f32 = np.float32
    for i in range(iters):
        offset = None
        if use_jitter:
            offset = tuple(int(torch.randint(0, s, (1,), generator=gen))
                           for s in stride)
        loss = loss_fn(p, offset)
        grads = torch.autograd.grad(loss, list(p.values()))
        if grad_reduce is not None:
            grads = grad_reduce(grads)
        count = i + 1
        bc1 = float(f32(1) - f32(_B1) ** f32(count))
        bc2 = float(f32(1) - f32(_B2) ** f32(count))
        scale = float(f32(_LR_DECAY_FLOOR) ** (f32(i) / f32(max(iters, 1)))
                      ) if decay else 1.0
        with torch.no_grad():
            for (k, v), g in zip(p.items(), grads):
                mu[k] = g * (1 - _B1) + mu[k] * _B1
                nu[k] = (g * g) * (1 - _B2) + nu[k] * _B2
                step = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + _EPS)
                v.sub_(step * (lr_map.get(k, 1.0) * scale))
    out = {k: v.detach() for k, v in p.items()}
    with torch.no_grad():
        final = loss_fn(out, None)
    return out, final


def _optimize_level(
        fixed: torch.Tensor, moving: torch.Tensor, params: Dict,
        pre_affine: Optional[Dict], kind: str, metric: str, iters: int,
        spacing: Optional[Tuple[float, ...]],
        lrs: Tuple[Tuple[str, float], ...],
        stride: Tuple[int, int, int] = (1, 1, 1),
        fixed_mask: Optional[torch.Tensor] = None,
        fix_pts: Optional[torch.Tensor] = None,
        mov_pts: Optional[torch.Tensor] = None,
        pt_weight: float = 0.0, jitter: bool = True,
        moving_mask: Optional[torch.Tensor] = None):
    """``iters`` Adam steps at one pyramid level of
    :func:`_level_loss_fn`'s loss."""
    return _adam_level_loop(_level_loss_fn(
        fixed, moving, pre_affine, kind, metric, spacing, stride,
        fixed_mask, fix_pts, mov_pts, pt_weight, moving_mask),
        params, iters, lrs, stride, jitter)


def _level_loss_fn(
        fixed: torch.Tensor, moving: torch.Tensor,
        pre_affine: Optional[Dict], kind: str, metric: str,
        spacing: Optional[Tuple[float, ...]],
        stride: Tuple[int, int, int] = (1, 1, 1),
        fixed_mask: Optional[torch.Tensor] = None,
        fix_pts: Optional[torch.Tensor] = None,
        mov_pts: Optional[torch.Tensor] = None,
        pt_weight: float = 0.0,
        moving_mask: Optional[torch.Tensor] = None):
    """The loss of parameters ``p`` at one pyramid level, on the sample
    grid shifted by ``offset`` (``reg_engine.py:182-204``): the metric of
    the fixed image against the moved one. ``fixed_mask`` restricts the
    metric to mask samples; ``moving_mask`` drops samples that map
    outside it (not differentiated through); ``fix_pts``/``mov_pts`` add
    the corresponding-points distance term weighted by ``pt_weight``."""
    def loss_fn(p, offset=None):
        moved = transform.resample(
            moving, p, kind, fixed.shape, spacing, pre_affine, order=1,
            stride=stride, offset=offset)
        fixed_s = transform.strided_sample(fixed, stride, offset)
        mask_s = None
        if fixed_mask is not None:
            mask_s = transform.strided_sample(fixed_mask, stride, offset)
        if moving_mask is not None:
            with torch.no_grad():
                mm = transform.resample(
                    moving_mask, p, kind, fixed.shape, spacing, pre_affine,
                    order=1, stride=stride, offset=offset)
            mm = (mm > 0.5).to(torch.float32)
            mask_s = mm if mask_s is None else mask_s * mm
        loss = metrics.metric_loss(metric, fixed_s, moved, mask=mask_s)
        if fix_pts is not None and mov_pts is not None:
            mapped = transform.transform_points(
                fix_pts, p, kind, fixed.shape, spacing, pre_affine)
            dist = torch.sqrt(torch.sum((mapped - mov_pts) ** 2, dim=1)
                              + 1e-12)
            loss = loss + pt_weight * torch.mean(dist)
        return loss

    return loss_fn


# ---------------------------------------------------------------------------
# The level over the ranks of a mesh (``reg_engine.py:210-410``).
#
# Every rank holds the whole fixed and moving volumes and the same
# parameters. The metric samples, padded to a multiple of the rank count
# and masked by ``valid``, are dealt over every mesh axis: each rank warps
# its share. Mattes MI sums each rank's partial Parzen joint histogram
# over the ranks; its intensity ranges come from a differentiable gather
# of each rank's extremes, so the gradient flows through the moving range
# as in the single-device metric. NCC and MSE gather the samples and run
# on all of them. The collectives' backward sums the upstream gradients
# over the ranks (``parallel.comm``), so a loss computed alike on every
# rank differentiates ``ranks`` times the loss, summed over the ranks'
# shares: the parameter gradients are all-reduced and divided by the rank
# count once, and every rank takes the same Adam step.


def _pad_to(x: torch.Tensor, n: int, axis: int = 0) -> torch.Tensor:
    """``x`` zero-padded at the end of ``axis`` to length ``n``."""
    pad = [0, 0] * x.dim()
    pad[2 * (x.dim() - 1 - axis) + 1] = n - x.shape[axis]
    return F.pad(x, pad)


def _local_share(mesh, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous share of ``x`` along ``axis`` (whose length
    is a multiple of the mesh's rank count), ranks in row-major order."""
    per = x.shape[axis] // mesh_mod.axis_size(mesh, mesh_mod.AXES)
    return x.narrow(axis, mesh_mod.axis_index(mesh, mesh_mod.AXES) * per,
                    per)


def _sharded_gather(mesh, moving: torch.Tensor, coords: torch.Tensor,
                    order: int = 1) -> torch.Tensor:
    """The warp of this rank's share of the samples: ``moving`` (whole on
    every rank) at its share of ``coords (3, N)``."""
    return transform.sample_volume(moving, _local_share(mesh, coords, 1),
                                   order=order)


def _sharded_mattes_mi(mesh, f, m, wf_weight, lo_f, hi_f, lo_m, hi_m,
                       nbins: int = 32) -> torch.Tensor:
    """Mattes MI of this rank's samples ``f``/``m`` (weights
    ``wf_weight``) with the Parzen joint histogram summed over the ranks
    (:func:`metrics.mattes_mi` up to the order of summation)."""
    fb = (f - lo_f) / torch.clamp_min(hi_f - lo_f, 1e-8) * (nbins - 1)
    mb = (m - lo_m) / torch.clamp_min(hi_m - lo_m, 1e-8) * (nbins - 1)
    wf = metrics._parzen_weights(fb, nbins) * wf_weight[:, None]
    wm = metrics._parzen_weights(mb, nbins)
    joint = comm.all_reduce_grad(wf.T @ wm, mesh)
    joint = joint / torch.clamp_min(joint.sum(), 1e-8)
    pf = joint.sum(dim=1, keepdim=True)
    pm = joint.sum(dim=0, keepdim=True)
    ratio = joint / torch.clamp_min(pf * pm, 1e-12)
    return torch.sum(joint * torch.log(torch.clamp_min(ratio, 1e-12)))


def _sharded_metric_loss(mesh, metric: str, f, m, valid, mask):
    """Minimizable loss of this rank's share of the flat samples.

    ``valid`` masks padding rows; ``mask`` carries the metric mask
    (fixed-mask samples and moving-mask rejection). As in the
    single-device metric, the MI intensity ranges ignore the metric mask
    but never see padding."""
    w_metric = valid if mask is None else valid * mask
    if metric in ("AdvancedMattesMutualInformation", "mi"):
        inf = float("inf")
        keep = valid > 0
        ext = torch.stack([
            torch.amin(torch.where(keep, f, inf)),
            -torch.amax(torch.where(keep, f, -inf)),
            torch.amin(torch.where(keep, m, inf)),
            -torch.amax(torch.where(keep, m, -inf))])
        lo = torch.amin(comm.all_gather_grad(ext[None], mesh), dim=0)
        return -_sharded_mattes_mi(
            mesh, f, m, w_metric, lo[0], -lo[1], lo[2], -lo[3])
    f_all = comm.all_gather(f, mesh)
    m_all = comm.all_gather_grad(m, mesh)
    w_all = comm.all_gather(w_metric, mesh)
    if metric in ("AdvancedNormalizedCorrelation", "ncc"):
        return -metrics.ncc(f_all, m_all, mask=w_all)
    if metric in ("mse", "AdvancedMeanSquares"):
        return torch.sum(w_all * (f_all - m_all) ** 2) / torch.clamp_min(
            w_all.sum(), 1.0)
    raise ValueError(f"unknown metric: {metric}")


def _sharded_level_loss_fn(
        mesh, fixed: torch.Tensor, moving: torch.Tensor,
        pre_affine: Optional[Dict], kind: str, metric: str,
        spacing: Optional[Tuple[float, ...]],
        stride: Tuple[int, int, int] = (1, 1, 1),
        fixed_mask: Optional[torch.Tensor] = None,
        fix_pts: Optional[torch.Tensor] = None,
        mov_pts: Optional[torch.Tensor] = None,
        pt_weight: float = 0.0,
        moving_mask: Optional[torch.Tensor] = None):
    """:func:`_level_loss_fn` with the samples dealt over the ranks."""
    n_ranks = mesh_mod.axis_size(mesh, mesh_mod.AXES)

    def loss_fn(p, offset=None):
        coords = transform.transform_coords(
            p, kind, fixed.shape, spacing, pre_affine, stride, offset)
        fixed_s = transform.strided_sample(fixed, stride, offset)
        n = fixed_s.numel()
        n_pad = -(-n // n_ranks) * n_ranks

        def share(x):
            return _local_share(mesh, _pad_to(x.reshape(-1), n_pad))

        f = share(fixed_s)
        c = _pad_to(coords.reshape(3, -1), n_pad, axis=1)
        valid = share(torch.ones(n, device=fixed.device))
        mask = None
        if fixed_mask is not None:
            mask = share(transform.strided_sample(fixed_mask, stride,
                                                  offset))
        m = _sharded_gather(mesh, moving, c)
        if moving_mask is not None:
            with torch.no_grad():
                mm = (_sharded_gather(mesh, moving_mask, c) > 0.5).to(
                    torch.float32)
            mask = mm if mask is None else mask * mm
        loss = _sharded_metric_loss(mesh, metric, f, m, valid, mask)
        if fix_pts is not None and mov_pts is not None:
            mapped = transform.transform_points(
                fix_pts, p, kind, fixed.shape, spacing, pre_affine)
            dist = torch.sqrt(torch.sum((mapped - mov_pts) ** 2, dim=1)
                              + 1e-12)
            loss = loss + pt_weight * torch.mean(dist)
        return loss

    return loss_fn


def _mean_grads(mesh):
    """The gradient reduction of a level whose parameters every rank
    holds alike: the ranks' gradients summed, over the rank count."""
    n_ranks = mesh_mod.axis_size(mesh, mesh_mod.AXES)
    return lambda grads: [comm.all_reduce(g, mesh) / n_ranks
                          for g in grads]


def _optimize_level_sharded(
        mesh, fixed: torch.Tensor, moving: torch.Tensor, params: Dict,
        pre_affine: Optional[Dict], kind: str, metric: str, iters: int,
        spacing: Optional[Tuple[float, ...]],
        lrs: Tuple[Tuple[str, float], ...],
        stride: Tuple[int, int, int] = (1, 1, 1),
        fixed_mask: Optional[torch.Tensor] = None,
        fix_pts: Optional[torch.Tensor] = None,
        mov_pts: Optional[torch.Tensor] = None,
        pt_weight: float = 0.0, jitter: bool = True,
        moving_mask: Optional[torch.Tensor] = None):
    """:func:`_optimize_level` over the ranks of ``mesh``: the same Adam
    and decay loop, the samples dealt over every mesh axis, the
    gradients averaged over the ranks, so every rank takes the same
    step."""
    return _adam_level_loop(_sharded_level_loss_fn(
        mesh, fixed, moving, pre_affine, kind, metric, spacing, stride,
        fixed_mask, fix_pts, mov_pts, pt_weight, moving_mask),
        params, iters, lrs, stride, jitter, grad_reduce=_mean_grads(mesh))


def _parse_grid_schedule(sched, levels_cap: int):
    """Parse an Elastix ``GridSpacingSchedule`` into per-level per-axis
    multipliers of the final grid spacing, coarsest level first: repeated
    values within the first 3 entries mean per-dimension triplets,
    otherwise one value per resolution; the coarsest entries beyond
    ``levels_cap`` are dropped."""
    vals = [float(v) for v in sched]
    ndim = 3
    if len(vals) % ndim == 0 and len(set(vals[:ndim])) != ndim:
        per_level = [tuple(vals[i:i + ndim])
                     for i in range(0, len(vals), ndim)]
    else:
        per_level = [(v,) * ndim for v in vals]
    return per_level[-levels_cap:] if len(per_level) > levels_cap \
        else per_level


def _mask_pyramid(mask: torch.Tensor, levels: int, erode: bool):
    """Mask pyramid matching :func:`_pyramid`'s geometry, coarsest first;
    with ``erode`` (Elastix ``ErodeMask``) every smoothed level is eroded
    by the pyramid kernel's support (a 9-voxel cube)."""
    out = [mask > 0]
    for _ in range(levels - 1):
        out.insert(0, out[0][::2, ::2, ::2])
    if erode:
        out = [m if lvl == levels - 1 else
               _max_filter((~m).to(torch.float32), (9, 9, 9)) < 0.5
               for lvl, m in enumerate(out)]
    return out


class _LevelClock:
    """Times each level's optimiser steps without waiting for the card:
    CUDA events on a card, the host clock on the CPU (whose steps run as
    they are issued); read after the stage's loss reached the host."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.rows: List[dict] = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, start, row: dict):
        row["_marks"] = (start, self.mark())
        self.rows.append(row)

    def read(self) -> List[dict]:
        for row in self.rows:
            if "_marks" in row:
                a, b = row.pop("_marks")
                row["seconds"] = (a.elapsed_time(b) / 1e3 if self.cuda
                                  else b - a)
                row["steps_per_s"] = row["iters"] / max(row["seconds"],
                                                        1e-12)
        return self.rows


def register_stage(
        fixed, moving, stage: Dict, init_params: Optional[Dict] = None,
        pre_affine: Optional[Dict] = None, iters_scale: float = 1.0,
        kind: Optional[str] = None, fixed_mask=None, moving_mask=None,
        fix_pts=None, mov_pts=None, pt_weight: float = 1.0, mesh=None,
        device="cuda", clock: Optional[_LevelClock] = None
) -> Tuple[Dict, float]:
    """Run one registration stage (translation / affine / bspline) on
    ``device`` (``reg_engine.py:413-598``).

    ``stage`` is a ``RegParamMap``-style dict (``map_name``, ``max_iter``,
    ``metric_similarity``, ``num_resolutions``, ``grid_space_voxels``,
    ``grid_spacing_schedule``, ``erode_mask``, ``point_based``,
    ``num_spatial_samples``, ``pyramid_mode``). ``init_params`` warm-starts
    (an affine from the translation), ``pre_affine`` is composed after a
    B-spline warp, ``fixed_mask``/``moving_mask`` restrict the metric's
    samples, ``fix_pts``/``mov_pts`` ``(N, 3)`` add the corresponding-
    points term on a ``point_based`` stage. ``clock`` records each level's
    steps and time. With ``mesh`` every level runs over its ranks
    (:func:`_optimize_level_sharded`). Returns ``(params, final_loss)``,
    the parameters as tensors on ``device``.
    """
    dev = device_mod.resolve(device)
    kind = kind or stage.get("map_name")
    if kind is None:
        raise ValueError("stage needs map_name or an explicit kind")
    metric = stage.get("metric_similarity", "AdvancedMattesMutualInformation")
    levels = int(stage.get("num_resolutions", 4) or 4)
    max_iter = max(1, int(stage.get("max_iter", 512) * iters_scale))

    fixed = _tensor(fixed, dev)
    moving = _tensor(moving, dev)
    smoothing = str(stage.get("pyramid_mode") or "downsample") \
        == "smoothing"
    # the coarsest level keeps >= 8 voxels per axis
    max_levels = int(np.floor(np.log2(max(min(fixed.shape) / 8, 1)))) + 1
    if not smoothing:
        levels = max(1, min(levels, max_levels))

    sched_levels = None
    gsv = None
    if kind == "bspline":
        gsv = float(stage.get("grid_space_voxels") or 50)
        sched = stage.get("grid_spacing_schedule")
        if sched:
            sched_levels = _parse_grid_schedule(sched, max_levels)
            levels = max(1, min(len(sched_levels), max_levels))
            sched_levels = sched_levels[-levels:]
        else:
            sched_levels = [(1.0, 1.0, 1.0)] * levels

    erode = bool(stage.get("erode_mask"))
    if smoothing:
        pyr_f = _smoothing_pyramid(fixed, levels)
        pyr_m = _smoothing_pyramid(moving, levels)

        def masks(mask):
            if mask is None:
                return None
            m = _tensor(mask, dev) > 0
            return [_erode_mask_by(m, int(4 * (2.0 ** (levels - 1 - lvl))
                                          / 2.0 + 0.5)) if erode else m
                    for lvl in range(levels)]
    else:
        pyr_f = _pyramid(fixed, levels)
        pyr_m = _pyramid(moving, levels)

        def masks(mask):
            return None if mask is None else _mask_pyramid(
                _tensor(mask, dev), levels, erode)
    mask_pyr = masks(fixed_mask)
    mov_mask_pyr = masks(moving_mask)

    # the point metric is gated on the stage's point_based key; points
    # passed by an API caller default on
    use_pts = (fix_pts is not None and mov_pts is not None
               and bool(stage.get("point_based", True)))
    if use_pts:
        fix_pts = _tensor(fix_pts, dev)
        mov_pts = _tensor(mov_pts, dev)

    def level_spacing(lvl: int):
        """B-spline control spacing at level ``lvl``, in level voxels."""
        level_factor = 1.0 if smoothing else 2.0 ** (levels - 1 - lvl)
        return tuple(
            gsv * sched_levels[lvl][ax] / level_factor for ax in range(3))

    grid_shape = None
    if kind == "bspline":
        grid_shape = transform.bspline_grid_shape(
            pyr_f[0].shape, level_spacing(0))
    params = init_params
    if params is None:
        params = transform.identity_params(kind, grid_shape, dev)
    else:
        params = {k: _tensor(v, dev) for k, v in params.items()}
        if kind == "bspline" and "grid" not in params:
            params = transform.identity_params(kind, grid_shape, dev)

    coarse_factor = 1.0 if smoothing else 2.0 ** (levels - 1)
    params = _scale_params(params, 1.0 / coarse_factor, kind)
    pre = None if pre_affine is None else {
        k: _tensor(v, dev) for k, v in pre_affine.items()}

    loss = None
    prev_sp = level_spacing(0) if kind == "bspline" else None
    for lvl, (f_l, m_l) in enumerate(zip(pyr_f, pyr_m)):
        level_factor = 1.0 if smoothing else 2.0 ** (levels - 1 - lvl)
        sp = None
        if kind == "bspline":
            sp = level_spacing(lvl)
            gshape = transform.bspline_grid_shape(f_l.shape, sp)
            if tuple(params["grid"].shape[1:]) != gshape:
                # re-lattice the control points (the previous spacing in
                # this level's voxels is twice its own when downsampling)
                old_sp = prev_sp if smoothing or lvl == 0 \
                    else tuple(2.0 * s for s in prev_sp)
                params = {"grid": transform.resample_grid(
                    params["grid"], old_sp, gshape, sp)}
            prev_sp = sp
        pre_l = (_scale_params(pre, 1.0 / level_factor, "affine")
                 if pre is not None else None)
        lrs = tuple(sorted(
            (k, _LEARNING_RATES.get(k, 1.0)) for k in params))
        iters = max_iter if smoothing else max(1, max_iter // (2 ** lvl))
        max_samples = int(
            stage.get("num_spatial_samples") or _MAX_METRIC_SAMPLES)
        stride = _metric_stride(f_l.shape, max_samples)
        mask_l = mask_pyr[lvl].to(torch.float32) \
            if mask_pyr is not None else None
        mov_mask_l = mov_mask_pyr[lvl].to(torch.float32) \
            if mov_mask_pyr is not None else None
        pts_args = {}
        if use_pts:
            pts_args = dict(
                fix_pts=fix_pts / level_factor,
                mov_pts=mov_pts / level_factor,
                pt_weight=float(pt_weight))
        start = clock.mark() if clock is not None else None
        level_args = (f_l, m_l, params, pre_l, kind, metric, iters, sp, lrs,
                      stride)
        level_kw = dict(fixed_mask=mask_l, moving_mask=mov_mask_l,
                        **pts_args)
        if mesh is not None:
            params, loss = _optimize_level_sharded(
                mesh, *level_args, **level_kw)
        else:
            params, loss = _optimize_level(*level_args, **level_kw)
        if clock is not None:
            clock.add(start, dict(kind=kind, level=lvl,
                                  shape=list(f_l.shape), stride=list(stride),
                                  iters=iters))
        if not smoothing and lvl < levels - 1:
            params = _scale_params(params, 2.0, kind)
    return params, float(loss)


class RegResult:
    """A completed registration: the transform chain (parameters as
    tensors on ``device``) and its metrics; ``levels`` holds each
    optimiser level's steps and seconds."""

    def __init__(self, stages: List[Tuple[str, Dict]],
                 fixed_shape: Sequence[int],
                 bspline_spacing: Optional[Sequence[float]] = None,
                 device="cuda"):
        self.stages = stages
        self.fixed_shape = tuple(int(s) for s in fixed_shape)
        self.bspline_spacing = bspline_spacing
        self.device = device_mod.resolve(device)
        self.metrics: Dict[str, float] = {}
        self.levels: List[dict] = []

    @classmethod
    def from_numpy(cls, stages, fixed_shape, bspline_spacing=None,
                   device="cuda") -> "RegResult":
        """The port's result for a chain of numpy parameters, e.g. the
        reference's ``RegResult.stages``."""
        dev = device_mod.resolve(device)
        return cls([(kind, {k: _tensor(v, dev) for k, v in p.items()})
                    for kind, p in stages], fixed_shape, bspline_spacing,
                   dev)

    def stages_numpy(self) -> List[Tuple[str, Dict[str, np.ndarray]]]:
        """The chain as numpy arrays (the reference's layout)."""
        return [(kind, {k: v.cpu().numpy() for k, v in p.items()})
                for kind, p in self.stages]

    def _final(self) -> Tuple[str, Dict, Optional[Dict]]:
        """Final transform kind, params, and pre-affine composition."""
        chain = dict(self.stages)
        if "bspline" in chain:
            return ("bspline", chain["bspline"],
                    chain.get("affine") or chain.get("translation"))
        if "affine" in chain:
            return "affine", chain["affine"], None
        return "translation", chain["translation"], None

    def transform_tensor(self, img, order: int = 1) -> torch.Tensor:
        """The chain applied on ``device`` (Transformix): order 1 in
        float32; order 0 in the image's own dtype, so integer labels keep
        every bit (the reference samples labels as float32, which rounds
        IDs above 2^24; ROADMAP §3)."""
        kind, params, pre = self._final()
        if order == 0:
            vol = img if torch.is_tensor(img) else torch.from_numpy(
                np.ascontiguousarray(img).astype(_gather_dtype(img.dtype)))
            vol = vol.to(self.device)
        else:
            vol = _tensor(img, self.device)
        return transform.resample(
            vol, params, kind, self.fixed_shape, self.bspline_spacing, pre,
            order=order)

    def transform_img(self, img, order: int = 1) -> np.ndarray:
        """:meth:`transform_tensor` as a numpy array, in ``img``'s dtype
        at order 0."""
        out = self.transform_tensor(img, order).cpu().numpy()
        return out.astype(img.dtype) if order == 0 else out


def _gather_dtype(dtype) -> np.dtype:
    """A dtype torch gathers on every device that holds ``dtype``'s
    values (unsigned 16/32-bit widened to a signed type)."""
    dtype = np.dtype(dtype)
    return {np.dtype(np.uint16): np.dtype(np.int32),
            np.dtype(np.uint32): np.dtype(np.int64)}.get(dtype, dtype)


def _bspline_spacing(stage: Dict) -> Tuple[float, ...]:
    gsv = float(stage.get("grid_space_voxels") or 50)
    sched = stage.get("grid_spacing_schedule")
    mult = _parse_grid_schedule(sched, 99)[-1] if sched else (1.0, 1.0, 1.0)
    return tuple(gsv * m for m in mult)


def register_duo(
        fixed: np.ndarray, moving: np.ndarray, profile,
        iters_scale: float = 1.0,
        fixed_mask: Optional[np.ndarray] = None,
        moving_mask: Optional[np.ndarray] = None,
        fix_pts: Optional[np.ndarray] = None,
        mov_pts: Optional[np.ndarray] = None,
        checkpoint_dir: Optional[str] = None,
        record_stage_dsc: bool = False, mesh=None,
        device="cuda") -> Tuple[np.ndarray, RegResult]:
    """Register ``moving`` onto ``fixed`` through the profile's stages
    (translation -> affine -> bspline) on ``device``
    (``reg_engine.py:635-740``). Returns the moved image and the result,
    whose metrics hold ``dsc_fixed_moved`` (and ``dsc_stage_<kind>`` after
    each optimised stage with ``record_stage_dsc``). With
    ``checkpoint_dir`` each completed stage is saved there, and a stage
    already saved is restored instead of optimised (only rank 0 of a
    ``mesh`` writes). With ``mesh`` every stage's levels run over its
    ranks."""
    dev = device_mod.resolve(device)
    ckpt = (checkpoint.RegistrationCheckpoint(checkpoint_dir)
            if checkpoint_dir else None)
    stages_cfg = [(k, s) for k, s in (
        ("translation", profile["reg_translation"]),
        ("affine", profile["reg_affine"]),
        ("bspline", profile["reg_bspline"])) if s]
    fixed_t = _tensor(fixed, dev)
    moving_t = _tensor(moving, dev)
    clock = _LevelClock(dev)

    done: List[Tuple[str, Dict]] = []
    stage_dsc: Dict[str, float] = {}
    init_affine = None
    pre_affine = None
    bspline_spacing = None
    for kind, stage in stages_cfg:
        common = dict(fixed_mask=fixed_mask, moving_mask=moving_mask,
                      iters_scale=iters_scale, kind=kind, mesh=mesh,
                      device=dev, clock=clock)
        if stage.get("point_based") and fix_pts is not None \
                and mov_pts is not None:
            common.update(fix_pts=fix_pts, mov_pts=mov_pts)
        restored = ckpt.load_stage(kind) if ckpt else None
        if restored is not None:
            params = {k: v.to(dev) for k, v in restored.items()}
        elif kind == "translation":
            params, loss = register_stage(fixed_t, moving_t, stage, **common)
        elif kind == "affine":
            params, loss = register_stage(
                fixed_t, moving_t, stage, init_params=init_affine, **common)
        else:
            if pre_affine is None and init_affine is not None:
                pre_affine = init_affine
            params, loss = register_stage(
                fixed_t, moving_t, stage, pre_affine=pre_affine, **common)
        if kind == "translation":
            init_affine = {"W": torch.zeros((3, 3), device=dev),
                           "t": params["t"]}
        elif kind == "affine":
            pre_affine = params
        else:
            bspline_spacing = _bspline_spacing(stage)
        done.append((kind, params))
        if restored is not None:
            _logger.info("stage %s restored from checkpoint", kind)
            continue
        _logger.info("stage %s done, loss %.5f", kind, loss)
        if ckpt:
            comm.on_writer(mesh, lambda: ckpt.save_stage(kind, params))
        if record_stage_dsc:
            partial = RegResult(list(done), fixed_t.shape, bspline_spacing,
                                dev)
            stage_dsc[kind] = metrics.measure_overlap(
                fixed_t, partial.transform_tensor(moving_t, order=1))

    result = RegResult(done, fixed_t.shape, bspline_spacing, dev)
    moved = result.transform_tensor(moving_t, order=1)
    result.metrics["dsc_fixed_moved"] = metrics.measure_overlap(
        fixed_t, moved)
    for kind, dsc in stage_dsc.items():
        result.metrics[f"dsc_stage_{kind}"] = dsc
    result.levels = clock.read()
    return moved.cpu().numpy(), result


#: groupwise learning rates: the affine pass, then the joint B-spline
#: refinement (``reg_engine.py:847,864``)
_GROUP_LRS = (("W", 0.01), ("t", 1.0))
_GROUP_LRS_BSPLINE = (("W", 0.003), ("grid", 0.5), ("t", 0.3))


def _group_loss_fn(vols: torch.Tensor, stride: Tuple[int, int, int],
                   spacing: Optional[Tuple[float, ...]] = None,
                   mesh=None, k: Optional[int] = None):
    """The groupwise loss of parameters ``p`` (``W (K, 3, 3)``, ``t (K,
    3)`` and optionally ``grid``): the mean over the ``stride``-th voxels
    of the group's population variance (the mean image, then the mean
    squared deviation from it, ``jnp.var``'s two passes), plus the anchors
    that keep the transforms near identity, ``1e-4 mean(t^2) + 1e-2
    mean(W^2)`` (``+ 1e-3 mean(grid^2)``) (``reg_engine.py:745-792``).
    The K warps are one gather. With ``mesh``, ``vols`` and ``p`` are
    this rank's share of the group's ``k`` subjects, dealt over the
    mesh's first axis, and every sum over subjects is summed over that
    axis's ranks too."""
    shape = tuple(vols.shape[1:])
    if mesh is None:
        k = vols.shape[0]

        def total(x):
            return x
    else:
        def total(x):
            return comm.all_reduce_grad(x, mesh, mesh_mod.AXES[0])

    def loss_fn(p, offset=None):
        moved = transform.sample_volume(
            vols, transform.group_coords(p, shape, spacing, stride))
        mean = total(moved.sum(dim=0)) / k
        var = total(((moved - mean) ** 2).sum(dim=0)) / k
        leaves = [n for n in ("t", "W", "grid") if n in p]
        sums = total(torch.stack([torch.sum(p[n] ** 2) for n in leaves]))
        weights = {"t": 1e-4, "W": 1e-2, "grid": 1e-3}
        reg = sum(sums[i] / (k * p[n][0].numel()) * weights[n]
                  for i, n in enumerate(leaves))
        return torch.mean(var) + reg

    return loss_fn


def _optimize_group_level(
        vols: torch.Tensor, params_stack: Dict, iters: int,
        lrs: Tuple[Tuple[str, float], ...],
        stride: Tuple[int, int, int] = (1, 1, 1),
        spacing: Optional[Tuple[float, ...]] = None, mesh=None,
        k: Optional[int] = None):
    """``iters`` Adam steps of the joint groupwise level, without decay or
    jitter (``reg_engine.py:745-792``); returns the parameters and the
    final loss (a tensor). With ``mesh``, ``vols`` and ``params_stack``
    are this rank's share of the ``k`` subjects, dealt over the mesh's
    first axis; each rank's gradients, the axis's rank count times its
    subjects' own, are divided by that count."""
    reduce = None
    if mesh is not None:
        n = mesh_mod.axis_size(mesh, mesh_mod.AXES[0])
        reduce = lambda grads: [g / n for g in grads]  # noqa: E731
    return _adam_level_loop(
        _group_loss_fn(vols, stride, spacing, mesh, k), params_stack, iters,
        lrs, stride, jitter=False, decay=False, grad_reduce=reduce)


def _group_pyramid(vols: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Each image's Gaussian pyramid (``sigma`` 1, nearest border, every
    second voxel), the group stacked, coarsest first."""
    pyr = [vols]
    for _ in range(levels - 1):
        sm = filters.gaussian_filter(pyr[0], 1.0, mode="nearest")
        pyr.insert(0, sm[:, ::2, ::2, ::2].contiguous())
    return pyr


def _group_schedule(grid_spacing_schedule) -> List[Tuple[float, ...]]:
    """The groupwise B-spline levels' spacing multipliers: triplets when
    the schedule holds more than one, one value a level otherwise
    (``reg_engine.py:855-862``)."""
    if not grid_spacing_schedule:
        return [(1.0, 1.0, 1.0)]
    s = [float(v) for v in grid_spacing_schedule]
    if len(s) % 3 == 0 and len(s) > 3:
        return [tuple(s[i:i + 3]) for i in range(0, len(s), 3)]
    return [(v,) * 3 for v in s]


def register_groupwise(
        imgs: Sequence[np.ndarray], max_iter: int = 256,
        num_resolutions: int = 3, bspline_iter: int = 0,
        grid_space_voxels: float = 130.0,
        grid_spacing_schedule: Optional[Sequence[float]] = None,
        mesh=None, device="cuda") -> Tuple[np.ndarray, list]:
    """Joint groupwise registration on ``device`` (``reg_engine.py:
    795-911``): every image's affine optimised together against the
    group's variance over a pyramid of up to ``num_resolutions`` levels
    (``max_iter // 2**level`` steps, the coarsest level first, only the
    translations doubled between levels); with ``bspline_iter``, per-image
    B-spline lattices (spacing ``grid_space_voxels`` times each level's
    multiplier of ``grid_spacing_schedule``, re-sampled between levels)
    then refine jointly at full resolution, composed with the affines.
    Images are cut to their common shape. Each level's steps and seconds
    are logged. With ``mesh``, the subjects are dealt over the mesh's
    first axis in contiguous shares (``reg_engine.py:831-842``): each rank
    warps and optimises its own, the mean and the variance across
    subjects are sums over the ranks, and the parameters are gathered at
    the end. Returns ``(mean_image, per_image_params)``, numpy, the same
    on every rank."""
    dev = device_mod.resolve(device)
    target = tuple(int(s) for s in np.asarray(
        [im.shape for im in imgs]).min(axis=0))
    k = len(imgs)
    mine = range(k)
    if mesh is not None:
        axis = mesh_mod.AXES[0]
        mine = range(*mesh_mod.shard_bounds(
            k, mesh_mod.axis_size(mesh, axis),
            mesh_mod.axis_index(mesh, axis)))
    vols = torch.stack([_tensor(np.asarray(
        imgs[i][:target[0], :target[1], :target[2]], np.float32), dev)
        for i in mine])
    k_local = len(mine)
    levels = max(1, min(num_resolutions, int(np.floor(
        np.log2(max(min(target) / 8, 1)))) + 1))
    pyr = _group_pyramid(vols, levels)
    clock = _LevelClock(dev)

    def run(v, params, iters, lrs, stride, spacing=None, kind="affine"):
        start = clock.mark()
        params, loss = _optimize_group_level(v, params, iters, lrs, stride,
                                             spacing, mesh=mesh, k=k)
        clock.add(start, dict(kind=kind, shape=list(v.shape[1:]),
                              stride=list(stride), iters=iters))
        return params, loss

    params = {"W": torch.zeros((k_local, 3, 3), device=dev),
              "t": torch.zeros((k_local, 3), device=dev)}
    loss = None
    for lvl, v_l in enumerate(pyr):
        iters = max(1, max_iter // (2 ** lvl))
        params, loss = run(v_l, params, iters, _GROUP_LRS,
                           _metric_stride(v_l.shape[1:]))
        if lvl < levels - 1:
            params = {"W": params["W"], "t": params["t"] * 2.0}

    spacing = None
    if bspline_iter:
        sched = _group_schedule(grid_spacing_schedule)
        stride = _metric_stride(target)
        level_iters = max(1, int(bspline_iter) // len(sched))
        prev_spacing = None
        for mult in sched:
            spacing = tuple(float(grid_space_voxels) * m for m in mult)
            gshape = transform.bspline_grid_shape(target, spacing)
            if "grid" not in params:
                params["grid"] = torch.zeros((k_local, 3) + gshape,
                                             device=dev)
            elif tuple(params["grid"].shape[2:]) != gshape:
                params["grid"] = transform.resample_grid(
                    params["grid"], prev_spacing, gshape, spacing)
            params, loss = run(vols, params, level_iters, _GROUP_LRS_BSPLINE,
                               stride, spacing, kind="bspline")
            prev_spacing = spacing
    _logger.info("groupwise registration done, loss %.6f", float(loss))
    _logger.info("groupwise levels: %s", clock.read())

    with torch.no_grad():
        moved = transform.sample_volume(
            vols, transform.group_coords(params, target, spacing))
    host = {n: v.cpu().numpy() for n, v in params.items()}
    per_img = []
    for i in range(k_local):
        row = {n: v[i] for n, v in host.items()}
        if "grid" in row:
            row["spacing"] = spacing
        per_img.append(row)
    if mesh is None:
        return moved.mean(dim=0).cpu().numpy(), per_img
    mean = comm.all_reduce(moved.sum(dim=0), mesh, axis) / k
    per_img = [row for rows in comm.all_gather_object(per_img, mesh, axis)
               for row in rows]
    return mean.cpu().numpy(), per_img
