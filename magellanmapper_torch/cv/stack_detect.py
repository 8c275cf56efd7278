"""Whole-image block detection on PyTorch.

Port of ``magellanmapper_tpu/cv/stack_detect.py``. The host plans blocks
(geometry, staging, overflow retries, cross-block pruning) exactly as
the reference does; the device step runs per block: per-denoise-tile
saturate and denoise (percentiles from kernel K4), the LoG pyramid, peak
finding (K1) and sphere-overlap pruning (K3). A batch of blocks is a
Python loop over views of the staged volume.

Staging: a volume up to ``_RESIDENT_BYTES_BUDGET`` bytes goes to the
device once and blocks are carved from it; a larger one goes in uniform
z/y slabs (``_plan_slabs``), one slab on the device at a time; one whose
block rows do not fit a slab ships each block window on its own. (The
reference's separate path for volumes smaller than a block window,
``stack_detect.py:756-768``, cannot run: the window is clamped to the
volume, ``:658``.)

Spans (``utils.profiler.annotate``, recorded only under a profiler):
``mm.detect`` a call; inside it ``mm.stage`` a transfer, ``mm.block`` a
block (``mm.preprocess``, ``mm.log``, ``mm.peaks``, ``mm.overlap``,
``mm.pull``), ``mm.store``, ``mm.retry``, and ``mm.prune`` with a
``mm.prune.match`` for each band matched (counter ``pairs``).
"""

from __future__ import annotations

import logging
import math
import time
from enum import Enum
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.cv import blobs as blobs_mod
from magellanmapper_torch.cv import chunking, detector
from magellanmapper_torch.io import _blockio
from magellanmapper_torch.settings import roi_prof
from magellanmapper_torch.ops import filters, preproc
from magellanmapper_torch.utils import profiler

_logger = logging.getLogger(__name__)

#: volumes up to this many bytes are staged to the device once; larger
#: ones in slabs of at most this many bytes
_RESIDENT_BYTES_BUDGET = 1 << 30
#: per-axis cap on the device block edge
_DEVICE_BLOCK_CAP = 256
#: volume types whose single windows go through the threaded extractor
#: (the reference's gather ships the narrow integer types as they are)
_EXTRACTED = tuple(np.dtype(t) for t in (
    np.uint32, np.int32, np.float32, np.float64))


class Blocks(NamedTuple):
    """Block-processing geometry (reference ``stack_detect.Blocks``)."""
    sub_roi_slices: np.ndarray
    sub_rois_offsets: np.ndarray
    denoise_max_shape: Optional[np.ndarray]
    exclude_border: Optional[Sequence[int]]
    tol: np.ndarray
    overlap_base: np.ndarray
    overlap: np.ndarray
    overlap_padding: np.ndarray
    max_pixels: np.ndarray


def setup_blocks(
        settings, shape: Sequence[int],
        resolutions: Sequence[float]) -> Blocks:
    """Block geometry from profile settings (copy of the reference's)."""
    scaling_factor = detector.calc_scaling_factor(resolutions)
    denoise_size = settings["denoise_size"]
    denoise_max_shape = None
    if denoise_size:
        denoise_max_shape = np.ceil(
            scaling_factor * denoise_size).astype(int)

    overlap_base = detector.calc_overlap(resolutions)
    tol = np.multiply(
        overlap_base, settings["prune_tol_factor"]).astype(int)
    overlap_padding = np.copy(tol)
    overlap = np.copy(overlap_base)
    exclude_border = settings["exclude_border"]
    if exclude_border is not None:
        # overlap must exceed 2x border exclusion so no plane is excluded
        # from both overlapping blocks
        exclude_border = np.asarray(exclude_border)
        thresh = 2 * exclude_border
        less = overlap < thresh
        overlap[less] = thresh[less]
        excluded = exclude_border > 0
        overlap[excluded] += 1
        overlap_padding[excluded] = 0
    max_pixels = np.ceil(
        scaling_factor * settings["segment_size"]).astype(int)
    max_pixels = np.minimum(max_pixels, _DEVICE_BLOCK_CAP)
    # the reference aligns the y/x window (max_pixels + overlap) to 128
    # lanes for its TPU peak kernel; kept so block borders, and so the
    # blobs, match the reference
    for ax in (1, 2):
        window = max_pixels[ax] + overlap[ax]
        aligned = (window // 128) * 128
        if aligned >= 128 and aligned > overlap[ax]:
            max_pixels[ax] = aligned - overlap[ax]
    sub_roi_slices, sub_rois_offsets = chunking.stack_splitter(
        shape, max_pixels, overlap)
    return Blocks(
        sub_roi_slices, sub_rois_offsets, denoise_max_shape,
        None if exclude_border is None else np.asarray(exclude_border),
        tol, overlap_base, overlap, overlap_padding, max_pixels)


def _window_for_block(
        shape: Sequence[int], start: np.ndarray,
        block_shape: np.ndarray) -> np.ndarray:
    """Clamp a uniform window start so it fits inside the volume."""
    return np.maximum(0, np.minimum(start, np.asarray(shape) - block_shape))


def _choose_capacity(settings, block_voxels: int) -> int:
    cap = settings["max_blobs_per_block"]
    if cap:
        return int(cap)
    return max(1024, min(32768, block_voxels // 1024))


def roi_profile(names: str = "lightsheet") -> roi_prof.ROIProfile:
    """ROI profile with the comma-separated named profiles applied, as
    ``--roi_profile names`` builds it."""
    prof = roi_prof.ROIProfile()
    prof.add_profiles(names)
    return prof


class StepParams(NamedTuple):
    """Static arguments of the per-block device step, derived from the
    profile as ``detect_blobs_blocks`` does (``stack_detect.py:659-724``
    of the reference, whose step functions take the same values)."""
    sigmas: Tuple[float, ...]
    threshold: float
    overlap: float
    capacity: int
    denoise_shape: Optional[Tuple[int, ...]]
    preproc_items: Optional[Tuple[Tuple[str, float], ...]]
    #: the fast LoG route (profile ``log_dtype="bfloat16"``); the
    #: preprocessing stays float32 either way
    fast: bool = False


def step_params(
        settings, blocks: Blocks, block_shape: Sequence[int],
        resolutions: Sequence[float], near_max: float,
        preprocess: bool = True) -> StepParams:
    """The device step's arguments for one channel of near-max
    ``near_max``."""
    scaling_factor = detector.calc_scaling_factor(resolutions)[2]
    sigmas = tuple(float(s) for s in detector.sigma_list(
        settings["min_sigma_factor"] * scaling_factor,
        settings["max_sigma_factor"] * scaling_factor,
        settings["num_sigma"]))
    prep = None
    if preprocess:
        prep = (
            ("clip_vmin", float(settings["clip_vmin"])),
            ("clip_vmax", float(settings["clip_vmax"])),
            ("max_thresh", float(
                near_max * settings["max_thresh_factor"])),
            ("clip_min", float(settings["clip_min"])),
            ("clip_max", float(settings["clip_max"])),
            ("tot_var_denoise", float(settings["tot_var_denoise"] or 0.0)),
            ("unsharp_strength", float(
                settings["unsharp_strength"] or 0.0)),
            ("erosion_threshold", float(
                settings["erosion_threshold"] or 0.0)),
        )
    denoise_shape = (tuple(int(d) for d in blocks.denoise_max_shape)
                     if blocks.denoise_max_shape is not None else None)
    return StepParams(
        sigmas, float(settings["detection_threshold"]),
        float(settings["overlap"]),
        _choose_capacity(settings, int(np.prod(block_shape))),
        denoise_shape, prep, detector.is_fast(settings))


# ---------------------------------------------------------------------------
# device step


def preprocess_block(
        vol: torch.Tensor, denoise_shape: Optional[Tuple[int, ...]],
        preproc_items: Optional[Tuple[Tuple[str, float], ...]]
) -> torch.Tensor:
    """Saturate and denoise each denoise tile of a ``(Z, Y, X)`` block.

    The block is padded at its trailing ends (numpy 'symmetric', in its
    own dtype) to whole tiles, the tiles are stacked along a leading
    axis and preprocessed as one batch, and the result is put back and
    cropped: the semantics of the reference's ``_preproc_sub_blocks_fused``
    (``:270-340``), plus per-tile total-variation denoising for profiles
    that ask for it, as its ``_preproc_sub_blocks`` (``:121-147``) does.
    Without ``denoise_shape`` the whole block is one tile. Returns float32.
    """
    if preproc_items is None:
        return vol
    params = dict(preproc_items)
    if denoise_shape is None:
        tiles, grid = vol[None], (1, 1, 1)
    else:
        tiles, grid = to_tiles(vol, denoise_shape)
    out = preproc.saturate(
        tiles, params["clip_vmin"], params["clip_vmax"],
        params.get("max_thresh"))
    out = preproc.denoise(
        out, params["clip_min"], params["clip_max"],
        params["tot_var_denoise"], params["unsharp_strength"],
        params["erosion_threshold"])
    nz, ny, nx = grid
    dz, dy, dx = out.shape[1:]
    out = out.reshape(nz, ny, nx, dz, dy, dx).permute(
        0, 3, 1, 4, 2, 5).reshape(nz * dz, ny * dy, nx * dx)
    bz, by, bx = vol.shape
    return out[:bz, :by, :bx]


def to_tiles(vol: torch.Tensor, denoise_shape: Tuple[int, ...]
             ) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """A ``(Z, Y, X)`` block, padded at its trailing ends (numpy
    'symmetric') to whole tiles, as a ``(T, dz, dy, dx)`` stack of its
    denoise tiles in its own dtype, plus the ``(nz, ny, nx)`` tile grid."""
    dz, dy, dx = denoise_shape
    bz, by, bx = vol.shape
    nz, ny, nx = -(-bz // dz), -(-by // dy), -(-bx // dx)
    padded = filters.pad_symmetric(
        vol, [(0, nz * dz - bz), (0, ny * dy - by), (0, nx * dx - bx)])
    tiles = padded.reshape(nz, dz, ny, dy, nx, dx).permute(
        0, 2, 4, 1, 3, 5).reshape(-1, dz, dy, dx)
    return tiles, (nz, ny, nx)


def detect_step(
        block: torch.Tensor, params: StepParams,
        capacity: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Preprocess and detect one ``(Z, Y, X)`` block.

    Returns ``raw`` ``(capacity, 4)`` rows ``z, y, x, sigma``, ``valid``
    ``(capacity,)`` and the pre-prune peak count.
    """
    cap = params.capacity if capacity is None else capacity
    with profiler.annotate("mm.preprocess"):
        vol = preprocess_block(
            block, params.denoise_shape, params.preproc_items)
    return detector.blob_log(
        vol, params.sigmas, params.threshold, params.overlap, cap,
        fast=params.fast)


# ---------------------------------------------------------------------------
# host planning and staging


class SlabPlan(NamedTuple):
    """Z/Y-slab plan for staging past the whole-volume budget: every slab
    has the same ``(sz, sy)`` extent with a clamped origin; ``slabs`` rows
    are ``(z0, y0, coords)`` with the block-grid coords inside the slab."""
    extent: Tuple[int, int]
    slabs: List[Tuple[int, int, List[Tuple[int, ...]]]]
    bytes_per_slab: int


def _plan_slabs(
        grid_shape, blocks: Blocks, block_shape, shape,
        itemsize: int, budget: Optional[int] = None) -> Optional[SlabPlan]:
    """Group block rows into uniform-extent slabs of <= ``budget`` bytes
    (copy of the reference's planner): full-Y z-slabs when one fits, else
    y-chunked single z block rows, else None (ship blocks one by one)."""
    if budget is None:
        budget = _RESIDENT_BYTES_BUDGET
    nz, ny, nx = (int(v) for v in grid_shape)
    bz, by, _bx = (int(v) for v in block_shape)
    stride = np.asarray(blocks.max_pixels, int)
    # the containment proof needs uniform strides: verify offsets
    for k in range(nz):
        if int(blocks.sub_rois_offsets[(k, 0, 0)][0]) != k * stride[0]:
            return None
    for j in range(ny):
        if int(blocks.sub_rois_offsets[(0, j, 0)][1]) != j * stride[1]:
            return None

    def extent(m, st, b, dim):
        return min((m - 1) * st + b, dim)

    row_bytes = int(shape[2]) * itemsize
    m_z = m_y = None
    for m in range(nz, 0, -1):
        sz = extent(m, stride[0], bz, shape[0])
        if sz * shape[1] * row_bytes <= budget:
            m_z, m_y = m, ny
            sy = int(shape[1])
            break
    if m_z is None:
        sz = min(bz, int(shape[0]))
        for m in range(ny, 0, -1):
            sy = extent(m, stride[1], by, shape[1])
            if sz * sy * row_bytes <= budget:
                m_z, m_y = 1, m
                break
    if m_z is None:
        return None
    slabs = []
    for k0 in range(0, nz, m_z):
        z0 = min(k0 * int(stride[0]), int(shape[0]) - sz)
        for j0 in range(0, ny, m_y):
            y0 = min(j0 * int(stride[1]), int(shape[1]) - sy)
            coords = [
                (k, j, i)
                for k in range(k0, min(k0 + m_z, nz))
                for j in range(j0, min(j0 + m_y, ny))
                for i in range(nx)]
            slabs.append((z0, y0, coords))
    return SlabPlan((sz, sy), slabs, sz * sy * row_bytes)


def _retry_overflow(retry, fallback, dispatch, store_block, capacity,
                    max_capacity):
    """Re-detect capacity-overflowed blocks at doubled capacity until they
    fit or the ceiling is hit (dynamic lists never truncate in the
    reference); at the ceiling, store the truncated brightest-first rows
    rather than drop the block."""
    cap = capacity
    while retry and cap < max_capacity:
        cap = min(cap * 2, max_capacity)
        _logger.info(
            "re-detecting %d dense blocks at capacity %d", len(retry), cap)
        still = []
        for coord, wstart, raw, count in dispatch(retry, cap):
            if count >= cap and cap < max_capacity:
                still.append(coord)
                fallback[coord] = (wstart, raw)
                continue
            if raw.shape[0]:
                store_block(coord, wstart, raw)
        retry = still
    for coord in retry:
        wstart, raw = fallback[coord]
        _logger.warning(
            "block %s still overflows at the %d-blob capacity ceiling; "
            "storing truncated results", coord, max_capacity)
        if raw.shape[0]:
            store_block(coord, wstart, raw)


@profiler.annotated("mm.detect")
def detect_blobs_blocks(
        image: np.ndarray,
        settings,
        resolutions: Sequence[float],
        channels: Optional[Sequence[int]] = None,
        near_max: Optional[Sequence[float]] = None,
        preprocess: bool = True,
        verify_fn=None,
        device: Union[str, torch.device] = "cuda",
) -> Tuple[Optional[np.ndarray], Dict[str, float]]:
    """Detect blobs across a whole (sub)image in blocks on ``device``.

    Args:
        image: ``(Z, Y, X[, C])`` volume (NumPy; may be a memmap).
        settings: ROI profile for the channel group.
        resolutions: z,y,x spacing.
        channels: channels to detect (must share block settings); None = all.
        near_max: near-max intensity for saturation, indexed by channel
            number; measured from the volume when absent.
        preprocess: apply saturate+denoise per denoise tile.
        verify_fn: optional callback ``(blobs) -> stats``, run on the
            pruned blobs when there are any; its result is
            ``timing["verify_stats"]``.
        device: where the device step runs: the card unless ``"cpu"`` is
            asked for; a CUDA device without a card raises.

    Returns:
        ``(blobs, timing)``: merged, pruned N x 10 blob array (None when
        empty) and stage timings in seconds (the reference's
        ``stack_detection_times.csv`` fields), from the same
        ``perf_counter`` reads as the spans ``mm.stage`` (``Gather_host``
        and ``Stage_h2d``), ``mm.pull`` (``Pull_wait``) and ``mm.prune``
        (``Pruning``).
    """
    dev = device_mod.resolve(device)
    shape = tuple(int(s) for s in image.shape[:3])
    multichannel = image.ndim > 3
    if channels is None:
        channels = list(range(image.shape[3])) if multichannel else [0]
    channels = list(np.atleast_1d(channels))

    blocks = setup_blocks(settings, shape, resolutions)
    grid_shape = blocks.sub_roi_slices.shape
    block_shape = np.minimum(blocks.max_pixels + blocks.overlap, shape)
    bz, by, bx = (int(v) for v in block_shape)
    block_voxels = int(np.prod(block_shape))
    #: hard ceiling for overflow-retry capacity doubling
    max_capacity = min(1 << 20, block_voxels)

    if near_max is None:
        # per-channel near-max for saturation, sampled as the importer
        # does (99.5th percentile)
        sample = image[::max(1, shape[0] // 16)]
        near_max = {
            c: float(np.percentile(
                sample[..., c] if multichannel else sample, 99.5))
            for c in channels}
    else:
        near_max = {c: near_max[c] for c in channels}

    coords_list = list(np.ndindex(*grid_shape))
    seg_rois = np.full(grid_shape, None, dtype=object)
    totals = {"Gather_host": 0.0, "Pull_wait": 0.0, "Stage_h2d": 0.0,
              "h2d_bytes": 0}
    time_detect = time.perf_counter()

    for chl in channels:
        chan_img = image[..., chl] if multichannel else image
        params = step_params(
            settings, blocks, block_shape, resolutions, near_max[chl],
            preprocess)
        nbytes = chan_img.size * chan_img.itemsize
        if nbytes <= _RESIDENT_BYTES_BUDGET:
            # resident staging: one slab holding the whole volume
            slab_plan = SlabPlan(
                (shape[0], shape[1]), [(0, 0, coords_list)], nbytes)
        else:
            slab_plan = _plan_slabs(
                grid_shape, blocks, block_shape, shape, chan_img.itemsize)

        def to_device(host: np.ndarray) -> torch.Tensor:
            """Read ``host`` (a view of the possibly memmapped image) into
            memory and ship it: Gather_host, then Stage_h2d."""
            with profiler.annotate("mm.stage", clock=True) as stage:
                host = np.ascontiguousarray(host)
                if not host.flags.writeable:
                    # read-only memmap: torch.from_numpy wants writable
                    # memory
                    host = host.copy()
                t1 = time.perf_counter()
                out = torch.from_numpy(host).to(dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            totals["Gather_host"] += t1 - stage.t0
            totals["Stage_h2d"] += stage.t1 - t1
            totals["h2d_bytes"] += host.nbytes
            return out

        def gather(wstart) -> torch.Tensor:
            """Ship one block window on its own; wider volumes are read
            and cast to float32 by the threaded extractor, as in the
            reference's gather (the device step casts to float32 all the
            same)."""
            if chan_img.dtype in _EXTRACTED:
                return to_device(_blockio.extract_blocks(
                    chan_img, np.asarray([wstart]), (bz, by, bx))[0])
            return to_device(chan_img[wstart[0]:wstart[0] + bz,
                                      wstart[1]:wstart[1] + by,
                                      wstart[2]:wstart[2] + bx])

        def detect(block: torch.Tensor, cap: int):
            with profiler.annotate("mm.block"):
                raw, valid, count = detect_step(block, params, cap)
                with profiler.annotate("mm.pull", clock=True) as pull:
                    rows = raw[valid].cpu().numpy()
            totals["Pull_wait"] += pull.seconds
            return rows, count

        def dispatch(coords, cap):
            """Blocks shipped one by one; yields
            ``(coord, window start, rows, pre-prune count)``."""
            for coord in coords:
                wstart = _window_for_block(
                    shape, blocks.sub_rois_offsets[coord], block_shape)
                rows, count = detect(gather(wstart), cap)
                yield coord, wstart, rows, count

        def staged(plan: SlabPlan):
            """Each slab staged once, its blocks carved on the device."""
            sz, sy = plan.extent
            for z0, y0, coords in plan.slabs:
                slab = to_device(chan_img[z0:z0 + sz, y0:y0 + sy])
                for coord in coords:
                    wstart = _window_for_block(
                        shape, blocks.sub_rois_offsets[coord], block_shape)
                    z, y, x = (int(v) for v in wstart)
                    block = slab[z - z0:z - z0 + bz, y - y0:y - y0 + by,
                                 x:x + bx]
                    rows, count = detect(block, params.capacity)
                    yield coord, wstart, rows, count
                del slab

        def store_block(coord, wstart, raw):
            with profiler.annotate("mm.store"):
                segs = block_blobs(raw, coord, wstart, blocks, chl)
                prev = seg_rois[coord]
                seg_rois[coord] = (
                    segs if prev is None else np.vstack([prev, segs]))

        results = (staged(slab_plan) if slab_plan is not None
                   else dispatch(coords_list, params.capacity))
        retry, fallback = [], {}
        for coord, wstart, rows, count in results:
            if count >= params.capacity:
                # a full PRE-prune buffer may be truncated: re-detect at a
                # doubled capacity (post-prune counts can sit below it)
                retry.append(coord)
                fallback[coord] = (wstart, rows)
                continue
            if rows.shape[0]:
                store_block(coord, wstart, rows)
        with profiler.annotate("mm.retry"):
            _retry_overflow(retry, fallback, dispatch, store_block,
                            params.capacity, max_capacity)

    time_detect = time.perf_counter() - time_detect
    with profiler.annotate("mm.prune", clock=True) as prune:
        blobs_all = prune_blobs(seg_rois, blocks, shape, channels)
    time_prune = prune.seconds

    timing = {"Detection": time_detect, "Pruning": time_prune,
              "Total_stack": time_detect + time_prune, **totals}
    if verify_fn is not None and blobs_all is not None:
        timing["verify_stats"] = verify_fn(blobs_all)
    return blobs_all, timing


def block_blobs(raw: np.ndarray, coord, wstart, blocks: Blocks,
                channel) -> np.ndarray:
    """One block's device rows as blobs of ``channel``: radii from
    sigmas, shifted to absolute coordinates, only those inside the
    block's sub-ROI kept (less its border zone, except at the stack's
    outer faces)."""
    raw[:, 3] *= math.sqrt(3)
    segs = blobs_mod.Blobs(raw).format_blobs(channel)
    blobs_mod.Blobs.shift_blob_rel_coords(segs, wstart)
    blobs_mod.Blobs.shift_blob_abs_coords(segs, wstart)
    sl = blocks.sub_roi_slices[coord]
    lo = np.asarray([s.start for s in sl])
    hi = np.asarray([s.stop for s in sl])
    if blocks.exclude_border is not None:
        last_coord = np.asarray(blocks.sub_roi_slices.shape) - 1
        exc = np.stack([blocks.exclude_border] * 2)
        exc[0, np.equal(coord, 0)] = 0
        exc[1, np.equal(coord, last_coord)] = 0
        lo = lo + exc[0]
        hi = hi - exc[1]
    keep = np.all((segs[:, :3] >= lo) & (segs[:, :3] < hi), axis=1)
    return segs[keep]


def prune_blobs(
        seg_rois: np.ndarray, blocks: Blocks, shape: Sequence[int],
        channels: Sequence[int]) -> Optional[np.ndarray]:
    """Cross-block duplicate pruning over overlap planes, on the host
    (copy of the reference's ``prune_blobs``): per channel and axis, blobs
    in each overlap band are pruned against the adjacent section by
    tolerance matching; blobs outside the bands pass through."""
    merged = chunking.merge_blobs(seg_rois)
    if merged is None:
        return None
    tol = blocks.tol
    overlap = blocks.overlap
    overlap_padding = blocks.overlap_padding
    offsets = blocks.sub_rois_offsets
    slices = blocks.sub_roi_slices
    grid_shape = slices.shape

    blobs_out = []
    for chl in channels:
        blobs = merged[blobs_mod.Blobs.get_blobs_channel(merged) == chl]
        for axis in range(3):
            num_sections = grid_shape[axis]
            if num_sections <= 1:
                continue
            non_ol_parts = []
            pruned_parts = []
            shift = overlap[axis] + overlap_padding[axis]
            for j in range(num_sections):
                coord = [0, 0, 0]
                coord[axis] = j
                coord = tuple(coord)
                offset_axis = offsets[coord][axis]
                sl = slices[coord][axis]
                size_axis = sl.stop - sl.start

                masks = []
                if j < num_sections - 1:
                    bound_lo = offset_axis + size_axis - shift
                    bound_hi = (offset_axis + size_axis
                                + overlap_padding[axis])
                    in_band = ((blobs[:, axis] >= bound_lo)
                               & (blobs[:, axis] < bound_hi))
                    band = blobs[in_band]
                    # prune: section j is master, j+1 is checked
                    axis_col = band.shape[1] - 3 + axis
                    master = band[band[:, axis_col] == j]
                    check = band[band[:, axis_col] == j + 1]
                    rest = band[(band[:, axis_col] != j)
                                & (band[:, axis_col] != j + 1)]
                    with profiler.annotate("mm.prune.match"):
                        profiler.count("pairs", len(check) * len(master))
                        pruned, master = detector.remove_close_blobs(
                            check, master, tol)
                    pruned_parts.extend(
                        [p for p in (master, pruned, rest) if len(p)])
                    masks.append(blobs[:, axis] < bound_lo)
                else:
                    masks.append(blobs[:, axis] < offset_axis + size_axis)
                start = offset_axis + (shift if j > 0 else 0)
                masks.append(blobs[:, axis] >= start)
                non_ol_parts.append(blobs[np.all(masks, axis=0)])
            parts = [p for p in non_ol_parts + pruned_parts if len(p)]
            blobs = np.vstack(parts) if parts else blobs[:0]
        blobs_out.append(blobs)
    if not blobs_out:
        return None
    out = np.vstack(blobs_out)
    if out.shape[0] == 0:
        # every blob pruned away (e.g. all duplicates in overlap bands)
        return None
    return out[:, :-3]


def detect_blobs_stack(
        image: np.ndarray,
        profiles,
        resolutions: Sequence[float],
        channels: Optional[Sequence[int]] = None,
        classifier_model=None,
        **kwargs,
) -> Tuple[blobs_mod.Blobs, Dict[str, float]]:
    """Detect blobs across all channels, grouping channels whose profiles
    share block geometry; ``kwargs`` go to :func:`detect_blobs_blocks`
    (``device`` defaults to the card there). With ``classifier_model`` (a
    ``cv.classifier.BlobClassifier``), the merged blobs of every channel
    are classified on channel 0's image into their ``confirmed`` column,
    as the reference does.

    Returns ``(Blobs, timing)`` with blobs merged across channel groups.
    """
    multichannel = image.ndim > 3
    if channels is None:
        channels = list(range(image.shape[3])) if multichannel else [0]
    channels = list(np.atleast_1d(channels))

    def get_prof(chl):
        if isinstance(profiles, (list, tuple)):
            return profiles[min(chl, len(profiles) - 1)]
        return profiles

    # group channels by identical block settings
    groups: List[List[int]] = []
    for chl in channels:
        for grp in groups:
            if roi_prof.is_identical_block_settings(
                    [get_prof(grp[0]), get_prof(chl)]):
                grp.append(chl)
                break
        else:
            groups.append([chl])

    all_blobs = []
    timing: Dict[str, float] = {}
    for grp in groups:
        out, t = detect_blobs_blocks(
            image, get_prof(grp[0]), resolutions, channels=grp, **kwargs)
        if out is not None:
            all_blobs.append(out)
        for k, v in t.items():
            if isinstance(v, (int, float)):
                timing[k] = timing.get(k, 0.0) + v

    merged = np.vstack(all_blobs) if all_blobs else None
    if merged is not None and classifier_model is not None:
        from magellanmapper_torch.cv import classifier as classifier_mod
        vol = image[..., 0] if image.ndim > 3 else image
        merged = classifier_mod.classify_whole_image(
            classifier_model, vol, merged)
    blobs = blobs_mod.Blobs(merged)
    blobs.resolutions = np.atleast_2d(np.asarray(resolutions, float))
    return blobs, timing


class StackTimes(Enum):
    """Stack processing duration keys (reference ``stack_detect.py:
    1168``); values match the timing dict of :func:`detect_blobs_blocks`."""
    DETECTION = "Detection"
    PRUNING = "Pruning"
    TOTAL = "Total_stack"


class StackDetector:
    """Class façade over :func:`detect_blobs_blocks` (reference
    ``StackDetector``): carries the configuration and the device (the
    card unless ``"cpu"`` is asked for). ``coloc`` is kept and not read,
    as in the reference."""

    def __init__(self, img, settings, resolutions, channel=None,
                 coloc=False, device: Union[str, torch.device] = "cuda"):
        self.img = img
        self.settings = settings
        self.resolutions = resolutions
        self.channel = channel
        self.coloc = coloc
        self.device = device

    def detect_stack(self, preprocess: bool = True):
        """Run whole-stack detection; returns ``(blobs, timing)``."""
        return detect_blobs_blocks(
            self.img, self.settings, self.resolutions,
            channels=self.channel, preprocess=preprocess,
            device=self.device)


class StackPruner:
    """Class façade over cross-block pruning (reference ``StackPruner``);
    delegates to :func:`prune_blobs`."""

    def __init__(self, seg_rois, blocks, shape, channels):
        self.seg_rois = seg_rois
        self.blocks = blocks
        self.shape = shape
        self.channels = channels

    def prune(self):
        """Prune duplicates in all overlap regions; returns the kept
        blobs array."""
        return prune_blobs(
            self.seg_rois, self.blocks, self.shape, self.channels)
