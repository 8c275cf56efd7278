"""Whole-stack detection with the block grid dealt over the ranks.

Port of ``magellanmapper_tpu/parallel/distributed.py``. The block grid of
``cv.stack_detect.setup_blocks`` is dealt to the ranks of the mesh (block
``i`` to rank ``i % ranks``); each rank reads its blocks' windows
(``io._blockio.extract_blocks``) and detects them (kernels K1 and K3 on
the card, K4 too with ``preprocess``), re-detecting a block whose peaks
overflowed its capacity as ``detect_blobs_blocks`` does. The per-block
blobs are gathered on every rank (``all_gather_object``) and every rank
runs the same cross-block pruning, so the result equals the
single-device ``stack_detect.detect_blobs_blocks``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.cv import stack_detect
from magellanmapper_torch.io import _blockio
from magellanmapper_torch.parallel import comm, mesh as mesh_mod


def detect_blobs_blocks_sharded(
        image: np.ndarray,
        settings,
        resolutions: Sequence[float],
        mesh=None,
        preprocess: bool = False,
        device="cuda",
) -> Tuple[Optional[np.ndarray], Dict[str, float]]:
    """Single-channel whole-stack detection with the blocks dealt over the
    ranks of ``mesh`` (default: every rank on ``dp``); returns the merged,
    pruned ``N x 10`` blobs (None when empty) and stage timings, the same
    on every rank."""
    dev = device_mod.resolve(device)
    if mesh is None:
        mesh = mesh_mod.make_mesh(dp=None, sp=1, device=device)
    n_ranks = mesh_mod.axis_size(mesh, mesh_mod.AXES)
    me = mesh_mod.axis_index(mesh, mesh_mod.AXES)

    shape = tuple(int(s) for s in image.shape[:3])
    blocks = stack_detect.setup_blocks(settings, shape, resolutions)
    grid_shape = blocks.sub_roi_slices.shape
    block_shape = np.minimum(blocks.max_pixels + blocks.overlap, shape)
    max_capacity = min(1 << 20, int(np.prod(block_shape)))
    near_max = float(np.percentile(
        image[::max(1, shape[0] // 16)], 99.5)) if preprocess else 0.0
    params = stack_detect.step_params(
        settings, blocks, block_shape, resolutions, near_max, preprocess)
    mine = list(np.ndindex(*grid_shape))[me::n_ranks]

    def window(wstart) -> torch.Tensor:
        bz, by, bx = (int(v) for v in block_shape)
        if image.dtype in stack_detect._EXTRACTED:
            host = _blockio.extract_blocks(
                image, np.asarray([wstart]), block_shape)[0]
        else:
            host = np.ascontiguousarray(
                image[wstart[0]:wstart[0] + bz, wstart[1]:wstart[1] + by,
                      wstart[2]:wstart[2] + bx])
        return torch.from_numpy(host).to(dev)

    def dispatch(coords, cap):
        for coord in coords:
            wstart = stack_detect._window_for_block(
                shape, blocks.sub_rois_offsets[coord], block_shape)
            raw, valid, count = stack_detect.detect_step(
                window(wstart), params, cap)
            yield coord, wstart, raw[valid].cpu().numpy(), count

    found: Dict[tuple, np.ndarray] = {}

    def store_block(coord, wstart, raw):
        segs = stack_detect.block_blobs(raw, coord, wstart, blocks, 0)
        prev = found.get(coord)
        found[coord] = segs if prev is None else np.vstack([prev, segs])

    t0 = time.time()
    retry, fallback = [], {}
    for coord, wstart, raw, count in dispatch(mine, params.capacity):
        if count >= params.capacity:
            retry.append(coord)
            fallback[coord] = (wstart, raw)
            continue
        if raw.shape[0]:
            store_block(coord, wstart, raw)
    stack_detect._retry_overflow(retry, fallback, dispatch, store_block,
                                 params.capacity, max_capacity)
    seg_rois = np.full(grid_shape, None, dtype=object)
    for part in comm.all_gather_object(found, mesh, mesh_mod.AXES):
        for coord, segs in part.items():
            seg_rois[coord] = segs
    t_detect = time.time() - t0

    t0 = time.time()
    blobs_all = stack_detect.prune_blobs(seg_rois, blocks, shape, [0])
    timing = {"Detection": t_detect, "Pruning": time.time() - t0}
    timing["Total_stack"] = sum(timing.values())
    return blobs_all, timing
