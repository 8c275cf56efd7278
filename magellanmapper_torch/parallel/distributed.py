"""Whole-stack detection with the block grid dealt over the ranks.

Port of ``magellanmapper_tpu/parallel/distributed.py``. The block grid of
``cv.stack_detect.setup_blocks`` is dealt to the ranks of the mesh (block
``i`` to rank ``i % ranks``); each rank runs ``stack_detect``'s block
pass (:class:`cv.stack_detect.BlockPass`) over its blocks, each window
gathered on its own (kernels K1 and K3 on the card, K4 too with
``preprocess``; blocks whose peaks overflowed their capacity are
re-detected), as ``detect_blobs_blocks`` runs it over every block. The
per-block blobs are gathered on every rank (``all_gather_object``) and
every rank runs the same cross-block pruning, so the result equals the
single-device ``stack_detect.detect_blobs_blocks``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.cv import stack_detect
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
    if mesh is None:
        mesh = mesh_mod.make_mesh(dp=None, sp=1, device=device)
    n_ranks = mesh_mod.axis_size(mesh, mesh_mod.AXES)
    me = mesh_mod.axis_index(mesh, mesh_mod.AXES)

    shape = tuple(int(s) for s in image.shape[:3])
    blocks = stack_detect.setup_blocks(settings, shape, resolutions)
    block_pass = stack_detect.BlockPass(
        blocks, shape, device_mod.resolve(device))
    near_max = stack_detect.sample_near_max(image) if preprocess else 0.0
    params = stack_detect.step_params(
        settings, blocks, block_pass.block_shape, resolutions, near_max,
        preprocess)
    mine = list(np.ndindex(*blocks.sub_roi_slices.shape))[me::n_ranks]

    t0 = time.perf_counter()
    block_pass.run(image, params, 0, mine)
    seg_rois = block_pass.seg_rois
    found = {coord: seg_rois[coord] for coord in mine
             if seg_rois[coord] is not None}
    for part in comm.all_gather_object(found, mesh, mesh_mod.AXES):
        for coord, segs in part.items():
            seg_rois[coord] = segs
    t_detect = time.perf_counter() - t0

    t0 = time.perf_counter()
    blobs_all = stack_detect.prune_blobs(seg_rois, blocks, shape, [0])
    timing = {"Detection": t_detect, "Pruning": time.perf_counter() - t0}
    timing["Total_stack"] = sum(timing.values())
    return blobs_all, timing
