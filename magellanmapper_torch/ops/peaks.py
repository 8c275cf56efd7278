"""Fixed-capacity peak finding and blob pruning on PyTorch.

Port of ``magellanmapper_tpu/ops/peaks.py``. Peak finding is kernel K1
(:mod:`magellanmapper_torch.kernels.peak_candidates`) and sphere-overlap
pruning kernel K3 (:mod:`magellanmapper_torch.kernels.prune_overlap`);
each dispatches a CUDA tensor to its kernel and a CPU tensor to its plain
version. The names below are the reference's; the reference's
``prune_overlapping_blobs`` and its dispatcher
``prune_overlapping_blobs_auto`` are the one function
``prune_overlapping_blobs`` here.
"""

from __future__ import annotations

from typing import Sequence

import torch

from magellanmapper_torch.kernels.peak_candidates import (  # noqa: F401
    find_peaks, max_filter_full, select_top_sparse)
from magellanmapper_torch.kernels.prune_overlap import (  # noqa: F401
    prune_overlap as prune_overlapping_blobs)


def prune_close_blobs(
        coords: torch.Tensor, valid: torch.Tensor,
        tol: Sequence[float]) -> torch.Tensor:
    """Drop row ``i`` when an earlier valid row is within ``tol`` on every
    axis (single-pass form of the reference's sequential accept loop,
    ``ops/peaks.py:332-349``)."""
    pos = coords[:, :3].to(torch.float32)
    diff = torch.abs(pos[:, None, :] - pos[None, :, :])
    tol = torch.as_tensor(tol, dtype=torch.float32, device=pos.device)
    close = torch.all(diff <= tol, dim=-1)
    idx = torch.arange(pos.shape[0], device=pos.device)
    dominated = close & (idx[None, :] < idx[:, None]) & valid[None, :]
    return valid & ~torch.any(dominated, dim=1)
