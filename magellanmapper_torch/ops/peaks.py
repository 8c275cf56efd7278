"""Fixed-capacity peak finding and blob pruning on PyTorch.

Port of ``magellanmapper_tpu/ops/peaks.py``. :func:`find_peaks` has the
reference's two routes (``ops/peaks.py:65-114``):

- fused, for a threshold > 0 on an ``(S, Z, Y, X)`` cube: kernel K1
  (:mod:`magellanmapper_torch.kernels.peak_candidates`) returns every
  peak, ordered by value with ties to the lower flat index;
- unfused, for any threshold and for the threshold sweep of
  ``cv.detector.blob_log_multi``: the local-maximum mask (computed once
  per cube), then per threshold :func:`_sparse_top_k`, whose harvest of at
  most 8 candidates per 128-lane group is kernel K2
  (:mod:`magellanmapper_torch.kernels.extract_candidates`).

Sphere-overlap pruning is kernel K3
(:mod:`magellanmapper_torch.kernels.prune_overlap`). Each kernel wrapper
dispatches a CUDA tensor to its kernel and a CPU tensor to its plain
version. The reference's ``prune_overlapping_blobs`` and its dispatcher
``prune_overlapping_blobs_auto`` are the one function
``prune_overlapping_blobs`` here, under both names.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from magellanmapper_torch.kernels import extract_candidates as k2
from magellanmapper_torch.kernels.peak_candidates import (  # noqa: F401
    max_filter_full, peak_candidates, select_top_sparse, select_top_stable)
from magellanmapper_torch.kernels.prune_overlap import (  # noqa: F401
    prune_overlap as prune_overlapping_blobs)

#: lane-group width and harvest rounds of the unfused route. Not layout:
#: they decide which peaks of a group holding more than 8 are returned
_GROUP = k2.GROUP
_ROUNDS = k2.ROUNDS

#: the reference's dispatcher: K3 dispatches by the tensor's device
prune_overlapping_blobs_auto = prune_overlapping_blobs

Peaks = Tuple[torch.Tensor, torch.Tensor, int]


def _peak_buffers(shape: Sequence[int], top_v: torch.Tensor,
                  top_i: torch.Tensor, count: int, capacity: int) -> Peaks:
    """``(coords, values, count)`` buffers of ``capacity`` rows from the
    selected peaks: coords zero and values -inf past the selection."""
    device = top_v.device
    coords = torch.zeros(
        (capacity, len(shape)), dtype=torch.int32, device=device)
    values = torch.full(
        (capacity,), float("-inf"), dtype=torch.float32, device=device)
    n = int(top_v.shape[0])
    if n:
        # decode with Python-int divisors: torch.unravel_index ships the
        # shape to the device on every call
        cols, rem = [], top_i
        for size in reversed(shape):
            cols.append(rem % size)
            rem = rem // size
        coords[:n] = torch.stack(cols[::-1], dim=1).to(torch.int32)
        values[:n] = top_v
    return coords, values, count


def _sparse_top_k(flat_vals: torch.Tensor, capacity: int
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Top ``capacity`` finite values of each row of ``(K, N)`` mostly
    -inf ``flat_vals`` and their flat indices (``ops/peaks.py:181-225``).

    Rows are padded to a multiple of 128. When the padded row holds fewer
    than ``capacity`` groups of 128, the selection is over every value
    (ties to the lower flat index). Otherwise K2 harvests up to 8
    candidates per group, all K rows in one launch, and the selection is
    over the candidates in round-major order (the reference's
    ``cand_v.T.reshape(-1)``): equal values go to the earlier round, then
    the lower group, not to the lower flat index. Returns per row the
    selected ``(values, flat indices)``, finite entries only, values
    descending.
    """
    k, n = flat_vals.shape
    g = -(-n // _GROUP)
    if g < capacity:
        out = []
        for row in flat_vals:
            idx = torch.nonzero(torch.isfinite(row)).squeeze(1)
            out.append(select_top_stable(row[idx], idx, capacity))
        return out
    if g * _GROUP != n:
        flat_vals = F.pad(flat_vals, (0, g * _GROUP - n), value=float("-inf"))
    cand_v, cand_l = k2.extract_candidates(
        flat_vals.reshape(k * g, _GROUP))
    # (K, G, 8) -> round-major (K, 8 * G)
    cand_v = cand_v.reshape(k, g, _ROUNDS).transpose(1, 2).reshape(k, -1)
    base = torch.arange(g, device=flat_vals.device) * _GROUP
    cand_i = (cand_l.reshape(k, g, _ROUNDS).transpose(1, 2).to(torch.int64)
              + base).reshape(k, -1)
    out = []
    for v, i in zip(cand_v, cand_i):
        pos = torch.nonzero(torch.isfinite(v)).squeeze(1)
        out.append(select_top_stable(v[pos], i[pos], capacity))
    return out


def local_maxima(cube: torch.Tensor) -> torch.Tensor:
    """Voxels not below any neighbour of their 3^nd window, with 0
    outside the cube (skimage ``peak_local_max``'s full footprint,
    ``exclude_border=False``), for any sign. It does not depend on the
    threshold, so a threshold sweep computes it once."""
    return cube == max_filter_full(cube, clamp_zero=False)


def _masked_fields(cube: torch.Tensor, local_max: torch.Tensor,
                   thresholds: Sequence[float]
                   ) -> Tuple[torch.Tensor, List[int]]:
    """``(K, cube.numel())`` peak fields, ``cube`` at the local maxima
    above each threshold and -inf elsewhere, and each field's peak
    count."""
    flat = torch.empty((len(thresholds), cube.numel()), dtype=cube.dtype,
                       device=cube.device)
    neg_inf = cube.new_full((), float("-inf"))
    counts = []
    for k, th in enumerate(thresholds):
        is_peak = local_max & (cube > th)
        counts.append(is_peak.sum())
        torch.where(is_peak, cube, neg_inf, out=flat[k].view(cube.shape))
    return flat, [int(c) for c in torch.stack(counts).tolist()]


def find_peaks_unfused(
        cube: torch.Tensor, thresholds: Sequence[float], capacity: int
) -> List[Peaks]:
    """The reference's unfused ``find_peaks`` at each of ``thresholds``
    (``ops/peaks.py:105-114``), sharing one :func:`local_maxima` mask.

    Returns per threshold ``(coords, values, count)`` as
    :func:`find_peaks`. ``count`` is every peak above the threshold,
    capped at ``capacity``; a 128-lane group holding more than 8 peaks
    returns only 8 of them, so fewer rows than ``count`` may be finite.
    """
    flat, counts = _masked_fields(cube, local_maxima(cube), thresholds)
    return [_peak_buffers(cube.shape, v, i, min(c, capacity), capacity)
            for (v, i), c in zip(_sparse_top_k(flat, capacity), counts)]


def find_peaks(
        cube: torch.Tensor, threshold: float, capacity: int,
        fused: Optional[bool] = None) -> Peaks:
    """Local maxima of ``cube`` above ``threshold``, capped at ``capacity``.

    Returns ``coords`` ``(capacity, cube.dim())`` int32 sorted by peak value
    descending (zero past the selection), ``values`` ``(capacity,)``
    float32 (-inf past the selection) and ``count``, the number of peaks
    capped at ``capacity``.

    ``fused`` (default: a threshold > 0 on a 4D cube) takes K1, which
    needs a threshold > 0; otherwise the unfused route runs
    (:func:`find_peaks_unfused`), exact for any sign of the threshold.
    """
    positive = float(threshold) > 0
    if fused is None:
        fused = positive and cube.dim() == 4
    if not fused:
        return find_peaks_unfused(cube, [threshold], capacity)[0]
    vals, idx = peak_candidates(cube, threshold)
    top_v, top_i = select_top_sparse(vals, idx, capacity)
    return _peak_buffers(cube.shape, top_v, top_i,
                         min(int(vals.shape[0]), capacity), capacity)


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
