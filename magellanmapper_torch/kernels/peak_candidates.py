"""K1: fused 3^4 local-maximum test, peak compaction and selection.

Replaces ``peak_candidates_pallas`` and its wrapper ``find_peaks_fused``
(``magellanmapper_tpu/ops/pallas_kernels.py:478,540``). A voxel of the
``(S, Z, Y, X)`` LoG cube is a peak when it is above the positive
threshold and not below any of its 80 neighbours over (s, z, y, x), with
out-of-range neighbours counted as 0 (``reduce_window``'s init,
``ops/peaks.py:40-44``). The CUDA kernel (``csrc/peak_candidates.cu``)
returns every peak as an unordered (value, flat index) list; the plain
version is :func:`max_filter_full` plus the compare. Selection is shared:
value descending, ties to the lower flat index, cut at capacity.

Unlike the TPU kernel there is no cap of 8 candidates per 128-lane group:
every peak is returned and counted.
"""

from __future__ import annotations

from typing import Tuple

import torch

from magellanmapper_torch import device as dev
from magellanmapper_torch.kernels import _build

SOURCE = "magellanmapper_torch/csrc/peak_candidates.cu"
REPLACES = "magellanmapper_tpu/ops/pallas_kernels.py:478"

#: first peak-buffer size; the kernel is launched again with a buffer of
#: the exact count when a cube holds more peaks
_FIRST_BUFFER = 1 << 16


def max_filter_full(cube: torch.Tensor) -> torch.Tensor:
    """Max filter with a full 3^nd footprint and constant-0 border,
    clamped to >= 0 (the reference's 0-initialised ``reduce_window``)."""
    out = cube
    for ax in range(cube.dim()):
        n = out.shape[ax]
        zero = torch.zeros_like(out.narrow(ax, 0, 1))
        lo = torch.cat([zero, out.narrow(ax, 0, n - 1)], dim=ax)
        hi = torch.cat([out.narrow(ax, 1, n - 1), zero], dim=ax)
        out = torch.maximum(torch.maximum(lo, out), hi)
    return torch.clamp_min(out, 0.0)


def peak_candidates_plain(
        cube: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: every peak's value and flat index, in flat
    index order."""
    is_peak = (cube == max_filter_full(cube)) & (cube > threshold)
    idx = torch.nonzero(is_peak.reshape(-1)).squeeze(1)
    return cube.reshape(-1)[idx], idx


def _launch(cube: torch.Tensor, threshold: float, buf_cap: int):
    s, z, y, x = cube.shape
    vals = torch.empty(buf_cap, dtype=torch.float32, device=cube.device)
    idx = torch.empty(buf_cap, dtype=torch.int32, device=cube.device)
    count = torch.zeros(1, dtype=torch.int32, device=cube.device)
    lib = _build.library()
    with torch.cuda.device(cube.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mm_peak_candidates(
            cube.data_ptr(), s, z, y, x, float(threshold), vals.data_ptr(),
            idx.data_ptr(), count.data_ptr(), buf_cap, stream)
    _build.check(err, "mm_peak_candidates")
    dev.count_launch("peak_candidates")
    return vals, idx, int(count.item())


def _peak_candidates_cuda(cube: torch.Tensor, threshold: float):
    if cube.dim() != 4:
        raise ValueError(
            f"peak_candidates kernel takes an (S, Z, Y, X) cube, got "
            f"{tuple(cube.shape)}")
    if cube.dtype != torch.float32 or not cube.is_contiguous():
        raise TypeError(
            "peak_candidates kernel takes a contiguous float32 cube")
    if cube.numel() >= 2 ** 31:
        raise ValueError(
            f"cube of {cube.numel()} voxels overflows the int32 flat index")
    vals, idx, total = _launch(cube, threshold, _FIRST_BUFFER)
    if total > _FIRST_BUFFER:
        # never truncate: the overflow retry gates on the exact count
        vals, idx, total = _launch(cube, threshold, total)
    return vals[:total], idx[:total].to(torch.int64)


def peak_candidates(
        cube: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every local maximum of ``cube`` above ``threshold`` (> 0) as
    ``(values, flat_indices)``, in no particular order.

    A CUDA tensor runs the kernel (contiguous float32 ``(S, Z, Y, X)``),
    a CPU tensor the plain version.
    """
    if not float(threshold) > 0:
        raise ValueError(
            "peak finding requires threshold > 0 (out-of-range neighbours "
            "count as 0, which clamps neighbourhood maxima to >= 0)")
    if cube.device.type == "cuda":
        return _peak_candidates_cuda(cube, threshold)
    if cube.device.type == "cpu":
        return peak_candidates_plain(cube, threshold)
    raise ValueError(f"unsupported device {cube.device}")


def select_top_sparse(
        vals: torch.Tensor, idx: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``capacity`` candidates by value, ties to the lower flat
    index (``lax.top_k`` order): sort by index, then stable-sort by value
    descending. ``torch.topk`` does not keep that tie order."""
    by_idx = torch.argsort(idx)
    vals, idx = vals[by_idx], idx[by_idx]
    order = torch.sort(vals, descending=True, stable=True).indices
    order = order[:capacity]
    return vals[order], idx[order]


def find_peaks(
        cube: torch.Tensor, threshold: float, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Local maxima of ``cube`` above ``threshold``, capped at ``capacity``.

    Returns ``coords`` ``(capacity, cube.dim())`` int32 sorted by peak value
    descending (zero past the count), ``values`` ``(capacity,)`` float32
    (-inf past the count) and ``count``, the number of peaks capped at
    ``capacity``.
    """
    vals, idx = peak_candidates(cube, threshold)
    total = int(vals.shape[0])
    top_v, top_i = select_top_sparse(vals, idx, capacity)
    n = int(top_v.shape[0])
    coords = torch.zeros(
        (capacity, cube.dim()), dtype=torch.int32, device=cube.device)
    values = torch.full(
        (capacity,), float("-inf"), dtype=torch.float32, device=cube.device)
    if n:
        # decode with Python-int divisors: torch.unravel_index ships the
        # shape to the device on every call
        cols, rem = [], top_i
        for size in reversed(cube.shape):
            cols.append(rem % size)
            rem = rem // size
        coords[:n] = torch.stack(cols[::-1], dim=1).to(torch.int32)
        values[:n] = top_v
    return coords, values, min(total, capacity)

