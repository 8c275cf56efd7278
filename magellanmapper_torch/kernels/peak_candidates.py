"""K1: fused 3^4 local-maximum test, peak compaction and selection.

Replaces ``peak_candidates_pallas`` (``magellanmapper_tpu/ops/
pallas_kernels.py:478``); its wrapper ``find_peaks_fused`` (``:540``) is
the fused route of :func:`magellanmapper_torch.ops.peaks.find_peaks`.
A voxel of the ``(S, Z, Y, X)`` LoG cube is a peak when it is above the
positive threshold and not below any of its 80 neighbours over
(s, z, y, x), with out-of-range neighbours counted as 0
(``reduce_window``'s init, ``ops/peaks.py:40-44``). The CUDA kernel
(``csrc/peak_candidates.cu``) streams the cube once in tiles, plane by
plane, and returns every peak as an unordered (value, flat index) list;
the plain version is :func:`max_filter_full` plus the compare. Selection
is shared: value descending, ties to the lower flat index, cut at
capacity.

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
FIRST_BUFFER = 1 << 16


def max_filter_full(
        cube: torch.Tensor, clamp_zero: bool = True) -> torch.Tensor:
    """Max filter with a full 3^nd footprint and constant-0 border.

    With ``clamp_zero`` the result is also clamped to >= 0 (the
    reference's 0-initialised ``reduce_window``); without it this is
    skimage's ``maximum_filter(mode='constant', cval=0)`` for any sign
    (``ops/peaks.py:24-48``). One axis at a time: the max over a 0-padded
    window is separable.
    """
    out = cube
    for ax in range(cube.dim()):
        n = out.shape[ax]
        zero = torch.zeros_like(out.narrow(ax, 0, 1))
        lo = torch.cat([zero, out.narrow(ax, 0, n - 1)], dim=ax)
        hi = torch.cat([out.narrow(ax, 1, n - 1), zero], dim=ax)
        out = torch.maximum(torch.maximum(lo, out), hi)
    return torch.clamp_min(out, 0.0) if clamp_zero else out


def peak_candidates_plain(
        cube: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: every peak's value and flat index, in flat
    index order."""
    is_peak = (cube == max_filter_full(cube)) & (cube > threshold)
    idx = torch.nonzero(is_peak.reshape(-1)).squeeze(1)
    return cube.reshape(-1)[idx], idx


def enqueue(cube: torch.Tensor, threshold: float, buf_cap: int):
    """Launch the kernel on the current stream without waiting for it:
    ``(vals, idx, count)`` on the card, the first ``min(count, buf_cap)``
    slots filled and ``count`` the exact number of peaks."""
    s, z, y, x = cube.shape
    vals = torch.empty(buf_cap, dtype=torch.float32, device=cube.device)
    # the int64 flat indices, then the count (which the C entry point sets
    # to 0 on the stream) in the low half of one more slot
    idx = torch.empty(buf_cap + 1, dtype=torch.int64, device=cube.device)
    count = idx[buf_cap:].view(torch.int32)[:1]
    lib = _build.library()
    with _build.on_device(cube.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mm_peak_candidates(
            cube.data_ptr(), s, z, y, x, float(threshold), vals.data_ptr(),
            idx.data_ptr(), count.data_ptr(), buf_cap, stream)
    _build.check(err, "mm_peak_candidates")
    dev.count_launch("peak_candidates")
    return vals, idx, count


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
    vals, idx, count = enqueue(cube, threshold, FIRST_BUFFER)
    total = int(count.item())
    if total > FIRST_BUFFER:
        # never truncate: the overflow retry gates on the exact count
        vals, idx, _ = enqueue(cube, threshold, total)
    return vals[:total], idx[:total]


def peak_candidates(
        cube: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every local maximum of ``cube`` above ``threshold`` (> 0) as
    ``(values, flat_indices)``, in no particular order.

    A CUDA tensor runs the kernel (contiguous float32 ``(S, Z, Y, X)``),
    a CPU tensor the plain version. Thresholds <= 0 take the unfused
    route of :func:`magellanmapper_torch.ops.peaks.find_peaks`.
    """
    if not float(threshold) > 0:
        raise ValueError(
            "the fused peak finder requires threshold > 0 (out-of-range "
            "neighbours count as 0, which clamps neighbourhood maxima to "
            ">= 0)")
    if cube.device.type == "cuda":
        return _peak_candidates_cuda(cube, threshold)
    if cube.device.type == "cpu":
        return peak_candidates_plain(cube, threshold)
    raise ValueError(f"unsupported device {cube.device}")


def select_top_stable(
        vals: torch.Tensor, idx: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``capacity`` entries by value descending; equal values keep
    their order in ``vals`` (a stable sort: ``torch.topk`` does not keep
    it)."""
    order = torch.sort(vals, descending=True, stable=True).indices
    order = order[:capacity]
    return vals[order], idx[order]


def select_top_sparse(
        vals: torch.Tensor, idx: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``capacity`` candidates by value, ties to the lower flat
    index (``lax.top_k`` order): sort by index, then
    :func:`select_top_stable`."""
    by_idx = torch.argsort(idx)
    return select_top_stable(vals[by_idx], idx[by_idx], capacity)

