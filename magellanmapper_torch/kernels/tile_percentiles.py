"""K4: exact per-row percentiles of a tile matrix.

Replaces ``tile_percentiles_pallas`` (``magellanmapper_tpu/ops/
pallas_kernels.py:262``): ``np.percentile(row, (q_lo, q_hi))`` with linear
interpolation for every row of a ``(T, V)`` matrix of nonnegative values.
The CUDA kernel (``csrc/tile_percentiles.cu``) radix-selects the exact
order statistics; the plain version sorts. Ranks and interpolation
weights are computed on the host exactly as the reference does, and both
versions interpolate as ``v0 + f32(frac) * (v1 - v0)`` with each step
rounded to f32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from magellanmapper_torch import device as dev
from magellanmapper_torch.kernels import _build

SOURCE = "magellanmapper_torch/csrc/tile_percentiles.cu"
REPLACES = "magellanmapper_tpu/ops/pallas_kernels.py:262"


def _rank(q: float, v: int) -> Tuple[int, float]:
    """1-indexed lower order statistic and f32 interpolation weight of
    percentile ``q`` over ``v`` values (``pallas_kernels.py:303-307``)."""
    r = q / 100.0 * (v - 1)
    lo = math.floor(r)
    frac32 = float(torch.tensor(r - lo, dtype=torch.float32))
    return int(lo) + 1, frac32


def _check(tiles: torch.Tensor) -> torch.Tensor:
    if tiles.dim() != 2 or tiles.shape[1] < 1:
        raise ValueError(
            f"tiles must be a (T, V) matrix with V >= 1, got "
            f"{tuple(tiles.shape)}")
    if tiles.dtype == torch.uint8:
        return tiles.to(torch.uint16)
    if tiles.dtype not in (torch.uint16, torch.float32):
        raise TypeError(
            f"tiles must be uint8, uint16 or float32, got {tiles.dtype}")
    return tiles


def tile_percentiles_plain(
        tiles: torch.Tensor, q_lo: float, q_hi: float) -> torch.Tensor:
    """Plain PyTorch version: sort each row, gather the k-th and (k+1)-th
    values, interpolate. Returns ``(T, 2)`` float32."""
    tiles = _check(tiles)
    v = tiles.shape[1]
    srt = torch.sort(tiles.to(torch.float32), dim=1).values
    cols = []
    for q in (q_lo, q_hi):
        k, frac = _rank(q, v)
        v0 = srt[:, k - 1]
        if frac > 0:
            v1 = srt[:, min(k, v - 1)]
            f = torch.tensor(frac, dtype=torch.float32, device=srt.device)
            v0 = v0 + f * (v1 - v0)
        cols.append(v0)
    return torch.stack(cols, dim=1)


def _launch(tiles: torch.Tensor, q_lo: float, q_hi: float) -> torch.Tensor:
    if not tiles.is_contiguous():
        raise ValueError("tile_percentiles kernel needs contiguous tiles")
    if tiles.dtype == torch.float32 and bool((tiles < 0).any()):
        raise ValueError(
            "tile_percentiles kernel orders float keys by their bit "
            "pattern, which needs values >= 0")
    t, v = tiles.shape
    if t >= 2 ** 31 or v >= 2 ** 31:
        raise ValueError(f"tile matrix too large: {tuple(tiles.shape)}")
    k_lo, f_lo = _rank(q_lo, v)
    k_hi, f_hi = _rank(q_hi, v)
    out = torch.empty((t, 2), dtype=torch.float32, device=tiles.device)
    lib = _build.library()
    with _build.on_device(tiles.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mm_tile_percentiles(
            tiles.data_ptr(), int(tiles.dtype == torch.uint16), t, v,
            k_lo, k_hi, f_lo, f_hi, out.data_ptr(), stream)
    _build.check(err, "mm_tile_percentiles")
    dev.count_launch("tile_percentiles")
    return out


def tile_percentiles(
        tiles: torch.Tensor, q_lo: float, q_hi: float) -> torch.Tensor:
    """``np.percentile(row, (q_lo, q_hi))`` per row of ``tiles``.

    ``tiles`` is ``(T, V)`` uint8, uint16 or float32 (float values >= 0).
    A CUDA tensor runs the kernel, a CPU tensor the plain version.
    Returns ``(T, 2)`` float32.
    """
    tiles = _check(tiles)
    if tiles.device.type == "cuda":
        return _launch(tiles, q_lo, q_hi)
    if tiles.device.type == "cpu":
        return tile_percentiles_plain(tiles, q_lo, q_hi)
    raise ValueError(f"unsupported device {tiles.device}")
