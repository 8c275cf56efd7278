"""K4: exact per-row percentiles of a tile matrix.

Replaces ``tile_percentiles_pallas`` (``magellanmapper_tpu/ops/
pallas_kernels.py:262``): ``np.percentile(row, (q_lo, q_hi))`` with linear
interpolation for every row of a ``(T, V)`` matrix. The CUDA kernel
(``csrc/tile_percentiles.cu``) radix-selects the exact order statistics;
the plain version sorts. Ranks and interpolation weights are computed on
the host exactly as the reference does, and both versions interpolate as
``v0 + f32(frac) * (v1 - v0)`` with each step rounded to f32.

Float keys are the f32 bits under the order-preserving sign flip, so the
kernel equals the plain version (and ``np.percentile``) on every finite
float, negatives included; the reference orders raw float bits, which
puts negative values in reverse.

:func:`split` chooses the kernel's route on the host: a row that fits the
shared memory of one CTA is staged there whole (one chunk a row); a longer
row is cut into chunks that many CTAs count in parallel, one launch a
radix pass.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from magellanmapper_torch import device as dev
from magellanmapper_torch.kernels import _build

SOURCE = "magellanmapper_torch/csrc/tile_percentiles.cu"
REPLACES = "magellanmapper_tpu/ops/pallas_kernels.py:262"

#: the longest row, in bytes, that one CTA stages whole in shared memory
SHORT_ROW_BYTES = 64 * 1024
#: elements a CTA counts on the long route: enough CTAs for LONG_CTAS over
#: all rows (two for each of the card's 132 SMs; more CTAs made the rows'
#: global histograms hotter and were slower), at least LONG_CHUNK_MIN; a
#: multiple of 8, so a chunk keeps the row's 16-byte alignment
LONG_CHUNK_MIN = 4096
LONG_CTAS = 264
#: zeroed 32-bit scratch words a row on the long route: for each of up to
#: four passes the global histograms of four prefixes and the row's CTA
#: counter, then its select state (8 words)
_SCRATCH_WORDS = 4 * (4 * 256 + 1) + 8


def split(t: int, v: int, itemsize: int) -> Tuple[int, int]:
    """``(n_chunks, chunk)`` of the kernel's route for a ``(t, v)`` matrix
    of ``itemsize``-byte values: chunk ``i`` of a row covers elements
    ``[i * chunk, min(v, (i + 1) * chunk))``, so the chunks cover the row
    once each. One chunk a row is the short route."""
    if v * itemsize <= SHORT_ROW_BYTES:
        return 1, v
    per_row = max(1, -(-LONG_CTAS // t))
    chunk = max(LONG_CHUNK_MIN, -(-v // per_row))
    chunk = -(-chunk // 8) * 8
    return -(-v // chunk), chunk


def _rank(q: float, v: int) -> Tuple[int, float]:
    """1-indexed lower order statistic and f32 interpolation weight of
    percentile ``q`` over ``v`` values (``pallas_kernels.py:303-307``)."""
    r = q / 100.0 * (v - 1)
    lo = math.floor(r)
    return int(lo) + 1, float(np.float32(r - lo))


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


def _sorted(tiles: torch.Tensor) -> torch.Tensor:
    """Each row sorted ascending, as float32. Float rows are sorted in
    the total order of their bits (``-0.0`` before ``+0.0``), the order of
    the kernel's keys, so the two agree on the sign of a zero too."""
    if tiles.dtype != torch.float32:
        return torch.sort(tiles.to(torch.float32), dim=1).values
    # negative floats: flip the magnitude bits, so int32 order is the
    # float order; the map is its own inverse
    bits = tiles.view(torch.int32)
    keys = torch.sort(bits ^ ((bits >> 31) & 0x7FFFFFFF), dim=1).values
    return (keys ^ ((keys >> 31) & 0x7FFFFFFF)).view(torch.float32)


def tile_percentiles_plain(
        tiles: torch.Tensor, q_lo: float, q_hi: float) -> torch.Tensor:
    """Plain PyTorch version: sort each row, gather the k-th and (k+1)-th
    values, interpolate. Returns ``(T, 2)`` float32."""
    tiles = _check(tiles)
    v = tiles.shape[1]
    srt = _sorted(tiles)
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
    t, v = tiles.shape
    if t >= 2 ** 31 or v >= 2 ** 31:
        raise ValueError(f"tile matrix too large: {tuple(tiles.shape)}")
    k_lo, f_lo = _rank(q_lo, v)
    k_hi, f_hi = _rank(q_hi, v)
    n_chunks, chunk = split(t, v, tiles.element_size())
    out = torch.empty((t, 2), dtype=torch.float32, device=tiles.device)
    scratch = None if n_chunks == 1 else torch.zeros(
        t * _SCRATCH_WORDS, dtype=torch.int32, device=tiles.device)
    lib = _build.library()
    with _build.on_device(tiles.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mm_tile_percentiles(
            tiles.data_ptr(), int(tiles.dtype == torch.uint16), t, v,
            k_lo, k_hi, f_lo, f_hi, out.data_ptr(), chunk, n_chunks,
            None if scratch is None else scratch.data_ptr(), stream)
    _build.check(err, "mm_tile_percentiles")
    dev.count_launch("tile_percentiles")
    return out


def tile_percentiles(
        tiles: torch.Tensor, q_lo: float, q_hi: float) -> torch.Tensor:
    """``np.percentile(row, (q_lo, q_hi))`` per row of ``tiles``.

    ``tiles`` is ``(T, V)`` uint8, uint16 or float32 (any finite values).
    A CUDA tensor runs the kernel, a CPU tensor the plain version.
    Returns ``(T, 2)`` float32.
    """
    tiles = _check(tiles)
    if tiles.device.type == "cuda":
        return _launch(tiles, q_lo, q_hi)
    if tiles.device.type == "cpu":
        return tile_percentiles_plain(tiles, q_lo, q_hi)
    raise ValueError(f"unsupported device {tiles.device}")
