"""Multi-tile stitching: phase correlation, global optimization, fusion.

Port of ``magellanmapper_tpu/stitch/stitcher.py``:

- pairwise shifts by 3D FFT phase correlation of whole tiles on the
  device (cuFFT through ``torch.fft``): the mean-subtracted tiles'
  cross-power spectrum whitened by ``mag + 1e-2 * max(mag)``, its
  inverse's peak taken on the device, and only the peak and its six
  neighbours copied to the host for the reference's wrap and parabola
  refinement (in float32, as there) (:func:`phase_shifts`); then, the
  port's own step, each peak checked and refined by the normalised
  cross-correlation of the tiles' overlap (:func:`refine_by_overlap`),
  since the reference's whitening floor lands a specimen's peaks a voxel
  off;
- global tile optimization as the weighted least-squares position solve
  ``min sum w_ij ||p_j - p_i - d_ij||^2`` on the host in float64 (one
  unknown a tile);
- fusion with linear feather blending on the device, in float64 like
  the reference's, tile by tile in their order over z slabs of the
  output, so every voxel sums the same terms in the same order and the
  result equals the reference's bit for bit;
- ImageJ ``TileConfiguration.txt`` files, read and written.

Every function that touches the device takes ``device`` and runs on the
card unless ``"cpu"`` is asked for.
"""

from __future__ import annotations

import logging
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from magellanmapper_torch import device as device_mod

_logger = logging.getLogger(__name__)

#: output voxels a fusion slab may hold on the device (its two float64
#: accumulators take 16 bytes a voxel)
FUSE_SLAB_VOXELS = 1 << 27
#: moves of the overlap's cross-correlation climb from the phase
#: correlation's peak
NCC_MAX_STEPS = 8


def _phase_corr_surface(fa: torch.Tensor, fb: torch.Tensor,
                        shape: Sequence[int]) -> torch.Tensor:
    """Correlation surface of two tiles from their half spectra
    (:func:`_spectrum`): the cross-power spectrum ``fa * conj(fb)``
    whitened by ``mag + 1e-2 * max(mag)``, transformed back. For real
    tiles the whitened spectrum is Hermitian and the half spectrum's
    largest magnitude is the whole one's, so ``irfftn`` gives the real
    part of the reference's complex inverse."""
    cross = fa * torch.conj(fb)
    mag = torch.abs(cross)
    cross = cross / (mag + 1e-2 * torch.max(mag))
    return torch.fft.irfftn(cross, s=tuple(shape))


def _spectrum(tile, dev: torch.device) -> torch.Tensor:
    """Half spectrum (``rfftn``) of a tile in float32, mean subtracted
    (as the reference's full spectrum, ``fftn``, subtracts it)."""
    t = _to_device(tile, dev).to(torch.float32)
    return torch.fft.rfftn(t - torch.mean(t))


def _to_device(arr, dev: torch.device) -> torch.Tensor:
    """A host array (any numeric dtype, uint16 included) as a tensor on
    ``dev``; uint16 travels as its int16 bits and widens there."""
    if isinstance(arr, torch.Tensor):
        return arr.to(dev)
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint16:
        bits = torch.from_numpy(arr.view(np.int16)).to(dev)
        return bits.to(torch.int32) & 0xFFFF
    return torch.from_numpy(arr).to(dev)


def _peak(surf: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """The surface's first largest voxel (flat order, as ``np.argmax``)
    and the values there and at its two wrapped neighbours on each axis,
    ``[peak, lo_0, hi_0, lo_1, hi_1, ...]``, in one copy to the host."""
    shape = torch.tensor(surf.shape, device=surf.device)
    peak = torch.stack(torch.unravel_index(torch.argmax(surf), surf.shape))
    offs = [np.zeros(surf.ndim, np.int64)]
    for ax in range(surf.ndim):
        for step in (-1, 1):
            off = np.zeros(surf.ndim, np.int64)
            off[ax] = step
            offs.append(off)
    pts = (peak + torch.from_numpy(np.stack(offs)).to(surf.device)) % shape
    vals = surf[tuple(pts.T)]
    # float64 holds the indices and the float32 values exactly
    host = torch.cat([peak.to(torch.float64),
                      vals.to(torch.float64)]).cpu().numpy()
    return (host[:surf.ndim].astype(np.int64),
            host[surf.ndim:].astype(np.float32))


def _refine(peak: np.ndarray, vals: np.ndarray, shape: Sequence[int]
            ) -> Tuple[np.ndarray, float]:
    """The reference's shift from the peak: indices past half an extent
    wrap to negative, then a parabola through each axis's three values
    moves it by a sub-voxel step, computed on float32 scalars."""
    score = float(vals[0])
    shift = np.asarray(peak, dtype=float)
    for ax, n in enumerate(shape):
        if shift[ax] > n / 2:
            shift[ax] -= n
    for ax in range(len(shape)):
        c0, c1, c2 = vals[1 + 2 * ax], vals[0], vals[2 + 2 * ax]
        denom = c0 - 2 * c1 + c2
        if abs(denom) > 1e-12:
            shift[ax] += 0.5 * (c0 - c2) / denom
    return shift, score


def phase_correlation(
        a: np.ndarray, b: np.ndarray, device="cuda"
) -> Tuple[np.ndarray, float]:
    """Translation of ``b`` relative to ``a`` via phase correlation on
    ``device``.

    Returns ``(shift, score)``: per-axis shift such that ``b`` shifted by
    ``shift`` aligns with ``a``; score is the correlation peak height.
    """
    dev = device_mod.resolve(device)
    surf = _phase_corr_surface(_spectrum(a, dev), _spectrum(b, dev),
                               np.shape(a))
    peak, vals = _peak(surf)
    return _refine(peak, vals, surf.shape)


class TileGrid:
    """Regular tile layout (reference ``stitch/tile_config.py:28-60``).

    Tiles are numbered row by row (``adjacent_pairs`` and
    ``nominal_positions``); ``snake`` changes only :meth:`tile_index`, as
    in the reference."""

    def __init__(
            self, rows: int, cols: int, tile_shape: Sequence[int],
            overlap_frac: float = 0.1, snake: bool = True):
        self.rows = rows
        self.cols = cols
        self.tile_shape = tuple(tile_shape)
        self.overlap_frac = overlap_frac
        self.snake = snake

    def nominal_positions(self) -> np.ndarray:
        """(n_tiles, 3) nominal z,y,x positions from the grid layout."""
        step_y = self.tile_shape[1] * (1 - self.overlap_frac)
        step_x = self.tile_shape[2] * (1 - self.overlap_frac)
        pos = []
        for r in range(self.rows):
            for c in range(self.cols):
                pos.append((0.0, r * step_y, c * step_x))
        return np.asarray(pos)

    def tile_index(self, r: int, c: int) -> int:
        if self.snake and r % 2 == 1:
            c = self.cols - 1 - c
        return r * self.cols + c

    def adjacent_pairs(self) -> List[Tuple[int, int]]:
        """Index pairs of horizontally/vertically adjacent tiles."""
        pairs = []
        for r in range(self.rows):
            for c in range(self.cols):
                i = r * self.cols + c
                if c + 1 < self.cols:
                    pairs.append((i, i + 1))
                if r + 1 < self.rows:
                    pairs.append((i, i + self.cols))
        return pairs


def _pairs_by_phase(tiles: Sequence[np.ndarray], grid: TileGrid,
                    dev: torch.device):
    """The reference's pairwise step, pair by pair: yields ``(i, j, d_ij,
    score, tile_i, tile_j)``, the phase correlation of the whole tiles,
    its shift wrap-resolved toward the nominal offset, and both tiles as
    float32 on ``dev``. Each tile is uploaded and transformed once and
    dropped after its last pair."""
    nominal = grid.nominal_positions()
    pairs = grid.adjacent_pairs()
    last_use = {t: k for k, pair in enumerate(pairs) for t in pair}
    on_dev: Dict[int, torch.Tensor] = {}
    spectra: Dict[int, torch.Tensor] = {}
    for k, (i, j) in enumerate(pairs):
        for t in (i, j):
            if t not in on_dev:
                on_dev[t] = _to_device(tiles[t], dev).to(torch.float32)
                spectra[t] = _spectrum(on_dev[t], dev)
        shape = np.shape(tiles[i])
        surf = _phase_corr_surface(spectra[i], spectra[j], shape)
        shift, score = _refine(*_peak(surf), surf.shape)
        del surf
        rel_nominal = nominal[j] - nominal[i]
        # phase correlation yields displacement of tile j's content in
        # tile i's frame; wrap-resolve toward the nominal offset: choose
        # the candidate (shift +- N per axis) closest to it
        d_ij = shift
        for ax, n in enumerate(shape):
            candidates = np.array([d_ij[ax], d_ij[ax] + n, d_ij[ax] - n])
            d_ij[ax] = candidates[
                np.argmin(np.abs(candidates - rel_nominal[ax]))]
        yield i, j, d_ij, score, on_dev[i], on_dev[j]
        for t in (i, j):
            if last_use[t] == k:
                del on_dev[t], spectra[t]


def phase_shifts(
        tiles: Sequence[np.ndarray], grid: TileGrid, device="cuda"
) -> List[Tuple[int, int, np.ndarray, float]]:
    """The reference's ``compute_pairwise_shifts`` on ``device``: each
    adjacent pair's whole tiles phase-correlated (its docstring's
    "overlap strip" is not what it computes), the shift wrap-resolved
    toward the nominal offset. Returns ``(i, j, d_ij, score)`` a pair."""
    dev = device_mod.resolve(device)
    return [(i, j, d_ij, score) for i, j, d_ij, score, _, _
            in _pairs_by_phase(tiles, grid, dev)]


def _ncc(a: torch.Tensor, b: torch.Tensor, offsets: np.ndarray
         ) -> torch.Tensor:
    """Normalised cross-correlation of tile ``a`` and tile ``b`` over
    their overlap with ``b``'s origin at each integer offset in ``a``'s
    frame, in float64 (-inf where the overlap is under 2 voxels an
    axis)."""
    out = []
    for off in offsets:
        lo = np.maximum(off, 0)
        hi = np.minimum(a.shape, off + np.asarray(b.shape))
        if np.any(hi - lo < 2):
            out.append(torch.tensor(-np.inf, dtype=torch.float64,
                                    device=a.device))
            continue
        ra = a[tuple(slice(p, q) for p, q in zip(lo, hi))].double()
        rb = b[tuple(slice(p - o, q - o)
                     for p, q, o in zip(lo, hi, off))].double()
        ra = ra - ra.mean()
        rb = rb - rb.mean()
        out.append((ra * rb).sum()
                   / torch.sqrt((ra * ra).sum() * (rb * rb).sum()))
    return torch.stack(out)


def refine_by_overlap(a: torch.Tensor, b: torch.Tensor, d_ij: np.ndarray
                      ) -> np.ndarray:
    """The integer offset of ``b`` in ``a``'s frame that maximises the
    normalised cross-correlation of their overlap, climbed from
    ``d_ij`` rounded through its 3^3 neighbourhoods (at most
    ``NCC_MAX_STEPS`` moves), then moved by the parabola through each axis's
    three correlations where that axis peaks there. BigStitcher checks its
    phase-correlation peaks the same way, by the cross-correlation of the
    overlap."""
    ndim = a.ndim
    window = np.stack(np.meshgrid(*[(-1, 0, 1)] * ndim, indexing="ij"),
                      -1).reshape(-1, ndim)
    centre = len(window) // 2
    cur = np.round(d_ij).astype(np.int64)
    for step in range(NCC_MAX_STEPS + 1):
        vals = _ncc(a, b, cur + window).cpu().numpy()
        best = int(np.argmax(vals))
        if step == NCC_MAX_STEPS or vals[best] <= vals[centre]:
            break
        cur = cur + window[best]
    out = cur.astype(float)
    c1 = vals[centre]
    for ax in range(ndim):
        # the window's neighbours one step down and up this axis
        stride = 3 ** (ndim - 1 - ax)
        c0, c2 = vals[centre - stride], vals[centre + stride]
        # only where the axis peaks here (the climb's end, unless it ran
        # out of steps), so the step stays within half a voxel
        if not (np.all(np.isfinite((c0, c1, c2))) and c1 >= max(c0, c2)
                and c0 - 2 * c1 + c2 < 0):
            continue
        out[ax] += 0.5 * (c0 - c2) / (c0 - 2 * c1 + c2)
    return out


def compute_pairwise_shifts(
        tiles: Sequence[np.ndarray], grid: TileGrid, device="cuda"
) -> List[Tuple[int, int, np.ndarray, float]]:
    """Each adjacent pair's offset on ``device``: the reference's phase
    correlation of the whole tiles (:func:`phase_shifts`), its peak then
    checked and refined by the normalised cross-correlation of the
    overlap (:func:`refine_by_overlap`).

    The check is the port's own decision, so these offsets, and the
    positions ``stitch`` and ``run_pipeline`` compute from them, differ
    from the reference's: its whitening floor (``1e-2 * max(mag)``)
    leaves a specimen's smooth brain-scale content in the surface, whose
    broad peak lands a voxel off on some pairs. The climb reaches at most
    ``NCC_MAX_STEPS`` voxels, so where the phase peak itself is far off
    (small tiles with little overlap) the offset stays as wrong as the
    reference's.

    Returns list of ``(i, j, d_ij, score)`` where ``d_ij`` is the measured
    offset of tile j relative to tile i, in global coordinates, and
    ``score`` the phase-correlation peak's height, as the reference's.
    """
    dev = device_mod.resolve(device)
    return [(i, j, refine_by_overlap(a, b, d_ij), score)
            for i, j, d_ij, score, a, b in _pairs_by_phase(tiles, grid, dev)]


def globally_optimize(
        pairs: Sequence[Tuple[int, int, np.ndarray, float]],
        n_tiles: int,
        nominal: Optional[np.ndarray] = None,
        score_thresh: float = 0.0) -> np.ndarray:
    """Solve tile positions minimizing weighted pairwise residuals
    (BigStitcher's global optimization as a linear least squares, on the
    host in float64).

    Tile 0 anchors at its nominal position (or the origin).
    """
    ndim = len(pairs[0][2]) if pairs else 3
    rows_a = []
    rows_b = []
    weights = []
    for i, j, d_ij, score in pairs:
        if score <= score_thresh:
            continue
        row = np.zeros(n_tiles)
        row[i] = -1.0
        row[j] = 1.0
        rows_a.append(row)
        rows_b.append(d_ij)
        weights.append(max(score, 1e-6))
    # anchor tile 0
    anchor = np.zeros(n_tiles)
    anchor[0] = 1.0
    rows_a.append(anchor)
    rows_b.append(nominal[0] if nominal is not None else np.zeros(ndim))
    weights.append(1.0)

    a = np.asarray(rows_a) * np.sqrt(np.asarray(weights))[:, None]
    b = np.asarray(rows_b) * np.sqrt(np.asarray(weights))[:, None]
    pos, *_ = np.linalg.lstsq(a, b, rcond=None)
    return pos


def fuse_layout(tiles: Sequence[np.ndarray], positions: np.ndarray
                ) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Each tile's integer offset in the fused volume and the volume's
    shape: positions less their minimum, rounded half to even
    (``np.round``), and the extent that holds every tile."""
    positions = np.asarray(positions, float)
    tile_shape = np.asarray(tiles[0].shape)
    positions = positions - positions.min(axis=0)
    extent = np.ceil(positions.max(axis=0) + tile_shape).astype(int)
    return (np.round(positions).astype(int),
            tuple(int(e) for e in extent))


def fuse_tiles(
        tiles: Sequence[np.ndarray], positions: np.ndarray,
        blend: str = "linear", device="cuda") -> np.ndarray:
    """Blend z,y,x tiles into one float32 volume at the given (float)
    positions, on ``device``.

    ``linear`` feathers overlaps by distance-to-tile-edge weights
    (BigStitcher's linear blending), the product of one ramp an axis;
    any other value weights every voxel 1, a plain mean (the reference's
    docstring names ``max``, which its code does not compute). The sums
    run in float64 over z slabs of at most ``FUSE_SLAB_VOXELS`` output
    voxels, so device memory holds one slab, not the whole volume.
    """
    dev = device_mod.resolve(device)
    tile_shape = tuple(int(s) for s in np.shape(tiles[0]))
    ipos, extent = fuse_layout(tiles, positions)
    # feather weight: distance to nearest tile face, per axis product;
    # each ramp normalised on the host in float64 as the reference does
    ramps = []
    for n in tile_shape:
        ramp = np.ones(n)
        if blend == "linear":
            ramp = np.minimum(np.arange(n) + 1, np.arange(n)[::-1] + 1)
            ramp = ramp / ramp.max()
        ramps.append(torch.from_numpy(np.asarray(ramp, np.float64)).to(dev))

    out = np.empty(extent, np.float32)
    plane = int(np.prod(extent[1:]))
    slab = max(1, FUSE_SLAB_VOXELS // plane)
    for z0 in range(0, extent[0], slab):
        z1 = min(z0 + slab, extent[0])
        acc = torch.zeros((z1 - z0,) + extent[1:], dtype=torch.float64,
                          device=dev)
        wacc = torch.zeros_like(acc)
        for tile, pos in zip(tiles, ipos):
            za, zb = max(z0, pos[0]), min(z1, pos[0] + tile_shape[0])
            if za >= zb:
                continue
            # the reference's weight, ((1 * r_z) * r_y) * r_x, for the
            # tile's planes in this slab
            w = ramps[0][za - pos[0]:zb - pos[0], None, None] \
                * ramps[1][None, :, None] * ramps[2][None, None, :]
            part = _to_device(tile[za - pos[0]:zb - pos[0]], dev)
            sl = (slice(za - z0, zb - z0),) + tuple(
                slice(p, p + s) for p, s in zip(pos[1:], tile_shape[1:]))
            # product and sum in two steps: one rounding each, no fused
            # multiply-add
            acc[sl] += part.to(torch.float64) * w
            wacc[sl] += w
        fused = acc / torch.clamp(wacc, min=1e-12)
        out[z0:z1] = fused.to(torch.float32).cpu().numpy()
        del acc, wacc, fused
    return out


def stitch(
        tiles: Sequence[np.ndarray], grid: TileGrid, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """Full pipeline on ``device``: pairwise shifts -> global
    optimization -> fusion.

    Returns ``(fused_volume, positions)``.
    """
    dev = device_mod.resolve(device)
    t0 = time.perf_counter()
    pairs = compute_pairwise_shifts(tiles, grid, dev)
    t1 = time.perf_counter()
    positions = globally_optimize(
        pairs, len(tiles), grid.nominal_positions())
    t2 = time.perf_counter()
    fused = fuse_tiles(tiles, positions, device=dev)
    t3 = time.perf_counter()
    _logger.info(
        "stitched %d tiles on %s: pairwise shifts %.4f s (%d pairs), "
        "optimisation %.4f s, fusion %.4f s", len(tiles), dev, t1 - t0,
        len(pairs), t2 - t1, t3 - t2)
    _logger.info("stitched positions (z, y, x): %s", positions)
    return fused, positions


# ---------------------------------------------------------------------------
# ImageJ TileConfiguration interchange


def write_tile_config(
        path: str, names: Sequence[str], positions: np.ndarray,
        ndim: int = 3) -> None:
    """Write an ImageJ ``TileConfiguration.txt``
    (reference ``stitch/tile_config.py`` output format)."""
    with open(path, "w") as f:
        f.write(f"dim = {ndim}\n")
        for name, pos in zip(names, positions):
            coords = ", ".join(f"{v:.1f}" for v in pos[::-1])  # x,y,z
            f.write(f"{name}; ; ({coords})\n")


def read_tile_config(path: str) -> Tuple[List[str], np.ndarray]:
    """Read an ImageJ ``TileConfiguration.txt``; returns names + z,y,x
    positions."""
    names = []
    positions = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "dim")):
                continue
            m = re.match(r"(.+?);\s*;\s*\(([^)]*)\)", line)
            if not m:
                continue
            names.append(m.group(1).strip())
            coords = [float(v) for v in m.group(2).split(",")]
            positions.append(coords[::-1])  # x,y,z -> z,y,x
    return names, np.asarray(positions)
