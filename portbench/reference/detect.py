"""Plain reference of whole-volume block detection.

From the volume and the profile's values alone it works out what
``--proc detect`` has to return: the near-max (the 99.5th percentile of
every ``Z // 16``-th plane), the blocks, and in each block window the
saturation and denoising of each denoise tile (percentile clip and
rescale, clip, unsharp mask, octahedron erosion of the tiles brighter
than the erosion threshold), the normalised LoG stack, every local
maximum over (sigma, z, y, x) above the threshold in value order, the
sphere-overlap prune; then the blocks' rows in the volume and the
cross-block prune. Every peak is kept up to the block's ceiling of
``min(2^20, block voxels)`` rows, which is what the program's capacity
doubling reaches. Device work runs on the device the volume is put on,
block by block, in float32 with TF32 off.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from portbench.reference import blobs as rb
from portbench.reference import filters as rf


def near_max(volume: np.ndarray) -> float:
    """The channel's near-max, from every ``Z // 16``-th plane."""
    return float(np.percentile(
        volume[::max(1, volume.shape[0] // 16)], 99.5))


def sigmas(settings, res) -> tuple:
    sf = rb.scaling(res)[2]
    lo = settings["min_sigma_factor"] * sf
    hi = settings["max_sigma_factor"] * sf
    n = int(settings["num_sigma"])
    vals = [float(lo)] if n <= 1 else np.linspace(float(lo), float(hi), n)
    return tuple(float(s) for s in vals)


def preprocess(block: torch.Tensor, settings, nm: float,
               tile: Sequence[int]) -> torch.Tensor:
    """Saturate and denoise each denoise tile of a float32 block (tiles
    padded numpy-symmetric at the trailing ends)."""
    dz, dy, dx = (int(t) for t in tile)
    bz, by, bx = block.shape
    nz, ny, nx = -(-bz // dz), -(-by // dy), -(-bx // dx)
    padded = rf.pad_symmetric(
        block, [(0, nz * dz - bz), (0, ny * dy - by), (0, nx * dx - bx)])
    tiles = padded.reshape(nz, dz, ny, dy, nx, dx).permute(
        0, 2, 4, 1, 3, 5).reshape(-1, dz, dy, dx)
    pct = rf.percentiles(tiles.reshape(len(tiles), -1),
                         settings["clip_vmin"], settings["clip_vmax"])
    vmin = pct[:, 0].reshape(-1, 1, 1, 1)
    vmax = torch.clamp_min(pct[:, 1].reshape(-1, 1, 1, 1),
                           float(nm * settings["max_thresh_factor"]))
    flat = vmin >= vmax
    span = torch.where(flat, 1.0, vmax - vmin)
    out = torch.where(flat, tiles,
                      (torch.clamp(tiles, vmin, vmax) - vmin) / span)
    mean = out.mean(dim=(-3, -2, -1), keepdim=True)
    out = torch.clamp(out, settings["clip_min"], settings["clip_max"])
    if settings["tot_var_denoise"]:
        raise NotImplementedError("total-variation denoising")
    if settings["unsharp_strength"]:
        blurred = rf.gaussian_nearest(out, 8.0)
        out = 2.0 * out - settings["unsharp_strength"] * blurred
    if settings["erosion_threshold"]:
        out = torch.where(mean > settings["erosion_threshold"],
                          rf.erosion_octahedron(out), out)
    out = out.reshape(nz, ny, nx, dz, dy, dx).permute(
        0, 3, 1, 4, 2, 5).reshape(nz * dz, ny * dy, nx * dx)
    return out[:bz, :by, :bx]


def block_peaks(vol: torch.Tensor, sig: tuple, threshold: float,
                overlap: float, ceiling: int) -> np.ndarray:
    """A preprocessed block's blobs: float32 ``z, y, x, sigma`` rows of
    the local maxima above ``threshold``, in value order (ties to the
    lower flat index), at most ``ceiling``, after the overlap prune."""
    cube = rf.log_stack(vol, sig)
    peak = (cube == torch.clamp_min(rf.max_filter_zero(cube), 0.0)) & (
        cube > threshold)
    idx = torch.nonzero(peak.reshape(-1)).squeeze(1)
    vals = cube.reshape(-1)[idx]
    order = torch.sort(vals, descending=True, stable=True).indices
    idx = idx[order][:ceiling]
    s, z, y, x = cube.shape
    coords = torch.stack([(idx // (y * x)) % z, (idx // x) % y, idx % x],
                         dim=1).to(torch.float32)
    sig_t = torch.tensor(sig, dtype=torch.float32, device=vol.device)
    sigma = sig_t[idx // (z * y * x)]
    keep = rf.prune_overlap(coords, sigma, overlap)
    rows = torch.cat([coords, sigma[:, None]], dim=1)[keep]
    return rows.cpu().numpy()


def detect(volume: np.ndarray, settings, res, device,
           channel: int = 0) -> Optional[np.ndarray]:
    """The blob rows that detection of the single-channel ``volume``
    must return (None when there are none)."""
    rf.full_float32()
    shape = volume.shape
    blocks = rb.setup_blocks(settings, shape, res)
    block_shape = np.minimum(blocks.max_pixels + blocks.overlap, shape)
    bz, by, bx = (int(v) for v in block_shape)
    ceiling = min(1 << 20, bz * by * bx)
    nm = near_max(volume)
    sig = sigmas(settings, res)
    staged = torch.from_numpy(np.ascontiguousarray(volume)).to(device)
    per_block = np.full(blocks.slices.shape, None, dtype=object)
    for coord in np.ndindex(*blocks.slices.shape):
        w = rb.window_start(shape, blocks.offsets[coord], block_shape)
        z, y, x = (int(v) for v in w)
        block = staged[z:z + bz, y:y + by, x:x + bx].to(torch.float32)
        pre = preprocess(block, settings, nm, blocks.denoise_shape)
        raw = block_peaks(pre, sig, float(settings["detection_threshold"]),
                          float(settings["overlap"]), ceiling)
        if raw.shape[0]:
            per_block[coord] = rb.block_rows(raw, coord, w, blocks, channel)
    del staged
    return rb.prune_across_blocks(per_block, blocks, [channel])
