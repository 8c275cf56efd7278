"""Synthetic fixtures and checks shared by the port's tests and
``chip_smoke.py``: a seeded volume of planted nuclei, a full-resolution
specimen made from a registration pair with nuclei planted in its brain,
a group of brains for groupwise registration, a one-sided atlas to
import and reannotate, a second channel with known co-expression, a point
cloud of dense, sparse and empty parts for clustering, a truth database
of the centres, blob-row equality, detection quality against the planted
centres, the edge cases of the percentile kernel (K4), and a seeded tile
set cut from a volume for stitching."""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Tuple

import numpy as np
import torch
from scipy import optimize, spatial
from scipy.spatial import distance

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.io import sqlite
from magellanmapper_torch.ops import filters
from magellanmapper_torch.ops import resize as resize_ops


def make_nuclei_volume(shape, seed, spacing=20, sigma=2.7, jitter=4):
    """Seeded uint16 volume of Gaussian nuclei on a jittered grid.

    Centres sit at ``spacing // 2 + k * spacing`` +- ``jitter`` (integer
    voxels), so they stay ``spacing // 2 - jitter`` voxels away from any
    multiple of ``spacing``; ``sigma`` matches the ``lightsheet`` profile's
    LoG scales at 1 um. Returns ``(volume, centres)``.
    """
    rng = np.random.default_rng(seed)
    grids = [np.arange(spacing // 2, s - spacing // 2 + 1, spacing)
             for s in shape]
    centres = np.stack(np.meshgrid(*grids, indexing="ij"), -1).reshape(-1, 3)
    centres = centres + rng.integers(-jitter, jitter + 1, centres.shape)
    r = int(3 * sigma) + 1
    g = np.arange(-r, r + 1, dtype=np.float32)
    stamp = np.exp(-(g[:, None, None] ** 2 + g[None, :, None] ** 2
                     + g[None, None, :] ** 2) / np.float32(2 * sigma ** 2))
    vol = np.zeros([s + 2 * r for s in shape], np.float32)
    amps = rng.uniform(1500, 3000, len(centres)).astype(np.float32)
    w = 2 * r + 1
    for (z, y, x), a in zip(centres, amps):
        vol[z:z + w, y:y + w, x:x + w] += a * stamp
    vol = vol[r:-r, r:-r, r:-r]
    for z in range(shape[0]):
        vol[z] += rng.normal(200, 30, shape[1:]).astype(np.float32)
    np.clip(vol, 0, 65535, out=vol)
    return vol.astype(np.uint16), centres


def make_coloc_channel(shape, centres: np.ndarray, seed: int,
                       spacing: int = 20, sigma: float = 2.7,
                       jitter: int = 4
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A second channel for the nuclei of :func:`make_nuclei_volume`
    (``centres``, made with the same ``spacing``): a seeded half of those
    nuclei co-express, and half of a lattice shifted by half a step on
    every axis (between the first channel's nuclei) holds nuclei of this
    channel alone, over the same noise.

    Returns ``(channel, coexpressed, own)``: the uint16 channel, a mask
    over ``centres`` of the co-expressing nuclei, and the z,y,x centres of
    the channel's own nuclei.
    """
    rng = np.random.default_rng(seed + 1000)
    co = rng.random(len(centres)) < 0.5
    grids = [np.arange(spacing, s - spacing + 1, spacing) for s in shape]
    own = np.stack(np.meshgrid(*grids, indexing="ij"), -1).reshape(-1, 3)
    own = own[rng.random(len(own)) < 0.5]
    own = own + rng.integers(-jitter, jitter + 1, own.shape)
    r = int(3 * sigma) + 1
    g = np.arange(-r, r + 1, dtype=np.float32)
    stamp = np.exp(-(g[:, None, None] ** 2 + g[None, :, None] ** 2
                     + g[None, None, :] ** 2) / np.float32(2 * sigma ** 2))
    vol = np.zeros([s + 2 * r for s in shape], np.float32)
    planted = np.concatenate([centres[co], own])
    amps = rng.uniform(1500, 3000, len(planted)).astype(np.float32)
    w = 2 * r + 1
    for (z, y, x), a in zip(planted, amps):
        vol[z:z + w, y:y + w, x:x + w] += a * stamp
    vol = vol[r:-r, r:-r, r:-r]
    for z in range(shape[0]):
        vol[z] += rng.normal(200, 30, shape[1:]).astype(np.float32)
    np.clip(vol, 0, 65535, out=vol)
    return vol.astype(np.uint16), co, own


def make_coloc_volume(shape, seed: int, spacing: int = 20):
    """A (z, y, x, 2) uint16 volume: channel 0 :func:`make_nuclei_volume`,
    channel 1 :func:`make_coloc_channel`. Returns ``(volume, centres,
    coexpressed, own)``."""
    ch0, centres = make_nuclei_volume(shape, seed, spacing)
    ch1, co, own = make_coloc_channel(shape, centres, seed, spacing)
    return np.stack([ch0, ch1], axis=-1), centres, co, own


def coloc_truth(blobs: np.ndarray, centres: np.ndarray, co: np.ndarray,
                own: np.ndarray, tol: float = 3.0) -> np.ndarray:
    """The planted co-expression of each blob, an ``(n, 2)`` 0/1 matrix
    like ``colocalize_blobs``' (a blob always expresses its own channel):
    a channel-0 blob within ``tol`` (Chebyshev) of a co-expressing nucleus
    expresses channel 1; a channel-1 blob within ``tol`` of one expresses
    channel 0, and one near a nucleus of channel 1 alone does not. Blobs
    near no planted nucleus get -1 in the other channel."""
    out = np.full((len(blobs), 2), -1, np.int8)
    chl = blobs[:, 6].astype(int)
    out[np.arange(len(blobs)), chl] = 1
    planted = np.concatenate([centres, own]).astype(float)
    both = np.concatenate([co, np.zeros(len(own), bool)])
    dist, idx = spatial.cKDTree(planted).query(blobs[:, :3], p=np.inf)
    near = dist <= tol
    other = 1 - chl
    out[near, other[near]] = both[idx[near]]
    return out


def make_point_cloud(n: int, seed: int, spacing: int = 20,
                     jitter: int = 4, region: int = 8) -> np.ndarray:
    """A seeded cloud of ``n`` integer z,y,x points, nuclei as detection
    gives them: a jittered lattice of ``spacing`` whose blocks of
    ``region`` lattice steps are, at random, dense (the lattice and its
    half-step shift), normal, sparse (a quarter of the lattice) or empty,
    so that DBSCAN finds clusters, border points and noise. Returns an
    ``(n, 3)`` float64 array."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil((n / 0.7) ** (1 / 3) / region)) * region
    kinds = rng.integers(0, 4, (side // region,) * 3)
    lattice = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"),
                       -1).reshape(-1, 3)
    kind = kinds[tuple((lattice // region).T)]
    keep = (kind == 0) | (kind == 1) | ((kind == 2)
                                        & (rng.random(len(kind)) < 0.25))
    pts = [lattice[keep] * spacing, lattice[kind == 0] * spacing
           + spacing // 2]
    pts = np.concatenate(pts)
    pts = pts[np.sort(rng.permutation(len(pts))[:n])]
    pts = pts + rng.integers(-jitter, jitter + 1, pts.shape)
    return rng.permutation(pts).astype(np.float64)


#: :func:`make_specimen`'s texture at its brightest, its tissue level in
#: the brain, and its background's mean and noise, in counts
SPECIMEN_TEXTURE = 150.0
SPECIMEN_TISSUE = 150.0
SPECIMEN_BACKGROUND = 200.0
SPECIMEN_NOISE = 15.0


def make_specimen(pair, factor: int = 4, seed: int = 0, device="cuda",
                  z_lattice: bool = True, noise: float = SPECIMEN_NOISE
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded full-resolution specimen of a registration pair
    (``atlas.gauntlet.build_pair``), made on ``device``.

    The pair's fixed image, blurred by one of its voxels and upsampled
    ``factor`` times per axis with ``ops.resize`` (linear), is a texture
    of ``SPECIMEN_TEXTURE`` counts at its brightest, over a tissue level
    of ``SPECIMEN_TISSUE`` counts in the ground-truth brain (its mask
    blurred by two voxels of the pair); Gaussian nuclei (the
    stamp, 20 voxel lattice, jitter and amplitudes of
    :func:`make_nuclei_volume`) are planted at the lattice points inside
    the ground-truth brain (``labels_fixed_gt`` > 0 at the point's voxel
    of the pair); noise N(``SPECIMEN_BACKGROUND``, ``noise``) from a
    generator seeded on ``device`` covers it all (``noise`` 0 leaves the
    scene for :func:`make_tiles` to add each tile's own).

    The contrasts are set so that the planted nuclei are the only blobs
    to find and the specimen still registers once shrunk back: texture
    and tissue together stay 5-10 times dimmer than a nucleus
    (1,500-3,000 counts), since the detector's per-tile saturation turns
    brighter ones into blobs, yet bright enough over the background that
    the shrunk brain is more than its nuclei to Otsu's threshold and to
    Mattes MI. In y and x the lattice keeps
    :func:`make_nuclei_volume`'s offset (centres stay 6 voxels or more
    from multiples of 20, where verification tiles may cut); in z it sits
    on the multiples of 20, so that the planes the detector samples for
    its near-max (every ``Z // 16``-th, a multiple of 20 at a depth of
    640) pass through nuclei as they would in tissue without a lattice.
    Without ``z_lattice`` each (y, x) column of the lattice instead sits
    at its own random z phase, so every plane holds the same share of
    centres and the near-max does not depend on the depth.
    Verify with tiles spanning the whole depth. Returns ``(volume,
    centres)``: uint16 ``(Z, Y, X)`` at ``factor`` times the pair's
    shape, and the nuclei's integer centres.
    """
    dev = device_mod.resolve(device)
    spacing, sigma, jitter = 20, 2.7, 4
    small = np.asarray(pair["fixed"], np.float32)
    shape = tuple(int(s) * factor for s in small.shape)
    rng = np.random.default_rng(seed)
    grids = [np.arange(spacing // 2, s - spacing // 2 + 1, spacing)
             for s in shape]
    grids[0] = np.arange(spacing, shape[0] - spacing // 2 + 1, spacing)
    centres = np.stack(np.meshgrid(*grids, indexing="ij"), -1).reshape(-1, 3)
    if not z_lattice:
        columns = len(grids[1]) * len(grids[2])
        phase = rng.integers(0, spacing, columns)
        centres[:, 0] += phase[np.arange(len(centres)) % columns]
        centres = centres[centres[:, 0] < shape[0] - spacing // 2]
    centres = centres + rng.integers(-jitter, jitter + 1, centres.shape)
    amps = rng.uniform(1500, 3000, len(centres)).astype(np.float32)
    inside = np.asarray(pair["labels_fixed_gt"])[
        tuple((centres // factor).T)] > 0
    centres, amps = centres[inside], amps[inside]

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    vol = torch.empty(shape, dtype=torch.float32, device=dev)
    vol.normal_(SPECIMEN_BACKGROUND, noise, generator=gen)
    # the pair's own voxel noise, upsampled, would be blobs of ~factor
    # voxels: a blur of one voxel of the pair takes it out first
    tex = filters.gaussian_filter(torch.from_numpy(small).to(dev), 1.0)
    tex *= np.float32(SPECIMEN_TEXTURE / max(float(tex.max()), 1e-6))
    brain = torch.from_numpy(np.asarray(pair["labels_fixed_gt"]) > 0)
    tex += filters.gaussian_filter(brain.to(dev, torch.float32), 2.0) \
        * np.float32(SPECIMEN_TISSUE)
    vol += resize_ops.resize(tex, shape)
    r = int(3 * sigma) + 1
    g = torch.arange(-r, r + 1, dtype=torch.float32, device=dev)
    stamp = torch.exp(-(g[:, None, None] ** 2 + g[None, :, None] ** 2
                        + g[None, None, :] ** 2) / np.float32(2 * sigma ** 2))
    for centre, amp in zip(centres, amps):
        lo = np.maximum(centre - r, 0)
        hi = np.minimum(centre + r + 1, shape)
        dst = tuple(slice(a, b) for a, b in zip(lo, hi))
        src = tuple(slice(a - c + r, b - c + r)
                    for a, b, c in zip(lo, hi, centre))
        vol[dst] += float(amp) * stamp[src]
    # truncate to uint16 as make_nuclei_volume does; int16 holds the bits
    vol = torch.clamp(vol, 0, 65535).to(torch.int32).to(torch.int16)
    return vol.cpu().numpy().view(np.uint16), centres


#: :func:`make_tiles`' per-tile noise, in counts (the specimen's own
#: noise is ``SPECIMEN_NOISE``)
TILE_NOISE = 10.0


def make_tiles(vol: np.ndarray, rows: int, cols: int, overlap: float,
               seed: int = 0, max_shift: int = 6, max_dz: int = 4,
               noise: float = TILE_NOISE, device="cuda"
               ) -> Tuple[list, np.ndarray]:
    """A seeded ``rows`` x ``cols`` tile set cut from ``vol``, as a
    microscope's stage would image it, made on ``device``.

    Tile t is cut at ``(0, max_shift, max_shift)`` plus its rounded
    nominal position plus a planted integer offset: y and x within
    +-``max_shift``, z within 0 to ``max_dz``; tile 0 has none, so it
    sits at its nominal position. Tiles share one shape, the largest that
    fits: in y and x the extent whose grid with ``overlap``
    (``stitcher.TileGrid``'s nominal steps) fits ``vol`` less
    ``max_shift`` on each side, and in z ``vol``'s depth less the largest
    z offset drawn, so that the tiles together span the whole depth (a
    specimen of :func:`make_specimen` keeps its nuclei's z lattice on
    the planes the detector samples for its near-max only at that
    depth). Each tile gets its own seeded N(0, ``noise``) noise and is
    clipped and truncated to uint16. Tiles are numbered row by row, as
    ``TileGrid`` numbers them.

    Returns ``(tiles, positions)``: the uint16 tiles and each tile's
    integer z,y,x origin in ``vol``.
    """
    from magellanmapper_torch.stitch import stitcher

    dev = device_mod.resolve(device)
    zmax, ymax, xmax = vol.shape

    def extent(n_tiles, size):
        # the largest tile whose rounded nominal steps fit
        tile = size
        while round((n_tiles - 1) * tile * (1 - overlap)) + tile \
                > size - 2 * max_shift:
            tile -= 1
        return tile

    rng = np.random.default_rng(seed)
    offsets = np.column_stack([
        rng.integers(0, max_dz + 1, rows * cols),
        rng.integers(-max_shift, max_shift + 1, (rows * cols, 2))])
    offsets[0] = 0
    shape = (zmax - int(offsets[:, 0].max()), extent(rows, ymax),
             extent(cols, xmax))
    nominal = stitcher.TileGrid(rows, cols, shape,
                                overlap).nominal_positions()
    positions = (np.array([0, max_shift, max_shift])
                 + np.round(nominal).astype(int) + offsets)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tiles = []
    for pos in positions:
        sl = tuple(slice(p, p + s) for p, s in zip(pos, shape))
        tile = torch.from_numpy(vol[sl].astype(np.float32)).to(dev)
        tile += torch.empty_like(tile).normal_(0.0, noise, generator=gen)
        # truncate to uint16; int16 holds the bits
        tile = torch.clamp(tile, 0, 65535).to(torch.int32).to(torch.int16)
        tiles.append(tile.cpu().numpy().view(np.uint16))
    return tiles, positions


def make_group(pair, seeds: Sequence[int] = (1, 2, 3, 4),
               device="cuda", **gt_kwargs) -> dict:
    """A group of brains for groupwise registration: the pair's fixed
    image and its ground-truth labels, each carried through its own known
    affine and B-spline warp (``gauntlet.make_ground_truth`` at each seed,
    on ``device``). Returns ``imgs`` (float32) and ``labels`` (int32),
    lists in seed order, and the warps ``gts``."""
    from magellanmapper_torch.atlas import gauntlet, reg_engine

    dev = device_mod.resolve(device)
    shape = np.asarray(pair["fixed"]).shape
    imgs, labels, gts = [], [], []
    for seed in seeds:
        gt = gauntlet.make_ground_truth(shape, seed=seed, device=dev,
                                        **gt_kwargs)
        warp = reg_engine.RegResult.from_numpy(
            [("affine", gt["affine"]), ("bspline", {"grid": gt["grid"]})],
            shape, gt["spacing"], dev)
        imgs.append(warp.transform_img(pair["fixed"], order=1))
        labels.append(warp.transform_img(
            pair["labels_fixed_gt"], order=0).astype(np.int32))
        gts.append(gt)
    return {"imgs": imgs, "labels": labels, "gts": gts}


def mean_pairwise_dsc(labels: Sequence[np.ndarray]) -> float:
    """The mean over every pair of label images of their mean per-label
    Dice (labels in either image, background left out)."""
    vals = []
    for i in range(len(labels)):
        for j in range(i + 1, len(labels)):
            a, b = np.asarray(labels[i]), np.asarray(labels[j])
            ids = np.union1d(np.unique(a), np.unique(b))
            ids = ids[ids != 0]
            inter = np.bincount(np.searchsorted(ids, a[(a == b) & (a != 0)]),
                                minlength=len(ids))
            sizes = (np.bincount(np.searchsorted(ids, a[a != 0]),
                                 minlength=len(ids))
                     + np.bincount(np.searchsorted(ids, b[b != 0]),
                                   minlength=len(ids)))
            vals.append(float(np.mean(2.0 * inter / sizes)))
    return float(np.mean(vals))


#: :func:`make_atlas`'s intensity scale: the pair's fixed image (0 to ~1)
#: in counts, so the profiles' ``atlas_threshold`` of 10 parts the brain
#: from the background
ATLAS_COUNTS = 100.0


def make_atlas(pair, shape: Sequence[int], split: Sequence[int] = (6, 4, 6),
               cut_planes: int = 4, device="cuda") -> dict:
    """A one-sided atlas to import, made on ``device`` from a pair: its
    fixed image (times :data:`ATLAS_COUNTS`) and ground-truth labels
    resized to ``shape`` (linear, nearest), both made symmetric across
    axis 0 (the first half mirrored onto the second), the labels split
    into ``label * 1000 + cell`` IDs by a ``split`` grid of cells, then
    kept on the first half only (as the ADMBA's one-sided annotations
    are), and their ``cut_planes`` outermost labelled planes along axis 0
    cleared, so that mirroring and lateral edge extension both have work.
    Returns ``atlas`` (float32), ``labels`` (int32, cut), ``truth`` (the
    one-sided labels before the cut) and ``cut`` (the cleared planes'
    slice)."""
    dev = device_mod.resolve(device)
    shape = tuple(int(s) for s in shape)
    half = shape[0] // 2
    atlas = resize_ops.resize(torch.from_numpy(np.asarray(
        pair["fixed"], np.float32)).to(dev), shape) * np.float32(ATLAS_COUNTS)
    labels = resize_ops.resize(torch.from_numpy(np.asarray(
        pair["labels_fixed_gt"], np.int32)).to(dev), shape, order=0)
    grid = [torch.arange(s, device=dev) * n // s
            for s, n in zip(shape, split)]
    cell = (grid[0][:, None, None] * split[1]
            + grid[1][None, :, None]) * split[2] + grid[2][None, None]
    labels = torch.where(labels > 0, labels * 1000 + cell, 0).to(torch.int32)
    for img in (atlas, labels):
        img[half:2 * half] = img[:half].flip(0)
    labels[half:] = 0
    truth = labels.cpu().numpy().copy()
    planes = torch.nonzero(labels.flatten(1).any(dim=1))[:, 0]
    first = int(planes[0]) if len(planes) else 0
    cut = slice(first, first + cut_planes)
    labels[cut] = 0
    return {"atlas": atlas.cpu().numpy(), "labels": labels.cpu().numpy(),
            "truth": truth, "cut": cut}


#: percentile pairs K4 is held to on its edge cases: lightsheet's clip,
#: the extremes, the median, minpreproc's near-extremes
K4_QS = ((5.0, 98.5), (0.0, 100.0), (50.0, 50.0), (0.01, 99.99))


def k4_cases(seed: int = 0) -> dict:
    """Seeded ``(T, V)`` matrices for K4: uint16 over many high bytes,
    rows of one value, one hot bin with outliers, V = 1 and 7, odd V
    (misaligned row starts), long rows (the split route: one
    (1, 2,555,904) row of image-like noise, 3 rows of 100,003), float32
    with negatives, with signed zeros, long float rows, and uint8."""
    rng = np.random.default_rng(seed)
    t, v = 252, 15625
    equal = np.repeat(rng.integers(0, 65536, (t, 1)), v, axis=1)
    equal[:2, :] = [[0], [65535]]
    hot = rng.integers(200, 204, (t, v))
    for col, val in ((3, 0), (50, 65535), (777, 1000), (9000, 4000)):
        hot[:, col] = val
    zeros = rng.choice(np.array([-0.0, 0.0, 1e-30, -1e-30, -1.0, 1.0],
                                np.float32), (t, v))
    noise = np.clip(rng.normal(200, 30, (1, 2555904)), 0, None)
    noise[0, rng.integers(0, noise.size, 20000)] += 3000
    return {
        "u16_wide": rng.integers(0, 4001, (t, v)).astype(np.uint16),
        "u16_all_equal": equal.astype(np.uint16),
        "u16_hot_bin": hot.astype(np.uint16),
        "u16_v1": rng.integers(0, 65536, (t, 1)).astype(np.uint16),
        "u16_v7": rng.integers(0, 300, (t, 7)).astype(np.uint16),
        "u16_odd_v": rng.integers(0, 65536, (t, 12347)).astype(np.uint16),
        "u16_long_row": noise.astype(np.uint16),
        "u16_long_rows": rng.integers(0, 65536, (3, 100003)).astype(
            np.uint16),
        "f32_negative": rng.normal(0, 1, (t, v)).astype(np.float32),
        "f32_signed_zeros": zeros,
        "f32_odd_v": rng.normal(-5, 10, (37, 7777)).astype(np.float32),
        "f32_long_rows": rng.normal(0, 1e4, (2, 1000001)).astype(
            np.float32),
        "u8": rng.integers(0, 256, (t, v)).astype(np.uint8),
    }


def make_grid_roi(shape, seed, spacing=20, jitter=4, decoy=0.3):
    """Seeded float32 ROI in [0, 1] for the grid search: the planted
    nuclei of :func:`make_nuclei_volume` (the truth; their centres are
    returned) plus ``decoy`` times as bright nuclei half a grid step away
    on every axis, which are not in the truth and become false positives
    at low thresholds. Returns ``(roi, centres)``."""
    vol, centres = make_nuclei_volume(shape, seed, spacing, jitter=jitter)
    dim, _ = make_nuclei_volume(shape, seed + 1, spacing, jitter=jitter)
    half = spacing // 2
    roi = vol.astype(np.float32) + np.float32(decoy) * np.roll(
        dim.astype(np.float32), (half, half, half), (0, 1, 2))
    return (roi / roi.max()).astype(np.float32), centres


def write_truth_db(
        path: str, centres: np.ndarray, shape: Sequence[int],
        radius: float = 3.0) -> str:
    """Write ``centres`` (z, y, x) as the confirmed truth blobs of one
    ROI spanning ``shape`` into a new sqlite blob database at ``path``
    (the reference's schema, through the port's ``io.sqlite``), as
    ``--truth_db`` reads it. Returns ``path``."""

    n = len(centres)
    rows = np.column_stack([
        np.asarray(centres, float), np.full(n, float(radius)),
        np.ones(n), np.ones(n), np.zeros(n)])
    db = sqlite.load_db(path)
    try:
        exp_id = db.select_or_insert_experiment("truth")
        roi_id, _ = db.select_or_insert_roi(
            exp_id, 0, (0, 0, 0), tuple(int(s) for s in shape[::-1]))
        db.insert_blobs(roi_id, rows)
    finally:
        db.close()
    return path


def sorted_rows(blobs: np.ndarray) -> np.ndarray:
    """Rows in lexicographic order of their columns."""
    return blobs[np.lexsort(blobs.T[::-1])]


def rows_equal(a, b) -> bool:
    """Blob rows equal after sorting: exact coordinates and columns, radii
    (column 3) within 1e-6 relative."""
    if a is None or b is None or a.shape != b.shape:
        return False
    a, b = sorted_rows(a), sorted_rows(b)
    other = [c for c in range(a.shape[1]) if c != 3]
    return (np.array_equal(a[:, other], b[:, other])
            and np.allclose(a[:, 3], b[:, 3], rtol=1e-6, atol=0))


def sens_ppv(
        blobs: np.ndarray, truth: np.ndarray, shape: Sequence[int],
        tile: Sequence[int], tol: Sequence[float]) -> Tuple[float, float]:
    """Sensitivity and PPV of detected ``blobs`` against ``truth`` centres.

    Within each ``tile`` of the volume, detections and truth are paired by
    an optimal assignment on tolerance-scaled distance, and a pair closer
    than ``max(tol)`` is a true positive (the matching of the reference's
    ``cv.verifier.find_closest_blobs_cdist``). Tiles keep each assignment
    small; with tile edges away from every centre, no pair is split.
    """
    tol = np.asarray(tol, float)
    thresh = float(np.amax(tol))
    scaling = thresh / tol
    tp = 0
    for lo in np.ndindex(*[-(-s // t) for s, t in zip(shape, tile)]):
        lo = np.multiply(lo, tile)
        hi = lo + tile

        def inside(a):
            return a[np.all((a[:, :3] >= lo) & (a[:, :3] < hi), 1), :3]

        det, tru = inside(blobs), inside(truth)
        if len(det) and len(tru):
            dists = distance.cdist(det * scaling, tru * scaling)
            rows, cols = optimize.linear_sum_assignment(dists)
            tp += int(np.sum(dists[rows, cols] < thresh))
    sens = tp / len(truth) if len(truth) else 0.0
    ppv = tp / len(blobs) if len(blobs) else 0.0
    return sens, ppv


# -- vendor files built byte by byte from their specifications --------------
#
# Copies of the builders of the reference's reader tests
# (``tests/test_czi_lif.py``, ``test_nd2.py``, ``test_nd2_legacy.py``,
# ``test_oib.py``, ``test_hdf5_ims.py``, ``test_hdf5_native.py``), so
# the readers are held to the formats and not to their own writers.

def same_outcome(want_fn, got_fn):
    """Run the reference's reader (``want_fn``) and the port's
    (``got_fn``): both raise an exception of the same type and message,
    or both return equal results (arrays of equal dtype and values,
    dicts, tuples and lists equal item by item). Returns the port's."""
    def run(fn):
        try:
            return True, fn()
        except Exception as err:  # noqa: BLE001 - compared below
            return False, (type(err).__name__, str(err))

    (ok_want, want), (ok_got, got) = run(want_fn), run(got_fn)
    assert ok_want == ok_got, (want, got)
    if not ok_want:
        assert want == got, (want, got)
        return got
    _assert_same(want, got)
    return got


def _assert_same(want, got, where="result"):
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        want, got = np.asarray(want), np.asarray(got)
        assert want.dtype == got.dtype, (where, want.dtype, got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(want) == set(got), (
            where, sorted(want), sorted(got))
        for k in want:
            _assert_same(want[k], got[k], f"{where}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert type(want) is type(got) and len(want) == len(got), where
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_same(a, b, f"{where}[{i}]")
    else:
        assert want == got and type(want) is type(got), (where, want, got)


def czi_segment(sid: bytes, payload: bytes) -> bytes:
    """A ZISRAW segment: 16-byte id, allocated and used sizes, payload
    padded to 32 bytes."""
    alloc = (len(payload) + 31) // 32 * 32
    return (sid.ljust(16, b"\x00") + struct.pack("<qq", alloc, len(payload))
            + payload.ljust(alloc, b"\x00"))


def czi_subblock(data: bytes, dims, pixel_type=1, compression=0,
                 pyramid_type=0, stored_override=None) -> bytes:
    """DV subblock payload per spec: SubBlock fixed part (MetadataSize,
    AttachmentSize, DataSize), directory entry (schema 'DV', PixelType,
    FilePosition/FilePart, Compression, PyramidType+spare, DimensionCount,
    DimensionEntryDV1 list), padding to >=256, then data."""
    entry = (b"DV" + struct.pack("<i", pixel_type) + b"\x00" * 12
             + struct.pack("<i", compression)
             + bytes([pyramid_type]) + b"\x00" * 5
             + struct.pack("<i", len(dims)))
    for name, start, size in dims:
        stored = size if stored_override is None else stored_override.get(
            name.decode(), size)
        entry += (name.ljust(4, b"\x00") + struct.pack("<ii", start, size)
                  + struct.pack("<fi", float(start), stored))
    head = struct.pack("<ii", 0, 0) + struct.pack("<q", len(data)) + entry
    return head + b"\x00" * (max(256, len(head)) - len(head)) + data


def czi_metadata(xml: bytes) -> bytes:
    """ZISRAWMETADATA payload: XmlSize, AttachmentSize, 248 spare bytes,
    then the XML."""
    return struct.pack("<ii", len(xml), 0) + b"\x00" * 248 + xml


#: ND2 chunk magic and the chunk map's signature
ND2_MAGIC = 0x0ABECEDA
ND2_SIG = b"ND2 CHUNK MAP SIGNATURE 0000001!"


def nd2_chunk(name: bytes, data: bytes) -> bytes:
    return struct.pack("<IIQ", ND2_MAGIC, len(name), len(data)) + name + data


def lv_item(name: str, value, dtype: int) -> bytes:
    """One scalar item of ND2's lite-variant metadata."""
    wname = (name + "\x00").encode("utf-16-le")
    head = struct.pack("<BB", dtype, len(name) + 1) + wname
    fmt = {1: "<B", 2: "<i", 3: "<I", 5: "<Q", 6: "<d"}
    if dtype == 1:
        return head + struct.pack("<B", int(value))
    if dtype in fmt:
        return head + struct.pack(fmt[dtype], value)
    if dtype == 8:
        return head + (value + "\x00").encode("utf-16-le")
    raise ValueError(dtype)


def lv_level(name: str, items: list) -> bytes:
    """A nested lite-variant level: ``<count:u32> <byte_len:u64>``, the
    items, a trailing u64 offset index."""
    body = b"".join(items)
    wname = (name + "\x00").encode("utf-16-le")
    head = struct.pack("<BB", 11, len(name) + 1) + wname
    index = struct.pack("<%dQ" % len(items), *range(len(items)))
    return (head + struct.pack("<IQ", len(items), len(body) + len(index))
            + body + index)


def nd2_attributes(width, height, comp=1, bpc=16, n_seq=1, stride=None,
                   compression=None) -> bytes:
    stride = stride if stride is not None else width * comp * (bpc // 8)
    items = [lv_item("uiWidth", width, 3), lv_item("uiWidthBytes", stride, 3),
             lv_item("uiHeight", height, 3), lv_item("uiComp", comp, 3),
             lv_item("uiBpcInMemory", bpc, 3),
             lv_item("uiBpcSignificant", bpc, 3),
             lv_item("uiSequenceCount", n_seq, 3)]
    if compression is not None:
        items.append(lv_item("eCompression", compression, 2))
    return lv_level("SLxImageAttributes", items)


def nd2_bytes(planes, attrs: bytes, extra_chunks=(), stride=None) -> bytes:
    """A chunk-map ND2: signature chunk, attribute and plane chunks, the
    chunk map and the 40-byte tail."""
    chunks = [(b"ND2 FILE SIGNATURE CHUNK NAME01!", b"Ver3.0\x00"),
              (b"ImageAttributesLV!", attrs)]
    for i, plane in enumerate(planes):
        if stride is None:
            pix = plane.tobytes()
        else:
            pix = b"".join(
                r.tobytes().ljust(stride, b"\x00")
                for r in plane.reshape(plane.shape[0], -1))
        chunks.append((b"ImageDataSeq|%d!" % i,
                       struct.pack("<d", 1000.0 * i) + pix))
    chunks.extend(extra_chunks)
    blob = b""
    offsets = {}
    for name, data in chunks:
        offsets[name] = len(blob)
        blob += nd2_chunk(name, data)
    map_data = b"".join(name + struct.pack("<QQ", off, 16 + len(name))
                        for name, off in offsets.items())
    map_data += ND2_SIG + struct.pack("<QQ", 0, 0)
    map_offset = len(blob)
    blob += nd2_chunk(ND2_SIG, map_data)
    return blob + ND2_SIG + struct.pack("<Q", map_offset)


def jp2_box(btype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + btype + payload


def jp2_xlbox(btype: bytes, payload: bytes) -> bytes:
    """Extended-length box: length field 1 + u64 XLBox length."""
    return (struct.pack(">I", 1) + btype
            + struct.pack(">Q", 16 + len(payload)) + payload)


def jp2_header(h: int, w: int, nc: int = 1, bpc: int = 16,
               res_box: bytes = b"") -> bytes:
    ihdr = jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc - 1, 7,
                                        0, 0))
    colr = jp2_box(b"colr", struct.pack(">BbBI", 1, 0, 0, 17))
    return jp2_box(b"jp2h", ihdr + colr + res_box)


def jp2_resc(ppm_num: int, ppm_den: int, exp: int) -> bytes:
    """Capture-resolution superbox: the same grid density on both axes."""
    return jp2_box(b"res ", jp2_box(b"resc", struct.pack(
        ">HHHHbb", ppm_num, ppm_den, ppm_num, ppm_den, exp, exp)))


#: the JP2 signature box and a file-type box, as legacy ND2 files open
JP2_SIG = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
JP2_FTYP = jp2_box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")

# compound files (v3: 512-byte sectors, 64-byte mini sectors)
_SS, _MS = 512, 64
_END, _FREE, _FATSECT = 0xFFFFFFFE, 0xFFFFFFFF, 0xFFFFFFFD
OLE_MAGIC = b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1"


def _dir_entry(name: str, obj_type: int, start: int, size: int,
               child: int = _FREE) -> bytes:
    wname = name.encode("utf-16-le") + b"\x00\x00"
    e = bytearray(128)
    e[:len(wname)] = wname
    struct.pack_into("<H", e, 64, len(wname))
    e[66] = obj_type
    e[67] = 1
    struct.pack_into("<III", e, 68, _FREE, _FREE, child)
    struct.pack_into("<I", e, 116, start)
    struct.pack_into("<Q", e, 120, size)
    return bytes(e)


def cfbf_bytes(streams) -> bytes:
    """A v3 compound file (OIB's container) of ``{name: bytes}``; streams
    under 4096 bytes go through the mini stream and mini FAT."""
    big = {n: d for n, d in streams.items() if len(d) >= 4096}
    small = {n: d for n, d in streams.items() if len(d) < 4096}
    mini_container = b""
    mini_start = {}
    mini_fat = []
    for name, data in small.items():
        n_minis = max(1, -(-len(data) // _MS))
        mini_start[name] = len(mini_fat)
        mini_fat += [len(mini_fat) + i + 1 for i in range(n_minis - 1)]
        mini_fat.append(_END)
        mini_container += data.ljust(n_minis * _MS, b"\x00")
    sectors = []
    fat = []

    def add_chain(data: bytes) -> int:
        n = max(1, -(-len(data) // _SS))
        first = len(sectors)
        for i in range(n):
            sectors.append(data[i * _SS:(i + 1) * _SS].ljust(_SS, b"\x00"))
            fat.append(first + i + 1 if i < n - 1 else _END)
        return first

    big_start = {n: add_chain(d) for n, d in big.items()}
    mini_cont_start = add_chain(mini_container) if mini_container else _END
    minifat_start = (add_chain(struct.pack("<%dI" % len(mini_fat),
                                           *mini_fat))
                     if mini_fat else _END)
    entries = [_dir_entry("Root Entry", 5, mini_cont_start,
                          len(mini_container), child=1)]
    for name, data in streams.items():
        start = big_start[name] if name in big else mini_start[name]
        entries.append(_dir_entry(name, 2, start, len(data)))
    dir_start = add_chain(b"".join(entries))
    per = _SS // 4
    n_fat = -(-(len(sectors) + 1) // per)
    fat_start = len(sectors)
    fat += [_FATSECT] * n_fat
    words = fat + [_FREE] * (n_fat * per - len(fat))
    sectors += [struct.pack("<%dI" % per, *words[i * per:(i + 1) * per])
                for i in range(n_fat)]
    header = bytearray(512)
    header[:8] = OLE_MAGIC
    struct.pack_into("<HHHH", header, 26, 3, 0xFFFE, 9, 6)
    struct.pack_into("<II", header, 44, n_fat, dir_start)
    struct.pack_into("<IIIII", header, 56, 4096, minifat_start,
                     1 if mini_fat else 0, _END, 0)
    difat = [fat_start + i for i in range(n_fat)]
    struct.pack_into("<109I", header, 76, *(difat + [_FREE] * (109 - n_fat)))
    return bytes(header) + b"".join(sectors)


def tiff_bytes(plane: np.ndarray) -> bytes:
    """A one-page uncompressed TIFF of ``plane``, written by the port."""
    import os
    import tempfile

    from magellanmapper_torch.io import tiff

    fd, path = tempfile.mkstemp(suffix=".tif")
    os.close(fd)
    try:
        tiff.write_tiff(path, plane[None])
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


def oif_files(directory: str, planes: np.ndarray, name: str = "img",
              ini_extra: str = "") -> str:
    """An OIF main file (UTF-16 INI: x/y calibration 0.62, z interval
    1.5) beside its ``.oif.files`` directory of one TIFF a plane of the
    ``(Z, Y, X)`` ``planes``; returns the main file's path."""
    import os

    from magellanmapper_torch.io import tiff

    files = os.path.join(directory, f"{name}.oif.files")
    os.makedirs(files)
    for z in range(planes.shape[0]):
        tiff.write_tiff(os.path.join(files, f"s_C001Z{z + 1:03d}.tif"),
                        planes[z][None])
    ini = ("[Reference Image Parameter]\nWidthConvertValue=0.62\n"
           "[Axis 3 Parameters Common]\n"
           'AxisCode="Z"\nInterval=1.5\n' + ini_extra)
    main = os.path.join(directory, f"{name}.oif")
    with open(main, "wb") as f:
        f.write(b"\xff\xfe" + ini.encode("utf-16-le"))
    return main


def s1(text: str) -> np.ndarray:
    """An Imaris-style one-char-per-element string attribute."""
    return np.frombuffer(text.encode(), "S1")


class H5Builder:
    """An HDF5 file byte by byte: superblock v0, v1 object headers,
    symbol-table groups, contiguous and chunked (v1 B-tree; gzip,
    shuffle) datasets, v1 attributes."""

    UNDEF = 0xFFFFFFFFFFFFFFFF
    SIGNATURE = b"\x89HDF\r\n\x1a\n"

    def __init__(self):
        self.buf = bytearray(96)

    def add(self, data: bytes) -> int:
        while len(self.buf) % 8:
            self.buf.append(0)
        addr = len(self.buf)
        self.buf += data
        return addr

    @staticmethod
    def msg(mtype: int, body: bytes) -> bytes:
        pad = (-len(body)) % 8
        return (struct.pack("<HHB3x", mtype, len(body) + pad, 0) + body
                + b"\x00" * pad)

    @staticmethod
    def dataspace(shape) -> bytes:
        return (struct.pack("<BB6x", 1, len(shape))
                + b"".join(struct.pack("<Q", s) for s in shape))

    @staticmethod
    def datatype(dt) -> bytes:
        dt = np.dtype(dt)
        if dt.kind in "ui":
            cls, bits = 0, 0x08 if dt.kind == "i" else 0
            props = struct.pack("<HH", 0, dt.itemsize * 8)
        elif dt.kind == "f":
            cls, bits = 1, 0x20
            props = struct.pack("<HHBBBBH", 0, dt.itemsize * 8, 0, 23, 23,
                                8, 127)
        elif dt.kind == "S":
            cls, bits, props = 3, 0, b""
        else:
            raise ValueError(dt)
        return struct.pack("<BBBBI", (1 << 4) | cls, bits, 0, 0,
                           dt.itemsize) + props

    def attribute(self, name: str, value) -> bytes:
        value = np.asarray(value)
        nb = name.encode() + b"\x00"
        dt = self.datatype(value.dtype)
        ds = self.dataspace(value.shape)

        def p8(b):
            return b + b"\x00" * ((-len(b)) % 8)

        return (struct.pack("<BxHHH", 1, len(nb), len(dt), len(ds))
                + p8(nb) + p8(dt) + p8(ds) + value.tobytes())

    def object_header(self, messages) -> int:
        body = b"".join(messages)
        return self.add(struct.pack("<BxHII4x", 1, len(messages), 1,
                                    len(body)) + body)

    def dataset(self, arr: np.ndarray, attrs=None, chunk=None, gzip=False,
                shuffle=False, extra_msgs=()) -> int:
        msgs = [self.msg(0x0001, self.dataspace(arr.shape)),
                self.msg(0x0003, self.datatype(arr.dtype))]
        if chunk is None:
            addr = self.add(arr.tobytes())
            msgs.append(self.msg(0x0008, struct.pack("<BBQQ", 3, 1, addr,
                                                     arr.nbytes)))
        else:
            filters = ([2] if shuffle else []) + ([1] if gzip else [])
            if filters:
                fb = struct.pack("<BB6x", 1, len(filters))
                for fid in filters:
                    vals = (1,) if fid == 1 else (arr.itemsize,)
                    fb += struct.pack("<HHHH", fid, 0, 1, len(vals))
                    fb += b"".join(struct.pack("<I", v) for v in vals)
                    fb += b"\x00" * 4 * (len(vals) % 2)
                msgs.append(self.msg(0x000B, fb))
            entries = []
            for offs in np.ndindex(*[-(-s // c) for s, c in
                                     zip(arr.shape, chunk)]):
                origin = [o * c for o, c in zip(offs, chunk)]
                block = np.zeros(chunk, arr.dtype)
                sl = tuple(slice(o, min(o + c, s))
                           for o, c, s in zip(origin, chunk, arr.shape))
                block[tuple(slice(0, s.stop - s.start) for s in sl)] = \
                    arr[sl]
                raw = block.tobytes()
                if shuffle:
                    raw = np.frombuffer(raw, np.uint8).reshape(
                        -1, arr.itemsize).T.tobytes()
                if gzip:
                    raw = zlib.compress(raw)
                entries.append((len(raw), origin, self.add(raw)))
            node = struct.pack("<4sBBH", b"TREE", 1, 0, len(entries))
            node += struct.pack("<QQ", self.UNDEF, self.UNDEF)
            for size, origin, caddr in entries:
                node += struct.pack("<II", size, 0)
                node += b"".join(struct.pack("<Q", o) for o in origin)
                node += struct.pack("<QQ", 0, caddr)
            node += struct.pack("<II", 0, 0) + b"\x00" * 8 * (arr.ndim + 1)
            layout = struct.pack("<BBBQ", 3, 2, arr.ndim + 1, self.add(node))
            layout += b"".join(struct.pack("<I", c) for c in chunk)
            msgs.append(self.msg(0x0008, layout + struct.pack(
                "<I", arr.itemsize)))
        msgs += list(extra_msgs)
        for name, val in (attrs or {}).items():
            msgs.append(self.msg(0x000C, self.attribute(name, val)))
        return self.object_header(msgs)

    def group(self, children, attrs=None) -> int:
        """``children``: ``{name: object header address}``."""
        heap_data = bytearray(8)
        offsets = {}
        for name in children:
            offsets[name] = len(heap_data)
            nb = name.encode() + b"\x00"
            heap_data += nb + b"\x00" * ((-len(nb)) % 8)
        heap_data_addr = self.add(bytes(heap_data))
        heap = self.add(struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap_data),
                                    len(heap_data), heap_data_addr))
        snod = struct.pack("<4sBBH", b"SNOD", 1, 0, len(children))
        for name in sorted(children):
            snod += struct.pack("<QQ", offsets[name], children[name])
            snod += b"\x00" * 24
        snod_addr = self.add(snod)
        node = struct.pack("<4sBBH", b"TREE", 0, 0, 1)
        node += struct.pack("<QQQQQ", self.UNDEF, self.UNDEF, 0, snod_addr,
                            0)
        msgs = [self.msg(0x0011, struct.pack("<QQ", self.add(node), heap))]
        for name, val in (attrs or {}).items():
            msgs.append(self.msg(0x000C, self.attribute(name, val)))
        return self.object_header(msgs)

    def finish(self, root_addr: int) -> bytes:
        sb = bytearray(96)
        sb[:8] = self.SIGNATURE
        sb[13] = sb[14] = 8
        struct.pack_into("<HH", sb, 16, 4, 16)
        struct.pack_into("<QQQQQ", sb, 24, 0, 0, len(self.buf), self.UNDEF,
                         0)
        struct.pack_into("<Q", sb, 64, root_addr)
        struct.pack_into("<I", sb, 72, 1)
        self.buf[:96] = sb
        return bytes(self.buf)


def ims_bytes(vols, sizes=None, ext=None, chunk=(2, 4, 4)) -> bytes:
    """An Imaris-layout file (``DataSet/ResolutionLevel 0/TimePoint 0/
    Channel N/Data``, chunk-padded and gzipped, with ``ImageSize*``
    attributes, and ``DataSetInfo/Image`` attributes) by
    :class:`H5Builder`."""
    b = H5Builder()
    channels = {}
    for ci, vol in enumerate(vols):
        padded = np.zeros([-(-s // c) * c for s, c in zip(vol.shape, chunk)],
                          vol.dtype)
        padded[tuple(slice(0, s) for s in vol.shape)] = vol
        attrs = {f"ImageSize{ax}": s1(str(s))
                 for ax, s in zip("ZYX", vol.shape)}
        channels[f"Channel {ci}"] = b.group(
            {"Data": b.dataset(padded, chunk=chunk, gzip=True)}, attrs=attrs)
    dataset = b.group({"ResolutionLevel 0": b.group(
        {"TimePoint 0": b.group(channels)})})
    img_attrs = {}
    if sizes:
        img_attrs.update({ax: s1(str(s)) for ax, s in zip("XYZ", sizes)})
    for i, (lo, hi) in enumerate(ext or ()):
        img_attrs[f"ExtMin{i}"] = s1(str(lo))
        img_attrs[f"ExtMax{i}"] = s1(str(hi))
    info = b.group({"Image": b.group({}, attrs=img_attrs)})
    return b.finish(b.group({"DataSet": dataset, "DataSetInfo": info}))


def write_ims(path: str, vols, sizes_zyx, libver: str = "earliest",
              ext=None, chunks=None, gzip=None, shuffle=False) -> str:
    """An Imaris-shaped file written by the system libhdf5
    (:class:`~magellanmapper_torch.io.hdf5_native.NativeHdf5Writer`):
    each ``(Z, Y, X)`` volume of ``vols`` as ``Channel N/Data`` with
    ``ImageSize*`` attributes, ``DataSetInfo/Image`` sizes and the
    ``ext`` attributes (``ExtMin0`` ...); contiguous unless ``chunks``."""
    from magellanmapper_torch.io import hdf5_native

    with hdf5_native.NativeHdf5Writer(path, libver=libver) as w:
        base = "DataSet/ResolutionLevel 0/TimePoint 0"
        for ci, vol in enumerate(vols):
            ch = f"{base}/Channel {ci}"
            w.write_dataset(f"{ch}/Data", vol, chunks=chunks, gzip=gzip,
                            shuffle=shuffle)
            for ax, size in zip("ZYX", sizes_zyx):
                w.write_attr(ch, f"ImageSize{ax}", str(size))
        w.create_group("DataSetInfo/Image")
        for ax, size in zip("ZYX", sizes_zyx):
            w.write_attr("DataSetInfo/Image", ax, str(size))
        for key, val in (ext or {}).items():
            w.write_attr("DataSetInfo/Image", key, str(val))
    return path
