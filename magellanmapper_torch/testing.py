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
