"""Frozen NumPy copies of the port's nucleus fixtures.

``make_nuclei_volume`` and ``make_grid_roi`` as ``magellanmapper_torch/
testing.py`` has them, kept here so that the benchmark's yardstick does
not move when the program's test fixtures do. ``render`` is the same
loop with the random draws passed in, so a test can hold the device
generator of ``nuclei.py`` to it draw for draw. Nothing the benchmark
runs on the card calls this module: its loop over every nucleus is far
too slow at specimen size.
"""

from __future__ import annotations

import numpy as np


def render(shape, centres, amps, noise, sigma=2.7):
    """The fixture's loop over ``centres`` (``(N, 3)``) and ``amps``,
    plus the ``noise`` field, clipped and cast to uint16."""
    r = int(3 * sigma) + 1
    g = np.arange(-r, r + 1, dtype=np.float32)
    stamp = np.exp(-(g[:, None, None] ** 2 + g[None, :, None] ** 2
                     + g[None, None, :] ** 2) / np.float32(2 * sigma ** 2))
    vol = np.zeros([s + 2 * r for s in shape], np.float32)
    w = 2 * r + 1
    for (z, y, x), a in zip(centres, np.asarray(amps, np.float32)):
        vol[z:z + w, y:y + w, x:x + w] += a * stamp
    vol = vol[r:-r, r:-r, r:-r]
    vol += np.asarray(noise, np.float32)
    np.clip(vol, 0, 65535, out=vol)
    return vol.astype(np.uint16)


def make_nuclei_volume(shape, seed, spacing=20, sigma=2.7, jitter=4):
    """Seeded uint16 volume of Gaussian nuclei on a jittered grid
    (frozen copy). Returns ``(volume, centres)``."""
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


def make_grid_roi(shape, seed, spacing=20, jitter=4, decoy=0.3):
    """Seeded float32 ROI in [0, 1]: the nuclei of ``make_nuclei_volume``
    plus ``decoy`` times as bright nuclei half a step away on every axis
    (frozen copy). Returns ``(roi, centres)``."""
    vol, centres = make_nuclei_volume(shape, seed, spacing, jitter=jitter)
    dim, _ = make_nuclei_volume(shape, seed + 1, spacing, jitter=jitter)
    return grid_roi_of(vol, dim, spacing, decoy), centres


def grid_roi_of(vol, dim, spacing=20, decoy=0.3):
    """The ROI of ``make_grid_roi`` from its two uint16 volumes."""
    half = spacing // 2
    roi = vol.astype(np.float32) + np.float32(decoy) * np.roll(
        dim.astype(np.float32), (half, half, half), (0, 1, 2))
    return (roi / roi.max()).astype(np.float32)
