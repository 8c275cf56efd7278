"""Acquisition-side stitching helpers: tile grids and mesoSPIM conversion.

Copy of ``magellanmapper_tpu/stitch/acquisition.py``: the Stitching
plugin's tile grid generator (uni/bidirectional travel, left/right start,
fractional overlap) and the mesoSPIM RAW-to-TIF export
(``<chl>_<tile>.raw`` files with ``_meta.txt`` sidecars become
BigStitcher-compatible ``tile_<t>_ch_<c>.tif`` stacks). As in the
reference, tiles are numbered in the sorted order of their file names,
which for mesoSPIM's ``X<c>Y<r>`` keys is column by column, while
:class:`~magellanmapper_torch.stitch.stitcher.TileGrid` numbers them row
by row.
"""

from __future__ import annotations

import glob
import logging
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from magellanmapper_torch.io import tiff

_logger = logging.getLogger(__name__)

TILE_CONFIG_FILE = "TileConfiguration.txt"
DIRECTIONALITY = ("uni", "bi")
START_DIRECTION = ("right", "left")


def build_tile_config(
        img_name: str, rows: int, cols: int,
        size: Sequence[float], overlap: float,
        directionality: str = "uni",
        start_direction: str = "right") -> List[str]:
    """Grid-layout TileConfiguration lines for a serpentine/row scan.

    ``size`` is the (x, y) tile extent; ``overlap`` the fractional tile
    overlap; ``bi`` directionality alternates travel direction per row,
    with ``start_direction`` selecting which rows flip (reference
    ``tile_config.main`` semantics).
    """
    if directionality not in DIRECTIONALITY:
        raise ValueError(f"directionality must be one of {DIRECTIONALITY}")
    if start_direction not in START_DIRECTION:
        raise ValueError(
            f"start_direction must be one of {START_DIRECTION}")
    lines = [f"dim = {len(size)}"]
    frac = abs(1 - overlap)
    for i in range(rows * cols):
        gx = i % cols
        gy = i // cols
        row_alt = gy + (1 if start_direction == "right" else 0)
        if directionality == "bi" and row_alt % 2 == 0:
            gx = cols - gx - 1
        off_x = size[0] * gx * frac
        off_y = size[1] * gy * frac
        lines.append(f"{img_name}; ; ({off_x}, {off_y}, 0.0)")
    return lines


def write_tile_config_grid(
        target_dir: str, img_name: str, rows: int, cols: int,
        size: Sequence[float], overlap: float,
        directionality: str = "uni",
        start_direction: str = "right") -> str:
    """Write the grid TileConfiguration file; returns its path."""
    path = os.path.join(target_dir, TILE_CONFIG_FILE)
    lines = build_tile_config(
        img_name, rows, cols, size, overlap, directionality,
        start_direction)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def parse_mesospim_meta(meta_path: str) -> Dict[str, str]:
    """Parse a mesoSPIM ``*_meta.txt`` sidecar (``[key] value`` lines)."""
    meta: Dict[str, str] = {}
    with open(meta_path) as f:
        for line in f:
            m = re.match(r"^(?P<key>\[.*\]) (?P<val>.*)$", line)
            if m:
                meta[m.group("key").strip("[]")] = m.group("val").strip()
    return meta


def mesospim_shape_res(meta: Dict[str, str]):
    """(z, y, x) shape and (z, y, x) um resolutions from parsed meta."""
    shape = (int(meta["z_planes"]), int(meta["y_pixels"]),
             int(meta["x_pixels"]))
    res = (float(meta["z_stepsize"]), float(meta["Pixelsize in um"]),
           float(meta["Pixelsize in um"]))
    return shape, res


def mesospim_to_tif(
        in_dir: str, out_dir: Optional[str] = None,
        pattern: str = "*.raw",
        compression: Optional[str] = None
) -> List[Tuple[str, int, int]]:
    """Convert mesoSPIM RAW tiles to BigStitcher-compatible TIF stacks.

    Files named ``<chl>_<tile-coords>.raw`` (with ``<file>_meta.txt``
    sidecars) become ``tile_<t>_ch_<c>.tif``; channel/tile indices are
    assigned in order of first appearance, mirroring the reference
    pipeline. Returns ``(out_path, tile_idx, chl_idx)`` per input.
    """
    paths = sorted(glob.glob(os.path.join(in_dir, pattern)))
    if not paths:
        raise FileNotFoundError(f"no {pattern} files in {in_dir}")
    out_dir = out_dir or in_dir
    os.makedirs(out_dir, exist_ok=True)

    chls: List[str] = []
    tiles: List[str] = []
    out: List[Tuple[str, int, int]] = []
    for path in paths:
        meta = parse_mesospim_meta(f"{path}_meta.txt")
        shape, res = mesospim_shape_res(meta)
        arr = np.memmap(path, dtype=np.uint16, mode="r", shape=shape)
        # `<chl>_<tile>` name split, indices by first appearance
        base = os.path.basename(path)
        stem = base[:-4] if base.endswith(".raw") else base
        parts = stem.split("_", 1)
        chl_key = parts[0]
        tile_key = parts[1] if len(parts) > 1 else "0"
        if chl_key not in chls:
            chls.append(chl_key)
        if tile_key not in tiles:
            tiles.append(tile_key)
        t, c = tiles.index(tile_key), chls.index(chl_key)
        out_path = os.path.join(out_dir, f"tile_{t}_ch_{c}.tif")
        tiff.write_tiff(out_path, np.asarray(arr), compression=compression)
        _logger.info(
            "converted %s -> %s (shape %s, res %s)", path, out_path,
            shape, res)
        out.append((out_path, t, c))
    return out
