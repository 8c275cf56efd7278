"""End-to-end pipeline runner from raw tiles to blobs.

Port of ``magellanmapper_tpu/io/pipelines.py`` (the reference's
``bin/pipelines.sh``: stitch -> import -> transpose/rescale -> detect)
with its artifact-level resume: a stage whose output already exists is
skipped. Stitching, transformation and detection run on ``device``. The
cloud stages (S3 download and upload, notification) are not ported and
raise by name.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.atlas import transformer
from magellanmapper_torch.cv import stack_detect
from magellanmapper_torch.io import importer, np_io, tiff
from magellanmapper_torch.settings.roi_prof import ROIProfile
from magellanmapper_torch.stitch import acquisition, stitcher
from magellanmapper_torch.utils import libmag

_logger = logging.getLogger(__name__)

PIPELINES = ("full", "detection", "transformation", "stitching",
             "import", "download")


def run_pipeline(
        pipeline: str,
        img_path: str,
        roi_profile=None,
        resolutions: Optional[Sequence[float]] = None,
        rescale: Optional[float] = None,
        tile_grid: Optional[Dict] = None,
        s3_bucket: Optional[str] = None,
        notify_url: Optional[str] = None,
        channels: Optional[Sequence[int]] = None,
        device="cuda") -> Dict[str, str]:
    """Run a named pipeline over an image on ``device``, resuming from
    existing artifacts.

    ``tile_grid`` (``{"dir", "rows", "cols"[, "overlap"][, "mesospim"]}``)
    stitches the directory's TIFF tiles (sorted by name; mesoSPIM RAW
    tiles converted first) into ``<img_path base>_fused``, which the
    later stages then read, whether this run or an earlier one stitched
    it. Returns a dict of stage -> output path for the stages that ran.
    """
    if pipeline not in PIPELINES:
        raise ValueError(
            f"unknown pipeline {pipeline}; options: {PIPELINES}")
    if s3_bucket or notify_url:
        raise NotImplementedError(
            "run_pipeline: the cloud stages (s3_bucket download and "
            "upload, notify_url) are not ported to magellanmapper_torch "
            "(ROADMAP queue 1, item 12); run them with "
            "magellanmapper_tpu.io.pipelines")
    dev = device_mod.resolve(device)
    if roi_profile is None:
        roi_profile = ROIProfile()
    outputs: Dict[str, str] = {}

    t_stage = time.perf_counter()

    def done(stage: str, path: str) -> None:
        nonlocal t_stage
        outputs[stage] = path
        now = time.perf_counter()
        _logger.info("pipeline stage %s: %.4f s", stage, now - t_stage)
        t_stage = now

    if pipeline in ("stitching", "full") and tile_grid:
        fused_path = os.path.splitext(img_path)[0] + "_fused.npy"
        if not os.path.exists(np_io.make_filenames(fused_path)[0]):
            if tile_grid.get("mesospim"):
                # mesoSPIM RAW tiles -> BigStitcher-style TIFs first
                acquisition.mesospim_to_tif(tile_grid["dir"])
            files = importer.setup_import_dir(tile_grid["dir"])
            t0 = time.perf_counter()
            tiles = [tiff.read_tiff(f) for f in files]
            _logger.info("stitching: read %d tiles in %.4f s", len(tiles),
                         time.perf_counter() - t0)
            grid = stitcher.TileGrid(
                tile_grid["rows"], tile_grid["cols"], tiles[0].shape,
                tile_grid.get("overlap", 0.1))
            fused, _ = stitcher.stitch(tiles, grid, device=dev)
            del tiles
            np_io.write_npy(fused_path, fused[None], resolutions=(
                [list(resolutions)] if resolutions else None))
            done("stitching", fused_path)
        # the later stages read the fused image, also when a resumed run
        # skipped its stitching (the reference goes on with the tiles'
        # path then, and fails)
        img_path = fused_path

    if pipeline in ("import", "detection", "transformation", "full"):
        path_img, _ = np_io.make_filenames(img_path)
        if not os.path.exists(path_img) and img_path.lower().endswith(
                (".tif", ".tiff")):
            importer.import_tiff(img_path, resolutions=resolutions)
            done("import", path_img)

    if pipeline in ("transformation", "full") and rescale:
        out_path = transformer.get_transposed_image_path(img_path, rescale)
        if not os.path.exists(np_io.make_filenames(out_path)[0]):
            done("transformation", transformer.transpose_img(
                img_path, rescale=rescale, device=dev))

    if pipeline in ("detection", "full"):
        blobs_path = libmag.combine_paths(img_path, np_io.SUFFIX_BLOBS)
        if not os.path.exists(blobs_path):
            img5d = np_io.read_file(img_path)
            res = (img5d.resolutions[0] if img5d.resolutions is not None
                   else resolutions or (1.0, 1.0, 1.0))
            blobs, timing = stack_detect.detect_blobs_stack(
                np.asarray(img5d.img[0]), roi_profile, res,
                channels=channels, device=dev)
            blobs.path = blobs_path
            blobs.basename = os.path.basename(img_path)
            blobs.save_archive()
            done("detection", blobs_path)
            _logger.info("detection: %d blobs in %.1fs", len(blobs),
                         timing.get("Total_stack", 0))
    return outputs
