#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``, and exits non-zero, printing no
result, on any fault. Phases:

1. device: the card's name and power limit;
2. build: the CUDA kernels from ``magellanmapper_torch/csrc`` (first use)
   and the host's native TIFF decoders (``csrc/host/tiffcodec.cpp``, g++);
3. each kernel against its plain PyTorch version on the card, bit for
   bit, at the shapes of the detection path (K1, K3, K4) and of the grid
   search (K2) and on edge cases (NaNs, ragged widths, masks that are no
   prefix, equal radii, K = 16,384, peak buffers that overflow; for K4
   both of its routes, the block as one tile, negative floats, signed
   zeros, rows of one value, V = 1; float results compared by their
   bits), timed with CUDA events beside its plain version (K1 and K4 also
   by their kernels' device time alone), the one PyTorch call that
   computes the same function where there is one (K2 ``torch.topk``, K4
   ``torch.quantile``) and its bound: the larger of the bytes it must
   move over 3.35 TB/s and the float32 operations it must do over 67
   TFLOP/s;
4. the detect slice: ``python -m magellanmapper_torch.io.cli --proc detect
   --roi_profile lightsheet`` on a seeded (256, 1024, 1024) uint16 volume
   of planted nuclei, with launch counters, a check against the planted
   truth, and a (64, 256, 256) crop detected on the card and on the CPU;
5. the grid search: ``python -m magellanmapper_torch.io.cli --grid_search
   gridtest --roi_profile 4xnuc --truth_db ...`` on a seeded
   (64, 512, 512) float32 ROI of planted nuclei and dimmer decoys, with a
   truth database of the nuclei's centres, launch counters and checks of
   the table; a
   (32, 128, 128) crop through the same batched route on the card and on
   the CPU; the LoG pyramid's tap route (an axis of 1024) on both;
6. the specimen chain and registration: the seeded (160, 240, 200)
   gauntlet pair built on the card; a (640, 960, 800) uint16 specimen
   made from it (``testing.make_specimen``: its fixed image upsampled 4
   times as a texture, nuclei planted in its brain), then through the
   port's CLI: ``--proc detect`` (launch counters of the ``specimen``
   path, sensitivity and PPV against the planted nuclei), ``--proc
   transform --transform rescale=0.25`` (shape, scaling and resolutions
   against the reference's formula; a (64, 240, 200) crop on the card
   against the CPU), ``--register single`` of the atlas onto the shrunk
   specimen with the default atlas profile (the register path, which
   runs no hand-written kernel: wall, the stats CSV's DSCs against the
   unregistered DSC, the written labels' per-region DSC against the
   ground truth, optimiser steps per second of each stage and level),
   ``--register make_density_images`` (the heat map holds every blob) and
   ``--register vol_stats`` (the regions' nuclei and voxels add up to the
   heat map's and the labels'; equal to ``--device cpu``'s table, floats
   within 1e-5), each step's wall and peak device memory, and each
   region's nuclei against the planted ones; ``vol_stats`` once more at
   the Allen CCFv3 25 um atlas's (528, 320, 456), several hundred IDs
   (wall, peak memory, the same sums); ``run_gauntlet_suite`` with the
   seed-0 pair alone, the reference's smoothing schedule, failing on the
   reference's gate (``passes``) and on the checks this script adds to it
   (:func:`gauntlet_checks`: an affine-stage DSC, a B-spline gain above 0,
   a warp error under the ground truth's displacement); ``register_duo``
   on a (20, 28, 28) pair and on the suite's truncated pair of that shape
   (its ``fixed_mask``), each on the card and on the CPU;
7. ``cv.detector.detect_blobs`` on a (48, 192, 192) crop of the detect
   volume at resolutions (2, 1, 1) made isotropic, card against CPU;
8. atlas construction, which runs none of the hand-written kernels (its
   launch counts are printed, 0): ``--register group --atlas_profile
   groupwise`` through the CLI on four brains of the pair's shape, each
   the pair's fixed image and truth labels under its own ground-truth
   warp (wall, steps per second by level, peak memory; the group's
   variance after below half of before, the carried labels' mean pairwise
   DSC above the unregistered one), the same engine card against CPU on
   three (20, 28, 28) brains; ``register`` with stage checkpoints stopped
   after its affine stage and resumed, equal to an uninterrupted run; a
   one-sided atlas at the 25 um atlas's (528, 320, 456) imported with
   ``abap56`` (its labels mirrored exactly), smoothed,
   ``make_edge_images`` (edges inside the labels, distance 0 exactly on
   them), ``merge_atlas_segs`` (watershed sweeps, labels lost,
   ``DSC_orig_new``) and ``make_subsegs`` (each sub-label's parent), each
   step's wall and peak memory; a crop of it card against CPU (markers,
   watershed and sub-labels exactly, the LoG image within 1e-4 of its
   range);
9. blob analysis on a (256, 1024, 1024, 2) uint16 volume (channel 0 the
   detect slice's, channel 1 a seeded half of its nuclei and its own
   between them, ``testing.make_coloc_channel``): ``--proc detect_coloc
   --channel 0 1 --roi_profile lightsheet`` through the CLI (launches of
   the ``coloc`` path; each channel's sensitivity and PPV against its
   planted nuclei at the detect slice's bars; the archive's ``colocs``;
   the flags against the planted co-expression; wall and Mvox/s), the
   whole stack matched between the channels in blocks, a (64, 256, 256,
   2) crop through ``detect_coloc`` and ``coloc_match`` on the card and
   on the CPU (blobs, flags and matches exactly equal); the patch
   classifier trained on channel 0's blobs (held-out accuracy beside the
   all-true baseline, steps per second), ``--proc classify --classifier``
   through the CLI (blobs per second) and the same weights card against
   CPU on 4,096 patches; ``--register cluster_blobs`` through the CLI
   (labels equal to the CPU's); ``cluster_dbscan`` on a seeded cloud of
   4,194,304 points with eps by the reference's rule (wall, peak memory)
   and a sub-block of 262,144 card against CPU. Phase 6's ``vol_stats``
   at 25 um also runs with the specimen's blobs and their regions, no
   cluster column (the per-region clusters card against CPU);
10. acquisition: phase 6's specimen as a scene (its nuclei at a random z
   phase a column, so no plane the detector samples for its near-max is
   favoured, and no noise) cut into a seeded 3 x 3 tile set
   (``testing.make_tiles``: 10% nominal overlap, y/x offsets within +-6,
   z 0-4 planes, each tile its own noise of the specimen's 15 counts, as
   one acquisition has), written as uncompressed
   ``tile_<t>_ch_0.tif`` files, then ``io.pipelines.run_pipeline("full",
   ..., rescale=0.25, tile_grid=...)`` on the card: stitching (tile
   reads, pairwise phase correlation checked by the overlap's
   cross-correlation, the global optimisation, fusion), transformation
   and detection of the fused volume (launches of the ``acquisition``
   path). Gates: every position within 1.0 voxel of the planted one;
   voxels under one tile equal to that tile; detection sensitivity > 0.85
   and PPV > 0.7 against the planted nuclei more than ``ACQ_EDGE`` voxels
   inside the tiles, and PPV over every covered voxel above
   ``ACQ_COVERED_PPV`` (the fused volume is 0 where no tile lies, as the
   reference's, and the detector finds false blobs as deep as a denoise
   tile and the LoG reach from that border, so the whole volume cannot
   meet 0.7; blobs and nuclei by depth are printed); the detector's
   near-max at the fused depth and a plane less within 5%; the
   transformation's shape and metadata by the reference formula; a 3 x 3
   set of (24, 96, 96) tiles, 30% overlap, stitched card against CPU
   (positions within 1e-3, fused volumes bit-equal where the rounded
   layouts agree), and at 10% overlap by the port's route and the
   reference's (tile errors printed, not gated); ``--proc import_only``
   of phase 6's specimen as one
   multi-page TIFF and ``--proc export_tif`` back, a deflate tile, an
   LZW (64, 343, 286) tile and two mesoSPIM RAW tiles converted, each
   equal to its source. Printed: each stage's wall, fusion GB/s,
   detection Mvox/s, peak device memory;
11. visualisation (:func:`render_path`): phase 6's specimen as float32 on
   the card, rendered at 512^2 by the gather volume renderer (256 steps,
   flat and shaded), the gather isosurface at its Otsu level, and
   shear-warp's composite, MIP and isosurface, at five poses whose
   principal axes are z (with and without the flip and the transposed
   film), y and x: ms a frame (CUDA events) and peak device memory a
   frame (gated), its blobs projected under each isosurface
   (``render_blobs_overlay``, visible share printed); the MIP along x
   against the volume's own maximum through the same film (gated);
   ``export_stack.render_rotation``, the frames of
   ``animate_rotation_3d``, 36 at 384^2 in MIP and isosurface modes
   (frames/s); ``render_channels_sw`` on phase 9's two-channel volume;
   ``plot_3d.deconvolve``, 30 iterations on a (64, 256, 256) ROI; the
   analytic sphere pins at 512^2; every engine and pose card against CPU
   on a (96, 128, 112) crop within the CPU tests' limits; deconvolution
   card against CPU; ``--proc extract`` and ``--proc export_rois``
   through the CLI, each output equal to its source. The matplotlib
   exports (``--proc export_planes[_channels]|animated``, ``--plot_2d``
   and the GIF writer of ``animate_rotation_3d``) are left out: the
   card's machine has no matplotlib, and the CPU tests hold them against
   the reference. The path reuses phase 6's blobs and launches no
   kernel (``render``: 0 each);
12. fast LoG, segmentation and atlas-register tasks (:func:`phase12`):
   phase 4's volume through ``--proc detect --roi_profile
   lightsheet,<fast.yml>`` (a profile file setting ``log_dtype:
   bfloat16``: TF32 band products in the LoG) at the slice's bars, with
   K1, K3 and K4 launched as often as by the float32 route, Mvox/s and
   the blobs that differ beside phase 4's, and one block's LoG within
   ``FAST_LOG_ATOL`` of the float32 route's and not equal to it; phase
   5's sweep with the same file (K2 and K3 launched, table beside phase
   5's); ``segment_rw`` on the whole slice seeded by phase 4's blobs,
   ``segment_ws`` and ``watershed_distance`` on a central (128, 512, 512)
   region (walls, peak memory, sweeps), a (32, 128, 128) crop of
   ``segment_rw``, ``segment_ws``, ``labels_to_markers_blob`` and
   ``borders_distance`` card against CPU; ``labels_to_markers_blob`` on
   phase 8's 25 um labels, and ``--register vol_compare``,
   ``labels_diff`` and ``labels_dist`` on those labels and markers as two
   samples, card against ``--device cpu`` (files equal, floats within
   1e-5). The segmentation and the tasks launch no kernel (``segment``,
   ``register_tasks``: 0 each);
13. vendor import (:func:`vendor_path`): phase 4's volume written by the
   port's writers as a CZI of Zstd1 hi-lo subblocks, a CZI of zlib
   subblocks, a LIF and an IMS (``NativeHdf5Writer``, contiguous), each
   imported through ``--proc import_only`` (array equal to the source,
   resolutions 1 um, write and import MB/s), a small Gray8 CZI of JPEG
   subblocks (within ``JPEG_ATOL`` of its source), and ``--proc detect``
   on the Zstd1 CZI's import (launches of the ``vendor`` path as phase
   4's, its bars, the blobs that differ from phase 4's,
   ``utils.profiler.Throughput``); the system libraries found are
   printed, and a form whose library is absent is named as not run;
14. the profiler (:func:`profiler_path`): a detect block of phase 4's
   volume stepped twice under ``utils.profiler.trace``, the second time
   in ``annotate``'s range, the Chrome trace read back naming K1, K3 and
   K4 inside the range on the device; ``entry.entry``'s step once on the
   card (launches of the ``profile`` path);
15. the study tables (:func:`study_tables`): twelve brains, six of
   ``WT`` and six of ``het`` (``null``, the third key of
   ``config.GROUPS_NUMERIC``, reads back from a CSV as missing), on phase
   6's 25 um labels, each a seeded Poisson heat map drawn on the card
   (1.6 nuclei a labelled voxel; 30% more in 20 seeded regions of the
   second condition that expect 1,000 or more) and measured by
   ``vols.measure_labels_metrics`` on the card (one brain through
   ``--register vol_stats``, equal to the direct call, floats within
   1e-5); the tables merged by ``python -m magellanmapper_torch.io.cli
   --df merge_csvs`` in a fresh interpreter beside
   ``clrstats.meas_group_stats`` by ``ttest``, ``wilcoxon``, ``gee`` and
   ``linregr`` (seconds each; the t-test must call 18 or more of the
   planted regions at BH-adjusted p < 0.05 with a positive effect, and at
   most 5% of the others), then ``--df append_csvs_cols --groups``,
   ``zscore``, ``pivot_table``, ``exps_by_region``, ``divide_cols``,
   ``melt_cols``, ``replace_vals`` and ``normalize`` (its ratios equal
   ``divide_cols'``) and ``--register combine_cols``, ``zscores``,
   ``coefvar``, ``melt_cols``, ``pivot_conds``, ``meas_improvement`` (on
   the t-test's table) and ``smoothing_peaks`` (on ``smooth_labels``'
   metrics at filter sizes 1-3 on a central crop) through the CLI in this
   process, each returning its table and writing its file where the
   reference writes one; ``reg_tasks.build_labels_diff_images`` of the
   conditions' mean density on the card (ms and peak memory), equal bit
   for bit to the host loop (``vols.map_meas_to_labels``) over 66 central
   planes (its seconds) and at every planted region to the pivoted
   table's difference; ``load_env.check_accelerator()`` reporting
   ``gpu``; ``extract_blocks`` on a float32 memmap of the detect slice's
   first 32 block windows equal to numpy slicing (MB/s of both, two
   turns). The matplotlib tasks (``--register plot_region_dev``,
   ``plot_lateral_unlabeled``, ``plot_intens_nuc``,
   ``plot_cluster_blobs``, ``clrstats.plot_volcano``) are named as not
   run; the CPU tests hold them. Launches: ``stats``, 0 each;
16. a JSON line of per-kernel results (launches summed over the paths,
   and by path), the ``nvidia-smi`` line, and the final JSON line.

``python3 chip_smoke.py --study-tables`` runs phase 15 alone, on the
seed-0 pair's labels at 25 um and the detect slice's volume.

``python3 chip_smoke.py --gauntlet-suite`` runs the reference's
gauntlet suite alone instead: ``run_gauntlet_suite`` on (160, 240, 200)
pairs of seeds 0 and 10 and the truncated seed-0 pair, ``iters_scale``
1.0, on the card; each pair's numbers, then a failure unless every pair
passes :func:`gauntlet_checks`; the ``nvidia-smi`` line and the final
JSON line.

``python3 chip_smoke.py --k4-times [--root DIR]`` times K4
alone instead (:func:`time_k4`, the same measure as phase 3) on one
seeded detect block: its (252, 15625) denoise tiles and the block as one
(1, 2,555,904) tile, each in uint16 and float32, one JSON line a shape.
``--root`` names the checkout whose ``magellanmapper_torch`` is timed
(default: this one), so an older commit unpacked with ``git archive`` can
be timed beside this one on the same card.
"""

from __future__ import annotations

import argparse
import csv
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
#: the slice's volume and the crop checked against the CPU
SLICE_SHAPE = (256, 1024, 1024)
CROP = (64, 256, 256)
#: verification tiles: edges on multiples of the nuclei grid spacing, so
#: every detection within tolerance of a nucleus shares its tile
VERIFY_TILE = (80, 320, 320)
VERIFY_TOL = (3, 3, 3)
SEED = 0
#: published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
#: 700 W limit): device-memory bytes/s and float32 operations/s outside
#: the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: operations the work needs, as the bounds count them: K1, a separable
#: 3^4 maximum (2 per axis) and 2 compares per voxel; K3, one overlap test
#: per unordered pair of valid blobs (distance 9, lens fraction ~28, 3
#: compares)
K1_OPS_PER_VOXEL = 10
K3_OPS_PER_PAIR = 40
#: the grid search's ROI (16 Mi voxels, the batched route's limit), its
#: card-against-CPU crop, and the tap route's volume (x past 768)
GRID_SHAPE = (64, 512, 512)
GRID_CROP = (32, 128, 128)
TAPS_SHAPE = (16, 48, 1024)
#: the grid search's first threshold chunk: ``gridtest`` sweeps 0.05 to
#: 0.20, two thresholds per K2 launch at GRID_SHAPE (``make_fn_detect_multi``)
GRID_K2_CHUNK = (0.05, 0.10)
#: card against CPU on the tap route: both sum in fp32, in another order
TAPS_RTOL, TAPS_ATOL = 1e-5, 1e-5
#: registration: the gauntlet pair (the reference's registration
#: yardstick, a 50 um mouse atlas's scale), the card-against-CPU pair
#: (15,680 voxels: every metric stride 1, so no jitter), its iteration
#: scale and its tolerances by stage and parameter, each a small factor
#: above the card-against-CPU difference it holds (2.4e-7, 6.5e-6, 8.2e-5
#: and 0.0155 voxels on an H100): Adam turns float32 noise in the
#: B-spline lattice's near-zero gradients into sign flips of whole steps
REG_SHAPE = (160, 240, 200)
REG_CROP = (20, 28, 28)
REG_CROP_ITERS = 0.25
REG_CROP_ATOL = {"translation.t": 1e-5, "affine.W": 1e-4, "affine.t": 1e-3,
                 "bspline.grid": 5e-2}
#: the specimen chain: the gauntlet pair's fixed image upsampled this many
#: times (a (640, 960, 800) uint16 specimen at 1 um), shrunk back to the
#: pair's shape by ``--proc transform``, detection verified in tiles of
#: the whole depth (``testing.make_specimen``); the transform's crop held
#: card against CPU; vol_stats card against CPU (both sum in float64)
SPEC_FACTOR = 4
SPEC_RESCALE = 0.25
SPEC_TILE_YX = (160, 160)
SPEC_CROP = (64, 240, 200)
TRANSFORM_RTOL = 1e-5
VOLS_RTOL = 1e-5
#: the Allen CCFv3 atlas at 25 um, and the grid that splits the pair's
#: regions into several hundred IDs there
CCF25_SHAPE = (528, 320, 456)
CCF25_SPLIT = (6, 4, 6)
#: atlas construction: four brains of the pair's shape (the pair's fixed
#: image and truth labels, each under its own ground-truth warp, seeds
#: 1-4) registered by ``--register group --atlas_profile groupwise``; the
#: reference's gate on the variance after against before
#: (``tests/test_registration.py:192``)
GROUP_SEEDS = (1, 2, 3, 4)
GROUP_VAR_GATE = 0.5
#: the groupwise card-against-CPU check: three brains of REG_CROP (every
#: metric stride 1), a short run of each route, and its limits by stage and
#: parameter: Adam turns float32 noise into sign flips of whole steps, as
#: for REG_CROP; the lattice (rate 0.5 voxels a step) is held to half a
#: step (0.070 voxels measured on an H100)
GROUP_CROP_RUN = dict(max_iter=32, grid_space_voxels=12.0,
                      grid_spacing_schedule=[2.0, 2.0, 2.0, 1.0, 1.0, 1.0])
GROUP_CROP_ATOL = {"affine.W": 1e-3, "affine.t": 1e-2, "bspline.W": 1e-3,
                   "bspline.t": 1e-2, "bspline.grid": 0.25}
#: the resume check: ``--register single`` on REG_CROP with a short
#: schedule, stopped after its affine stage and resumed
RESUME_ITERS = {"reg_translation": 48, "reg_affine": 32, "reg_bspline": 16}
#: atlas refinement at CCF25_SHAPE: a one-sided atlas from the pair
#: (``testing.make_atlas``), its outermost labelled planes cleared, imported
#: with the ``abap56`` profile, smoothed (filter 2), reannotated; the
#: card-against-CPU crop of the imported atlas and the LoG image's limit
ATLAS_CUT_PLANES = 8
ATLAS_CROP = (slice(40, 88), slice(96, 192), slice(96, 192))
LOG_RTOL = 1e-4
#: blob analysis: channel 1's own nuclei sit on the lattice shifted by
#: half a step, so their verification tiles shift by this much; patches
#: held card against CPU and the probabilities' limit (float32 CNN,
#: convolutions in other orders); the DBSCAN cloud (a fifteenth of a mouse
#: brain's nuclei at the detect slice's density) and its sub-block held
#: card against CPU
COLOC_OWN_SHIFT = 10
CLASSIFY_PATCHES = 4096
CLASSIFY_ATOL = 1e-5
CLOUD_POINTS = 4194304
CLOUD_SUB = 262144
#: acquisition (phase 10): the specimen cut into a 3 x 3 grid of tiles
#: with 10% nominal overlap (``testing.make_tiles``: y/x offsets within
#: +-6, z 0-4 planes), stitched, transformed and detected by
#: ``run_pipeline``; the reference test's bar on the recovered positions;
#: the card-against-CPU tile set (30% overlap: tiles of 96 voxels
#: overlapping by 10% hold too little for phase correlation, so that set
#: is stitched too but its errors are only printed) and its limit on the
#: positions; the
#: LZW-compressed tile and the mesoSPIM RAW tiles
ACQ_GRID = (3, 3)
ACQ_OVERLAP = 0.1
ACQ_POS_TOL = 1.0
#: the fused volume is 0 where no tile lies, as the reference's, and the
#: detector finds false blobs as deep as that border reaches: a
#: ``lightsheet`` denoise tile (25 voxels) holding an uncovered voxel is
#: saturated by percentiles that count its zeros, and the LoG reaches 3
#: times its largest scale (under 8) further. Detection is held to the
#: detect slice's bars on the voxels farther than that from every
#: uncovered one, and over every covered voxel, the border's blobs
#: included, to a PPV above the second value, set under the H100's
#: readings of phase 10 (0.2556-0.2637); blobs and nuclei are counted in
#: ``ACQ_BANDS`` bands of ``ACQ_BAND`` voxels of depth
ACQ_EDGE = 25 + 8
ACQ_COVERED_PPV = 0.2
ACQ_BAND = 8
ACQ_BANDS = 6
#: the near-max of the fused volume at its depth and a plane less agree
#: within this share (the z lattice of phase 6's specimen moved it from
#: 1848 to 1220 for one plane)
ACQ_NEAR_MAX_RTOL = 0.05
ACQ_SMALL_TILE = (24, 96, 96)
ACQ_SMALL_OVERLAP = 0.3
ACQ_POS_ATOL = 1e-3
ACQ_LZW_SHAPE = (64, 343, 286)
ACQ_RAW_SHAPE = (64, 128, 128)
#: detect_blobs: a crop of the detect volume, read as 2 um in z
DETECT_CROP = (48, 192, 192)
DETECT_RES = (2.0, 1.0, 1.0)
#: visualisation (phase 11): phase 6's specimen on the card as float32,
#: rendered at 512^2 by each engine at an orbit of poses whose principal
#: axes are z, y and x (the gather ray casters at 256 steps); the
#: card-against-CPU crop, its film and steps, and the CPU tests' limits
#: (``tests/test_torch_render3d.py``: images, depth in voxels, share of
#: isosurface hits that may differ); the analytic sphere of
#: ``tests/test_render3d.py``; the axis-aligned MIP's limits (largest
#: and mean) against the volume's own maximum sampled at the camera's
#: exact film positions: shear-warp takes its film mapping from float32
#: probes one pixel apart (the reference's ``_film_affine``), which puts
#: the far edge of this 512^2 film 0.008 voxels off its exact place, and
#: the MIP's steepest steps turn that into ~2e-3 (1.8e-3 measured on an
#: H100); a frame's peak device memory, the resident volume included
RENDER_HW = (512, 512)
RENDER_STEPS = 256
RENDER_POSES = ((30.0, 70.0), (350.0, -65.0), (100.0, 15.0), (290.0, -10.0),
                (200.0, -20.0))
RENDER_CROP = (96, 128, 112)
RENDER_CROP_HW = (96, 96)
RENDER_CROP_STEPS = 96
RENDER_ATOL = 1e-4
RENDER_DEPTH_ATOL = 1e-3
RENDER_HIT_MISMATCH = 1e-3
SPHERE_SHAPE = (48, 48, 48)
SPHERE_R = 14.0
MIP_ATOL = 5e-3
MIP_MEAN_ATOL = 1e-4
RENDER_PEAK_MIB = 16384
#: ``export_stack.render_rotation`` (the frames of ``animate_rotation_3d``)
#: at its defaults; Richardson-Lucy on a specimen ROI, and its
#: card-against-CPU ROI and relative limit (cuFFT against pocketfft)
ORBIT_FRAMES = 36
ORBIT_HW = (384, 384)
DECONV_ROI = (64, 256, 256)
DECONV_ITERS = 30
DECONV_CROP = (32, 64, 64)
DECONV_RTOL = 1e-4
#: ``--k4-times``: one detect block of the lightsheet profile, its denoise
#: tiles and its clip percentiles (clip_vmin, clip_vmax)
K4_BLOCK = (156, 128, 128)
K4_TILE = (25, 25, 25)
K4_Q = (5.0, 98.5)


#: fast LoG, segmentation and atlas-register tasks (phase 12): the
#: profile file that turns the fast LoG route on
FAST_YML = "log_dtype: bfloat16\n"
#: the fast route's largest absolute LoG difference from the float32
#: route on one detect block (limit set in PERF.md before the first run)
FAST_LOG_ATOL = 1e-3
#: watershed region at the slice's centre, and the card-against-CPU crop
SEG_CENTRAL = (128, 512, 512)
SEG_CROP = (32, 128, 128)
#: random-walker probabilities and distances, card against CPU (the CPU
#: tests' limits against the reference)
RW_PROB_ATOL = 1e-5
DIST_ATOL = 1e-5
#: item-16 tasks' floats, card against CPU
TASK_RTOL = 1e-5
#: vendor import (phase 13): phase 4's volume written in each form (name,
#: writer, CZI compression, the system library the form needs), the
#: libraries looked up on the host, and the small JPEG CZI (a Gray8 plane
#: of flat blocks) with its limit against the source: baseline JPEG at
#: quality 100 keeps such planes within 2, as the CPU tests pin
VENDOR_FORMS = (("czi_zstd1hilo", "czi", "zstd1hilo", "zstd"),
                ("czi_zlib", "czi", "zlib", None),
                ("lif", "lif", None, None),
                ("ims", "ims", None, "hdf5"))
VENDOR_LIBS = ("zstd", "jpeg", "openjp2", "hdf5_serial", "hdf5")
JPEG_PLANE = (256, 320)
JPEG_ATOL = 2
#: the profiler phase (14): the kernels the trace of one detect block
#: must name (K1, K3's pair pass, K4) and the range it annotates
TRACE_KERNELS = ("peak_candidates_kernel", "pairs_kernel",
                 "tile_percentiles")
TRACE_RANGE = "detect_block"
#: ``--gauntlet-suite``: the reference suite's seeded pairs and truncated
#: pair (``gauntlet.py:453-478``)
SUITE_SEEDS = (0, 10)
SUITE_TRUNCATED = 0
#: the study tables (phase 15): twelve brains, six a condition (keys of
#: ``config.GROUPS_NUMERIC``; not its "null", which pandas' CSV reader,
#: and so every table task of both packages, reads back as missing), on
#: phase 6's 25 um labels; Poisson
#: nuclei at ``STUDY_NUCLEI_PER_VOXEL`` a labelled voxel, uniform over the
#: brain as the specimen's lattice of nuclei is (1.6 a 25 um voxel is
#: about 100,000 a cubic millimetre, the order of a mouse brain's), and
#: ``STUDY_EFFECT`` more in ``STUDY_PLANTED`` seeded regions of the
#: second condition, drawn among the regions expecting at least
#: ``STUDY_MIN_NUCLEI`` a brain; the t-test must call at least
#: ``STUDY_MIN_CALLED`` of them at BH-adjusted p < ``STUDY_ALPHA`` and at
#: most ``STUDY_MAX_FALSE`` of the other regions
STUDY_CONDS = ("WT", "het")
STUDY_BRAINS = 6
STUDY_NUCLEI_PER_VOXEL = 1.6
STUDY_EFFECT = 0.30
STUDY_PLANTED = 20
STUDY_MIN_NUCLEI = 1000
STUDY_MIN_CALLED = 18
STUDY_ALPHA = 0.05
STUDY_MAX_FALSE = 0.05
STUDY_MODELS = ("ttest", "wilcoxon", "gee", "linregr")
#: the host loop (``vols.map_meas_to_labels``) paints the difference
#: image over this many central planes of the 25 um labels (the whole
#: image takes it a tenth of a second a region), to hold the card's image
#: there bit for bit
STUDY_LOOP_PLANES = 66
#: ``smooth_labels(metrics=True)``'s filter sizes on a central crop of the
#: labels (each axis a quarter), the table ``--register smoothing_peaks``
#: reads
STUDY_FILTER_SIZES = (1, 2, 3)
#: ``extract_blocks``: the detect slice's first block windows, from a
#: float32 memmap of the planes they cover
STUDY_EXTRACT_BLOCKS = 32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, reps=20):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(torch, fn, name_part, reps=50):
    """Mean milliseconds of device time per call of ``fn`` spent in the
    kernels whose name holds ``name_part`` (every device activity for
    ``""``), from ``torch.profiler``'s records (the launch's host cost
    left out)."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [ev.time_range.end - ev.time_range.start for ev in prof.events()
          if ev.device_type == DeviceType.CUDA and name_part in ev.name
          and not ev.name.startswith("Activity Buffer")]
    if not us:
        fail(f"the profiler recorded no kernel named *{name_part}*")
    return sum(us) / reps / 1e3


def bound(nbytes: float, ops: float):
    """``(ms, resource)``: the least time the card could take to move
    ``nbytes`` (each input read once, each output written once) and to do
    ``ops`` float32 operations, at the published peaks."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def record(results, name, *, ms, plain_ms, library_ms, nbytes, ops,
           max_abs_err, **extra):
    """Fill ``results[name]`` with the measured times and this run's
    bound."""
    bound_ms, bound_by = bound(nbytes, ops)
    results[name].update(
        max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
        library_ms=library_ms, **extra)
    print(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f}, library "
          f"{library_ms}), bound {bound_ms:.4f} ms by {bound_by}, "
          f"{100 * bound_ms / ms:.1f}% of bound", flush=True)


def detect_block(torch, prof, vol, dev):
    """The detect path's step parameters for ``vol`` and one of its block
    windows on ``dev``."""
    from magellanmapper_torch.cv import stack_detect as sd

    blocks = sd.setup_blocks(prof, vol.shape, (1.0, 1.0, 1.0))
    block_shape = np.minimum(blocks.max_pixels + blocks.overlap, vol.shape)
    params = sd.step_params(prof, blocks, block_shape, (1.0, 1.0, 1.0),
                            float(np.percentile(vol[::16], 99.5)))
    bz, by, bx = (int(v) for v in block_shape)
    block = torch.from_numpy(np.ascontiguousarray(
        vol[64:64 + bz, 256:256 + by, 256:256 + bx])).to(dev)
    return params, block


def block_inputs(torch, prof, vol, dev):
    """One block of the detect path on ``dev``: its parameters, the raw
    block, its LoG cube, and the LoG cube of a ragged (31, 64, 130)
    window."""
    from magellanmapper_torch.cv import stack_detect as sd
    from magellanmapper_torch.ops import filters

    params, block = detect_block(torch, prof, vol, dev)
    print(f"block window {tuple(block.shape)}, capacity "
          f"{params.capacity}, {len(params.sigmas)} scales", flush=True)
    pre = sd.preprocess_block(block, params.denoise_shape,
                              params.preproc_items)
    cube = filters.log_pyramid(pre, params.sigmas).contiguous()
    ragged_pre = sd.preprocess_block(
        torch.from_numpy(np.ascontiguousarray(
            vol[11:42, 100:164, 300:430])).to(dev),
        params.denoise_shape, params.preproc_items)
    ragged = filters.log_pyramid(ragged_pre, params.sigmas).contiguous()
    return params, block, cube, ragged


def same_bits(torch, a, b) -> bool:
    """Float32 tensors equal bit for bit (``-0.0`` is not ``+0.0``)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def k4_shapes(torch, tiles, block):
    """K4's timed shapes: a block's denoise tiles as the detect path hands
    them over, and the block as one tile (a profile without denoise tiles,
    e.g. ``binary``), each in uint16 and float32."""
    whole = block.reshape(1, -1)
    return {"tiles_u16": tiles, "tiles_f32": tiles.to(torch.float32),
            "block_u16": whole, "block_f32": whole.to(torch.float32)}


def time_k4(torch, k4, t, q, reps=50):
    """K4 of module ``k4`` at one shape: its kernels' device time and that
    of every device activity of a call (the long route's scratch fill
    too), from ``torch.profiler``; the wrapper's, the plain version's and
    ``torch.quantile``'s times (CUDA events); the bound (the matrix read
    once, the (T, 2) result written once; one operation an element)."""
    t_f32 = t.to(torch.float32)   # the library call's copy, made untimed
    qt = torch.tensor([q[0] / 100, q[1] / 100], dtype=torch.float32,
                      device=t.device)
    call = lambda: k4.tile_percentiles(t, *q)   # noqa: E731
    nbytes = t.numel() * t.element_size() + t.shape[0] * 2 * 4
    out = dict(
        shape=list(t.shape), dtype=str(t.dtype),
        device_ms=kernel_device_ms(torch, call, "tile_percentiles", reps),
        call_device_ms=kernel_device_ms(torch, call, "", reps),
        ms=cuda_ms(torch, call),
        plain_ms=cuda_ms(torch, lambda: k4.tile_percentiles_plain(t, *q)),
        library_ms=cuda_ms(torch, lambda: torch.quantile(t_f32, qt, dim=1)),
        nbytes=nbytes, bound_ms=bound(nbytes, t.numel())[0])
    out["device_share_of_bound"] = out["bound_ms"] / out["device_ms"]
    return out


def check_k4(torch, params, block, results, dev):
    """K4 on the denoise tiles of one block, as the preprocessing cuts
    them, on the block as one tile (the split route), and on the edge cases
    of ``testing.k4_cases``, bit for bit at each percentile pair of
    ``testing.K4_QS`` and the profile's; timed by :func:`time_k4` at the
    shapes of :func:`k4_shapes`."""
    from magellanmapper_torch import testing
    from magellanmapper_torch.cv import stack_detect as sd
    from magellanmapper_torch.kernels import tile_percentiles as k4

    prep = dict(params.preproc_items)
    tiles = sd.to_tiles(block, params.denoise_shape)[0]
    tiles = tiles.reshape(tiles.shape[0], -1)
    whole = block.reshape(1, -1)
    rng = np.random.default_rng(SEED)
    dup = torch.from_numpy(
        rng.integers(0, 4, tiles.shape).astype(np.float32)).to(dev)
    cases = {
        "u16": tiles,
        "f32": tiles.to(torch.float32),
        "u16_ragged_v": tiles[:, :12345].contiguous(),
        "f32_duplicates": dup,
        "u16_block_one_tile": whole,
        "f32_block_one_tile": whole.to(torch.float32),
    }
    cases.update((name, torch.from_numpy(a).to(dev))
                 for name, a in testing.k4_cases(SEED).items())
    q = (prep["clip_vmin"], prep["clip_vmax"])
    qs = (q,) + testing.K4_QS
    err4 = 0.0
    routes = set()
    for name, t in cases.items():
        n_chunks, chunk = k4.split(*t.shape, max(2, t.element_size()))
        routes.add("long" if n_chunks > 1 else "short")
        for qq in qs:
            got = k4.tile_percentiles(t, *qq)
            want = k4.tile_percentiles_plain(t, *qq)
            err = float((got - want).abs().max())
            err4 = max(err4, err)
            if not same_bits(torch, got, want):
                fail(f"K4 {name} {tuple(t.shape)} q={qq}: kernel != plain "
                     f"version (max_abs_err {err})")
        print(f"K4 {name} {tuple(t.shape)} {t.dtype}, {n_chunks} chunk(s) "
              f"of {chunk}: equal at {len(qs)} percentile pairs", flush=True)
    if routes != {"short", "long"}:
        fail(f"K4's cases took the routes {sorted(routes)}, not both")
    qt = torch.tensor([q[0] / 100, q[1] / 100], dtype=torch.float32,
                      device=dev)
    lib_err = float((torch.quantile(tiles.to(torch.float32), qt, dim=1).T
                     - k4.tile_percentiles(tiles, *q)).abs().max())
    print(f"K4 torch.quantile against the kernel: max_abs_diff {lib_err}",
          flush=True)
    timed = {name: time_k4(torch, k4, t, q)
             for name, t in k4_shapes(torch, tiles, block).items()}
    for name, row in timed.items():
        print(f"K4 timed {name}: {row}", flush=True)
    main = timed["tiles_u16"]
    record(results, "tile_percentiles", ms=main["ms"],
           plain_ms=main["plain_ms"], library_ms=main["library_ms"],
           nbytes=main["nbytes"], ops=tiles.numel(), max_abs_err=err4,
           shape=main["shape"], device_ms=main["device_ms"],
           device_share_of_bound=main["device_share_of_bound"],
           timed=timed)


def k4_times(root: str) -> None:
    """``--k4-times``: K4 of the checkout at ``root`` against its own plain
    version (bit for bit), then one JSON line of :func:`time_k4` for each
    of :func:`k4_shapes` (labelled with ``root``), on a seeded block of
    ``K4_BLOCK``."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    try:
        from magellanmapper_torch import testing
        from magellanmapper_torch.cv import stack_detect as sd
        from magellanmapper_torch.kernels import tile_percentiles as k4
    except ImportError as err:
        fail(f"{root} holds no magellanmapper_torch package: {err}")
    if not k4.__file__.startswith(root + os.sep):
        fail(f"imported {k4.__file__}, not the one under {root}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    block = torch.from_numpy(
        testing.make_nuclei_volume(K4_BLOCK, SEED)[0]).cuda()
    tiles = sd.to_tiles(block, K4_TILE)[0]
    tiles = tiles.reshape(tiles.shape[0], -1)
    for name, t in k4_shapes(torch, tiles, block).items():
        if not same_bits(torch, k4.tile_percentiles(t, *K4_Q),
                         k4.tile_percentiles_plain(t, *K4_Q)):
            fail(f"K4 {name} of {root}: kernel != plain version")
        print(json.dumps({"root": root, "name": name,
                          **time_k4(torch, k4, t, K4_Q, reps=100)}),
              flush=True)


def k1_cases(torch, cube, ragged, thr, dev):
    """K1's cases: the block's and a ragged LoG cube, the block's with
    planted NaNs, scale counts of 1, 2 and 12 (two scale chunks), x widths
    of 1, 127 and 130, and two cubes with more peaks than the first buffer
    holds."""
    from magellanmapper_torch.kernels import peak_candidates as k1

    rng = np.random.default_rng(SEED + 1)

    def noise(shape):
        return torch.from_numpy(
            rng.normal(0, 0.1, shape).astype(np.float32)).to(dev)

    nan = cube.clone()
    _, idx = k1.peak_candidates_plain(cube, thr)
    flat = nan.view(-1)
    flat[idx[::7]] = float("nan")               # NaN centres
    flat[torch.clamp(idx[1::7] + 1, max=flat.numel() - 1)] = float("nan")
    flat[torch.from_numpy(rng.integers(0, flat.numel(), 5000)).to(dev)] = (
        float("nan"))
    plateau = torch.zeros((1, 2, 512, 512), device=dev)
    plateau[0, 1] = 1.0                         # 262,144 equal peaks
    return {
        "block": (cube, thr), "ragged": (ragged, thr), "nan": (nan, thr),
        "s1": (noise((1, 40, 64, 96)), 0.1),
        "s2": (noise((2, 40, 64, 96)), 0.1),
        "s12": (noise((12, 20, 40, 64)), 0.1),
        "x1": (noise((3, 20, 30, 1)), 0.05),
        "x127": (noise((4, 17, 45, 127)), 0.1),
        "x130": (noise((10, 31, 64, 130)), 0.1),
        "many_peaks": (noise((4, 64, 256, 256)), 0.05),
        "plateau_relaunch": (plateau, 0.5),
    }


def check_k1(torch, cube, ragged, thr, results, dev):
    """K1 against its plain version, bit for bit, on every case of
    :func:`k1_cases`; timed on the block's cube."""
    from magellanmapper_torch.kernels import peak_candidates as k1

    err1 = 0.0
    for name, (c, t) in k1_cases(torch, cube, ragged, thr, dev).items():
        gv, gi = k1.select_top_sparse(*k1.peak_candidates(c, t), c.numel())
        wv, wi = k1.select_top_sparse(
            *k1.peak_candidates_plain(c, t), c.numel())
        print(f"K1 {name} {tuple(c.shape)}: {gv.numel()} peaks (plain "
              f"{wv.numel()})", flush=True)
        if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
            fail(f"K1 {name}: kernel peaks != plain version")
        if gv.numel():
            err1 = max(err1, float((gv - wv).abs().max()))
    n_peaks = k1.peak_candidates_plain(cube, thr)[0].numel()
    record(results, "peak_candidates",
           ms=cuda_ms(torch, lambda: k1.peak_candidates(cube, thr)),
           plain_ms=cuda_ms(
               torch, lambda: k1.peak_candidates_plain(cube, thr)),
           library_ms=None,
           nbytes=cube.numel() * 4 + n_peaks * 8 + 4,
           ops=cube.numel() * K1_OPS_PER_VOXEL, max_abs_err=err1,
           device_ms=cuda_ms(
               torch, lambda: k1.enqueue(cube, thr, k1.FIRST_BUFFER)),
           shape=list(cube.shape), peaks=n_peaks,
           frac_above_threshold=float((cube > thr).sum()) / cube.numel())


def k3_cases(torch, cube, params, dev):
    """K3's cases at the block capacity: the block's own peaks, the same
    rows under a mask that is no prefix, synthetic buffers (sparse,
    dense-crowded, all-invalid, equal radii), a K of no tile's multiple,
    and the grid search's capacity of 16,384."""
    from magellanmapper_torch.ops import peaks

    rng = np.random.default_rng(SEED + 2)
    k = params.capacity
    coords4, _, count = peaks.find_peaks(cube, params.threshold, k)
    sig = torch.tensor(params.sigmas, dtype=torch.float32,
                       device=dev)[coords4[:, 0].long()]
    pos = coords4[:, 1:].to(torch.float32).contiguous()
    prefix = torch.arange(k, device=dev) < count
    holes = prefix & torch.from_numpy(rng.random(k) < 0.5).to(dev)

    def synth(n, box, s_lo, s_hi, frac_valid, equal=False):
        c = torch.from_numpy((rng.random((n, 3)) * np.asarray(box)).astype(
            np.float32)).to(dev)
        s = np.full(n, s_lo) if equal else rng.uniform(s_lo, s_hi, n)
        v = torch.from_numpy(rng.random(n) < frac_valid).to(dev)
        return c, torch.from_numpy(s.astype(np.float32)).to(dev), v

    return {
        "block_peaks": (pos, sig, prefix),
        "block_non_prefix": (pos, sig, holes),
        "sparse": synth(k, (128, 128, 128), 2.6, 2.8, 0.15),
        "dense_crowded": synth(k, (40, 40, 40), 1.5, 4.0, 0.95),
        "all_invalid": synth(k, (128, 128, 128), 2.6, 2.8, 0.0),
        "equal_radii": synth(k, (24, 24, 24), 2.5, 2.5, 0.9, equal=True),
        "ragged_k_4099": synth(4099, (40, 40, 40), 1.5, 4.0, 0.95),
        "k16384": synth(16384, (64, 256, 256), 3.0, 4.0, 0.5),
    }


def check_k3(torch, cube, params, results, dev):
    """K3 against its plain version, bit for bit, on every case of
    :func:`k3_cases`; timed on the block's peaks, dense-crowded and
    K = 16,384."""
    from magellanmapper_torch.kernels import prune_overlap as k3

    cases = k3_cases(torch, cube, params, dev)
    thresh = params.overlap
    mism = 0
    for name, (c, s, v) in cases.items():
        got = k3.prune_overlap(c, s, v, thresh)
        want = k3.prune_overlap_plain(c, s, v, thresh)
        n_bad = int((got != want).sum())
        print(f"K3 {name} K={len(v)}: {int(v.sum())} valid -> "
              f"{int(got.sum())} kept, {n_bad} mismatches", flush=True)
        if n_bad:
            fail(f"K3 {name}: kernel mask != plain version")
        mism = max(mism, n_bad)
    timed = {}
    for name in ("block_peaks", "dense_crowded", "k16384"):
        c, s, v = cases[name]
        n = int(v.sum())
        nbytes = len(v) * (3 * 4 + 4 + 1 + 1)
        ops = n * (n - 1) // 2 * K3_OPS_PER_PAIR
        timed[name] = dict(
            k=len(v), valid=n,
            ms=cuda_ms(torch, lambda: k3.prune_overlap(c, s, v, thresh)),
            plain_ms=cuda_ms(torch, lambda: k3.prune_overlap_plain(
                c, s, v, thresh), reps=3),
            bound_ms=bound(nbytes, ops)[0], bound_by=bound(nbytes, ops)[1])
        print(f"K3 timed {name}: {timed[name]}", flush=True)
    main = timed["dense_crowded"]
    n = main["valid"]
    record(results, "prune_overlap", ms=main["ms"],
           plain_ms=main["plain_ms"], library_ms=None,
           nbytes=main["k"] * (3 * 4 + 4 + 1 + 1),
           ops=n * (n - 1) // 2 * K3_OPS_PER_PAIR, max_abs_err=float(mism),
           timed_case="dense_crowded", cases=timed)


def check_k2(torch, roi, sigmas, results, dev):
    """K2 against its plain version on ``dev``, bit for bit (values and
    lanes): one launch of the grid search (the masked fields of its first
    threshold chunk, 0.05 and 0.10, as ``peaks.find_peaks_unfused`` builds
    them), all -inf rows, plateau rows, duplicate-heavy rows and a ragged
    row count; the library call is ``torch.topk``."""
    from magellanmapper_torch.kernels import extract_candidates as k2
    from magellanmapper_torch.ops import filters, peaks

    cube = filters.log_pyramid(torch.from_numpy(roi).to(dev), sigmas)
    # thresholds rounded to float32, as blob_log_multi rounds them
    chunk = [float(t) for t in np.asarray(GRID_K2_CHUNK, np.float32)]
    field = peaks._masked_fields(
        cube, peaks.local_maxima(cube), chunk)[0].reshape(-1, k2.GROUP)
    del cube
    rng = np.random.default_rng(SEED)
    neg_inf = np.full((65536, k2.GROUP), -np.inf, np.float32)
    plateau = neg_inf[:4096].copy()
    plateau[::2] = 0.5
    plateau[1::4, ::3] = 0.25
    plateau[3::4, 5] = 0.3
    dup = rng.integers(0, 4, (65536, k2.GROUP)).astype(np.float32)
    dup[rng.random(dup.shape) < 0.5] = -np.inf
    ragged = np.full((100003, k2.GROUP), -np.inf, np.float32)
    hit = rng.random(ragged.shape) < 0.02
    ragged[hit] = rng.uniform(0, 1, hit.sum())
    cases = {"grid_chunk_0.05_0.10": field, "all_neg_inf": neg_inf,
             "plateau": plateau, "duplicates": dup, "ragged_R": ragged}
    err2 = 0.0
    for name, rows in cases.items():
        rows = rows if torch.is_tensor(rows) else torch.from_numpy(
            rows).to(dev)
        got_v, got_l = k2.extract_candidates(rows)
        want_v, want_l = k2.extract_candidates_plain(rows)
        same = got_v == want_v      # equal -infs compare equal
        n_bad = int((~same | (got_l != want_l)).sum())
        err = float(torch.where(same, 0.0, (got_v - want_v).abs()).max())
        finite = int(torch.isfinite(got_v).sum())
        print(f"K2 {name} {tuple(rows.shape)}: {finite} finite candidates, "
              f"{n_bad} mismatches, max_abs_err {err}", flush=True)
        if n_bad:
            fail(f"K2 {name}: kernel != plain version")
        err2 = max(err2, err)
    r = field.shape[0]
    busy_rows = int(torch.isfinite(field).any(dim=1).sum())
    record(results, "extract_candidates",
           ms=cuda_ms(torch, lambda: k2.extract_candidates(field)),
           plain_ms=cuda_ms(
               torch, lambda: k2.extract_candidates_plain(field), reps=3),
           library_ms=cuda_ms(torch, lambda: torch.topk(field, 8, dim=1)),
           nbytes=r * k2.GROUP * 4 + r * k2.ROUNDS * 8,
           ops=r * k2.GROUP + busy_rows * k2.ROUNDS * k2.GROUP,
           max_abs_err=err2, shape=list(field.shape))


def grid_search_path(torch, roi, centres, work, results, launches):
    """The ``--grid_search`` task through the port's CLI on the card;
    returns its table, fails on a fault."""
    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch import testing
    from magellanmapper_torch.cv import stack_detect
    from magellanmapper_torch.io import cli
    from magellanmapper_torch.stats import mlearn

    with tempfile.TemporaryDirectory(dir=work) as tmp:
        img = os.path.join(tmp, "roi.npy")
        np.save(img, roi)   # no metadata: the CLI takes 1 um spacing
        truth = testing.write_truth_db(
            os.path.join(tmp, "truth.db"), centres, GRID_SHAPE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dev_mod.reset_launches()
        t0 = time.perf_counter()
        df = cli.main(["--img", img, "--grid_search", "gridtest",
                       "--roi_profile", "4xnuc", "--truth_db", truth,
                       "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["grid_search"] = dict(dev_mod.LAUNCHES)
        peak_mem = torch.cuda.max_memory_allocated()
        with open(img + "_gridsearch.csv") as f:
            saved = list(csv.DictReader(f))
    print(f"grid search: launches {launches['grid_search']}", flush=True)
    if dev_mod.TF32_SCOPES["band_products"]:
        fail("grid search: the float32 route ran band products with TF32")
    for name in ("extract_candidates", "prune_overlap"):
        if launches["grid_search"][name] <= 0:
            fail(f"kernel {name} was not launched by the grid search")
    if len(df) != 4 or len(saved) != 4:
        fail(f"expected 4 grid rows, got {len(df)} (csv {len(saved)})")
    by_thr = df.sort_values("detection_threshold")
    for _, row in by_thr.iterrows():
        print(f"grid search: threshold {row['detection_threshold']:.2f} "
              f"TP {int(row['TP'])} FP {int(row['FP'])} SENS {row['SENS']:.4f} "
              f"PPV {row['PPV']:.4f}", flush=True)
    det = (by_thr["TP"] + by_thr["FP"]).to_numpy()
    if np.any(np.diff(det) > 0):
        fail(f"detections rise with the threshold: {det.tolist()}")
    best = mlearn.parse_grid_stats(df).iloc[0]
    print(f"grid search: {len(centres)} planted nuclei; best threshold "
          f"{best['detection_threshold']:.2f} (sensitivity "
          f"{best['SENS']:.4f}, PPV {best['PPV']:.4f}); wall {wall:.3f} s; "
          f"peak device memory {peak_mem / 2**20:.1f} MiB", flush=True)
    if not (best["SENS"] > 0.85 and best["PPV"] > 0.7):
        fail(f"grid search quality below the bars: {best.to_dict()}")

    # the batched route on a crop, card against CPU (K2 route: 40,960
    # groups of 128 lanes against a capacity of 4,096)
    prof = stack_detect.roi_profile("4xnuc")
    crop = np.ascontiguousarray(roi[:GRID_CROP[0], :GRID_CROP[1],
                                    :GRID_CROP[2]])
    ths = [0.05, 0.1, 0.15, 0.2]
    on_card = mlearn.make_fn_detect_multi(
        crop, (1.0, 1.0, 1.0), prof, "cuda")({}, ths)
    on_cpu = mlearn.make_fn_detect_multi(
        crop, (1.0, 1.0, 1.0), prof, "cpu")({}, ths)
    for th, a, b in zip(ths, on_card, on_cpu):
        n = 0 if a is None else len(a)
        print(f"grid crop {GRID_CROP} at {th}: {n} blobs on the card, "
              f"{0 if b is None else len(b)} on the CPU", flush=True)
        if not ((a is None and b is None) or testing.rows_equal(a, b)):
            fail(f"grid crop at {th}: the card's blobs differ from the CPU's")
    return df


def check_taps(torch, sigmas):
    """The LoG pyramid's tap route (x past 768 samples) on the card
    against the CPU."""
    from magellanmapper_torch.ops import filters

    vol = np.random.default_rng(SEED).random(TAPS_SHAPE).astype(np.float32)
    on_cpu = filters.log_pyramid(torch.from_numpy(vol), sigmas)
    on_card = filters.log_pyramid(torch.from_numpy(vol).cuda(), sigmas)
    err = float((on_card.cpu() - on_cpu).abs().max())
    print(f"taps {TAPS_SHAPE}, {len(sigmas)} scales: card vs CPU max_abs_err "
          f"{err} (max |LoG| {float(on_cpu.abs().max()):.4f})", flush=True)
    if not torch.allclose(on_card.cpu(), on_cpu, rtol=TAPS_RTOL,
                          atol=TAPS_ATOL):
        fail("tap route: the card's pyramid differs from the CPU's")


def stage_rates(levels):
    """Optimiser steps per second of each stage, over its levels."""
    out = {}
    for row in levels:
        steps, secs = out.get(row["kind"], (0, 0.0))
        out[row["kind"]] = (steps + row["iters"], secs + row["seconds"])
    return {k: {"steps": n, "seconds": s, "steps_per_s": n / s}
            for k, (n, s) in out.items()}


def register_path(torch, pair, sample, atlas, prefix, launches):
    """``--register single`` through the port's CLI on the card with the
    default atlas profile, of the atlas directory onto ``sample``, the
    outputs named after ``prefix``; fails unless the four outputs are
    written and the atlas overlaps the sample better than before
    registration. Returns the written labels."""
    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch.atlas import gauntlet, metrics
    from magellanmapper_torch.io import cli, np_io, sitk_io

    fixed = np.asarray(np_io.read_file(sample).img[0])
    unreg = metrics.measure_overlap(fixed, pair["moving"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dev_mod.reset_launches()
    t0 = time.perf_counter()
    out = cli.main(["--img", sample, atlas, "--register", "single",
                    "--prefix", prefix, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["register"] = dict(dev_mod.LAUNCHES)
    peak_mem = torch.cuda.max_memory_allocated()
    names = {k: sitk_io.reg_out_path(prefix, k) for k in (
        "exp.mhd", "atlasVolume.mhd", "annotation.mhd", "stats.csv")}
    missing = [k for k, p in names.items() if not os.path.isfile(p)]
    if missing:
        fail(f"--register single wrote no {missing}")
    with open(names["stats.csv"]) as f:
        stats = {k: float(v) for k, v in next(csv.DictReader(f)).items()}
    labels = sitk_io.read_med_img(names["annotation.mhd"]).img
    lt = gauntlet.label_transfer_dsc(labels, pair["labels_fixed_gt"])
    result = out["transform"]
    print(f"register: launches {launches['register']}", flush=True)
    for row in result.levels:
        print(f"register level: {json.dumps(row)}", flush=True)
    print("register: " + json.dumps({
        "wall_s": wall, "DSC_atlas_sample": stats["DSC_atlas_sample"],
        "DSC_sample_labels": stats["DSC_sample_labels"],
        "Time_s": stats["Time_s"], "unregistered_dsc": unreg,
        "label_dsc_median": lt["median"], "label_dsc_min": lt["min"],
        "label_dsc_p10": lt["p10"], "stages": stage_rates(result.levels),
        "peak_device_mib": peak_mem / 2**20}), flush=True)
    if not stats["DSC_atlas_sample"] > unreg:
        fail(f"registration did not improve the overlap: "
             f"{stats['DSC_atlas_sample']} <= unregistered {unreg}")
    return labels, wall


def transform_crop(torch, vol, work):
    """``transpose_img`` at the chain's rescale on a crop of the specimen
    written as its own image5d, on the card and on the CPU; fails unless
    they agree within ``TRANSFORM_RTOL``."""
    from magellanmapper_torch.atlas import transformer
    from magellanmapper_torch.io import np_io

    crop = np.ascontiguousarray(vol[tuple(slice(0, s) for s in SPEC_CROP)])
    outs = {}
    for dev in ("cuda", "cpu"):
        where = os.path.join(work, dev)
        os.makedirs(where)
        path = os.path.join(where, "crop.npy")
        np_io.write_npy(path, crop, resolutions=[[1.0, 1.0, 1.0]])
        out = transformer.transpose_img(path, rescale=SPEC_RESCALE,
                                        device=dev)
        outs[dev] = np.asarray(np_io.read_file(out).img)
    card, cpu = outs["cuda"], outs["cpu"]
    err = float(np.max(np.abs(card - cpu) / np.maximum(np.abs(cpu), 1e-30)))
    print(f"transform crop {SPEC_CROP} at {SPEC_RESCALE}: {card.shape}; card "
          f"vs CPU max relative difference {err:.3g}", flush=True)
    if card.shape != cpu.shape or not np.allclose(
            card, cpu, rtol=TRANSFORM_RTOL, atol=0):
        fail("transform crop: the card's image differs from the CPU's")


def region_counts(df, truth_regions):
    """Per-region ``Nuclei`` of a vol_stats table against the planted
    nuclei per ground-truth region: median and worst relative error and
    the three worst regions."""
    truth = dict(zip(*np.unique(truth_regions[truth_regions > 0],
                                return_counts=True)))
    got = dict(zip(df["Region"].astype(int), df["Nuclei"].astype(int)))
    rows = sorted(
        ((abs(got.get(r, 0) - n) / n, int(r), int(got.get(r, 0)), int(n))
         for r, n in truth.items()), reverse=True)
    errs = [r[0] for r in rows]
    return {"median_rel_err": float(np.median(errs)),
            "worst_rel_err": float(errs[0]),
            "worst": [{"region": r, "nuclei": g, "planted": n}
                      for _, r, g, n in rows[:3]]}


def specimen_chain(torch, pair, work, launches):
    """The specimen pipeline through the port's CLI on the card, on a
    seeded full-resolution specimen of the gauntlet pair
    (``testing.make_specimen``, ``SPEC_FACTOR`` times its shape): detect,
    transform (``rescale`` ``SPEC_RESCALE``, back to the pair's shape),
    ``--register single`` onto the shrunk specimen (:func:`register_path`),
    ``make_density_images`` and ``vol_stats``. Fails unless detection
    meets the detect slice's bars, the transform's shape and metadata are
    the reference formula's and its crop agrees with the CPU, the heat map
    holds every blob, the regions' sums equal the heat map's and the
    labels', and ``vol_stats`` on the CPU agrees with the card's. Returns
    the blobs, and the specimen for phase 10's TIFF round trips."""
    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch import testing
    from magellanmapper_torch.io import cli, np_io, sitk_io

    steps = {}

    def step(name, argv):
        out, steps[name] = timed(torch, lambda: cli.main(
            argv + ["--device", "cuda"]))
        return out

    t0 = time.perf_counter()
    vol, centres = testing.make_specimen(pair, SPEC_FACTOR, SEED, "cuda")
    shape = vol.shape
    spec = os.path.join(work, "spec.npy")
    np_io.write_npy(spec, vol, resolutions=[[1.0, 1.0, 1.0]])
    print(f"specimen {shape} {vol.dtype} ({vol.nbytes} B), {len(centres)} "
          f"planted nuclei, made and written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    transform_crop(torch, vol, os.path.join(work, "crop"))
    atlas = os.path.join(work, "atlas")
    os.makedirs(atlas)
    sitk_io.write_med_img(os.path.join(atlas, "atlasVolume.mhd"),
                          sitk_io.MedImage(pair["moving"]))
    sitk_io.write_med_img(os.path.join(atlas, "annotation.mhd"),
                          sitk_io.MedImage(pair["labels"]))

    # detect and transform: the specimen path's kernels
    dev_mod.reset_launches()
    blobs = step("detect", ["--img", spec, "--proc", "detect",
                            "--roi_profile", "lightsheet"]).blobs
    small = step("transform", ["--img", spec, "--proc", "transform",
                               "--transform", f"rescale={SPEC_RESCALE}"])
    counts = dict(dev_mod.LAUNCHES)
    sens, ppv = testing.sens_ppv(blobs, centres, shape,
                                 (shape[0],) + SPEC_TILE_YX, VERIFY_TOL)
    print(f"specimen detect: {len(blobs)} blobs for {len(centres)} nuclei; "
          f"sensitivity {sens:.4f} PPV {ppv:.4f}", flush=True)
    if not (sens > 0.85 and ppv > 0.7):
        fail(f"specimen detection below the bars: sens {sens} ppv {ppv}")
    img5d = np_io.read_file(small)
    want_shape = tuple(int(s * SPEC_RESCALE) for s in shape)
    meta = img5d.meta
    print(f"specimen transform: {img5d.img.shape}, scaling "
          f"{meta['scaling']}, resolutions {meta['resolutions']}",
          flush=True)
    want_res = [(np.ones(3) / SPEC_RESCALE).tolist()]
    if img5d.img.shape != (1,) + want_shape or want_shape != REG_SHAPE \
            or meta["scaling"] != np.divide(want_shape, shape).tolist() \
            or meta["resolutions"] != want_res:
        fail(f"transform wrote {img5d.img.shape} with {meta}, not the "
             f"reference formula's {want_shape}")

    # register the shrunk specimen, naming the outputs after the specimen
    labels, reg_wall = register_path(torch, pair, small, atlas, spec,
                                     launches)
    steps["register"] = {"wall_s": reg_wall}

    # count per region
    dev_mod.reset_launches()
    step("make_density_images", ["--img", spec, "--register",
                                 "make_density_images"])
    df = step("vol_stats", ["--img", spec, "--register", "vol_stats"])
    launches["specimen"] = {k: v + dev_mod.LAUNCHES[k]
                            for k, v in counts.items()}
    print(f"specimen: launches {launches['specimen']}", flush=True)
    for name in ("peak_candidates", "prune_overlap", "tile_percentiles"):
        if launches["specimen"][name] <= 0:
            fail(f"kernel {name} was not launched on the specimen path")
    heat = sitk_io.load_registered_img(spec, "heat.mhd")
    fg = labels != 0
    sums = {"blobs": len(blobs), "heat": int(heat.sum()),
            "nuclei": int(df["Nuclei"].sum()),
            "heat_in_labels": int(heat[fg].sum()),
            "volpx": int(df["VolPx"].sum()), "labelled": int(fg.sum())}
    print(f"specimen sums: {sums}; heat {heat.shape} {heat.dtype}",
          flush=True)
    if heat.shape != REG_SHAPE or sums["heat"] != sums["blobs"] \
            or sums["nuclei"] != sums["heat_in_labels"] \
            or sums["volpx"] != sums["labelled"]:
        fail(f"specimen counts do not add up: {sums}")
    cpu_prefix = os.path.join(work, "spec_cpu")
    t0 = time.perf_counter()
    df_cpu = cli.main(["--img", spec, "--register", "vol_stats",
                       "--prefix", cpu_prefix, "--device", "cpu"])
    t_cpu = time.perf_counter() - t0
    for col in df.columns:
        a, b = df[col].to_numpy(), df_cpu[col].to_numpy()
        same = (np.array_equal(a, b) if a.dtype.kind in "iu"
                else np.allclose(a, b, rtol=VOLS_RTOL, atol=0,
                                 equal_nan=True))
        if not same:
            fail(f"vol_stats column {col}: the card's differs from the CPU's")
    regions = pair["labels_fixed_gt"][tuple((centres // SPEC_FACTOR).T)]
    print("specimen regions against the planted nuclei: "
          + json.dumps(region_counts(df, regions)), flush=True)
    mvox = {k: float(np.prod(shape)) / 1e6 / steps[k]["wall_s"]
            for k in ("detect", "transform")}
    print("specimen chain: " + json.dumps({
        "shape": list(shape), "nuclei": len(centres), "regions": len(df),
        "steps": steps, "mvox_per_s": mvox, "vol_stats_cpu_s": t_cpu}),
        flush=True)
    return blobs, vol


def ccf25_labels(torch, pair):
    """The pair's ground-truth labels resized to the Allen CCFv3 25 um
    atlas's size at order 0 and split by a coarse grid into several
    hundred IDs (the left half negative, as a mirrored annotation), and
    the fixed image resized as the intensity: ``(labels, intensity)``,
    int32 and float32 on the host."""
    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch.ops import resize

    dev = dev_mod.resolve("cuda")
    gt = torch.from_numpy(pair["labels_fixed_gt"]).to(dev)
    labels = resize.resize(gt, CCF25_SHAPE, order=0)
    grid = [torch.arange(s, device=dev) * n // s
            for s, n in zip(CCF25_SHAPE, CCF25_SPLIT)]
    cell = (grid[0][:, None, None] * CCF25_SPLIT[1]
            + grid[1][None, :, None]) * CCF25_SPLIT[2] + grid[2][None, None]
    labels = torch.where(labels > 0, labels * 1000 + cell, 0)
    side = torch.where(torch.arange(CCF25_SHAPE[2], device=dev)
                       < CCF25_SHAPE[2] // 2, -1, 1)
    labels = (labels * side).to(torch.int32).cpu().numpy()
    intensity = resize.resize(torch.from_numpy(pair["fixed"]).to(dev),
                              CCF25_SHAPE).cpu().numpy()
    return labels, intensity


def vol_stats_25um(torch, pair, blobs):
    """``measure_labels_metrics`` once on the card at the Allen CCFv3
    25 um atlas's size (:func:`ccf25_labels`), with the specimen's blobs
    as an int32 heat map; fails unless the regions' sums equal the heat
    map's and the labels'. Returns the labels and intensity."""
    from magellanmapper_torch.atlas import ontology
    from magellanmapper_torch.cv import cv_nd
    from magellanmapper_torch.io import np_io
    from magellanmapper_torch.stats import vols

    labels, intensity = ccf25_labels(torch, pair)
    scaling = np_io.find_scaling(
        tuple(s * SPEC_FACTOR for s in REG_SHAPE), CCF25_SHAPE)
    heat = cv_nd.build_heat_map(
        CCF25_SHAPE, ontology.scale_coords(blobs[:, :3], scaling,
                                           CCF25_SHAPE), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    df = vols.measure_labels_metrics(intensity, labels, heat_map=heat,
                                     device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    fg = labels != 0
    sums = {"nuclei": int(df["Nuclei"].sum()),
            "heat_in_labels": int(heat[fg].sum()),
            "volpx": int(df["VolPx"].sum()), "labelled": int(fg.sum())}
    print("vol_stats 25um: " + json.dumps({
        "shape": list(CCF25_SHAPE), "voxels": int(np.prod(CCF25_SHAPE)),
        "regions": len(df), "wall_s": wall, "peak_device_mib": peak,
        "sums": sums}), flush=True)
    if sums["nuclei"] != sums["heat_in_labels"] \
            or sums["volpx"] != sums["labelled"]:
        fail(f"vol_stats at 25 um: the sums do not add up: {sums}")

    # the specimen's blobs with their regions and no cluster column: each
    # region's blobs clustered by DBSCAN in the same call
    from magellanmapper_torch.stats import clustering
    region = ontology.get_label_ids_from_position(ontology.scale_coords(
        blobs[:, :3], scaling, CCF25_SHAPE), labels)
    with_regions = np.column_stack([blobs[:, :3], region])
    df_c, step = timed(torch, lambda: vols.measure_labels_metrics(
        intensity, labels, heat_map=heat, blobs=with_regions,
        device="cuda"))
    ids = df_c["Region"].to_numpy()
    m = np.isin(np.abs(region), ids)
    _, clus_step = timed(torch, lambda: clustering.cluster_dbscan(
        blobs[m, :3], 20.0, 5, device="cuda", groups=np.abs(region[m])))
    t0 = time.perf_counter()
    cpu = clustering.cluster_dbscan(blobs[m, :3], 20.0, 5, device="cpu",
                                    groups=np.abs(region[m]))
    t_cpu = time.perf_counter() - t0
    want = np.array([clustering.cluster_dbscan_metrics(
        cpu[np.abs(region[m]) == r]) if np.any(np.abs(region[m]) == r)
        else (np.nan,) * 3 for r in ids], float)
    got = df_c[["NucCluster", "NucClusNoise", "NucClusLarg"]].to_numpy()
    print("vol_stats 25um with blobs: " + json.dumps({
        "blobs": len(blobs), "in_regions": int(m.sum()),
        "nuc_cluster_sum": float(np.nansum(df_c["NucCluster"])),
        "nuc_noise_sum": float(np.nansum(df_c["NucClusNoise"])),
        "without_blobs_s": wall, **step,
        "clustering_alone_s": clus_step["wall_s"],
        "cpu_clustering_s": t_cpu}), flush=True)
    if not np.array_equal(got, want, equal_nan=True):
        fail("vol_stats 25um: the card's cluster columns differ from the "
             "CPU's")
    return labels, intensity


def gauntlet_checks(name, res):
    """The reference's gate on one pair of the suite, and the checks this
    script adds to it, which the gate lets through: the affine stage's
    DSC recorded, a B-spline stage that gained DSC, and a warp error under
    the ground truth's mean displacement (the registration recovered more
    of the warp than it left). Returns the failures."""
    bad = [] if res["passes"] else ["below the reference's gate"]
    if "affine" not in res["stage_dsc"]:
        bad.append("no affine-stage DSC")
    if not res["bspline_dsc_gain"] > 0:
        bad.append(f"B-spline DSC gain {res['bspline_dsc_gain']} <= 0")
    if not res["warp_err_vox"] < res["gt_disp_vox"]:
        bad.append(f"warp error {res['warp_err_vox']} not under the "
                   f"ground truth's displacement {res['gt_disp_vox']}")
    return [f"{name}: {b}" for b in bad]


def gauntlet_suite(seeds, truncated_seed):
    """``run_gauntlet_suite`` of ``REG_SHAPE`` pairs on the card with the
    reference's smoothing schedule: each pair's numbers printed, then a
    failure unless every pair passes :func:`gauntlet_checks`."""
    from magellanmapper_torch.atlas import gauntlet

    t0 = time.perf_counter()
    suite = gauntlet.run_gauntlet_suite(
        REG_SHAPE, seeds=seeds, truncated_seed=truncated_seed,
        device="cuda")
    bad = []
    for name, res in suite["pairs"].items():
        print(f"gauntlet {name}: " + json.dumps(res), flush=True)
        bad += gauntlet_checks(name, res)
    print(f"gauntlet suite {list(suite['pairs'])}: passes "
          f"{suite['passes']}, registrations {suite['wall_s']:.2f} s, "
          f"wall {time.perf_counter() - t0:.2f} s", flush=True)
    if bad or not suite["passes"]:
        fail("gauntlet suite: " + "; ".join(bad))
    return suite


def register_crop(truncated=False):
    """``register_duo`` on a small pair (every stride 1, no jitter) on the
    card and on the CPU; fails if the parameters differ beyond
    ``REG_CROP_ATOL`` or the order-0 labels in more than 0.1% of
    voxels. ``truncated`` takes the suite's truncated pair: its specimen
    cut off in z and registered under its ``fixed_mask``."""
    from magellanmapper_torch.atlas import gauntlet, reg_engine
    from magellanmapper_torch.settings.atlas_prof import AtlasProfile

    build = gauntlet.build_truncated_pair if truncated else \
        gauntlet.build_pair
    pair = build(REG_CROP, seed=SEED, device="cpu", ffd_spacing=16.0,
                 ffd_ctrl_sigma=3.0)
    mask = pair.get("fixed_mask")
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        _, res = reg_engine.register_duo(
            pair["fixed"], pair["moving"], AtlasProfile(),
            iters_scale=REG_CROP_ITERS, device=dev,
            fixed_mask=None if mask is None else mask.astype(np.float32))
        runs[dev] = (res, time.perf_counter() - t0)
    (card, t_card), (cpu, t_cpu) = runs["cuda"], runs["cpu"]
    what = "truncated register crop" if truncated else "register crop"
    worst = {}
    for (kind, a), (_, b) in zip(card.stages_numpy(), cpu.stages_numpy()):
        for k in a:
            err = float(np.abs(a[k] - b[k]).max())
            worst[f"{kind}.{k}"] = err
            if err > REG_CROP_ATOL[f"{kind}.{k}"]:
                fail(f"{what}: {kind} {k} differs by {err} between the "
                     "card and the CPU")
    labels = [r.transform_img(pair["labels"], order=0) for r in (card, cpu)]
    if mask is not None:
        labels = [np.where(mask, lab, 0) for lab in labels]
    frac = float(np.mean(labels[0] != labels[1]))
    print(f"{what} {REG_CROP}: card {t_card:.2f} s, CPU {t_cpu:.2f} s; "
          f"max param diffs {worst}; label voxels differing {frac:.6f}; "
          f"dsc card {card.metrics['dsc_fixed_moved']:.5f} CPU "
          f"{cpu.metrics['dsc_fixed_moved']:.5f}", flush=True)
    if frac > 1e-3:
        fail(f"{what}: {frac:.4%} of label voxels differ")


def detect_blobs_crop(torch, crop, launches):
    """``cv.detector.detect_blobs`` on an anisotropic crop at resolutions
    (2, 1, 1) with ``isotropic`` set, on the card and on the CPU."""
    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch import testing
    from magellanmapper_torch.cv import detector, stack_detect as sd

    prof = sd.roi_profile("lightsheet")
    prof["isotropic"] = (1.0, 1.0, 1.0)
    dev_mod.reset_launches()
    t0 = time.perf_counter()
    on_card = detector.detect_blobs(crop, prof, DETECT_RES, preprocess=True,
                                    device="cuda")
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    launches["detect_blobs"] = dict(dev_mod.LAUNCHES)
    on_cpu = detector.detect_blobs(crop, prof, DETECT_RES, preprocess=True,
                                   device="cpu")
    print(f"detect_blobs {crop.shape} at {DETECT_RES}, isotropic: "
          f"{0 if on_card is None else len(on_card)} blobs on the card "
          f"({t_card:.2f} s), {0 if on_cpu is None else len(on_cpu)} on the "
          f"CPU; launches {launches['detect_blobs']}", flush=True)
    if on_card is None or not testing.rows_equal(on_card, on_cpu):
        fail("detect_blobs: the card's blobs differ from the CPU's")


class LogRecords:
    """Collects the port's log records while open, so a phase can read
    what a task logged (the watershed's sweeps, the groupwise levels)."""

    def __init__(self, name: str):
        import logging

        self.records = []
        self.logger = logging.getLogger(name)
        self.handler = logging.Handler()
        self.handler.emit = self.records.append

    def __enter__(self):
        import logging

        self.logger.addHandler(self.handler)
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)

    def args(self, prefix: str):
        """The arguments of every record whose message starts so."""
        return [r.args for r in self.records if r.msg.startswith(prefix)]


def timed(torch, fn):
    """``fn()`` on the card: its result, wall seconds and peak MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {"wall_s": time.perf_counter() - t0,
                 "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20}


def group_labels(torch, labels, per_img, spacing):
    """The group's labels carried through their recovered transforms, in
    one gather at order 0, on the card."""
    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch.atlas import transform

    dev = dev_mod.resolve("cuda")
    lab = torch.from_numpy(np.stack(labels)).to(dev)
    p = {k: torch.from_numpy(np.stack([q[k] for q in per_img])).to(dev)
         for k in ("W", "t", "grid") if k in per_img[0]}
    coords = transform.group_coords(p, lab.shape[1:], spacing)
    return list(transform.sample_volume(lab, coords, order=0).cpu().numpy())


def groupwise_path(torch, pair, work, launches):
    """``--register group --atlas_profile groupwise`` through the port's
    CLI on the card, on four brains of the pair's shape
    (``testing.make_group``): wall, steps per second by level (from the
    engine's log), peak memory; fails unless the group's variance under
    the recovered transforms is below ``GROUP_VAR_GATE`` of the variance
    before and the truth labels carried by them overlap each other (mean
    pairwise per-label DSC) better than unregistered."""
    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch import testing
    from magellanmapper_torch.atlas import transform
    from magellanmapper_torch.io import cli, np_io

    t0 = time.perf_counter()
    group = testing.make_group(pair, GROUP_SEEDS, device="cuda")
    paths = []
    for i, img in enumerate(group["imgs"]):
        paths.append(os.path.join(work, f"brain{i}.npy"))
        np_io.write_npy(paths[-1], img)
    print(f"groupwise: {len(paths)} brains of {REG_SHAPE} made and written "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    dev_mod.reset_launches()
    with LogRecords("magellanmapper_torch.atlas.reg_engine") as logs:
        (mean, per_img), stats = timed(torch, lambda: cli.main(
            ["--img"] + paths + ["--register", "group", "--atlas_profile",
                                 "groupwise", "--device", "cuda"]))
    launches["groupwise"] = dict(dev_mod.LAUNCHES)
    levels = logs.args("groupwise levels")[0][0]
    spacing = per_img[0].get("spacing")
    dev = dev_mod.resolve("cuda")
    vols = torch.from_numpy(np.stack(group["imgs"])).to(dev)
    p = {k: torch.from_numpy(np.stack([q[k] for q in per_img])).to(dev)
         for k in ("W", "t", "grid") if k in per_img[0]}
    with torch.no_grad():
        moved = transform.sample_volume(
            vols, transform.group_coords(p, REG_SHAPE, spacing))
        var_before = float(torch.var(vols, dim=0, correction=0).mean())
        var_after = float(torch.var(moved, dim=0, correction=0).mean())
    del vols, moved
    carried = group_labels(torch, group["labels"], per_img, spacing)
    dsc = testing.mean_pairwise_dsc(carried)
    dsc_before = testing.mean_pairwise_dsc(group["labels"])
    ratio = var_after / var_before
    for row in levels:
        print(f"groupwise level: {json.dumps(row)}", flush=True)
    print("groupwise: " + json.dumps({
        "brains": len(paths), "shape": list(REG_SHAPE), **stats,
        "launches": launches["groupwise"], "variance_before": var_before,
        "variance_after": var_after, "variance_ratio": ratio,
        "label_dsc_pairwise": dsc, "label_dsc_pairwise_unregistered":
        dsc_before, "mean_finite": bool(np.isfinite(mean).all()),
        "stages": stage_rates(levels)}), flush=True)
    if not np.isfinite(mean).all() or mean.shape != REG_SHAPE:
        fail(f"groupwise mean image {mean.shape} is not finite")
    if not ratio < GROUP_VAR_GATE:
        fail(f"groupwise variance ratio {ratio} >= {GROUP_VAR_GATE}")
    if not dsc > dsc_before:
        fail(f"groupwise labels overlap {dsc} <= unregistered {dsc_before}")


def groupwise_crop():
    """``register_groupwise`` on three brains of ``REG_CROP`` (every
    metric stride 1) on the card and on the CPU, the affine route and the
    B-spline route; fails if a stage's parameters differ beyond
    ``GROUP_CROP_ATOL``."""
    from magellanmapper_torch import testing
    from magellanmapper_torch.atlas import gauntlet, reg_engine

    pair = gauntlet.build_pair(REG_CROP, seed=SEED, device="cpu",
                               ffd_spacing=16.0, ffd_ctrl_sigma=3.0)
    imgs = testing.make_group(pair, GROUP_SEEDS[:3], device="cpu",
                              ffd_spacing=16.0, ffd_ctrl_sigma=2.0)["imgs"]
    worst = {}
    for stage, bs_iter in (("affine", 0), ("bspline", 16)):
        runs = [reg_engine.register_groupwise(
            imgs, bspline_iter=bs_iter, device=dev, **GROUP_CROP_RUN)[1]
            for dev in ("cuda", "cpu")]
        for k in runs[0][0]:
            if k != "spacing":
                worst[f"{stage}.{k}"] = max(float(np.abs(a[k] - b[k]).max())
                                            for a, b in zip(*runs))
    print(f"groupwise crop {REG_CROP} x 3: max param diffs card vs CPU "
          f"{json.dumps(worst)}", flush=True)
    over = {k: v for k, v in worst.items() if v > GROUP_CROP_ATOL[k]}
    if over:
        fail(f"groupwise crop: the card's parameters differ from the CPU's "
             f"beyond {GROUP_CROP_ATOL}: {over}")


def resume_path(torch, work):
    """``register`` (the ``--register single`` task's function) on a
    ``REG_CROP`` pair with a short schedule and stage checkpoints, once
    uninterrupted and once stopped after its affine stage (the B-spline
    stage raises, as a killed process stops) and run again; fails unless
    the resumed run equals the uninterrupted one."""
    from magellanmapper_torch.atlas import gauntlet, reg_engine, register
    from magellanmapper_torch.settings.atlas_prof import AtlasProfile

    class Stop(Exception):
        pass

    pair = gauntlet.build_pair(REG_CROP, seed=SEED, device="cpu",
                               ffd_spacing=16.0, ffd_ctrl_sigma=3.0)
    prof = AtlasProfile()
    for key, n in RESUME_ITERS.items():
        prof[key] = dict(prof[key], max_iter=n)
    imgs = {"atlas": pair["moving"], "labels": pair["labels"]}

    def run(ckdir):
        return register.register(pair["fixed"], imgs, prof,
                                 write_imgs=False, checkpoint_dir=ckdir,
                                 device="cuda")

    whole = run(os.path.join(work, "whole"))
    orig = reg_engine.register_stage

    def stop(*args, **kwargs):
        if kwargs.get("kind") == "bspline":
            raise Stop
        return orig(*args, **kwargs)

    ckdir = os.path.join(work, "stopped")
    reg_engine.register_stage = stop
    try:
        run(ckdir)
        fail("resume: the stopped run did not stop")
    except Stop:
        pass
    finally:
        reg_engine.register_stage = orig
    saved = sorted(os.listdir(ckdir))
    resumed = run(ckdir)
    same = {
        "moved_atlas": bool(np.array_equal(whole["moved_atlas"],
                                           resumed["moved_atlas"])),
        "moved_labels": bool(np.array_equal(whole["moved_labels"],
                                            resumed["moved_labels"])),
        "params": all(torch.equal(a[k], b[k]) for (_, a), (_, b) in zip(
            whole["transform"].stages, resumed["transform"].stages)
            for k in a)}
    print(f"resume: checkpoints after the stop {saved}; resumed equals "
          f"uninterrupted {json.dumps(same)}", flush=True)
    if saved != ["affine.pt", "translation.pt"] or not all(same.values()):
        fail(f"resume: the resumed run differs: {same}, saved {saved}")


def atlas_path(torch, pair, work, launches):
    """Atlas refinement at the Allen CCFv3 25 um atlas's size through the
    port's CLI on the card, one step at a time (seconds and peak memory
    each): ``import_atlas`` with the ``abap56`` profile (lateral edge
    extension, mirroring), ``smooth_labels`` (filter 2) by a direct call,
    ``make_edge_images``, ``merge_atlas_segs`` and ``make_subsegs``. Fails
    unless the imported labels mirror each other exactly (negated), the
    edges lie in the labels' foreground with the distance 0 exactly on
    them, and every sub-label over 100 is its parent's ID; prints the
    restored planes' overlap with the uncut truth, the watershed's sweeps,
    the labels reannotation lost and ``DSC_orig_new``. Returns the
    imported atlas and labels."""
    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch import testing
    from magellanmapper_torch.atlas import atlas_refiner
    from magellanmapper_torch.io import cli, sitk_io

    steps = {}
    t0 = time.perf_counter()
    fx = testing.make_atlas(pair, CCF25_SHAPE, CCF25_SPLIT,
                            ATLAS_CUT_PLANES, device="cuda")
    src = os.path.join(work, "ccf25")
    os.makedirs(src)
    for name, arr in (("atlasVolume", fx["atlas"]),
                      ("annotation", fx["labels"])):
        sitk_io.write_med_img(os.path.join(src, f"{name}.mhd"),
                              sitk_io.MedImage(arr, (0.025,) * 3))
    n_ids = len(np.unique(fx["truth"])) - 1
    print(f"atlas {CCF25_SHAPE}: {n_ids} IDs on one side, planes "
          f"{fx['cut'].start}-{fx['cut'].stop - 1} cleared, made and "
          f"written in {time.perf_counter() - t0:.1f} s", flush=True)

    def step(name, argv):
        out, steps[name] = timed(torch, lambda: cli.main(
            argv + ["--device", "cuda"]))
        return out

    dev_mod.reset_launches()
    paths = step("import_atlas", ["--img", src, "--register",
                                  "import_atlas", "--atlas_profile",
                                  "abap56"])
    base = paths["annotation.mhd"].replace("_annotation.mhd", ".mhd")
    atlas = sitk_io.read_med_img(paths["atlasVolume.mhd"]).img
    labels = sitk_io.read_med_img(paths["annotation.mhd"]).img
    mirrored = atlas_refiner.check_mirrorred(labels, -1)
    cut = fx["cut"]
    truth, got = fx["truth"][cut], labels[cut]
    fg_t, fg_g = truth != 0, got != 0
    restored = {
        "planes": [cut.start, cut.stop - 1],
        "fg_dsc": float(2 * np.sum(fg_t & fg_g)
                        / max(fg_t.sum() + fg_g.sum(), 1)),
        "same_id_frac": float(np.mean(got[fg_t] == truth[fg_t]))}
    print(f"import_atlas: mirrored (values, IDs) {mirrored}; restored "
          f"lateral planes against the uncut truth {json.dumps(restored)}",
          flush=True)
    if not mirrored[0]:
        fail("import_atlas: the labels do not mirror each other")

    smoothed = np.array(labels)
    _, steps["smooth_labels"] = timed(torch, lambda: (
        atlas_refiner.smooth_labels(smoothed, 2, device="cuda")))
    print(f"smooth_labels: {int(np.sum(smoothed != labels))} voxels "
          "relabelled", flush=True)
    del smoothed

    imgs = step("make_edge_images", ["--img", base, "--register",
                                     "make_edge_images"])
    edges = imgs["atlas_edge"] != 0
    dist = imgs["dist_to_edge"]
    edge_check = {"edges": int(edges.sum()),
                  "outside_labels": int(np.sum(edges & (labels == 0))),
                  "dist_nonzero_on_edges": int(np.sum(dist[edges] != 0)),
                  "dist_zero_off_edges": int(np.sum(dist[~edges] == 0))}
    print(f"make_edge_images: {json.dumps(edge_check)}", flush=True)
    del imgs, dist
    if edge_check["edges"] == 0 or any(
            v for k, v in edge_check.items() if k != "edges"):
        fail(f"make_edge_images: edges or distances wrong: {edge_check}")

    with LogRecords("magellanmapper_torch.cv.segmenter") as logs:
        metr = step("merge_atlas_segs", ["--img", base, "--register",
                                         "merge_atlas_segs"])[0]
    sweeps = [a[0] for a in logs.args("watershed flood")]
    new = sitk_io.load_registered_img(base, "annotation.mhd")
    lost = atlas_refiner.find_labels_lost(np.unique(labels), np.unique(new))
    print(f"merge_atlas_segs: watershed sweeps {sweeps}; "
          f"{json.dumps(metr)}; labels lost {lost.tolist()}", flush=True)

    sub = step("make_subsegs", ["--img", base, "--register",
                                "make_subsegs"])
    nz = sub != 0
    # sub-labels are sign(id) * (|id| * 100 + k), k the component: // 100
    # gives the parent while a label has under 100 components (as in the
    # reference, whose numbering runs on into the next ID's range past 99)
    k = np.abs(sub[nz]).astype(np.int64) - np.abs(new[nz]).astype(
        np.int64) * 100
    wide = np.unique(new[nz][k >= 100])
    under = ~np.isin(new[nz], wide)
    parents = bool(np.array_equal(nz, new != 0) and k.min() >= 0
                   and np.array_equal(np.sign(sub[nz]), np.sign(new[nz]))
                   and np.array_equal(np.abs(sub[nz][under]) // 100,
                                      np.abs(new[nz][under])))
    print(f"make_subsegs: {len(np.unique(sub)) - 1} sub-labels of "
          f"{len(np.unique(new)) - 1} labels, each its parent's (// 100 the "
          f"parent's |ID| under 100 components): {parents}; {len(wide)} "
          f"labels of 100 or more components, numbered on into the next "
          f"ID's range: {wide.tolist()[:10]}", flush=True)
    if not parents:
        fail("make_subsegs: a sub-label is not its parent's")
    launches["atlas"] = dict(dev_mod.LAUNCHES)
    print("atlas refinement: " + json.dumps({
        "shape": list(CCF25_SHAPE), "voxels": int(np.prod(CCF25_SHAPE)),
        "labels": int(len(np.unique(labels)) - 1), "steps": steps,
        "launches": launches["atlas"]}), flush=True)
    return atlas, labels


def atlas_crop(atlas, labels):
    """A crop of the imported atlas on the card and on the CPU: the
    markers, the watershed onto one edge image (the card's) and the
    sub-labels exactly, the clipped LoG image within ``LOG_RTOL`` of its
    range."""
    from magellanmapper_torch.atlas import edge_seg
    from magellanmapper_torch.cv import cv_nd, segmenter

    a = np.ascontiguousarray(atlas[ATLAS_CROP])
    lab = np.ascontiguousarray(labels[ATLAS_CROP])
    edges = edge_seg.make_edge_images(a, lab, 5.0,
                                      device="cuda")["atlas_edge"]
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        markers = edge_seg.erode_labels(lab, 8, device=dev)[0]
        out[dev] = {
            "markers": markers,
            "watershed": segmenter.segment_from_labels(edges, markers, lab,
                                                       device=dev),
            "sub": edge_seg.make_sub_segmented_labels(lab, edges,
                                                      device=dev),
            "log": cv_nd.laplacian_of_gaussian_img(a, 5.0, lab,
                                                   device=dev),
            "s": time.perf_counter() - t0}
    card, cpu = out["cuda"], out["cpu"]
    same = {k: bool(np.array_equal(card[k], cpu[k]))
            for k in ("markers", "watershed", "sub")}
    log_err = float(np.abs(card["log"] - cpu["log"]).max()
                    / max(np.ptp(cpu["log"]), 1e-30))
    print(f"atlas crop {lab.shape}: card {card['s']:.2f} s, CPU "
          f"{cpu['s']:.2f} s; equal {json.dumps(same)}; LoG max difference "
          f"{log_err:.3g} of its range", flush=True)
    if not all(same.values()) or not log_err <= LOG_RTOL:
        fail(f"atlas crop: the card differs from the CPU: {same}, LoG "
             f"{log_err}")


def channel_sens_ppv(det, families, shifts):
    """Sensitivity and PPV of one channel's detections against planted
    nuclei of several lattices (``families``): each detection is scored
    with the lattice of its nearest nucleus, in verification tiles
    shifted by that lattice's ``shifts`` so that no tile edge passes near
    its nuclei (:func:`testing.sens_ppv`)."""
    from scipy.spatial import cKDTree
    from magellanmapper_torch import testing

    planted = np.concatenate(families)
    family = np.concatenate([np.full(len(f), i)
                             for i, f in enumerate(families)])
    _, nearest = cKDTree(planted).query(det[:, :3])
    tp = 0
    for i, (truth, shift) in enumerate(zip(families, shifts)):
        mine = det[family[nearest] == i][:, :3] + shift
        sens, _ = testing.sens_ppv(
            mine, truth + shift, np.add(SLICE_SHAPE, shift), VERIFY_TILE,
            VERIFY_TOL)
        tp += int(round(sens * len(truth)))
    return tp / len(planted), tp / len(det)


def sorted_with(blobs, *others):
    """``blobs`` in lexicographic row order, and ``others`` (arrays with a
    row per blob) in the same order."""
    order = np.lexsort(blobs.T[::-1])
    return (blobs[order],) + tuple(o[order] for o in others)


def match_rows(matches):
    """Every channel pair's matches as sorted rows of blob 1, blob 2 and
    the distance."""
    out = {}
    for pair, bm in matches.items():
        rows = np.array([np.concatenate([r["Blob1"], r["Blob2"],
                                         [r["Distance"]]])
                         for _, r in bm.df.iterrows()]).reshape(-1, 21)
        out[pair] = rows[np.lexsort(rows.T[::-1])]
    return out


def coloc_volume(vol, centres, work):
    """The two-channel volume of the blob-analysis phase: channel 0 the
    detect slice's ``vol``, channel 1 a seeded half of its nuclei plus its
    own between them (``testing.make_coloc_channel``), written as a 5D
    image5d at ``work/coloc.npy``. Returns the path and the planted
    truth (centres, co-expression mask, channel 1's own centres)."""
    from magellanmapper_torch import testing
    from magellanmapper_torch.io import np_io

    t0 = time.perf_counter()
    ch1, co, own = testing.make_coloc_channel(SLICE_SHAPE, centres, SEED)
    path = os.path.join(work, "coloc.npy")
    np_io.write_npy(path, np.stack([vol, ch1], axis=-1)[None])
    print(f"coloc volume {SLICE_SHAPE + (2,)}: {int(co.sum())} of "
          f"{len(centres)} nuclei co-expressed, {len(own)} of channel 1 "
          f"alone, made and written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return path, (centres, co, own)


def coloc_path(torch, path, truth, work, launches):
    """``--proc detect_coloc --channel 0 1`` through the CLI on the
    two-channel volume (launches of the ``coloc`` path; sensitivity and
    PPV of each channel against its planted nuclei at the detect slice's
    bars; the archive's ``colocs`` the returned ones; the flags against
    the planted co-expression), the whole stack matched between the
    channels in blocks, and a crop through both tasks on the card and on
    the CPU (blobs, ``colocs`` and matches exactly equal). Returns the
    blobs."""
    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch import testing
    from magellanmapper_torch.cv import colocalizer, detector
    from magellanmapper_torch.io import cli, np_io

    centres, co, own = truth
    argv = ["--img", path, "--proc", "detect_coloc", "--channel", "0", "1",
            "--roi_profile", "lightsheet"]
    dev_mod.reset_launches()
    out, step = timed(torch, lambda: cli.main(argv + ["--device", "cuda"]))
    launches["coloc"] = dict(dev_mod.LAUNCHES)
    print(f"coloc: launches {launches['coloc']}", flush=True)
    for name in ("peak_candidates", "prune_overlap", "tile_percentiles"):
        if launches["coloc"][name] <= 0:
            fail(f"kernel {name} was not launched on the coloc path")
    det, colocs = out.blobs, out.colocalizations
    if det is None or det.ndim != 2 or det.shape[1] != 10 \
            or not np.all(np.isfinite(det)) or colocs is None \
            or colocs.shape != (len(det), 2) or colocs.dtype != np.uint8:
        fail(f"detect_coloc returned {None if det is None else det.shape} "
             f"blobs, colocs {None if colocs is None else colocs.shape}")
    with np.load(path.replace(".npy", "_blobs.npz")) as archive:
        if not (np.array_equal(archive["segments"], det)
                and np.array_equal(archive["colocs"], colocs)):
            fail("blobs.npz differs from the returned blobs or colocs")
    with open(path.replace(".npy", "_stack_detection_times.csv")) as f:
        detection_s = float(next(csv.DictReader(f))["Total_stack"])
    chl = det[:, 6].astype(int)
    quality = {
        0: testing.sens_ppv(det[chl == 0], centres, SLICE_SHAPE,
                            VERIFY_TILE, VERIFY_TOL),
        1: channel_sens_ppv(det[chl == 1], [centres[co], own],
                            [0, COLOC_OWN_SHIFT])}
    want = testing.coloc_truth(det, centres, co, own)
    other = 1 - chl
    flag = colocs[np.arange(len(det)), other]
    known = want[np.arange(len(det)), other]
    tp = int(np.sum((flag == 1) & (known == 1)))
    recall = tp / max(int(np.sum(known == 1)), 1)
    precision = tp / max(int(np.sum((flag == 1) & (known >= 0))), 1)
    voxels = float(np.prod(SLICE_SHAPE)) * 2
    print("coloc: " + json.dumps({
        "blobs": len(det), "by_channel": [int(np.sum(chl == c))
                                          for c in (0, 1)],
        "sens_ppv": {c: [float(v) for v in q] for c, q in quality.items()},
        "flags_recall": recall, "flags_precision": precision,
        "flags_unknown": int(np.sum(known < 0)),
        "colocs_per_channel": colocs.sum(0).tolist(),
        "detection_s": detection_s, **step,
        "mvox_per_s": voxels / 1e6 / step["wall_s"]}), flush=True)
    for c, (sens, ppv) in quality.items():
        if not (sens > 0.85 and ppv > 0.7):
            fail(f"coloc channel {c} below the bars: sens {sens} ppv {ppv}")

    # the whole stack matched between the channels in blocks (the CLI's
    # task is one assignment over the whole image, for an ROI)
    tol = detector.calc_overlap((1.0, 1.0, 1.0))
    t0 = time.perf_counter()
    matches = colocalizer.StackColocalizer.colocalize_stack(
        SLICE_SHAPE, det, tol)
    t_match = time.perf_counter() - t0
    rows = match_rows(matches).get((0, 1), np.zeros((0, 21)))
    from scipy.spatial import cKDTree
    _, near1 = cKDTree(centres).query(rows[:, :3])
    _, near2 = cKDTree(centres).query(rows[:, 10:13])
    planted_pairs = int(np.sum((near1 == near2) & co[near1]))
    print("coloc_match (stack): " + json.dumps({
        "matches": len(rows), "of_planted_pairs": planted_pairs,
        "planted_coexpressed": int(co.sum()), "wall_s": t_match}),
        flush=True)

    # a crop through both tasks, card against CPU
    crop = np.ascontiguousarray(
        np_io.read_file(path).img[0][:CROP[0], :CROP[1], :CROP[2]])
    got = {}
    for name in ("cuda", "cpu"):
        sub = os.path.join(work, f"crop_{name}.npy")
        np_io.write_npy(sub, crop[None])
        t0 = time.perf_counter()
        res = cli.main(["--img", sub] + argv[2:] + ["--device", name])
        pairs = cli.main(["--img", sub, "--proc", "coloc_match",
                          "--device", name])
        got[name] = (sorted_with(res.blobs, res.colocalizations),
                     match_rows(pairs), time.perf_counter() - t0)
    (b_card, c_card), m_card, t_card = got["cuda"]
    (b_cpu, c_cpu), m_cpu, t_cpu = got["cpu"]
    same = (testing.rows_equal(b_card, b_cpu)
            and np.array_equal(c_card, c_cpu)
            and m_card.keys() == m_cpu.keys()
            and all(np.array_equal(m_card[k], m_cpu[k]) for k in m_card))
    print(f"coloc crop {CROP + (2,)}: {len(b_card)} blobs, "
          f"{int(c_card.sum())} flags, "
          f"{sum(len(v) for v in m_card.values())} matches on the card "
          f"({t_card:.2f} s), the CPU's {len(b_cpu)}, {int(c_cpu.sum())}, "
          f"{sum(len(v) for v in m_cpu.values())} ({t_cpu:.2f} s)",
          flush=True)
    if not same:
        fail("the coloc crop on the card differs from the CPU's")
    return det


def classifier_path(torch, path, det, centres, work):
    """The patch classifier: trained on channel 0's blobs (even-indexed;
    label 1 within the verify tolerance of a planted nucleus), held out on
    the odd-indexed ones, saved; then ``--proc classify --classifier``
    through the CLI on the two-channel volume, and the same weights on
    the card and on the CPU on 4,096 patches of channel 0 (patches exactly
    equal, probabilities within :data:`CLASSIFY_ATOL`, flags equal where a
    probability is further than that from 0.5)."""
    from scipy.spatial import cKDTree
    from magellanmapper_torch.cv import classifier
    from magellanmapper_torch.io import cli, np_io

    ch0 = det[det[:, 6] == 0]
    dist, _ = cKDTree(centres).query(ch0[:, :3])
    labels = (dist < max(VERIFY_TOL)).astype(np.float32)
    image = np_io.read_file(path).img[0][..., 0]
    t0 = time.perf_counter()
    patches = classifier.extract_patches(image, ch0, device="cuda")
    t_patch = time.perf_counter() - t0
    # the process's first training step initialises cuDNN and loads its
    # kernels (seconds); a step of a throwaway model takes that out of
    # the timed run
    _, warm = timed(torch, lambda: classifier.BlobClassifier(
        seed=SEED + 1, device="cuda").train(patches[:128], labels[:128],
                                            epochs=1))
    clf = classifier.BlobClassifier(seed=SEED, device="cuda")
    train_x, train_y = patches[0::2], labels[0::2]
    out, step = timed(torch, lambda: clf.train(train_x, train_y))
    n_steps = 10 * -(-len(train_x) // 128)
    held = (clf.predict(patches[1::2]) > 0.5) == (labels[1::2] > 0.5)
    model = os.path.join(work, "classifier.pkl")
    clf.save(model)
    print("classifier train: " + json.dumps({
        "patches": len(patches), "train": len(train_x),
        "true_share": float(labels.mean()), "loss": out["loss"],
        "train_accuracy": out["accuracy"],
        "held_out_accuracy": float(held.mean()),
        "all_true_baseline": float(labels[1::2].mean()), "steps": n_steps,
        "steps_per_s": n_steps / step["wall_s"], "patch_s": t_patch,
        "first_step_s": warm["wall_s"], **step}), flush=True)

    res, step = timed(torch, lambda: cli.main([
        "--img", path, "--proc", "classify", "--classifier", model,
        "--device", "cuda"]))
    flags = res.blobs[:, 4]
    if not np.array_equal(res.blobs[:, :4], det[:, :4]) \
            or not set(np.unique(flags)) <= {0.0, 1.0}:
        fail("classify changed the blobs or left flags outside {0, 1}")
    print("classify: " + json.dumps({
        "blobs": len(res.blobs), "confirmed": int(np.sum(flags == 1)),
        "blobs_per_s": len(res.blobs) / step["wall_s"], **step}),
        flush=True)

    first = ch0[ch0[:, 0] < 100][:CLASSIFY_PATCHES]
    chunk = np.ascontiguousarray(image[:100])
    x = classifier.extract_patches(chunk, first, device="cuda")
    x_cpu = classifier.extract_patches(chunk, first, device="cpu")
    p_card = clf.predict(x)
    p_cpu = classifier.BlobClassifier.load(model, device="cpu").predict(x)
    err = float(np.abs(p_card - p_cpu).max())
    clear = np.abs(p_cpu - 0.5) > CLASSIFY_ATOL
    print(f"classify card vs CPU: {len(x)} patches, patches equal "
          f"{np.array_equal(x, x_cpu)}, probabilities {err:.3e} apart",
          flush=True)
    if len(x) != CLASSIFY_PATCHES or not np.array_equal(x, x_cpu) \
            or err > CLASSIFY_ATOL or not np.array_equal(
                (p_card >= 0.5)[clear], (p_cpu >= 0.5)[clear]):
        fail("the classifier on the card differs from the CPU's")


def cluster_path(torch, path, det):
    """``--register cluster_blobs`` through the CLI on the coloc run's
    blobs (labels equal to the CPU's), then ``cluster_dbscan`` at scale on
    a seeded cloud of :data:`CLOUD_POINTS` points with eps by the
    reference's 90th-percentile rule (wall, peak memory) and a sub-block
    of it on the card and on the CPU (labels equal)."""
    from magellanmapper_torch import testing
    from magellanmapper_torch.io import cli
    from magellanmapper_torch.stats import clustering

    got, step = timed(torch, lambda: cli.main([
        "--img", path, "--register", "cluster_blobs", "--device", "cuda"]))
    t0 = time.perf_counter()
    want, stats = clustering.cluster_blobs(det, device="cpu")
    t_cpu = time.perf_counter() - t0
    print("cluster_blobs: " + json.dumps({
        "blobs": len(got), **stats, **step, "cpu_s": t_cpu}), flush=True)
    if not np.array_equal(got[:, -1], want[:, -1]):
        fail("cluster_blobs on the card differs from the CPU's")

    t0 = time.perf_counter()
    pts = testing.make_point_cloud(CLOUD_POINTS, SEED)
    t_make = time.perf_counter() - t0
    dists, knn_step = timed(torch, lambda: clustering.knn_dist(
        pts, 5, return_sorted=False, device="cuda"))
    eps = float(np.percentile(dists, 90))
    labels, db_step = timed(torch, lambda: clustering.cluster_dbscan(
        pts, eps, 5, device="cuda"))
    found = labels[labels >= 0]
    print("dbscan at scale: " + json.dumps({
        "points": len(pts), "made_s": t_make, "eps": eps,
        "clusters": int(len(np.unique(found))),
        "noise": int(np.sum(labels < 0)),
        "largest": int(np.bincount(found).max()) if len(found) else 0,
        "knn": knn_step, "dbscan": db_step,
        "dbscan_points_per_s": len(pts) / db_step["wall_s"]}), flush=True)
    corner = pts.max(1)
    sub = pts[corner <= np.sort(corner)[CLOUD_SUB - 1]][:CLOUD_SUB]
    card, sub_step = timed(torch, lambda: clustering.cluster_dbscan(
        sub, eps, 5, device="cuda"))
    t0 = time.perf_counter()
    cpu = clustering.cluster_dbscan(sub, eps, 5, device="cpu")
    print(f"dbscan sub-block: {len(sub)} points, "
          f"{len(np.unique(cpu[cpu >= 0]))} clusters, card "
          f"{sub_step['wall_s']:.3f} s, CPU {time.perf_counter() - t0:.3f} "
          f"s", flush=True)
    if len(sub) != CLOUD_SUB or not np.array_equal(card, cpu):
        fail("dbscan of the sub-block on the card differs from the CPU's")


def blob_analysis(torch, path, truth, work, launches):
    """Phase 9: colocalization, the classifier and clustering on the
    two-channel volume (:func:`coloc_path`, :func:`classifier_path`,
    :func:`cluster_path`)."""
    t0 = time.perf_counter()
    det = coloc_path(torch, path, truth, work, launches)
    classifier_path(torch, path, det, truth[0], work)
    cluster_path(torch, path, det)
    print(f"blob analysis: {time.perf_counter() - t0:.1f} s", flush=True)


def coverage(torch, tiles, ipos, extent, device="cuda"):
    """The number of tiles over each voxel of the fused volume, uint8 on
    ``device``."""
    cover = torch.zeros(extent, dtype=torch.uint8, device=device)
    for pos in ipos:
        cover[tuple(slice(p, p + n) for p, n in zip(pos, tiles[0].shape))] \
            += 1
    return cover


def fused_detection(torch, blobs, centres, cover, origin, vol_shape):
    """Detection on a fused volume against the planted ``centres`` (its
    origin at ``origin`` in the specimen): sensitivity and PPV over the
    voxels farther than ``ACQ_EDGE`` (Chebyshev) from every voxel no tile
    covers, and over every covered voxel; and the blobs and nuclei at
    each depth from those voxels, in bands of ``ACQ_BAND`` voxels (blobs
    past the nuclei are false ones, wherever the border reaches). Blobs
    move into the specimen's frame and are verified in its tiles, whose
    edges keep off the nuclei."""
    from magellanmapper_torch import testing

    import torch.nn.functional as F

    def inside(margin):
        # covered voxels farther than margin from every uncovered one
        k = 2 * margin + 1
        bare = (cover == 0).to(torch.float16)[None, None]
        for size in ((k, 1, 1), (1, k, 1), (1, 1, k)):
            bare = F.max_pool3d(bare, size, stride=1,
                                padding=tuple(s // 2 for s in size))
        return (bare[0, 0] == 0) & (cover > 0)

    extent = np.asarray(cover.shape)

    def where(mask, pts):
        pts = np.asarray(pts, np.int64)
        ok = np.all((pts >= 0) & (pts < extent), 1)
        ok[ok] = mask[tuple(torch.from_numpy(pts[ok]).to(
            mask.device).T)].cpu().numpy()
        return ok

    out = {"blobs": len(blobs)}
    for name, mask in (("interior", inside(ACQ_EDGE)),
                       ("covered", cover > 0)):
        det = blobs[where(mask, blobs[:, :3])]
        truth = centres[where(mask, centres - origin)]
        sens, ppv = testing.sens_ppv(
            det[:, :3] + origin, truth, vol_shape,
            (vol_shape[0],) + SPEC_TILE_YX, VERIFY_TOL)
        out[name] = {"blobs": len(det), "nuclei": len(truth),
                     "sensitivity": sens, "ppv": ppv}
    # depth bands: a point's band is the number of margins it lies past
    det_band = where(cover > 0, blobs[:, :3]).astype(int)
    truth_band = where(cover > 0, centres - origin).astype(int)
    for margin in range(ACQ_BAND, ACQ_BAND * ACQ_BANDS, ACQ_BAND):
        mask = inside(margin)
        det_band += where(mask, blobs[:, :3])
        truth_band += where(mask, centres - origin)
    out["by_depth"] = {
        f"{(b - 1) * ACQ_BAND}+": [int(np.sum(det_band == b)),
                                   int(np.sum(truth_band == b))]
        for b in range(1, ACQ_BANDS + 1)}
    return out


def small_tile_set(scene, overlap):
    """A 3 x 3 set of ``ACQ_SMALL_TILE`` tiles overlapping by ``overlap``,
    cut from the interior of phase 10's scene with y/x offsets within
    +-3 (a third of the nominal overlap at 10%) and none in z, each tile
    its own noise: the tiles, their planted origins and their grid."""
    from magellanmapper_torch import testing
    from magellanmapper_torch.stitch import stitcher

    tz, ty, tx = ACQ_SMALL_TILE
    shift = 3
    span = [round(2 * t * (1 - overlap)) + t + 2 * shift for t in (ty, tx)]
    z0, y0, x0 = (np.asarray(scene.shape) - (tz, *span)) // 2
    crop = scene[z0:z0 + tz, y0:y0 + span[0], x0:x0 + span[1]]
    tiles, planted = testing.make_tiles(crop, *ACQ_GRID, overlap, SEED,
                                        max_shift=shift, max_dz=0,
                                        noise=testing.SPECIMEN_NOISE,
                                        device="cuda")
    if tiles[0].shape != ACQ_SMALL_TILE:
        fail(f"small tile set: tiles {tiles[0].shape}, not {ACQ_SMALL_TILE}")
    return tiles, planted, stitcher.TileGrid(*ACQ_GRID, tiles[0].shape,
                                             overlap)


def tile_grid_crop(torch, scene):
    """Stitching on a 3 x 3 set of ``ACQ_SMALL_TILE`` tiles overlapping by
    ``ACQ_SMALL_OVERLAP``, on the card and on the CPU: positions within
    ``ACQ_POS_ATOL`` and, where their rounded layouts agree, fused
    volumes equal bit for bit. The same tiles at ``ACQ_OVERLAP`` are
    stitched on the card by the port's route and by the reference's
    (:func:`stitcher.phase_shifts`), each tile's error printed: the
    whole-tile phase peak lies tens of voxels off there and the overlap
    check cannot climb that far (ROADMAP section 3)."""
    from magellanmapper_torch.stitch import stitcher

    tiles, planted, grid = small_tile_set(scene, ACQ_SMALL_OVERLAP)
    (card, p_card), t_card = timed(torch, lambda: stitcher.stitch(
        tiles, grid, device="cuda"))
    t0 = time.perf_counter()
    cpu, p_cpu = stitcher.stitch(tiles, grid, device="cpu")
    t_cpu = time.perf_counter() - t0
    diff = float(np.abs(p_card - p_cpu).max())
    same_layout = np.array_equal(stitcher.fuse_layout(tiles, p_card)[0],
                                 stitcher.fuse_layout(tiles, p_cpu)[0])
    err = float(np.abs((p_card - p_card[0]) - (planted - planted[0])).max())
    print(f"tile set {ACQ_GRID} x {ACQ_SMALL_TILE}, overlap "
          f"{ACQ_SMALL_OVERLAP}: positions card vs CPU {diff:.3g} apart, "
          f"{err:.3f} from the planted ones; rounded layouts "
          f"{'equal' if same_layout else 'differ'}; card "
          f"{t_card['wall_s']:.3f} s, CPU {t_cpu:.3f} s", flush=True)
    if diff > ACQ_POS_ATOL:
        fail(f"small tile set: card and CPU positions {diff} apart")
    if same_layout and not np.array_equal(card.view(np.int32),
                                          cpu.view(np.int32)):
        fail("small tile set: the card's fused volume differs from the CPU's")

    tiles, planted, grid = small_tile_set(scene, ACQ_OVERLAP)
    nominal = grid.nominal_positions()
    errs = {}
    for name, fn in (("port", stitcher.compute_pairwise_shifts),
                     ("reference", stitcher.phase_shifts)):
        pos = stitcher.globally_optimize(fn(tiles, grid, "cuda"),
                                         len(tiles), nominal)
        errs[name] = np.round(np.abs((pos - pos[0]) - (
            planted - planted[0])).max(axis=1), 3).tolist()
    print(f"tile set {ACQ_GRID} x {ACQ_SMALL_TILE}, overlap {ACQ_OVERLAP}: "
          f"tile errors {json.dumps(errs)} voxels (not gated)", flush=True)


def tiff_round_trips(vol, tiles, work):
    """``--proc import_only`` of the specimen written as one multi-page
    TIFF, ``--proc export_tif`` back, a deflate tile and an LZW
    ``ACQ_LZW_SHAPE`` tile read back, and mesoSPIM RAW tiles converted:
    each equal to its source. Returns the walls."""
    from magellanmapper_torch.io import cli, tiff
    from magellanmapper_torch.stitch import acquisition

    walls = {}

    def wall(name, fn):
        t0 = time.perf_counter()
        out = fn()
        walls[name] = time.perf_counter() - t0
        return out

    spec_tif = os.path.join(work, "spec.tif")
    wall("write_tif", lambda: tiff.write_tiff(spec_tif, vol))
    img5d = wall("import_only", lambda: cli.main(
        ["--img", spec_tif, "--proc", "import_only"]))
    if img5d.img.shape != (1,) + vol.shape or img5d.img.dtype != vol.dtype \
            or not np.array_equal(img5d.img[0], vol):
        fail(f"import_only: {img5d.img.shape} {img5d.img.dtype} differs "
             f"from the specimen")
    exported = wall("export_tif", lambda: cli.main(
        ["--img", spec_tif, "--proc", "export_tif", "--prefix",
         os.path.join(work, "spec_export")]))
    if not np.array_equal(tiff.read_tiff(exported), vol):
        fail("export_tif: the written TIFF differs from the specimen")
    del img5d
    for path in (spec_tif, exported):
        os.remove(path)
    walls["import_mb_per_s"] = vol.nbytes / 1e6 / walls["import_only"]

    deflate = os.path.join(work, "tile_deflate.tif")
    wall("deflate_write", lambda: tiff.write_tiff(deflate, tiles[0],
                                                  compression="deflate"))
    if not np.array_equal(wall("deflate_read",
                               lambda: tiff.read_tiff(deflate)), tiles[0]):
        fail("the deflate-compressed tile reads back different")
    z0, y0, x0 = (np.asarray(vol.shape) - ACQ_LZW_SHAPE) // 2
    lzw_tile = np.ascontiguousarray(vol[
        z0:z0 + ACQ_LZW_SHAPE[0], y0:y0 + ACQ_LZW_SHAPE[1],
        x0:x0 + ACQ_LZW_SHAPE[2]])
    lzw = os.path.join(work, "tile_lzw.tif")
    wall("lzw_write", lambda: tiff.write_tiff(lzw, lzw_tile,
                                              compression="lzw"))
    if not np.array_equal(wall("lzw_read", lambda: tiff.read_tiff(lzw)),
                          lzw_tile):
        fail("the LZW-compressed tile reads back different")

    raw_dir = os.path.join(work, "mesospim")
    os.makedirs(raw_dir)
    raws = {}
    for k, key in enumerate(("X0Y0", "X1Y0")):
        x0 = k * ACQ_RAW_SHAPE[2]
        arr = np.ascontiguousarray(lzw_tile[:ACQ_RAW_SHAPE[0],
                                            :ACQ_RAW_SHAPE[1],
                                            x0:x0 + ACQ_RAW_SHAPE[2]])
        raws[key] = arr
        path = os.path.join(raw_dir, f"488_{key}.raw")
        arr.tofile(path)
        with open(f"{path}_meta.txt", "w") as f:
            f.write(f"[z_planes] {arr.shape[0]}\n[y_pixels] {arr.shape[1]}\n"
                    f"[x_pixels] {arr.shape[2]}\n[z_stepsize] 5.0\n"
                    "[Pixelsize in um] 2.6\n")
    converted = wall("mesospim", lambda: acquisition.mesospim_to_tif(
        raw_dir))
    for (path, t, c), key in zip(converted, ("X0Y0", "X1Y0")):
        if os.path.basename(path) != f"tile_{t}_ch_{c}.tif" or c != 0 \
                or not np.array_equal(tiff.read_tiff(path), raws[key]):
            fail(f"mesoSPIM conversion of {key} differs: {path}")
    print("acquisition TIFF round trips: " + json.dumps(walls), flush=True)
    return walls


def acquisition_path(torch, spec, scene, centres, work, launches):
    """Phase 10: ``scene`` (phase 6's specimen with its nuclei, ``centres``,
    at a random z phase a column and no noise) cut into a seeded 3 x 3
    tile set (``testing.make_tiles``, each tile its own noise of the
    specimen's ``SPECIMEN_NOISE``), written as uncompressed
    ``tile_<t>_ch_0.tif`` files, and ``run_pipeline("full", ...)`` on the
    card: stitching (tile reads, pairwise phase correlation, the global
    optimisation, fusion), transformation (``rescale`` ``SPEC_RESCALE``)
    and detection (``lightsheet``) of the fused volume. Fails unless every
    recovered position lies within ``ACQ_POS_TOL`` of the planted one,
    every voxel under one tile only holds that tile's value, detection
    meets the detect slice's bars against the planted nuclei more than
    ``ACQ_EDGE`` voxels inside the tiles and its PPV over every covered
    voxel exceeds ``ACQ_COVERED_PPV`` (:func:`fused_detection`), the
    near-max at the fused depth and a plane less agree within
    ``ACQ_NEAR_MAX_RTOL``, the
    transform's shape and metadata are the reference formula's, K1, K3
    and K4 ran, the small tile set agrees card against CPU
    (:func:`tile_grid_crop`) and every TIFF round trip is exact
    (:func:`tiff_round_trips`)."""
    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch import testing
    from magellanmapper_torch.cv import blobs as blobs_mod
    from magellanmapper_torch.io import np_io, pipelines, tiff
    from magellanmapper_torch.settings.roi_prof import ROIProfile
    from magellanmapper_torch.stitch import stitcher

    t0 = time.perf_counter()
    tiles, planted = testing.make_tiles(scene, *ACQ_GRID, ACQ_OVERLAP, SEED,
                                        noise=testing.SPECIMEN_NOISE,
                                        device="cuda")
    t_make = time.perf_counter() - t0
    tile_dir = os.path.join(work, "tiles")
    os.makedirs(tile_dir)
    t0 = time.perf_counter()
    for t, tile in enumerate(tiles):
        tiff.write_tiff(os.path.join(tile_dir, f"tile_{t}_ch_0.tif"), tile)
    t_write = time.perf_counter() - t0
    tile_bytes = sum(tile.nbytes for tile in tiles)
    print(f"acquisition: {len(tiles)} tiles of {tiles[0].shape} uint16 "
          f"({tile_bytes} B) from the scene {scene.shape}, made in "
          f"{t_make:.2f} s, written in {t_write:.2f} s; planted origins "
          f"{planted.tolist()}", flush=True)

    prof = ROIProfile()
    prof.add_profiles("lightsheet")
    dev_mod.reset_launches()
    with LogRecords("magellanmapper_torch.io.pipelines") as plog, \
            LogRecords("magellanmapper_torch.stitch.stitcher") as slog:
        out, step = timed(torch, lambda: pipelines.run_pipeline(
            "full", os.path.join(work, "acq.tif"), prof,
            rescale=SPEC_RESCALE, device="cuda", tile_grid={
                "dir": tile_dir, "rows": ACQ_GRID[0], "cols": ACQ_GRID[1],
                "overlap": ACQ_OVERLAP}))
    launches["acquisition"] = dict(dev_mod.LAUNCHES)
    print(f"acquisition: launches {launches['acquisition']}", flush=True)
    for name in ("peak_candidates", "prune_overlap", "tile_percentiles"):
        if launches["acquisition"][name] <= 0:
            fail(f"kernel {name} was not launched on the acquisition path")
    stages = dict(plog.args("pipeline stage"))
    _, t_read = plog.args("stitching: read")[0]
    _, _, t_shifts, n_pairs, t_opt, t_fuse = slog.args("stitched %d")[0]
    positions = slog.args("stitched positions")[0][0]

    # positions against the planted ones, relative to tile 0
    err = np.abs((positions - positions[0]) - (planted - planted[0]))
    print(f"acquisition positions: largest error {err.max():.4f} voxels; "
          f"by tile {np.round(err.max(axis=1), 4).tolist()}", flush=True)
    if err.max() > ACQ_POS_TOL:
        fail(f"stitched positions off the planted ones by {err.max()}")

    # voxels under one tile hold that tile's value
    ipos, extent = stitcher.fuse_layout(tiles, positions)
    fused = np_io.read_file(out["stitching"]).img[0]
    if fused.shape != extent or fused.dtype != np.float32:
        fail(f"fused volume {fused.shape} {fused.dtype}, not {extent}")
    dev = torch.device("cuda")
    cover = coverage(torch, tiles, ipos, extent, dev)
    single = bad = 0
    for tile, pos in zip(tiles, ipos):
        sl = tuple(slice(p, p + n) for p, n in zip(pos, tile.shape))
        alone = cover[sl] == 1
        got = torch.from_numpy(np.ascontiguousarray(fused[sl])).to(dev)
        want = torch.from_numpy(tile.astype(np.float32)).to(dev)
        single += int(alone.sum())
        bad += int((got[alone] != want[alone]).sum())
    print(f"acquisition fusion: {extent} float32, {single} voxels under one "
          f"tile, {bad} of them off the tile's value", flush=True)
    if bad:
        fail(f"fusion: {bad} voxels under one tile differ from its value")

    # the detector's near-max (the 99.5th percentile of every Z // 16-th
    # plane) at the fused depth and one plane less: the scene favours no
    # plane, so a depth off by one moves it little
    near_max = [float(np.percentile(v[::max(1, v.shape[0] // 16)], 99.5))
                for v in (fused, fused[1:])]
    print(f"acquisition near-max: {near_max[0]} at the fused depth, "
          f"{near_max[1]} a plane less", flush=True)
    if abs(near_max[1] - near_max[0]) > ACQ_NEAR_MAX_RTOL * near_max[0]:
        fail(f"the fused volume's near-max hangs on its depth: {near_max}")

    # detection against the planted nuclei: the fused frame's origin lies
    # at planted[0] - ipos[0] in the specimen
    blobs = blobs_mod.Blobs().load_blobs(out["detection"]).blobs
    if blobs is None or not np.all(np.isfinite(blobs)):
        fail("detection on the fused volume gave no finite blobs")
    quality = fused_detection(torch, blobs, centres, cover,
                              planted[0] - ipos[0], scene.shape)
    del cover
    print("acquisition detect: " + json.dumps(quality), flush=True)
    inner = quality["interior"]
    if not (inner["sensitivity"] > 0.85 and inner["ppv"] > 0.7):
        fail(f"detection on the fused volume below the bars: {inner}")
    if not quality["covered"]["ppv"] > ACQ_COVERED_PPV:
        fail(f"detection on the fused volume: PPV over every covered voxel "
             f"{quality['covered']['ppv']} not above {ACQ_COVERED_PPV}")

    # the transformation: the reference formula's shape and metadata
    small = np_io.read_file(out["transformation"])
    want_shape = tuple(int(s * SPEC_RESCALE) for s in extent)
    meta = small.meta
    if small.img.shape != (1,) + want_shape \
            or meta["scaling"] != np.divide(want_shape, extent).tolist() \
            or meta["resolutions"] != [(np.ones(3) / SPEC_RESCALE).tolist()]:
        fail(f"transformation wrote {small.img.shape} with {meta}, not the "
             f"reference formula's {want_shape}")
    del fused, small

    fused_bytes = int(np.prod(extent)) * 4
    print("acquisition pipeline: " + json.dumps({
        "tiles": len(tiles), "tile_shape": list(tiles[0].shape),
        "fused_shape": list(extent), "wall_s": step["wall_s"],
        "stages_s": stages, "tile_reads_s": t_read,
        "pairwise_shifts_s": t_shifts, "pairs": n_pairs,
        "ms_per_pair": 1e3 * t_shifts / n_pairs, "optimisation_s": t_opt,
        "fusion_s": t_fuse,
        "fusion_gb_per_s": (tile_bytes + fused_bytes) / 1e9 / t_fuse,
        "detection_mvox_per_s": np.prod(extent) / 1e6
        / stages["detection"],
        "peak_device_mib": step["peak_device_mib"]}), flush=True)

    tile_grid_crop(torch, scene)
    tiff_round_trips(spec, tiles, work)


def render_engines(render3d, window, level, hw, steps):
    """Phase 11's engines, ``name: fn(vol, azim, elev, device)``: the
    gather volume renderer flat and shaded, the gather isosurface, and
    shear-warp's composite, MIP and isosurface; ``window`` is the transfer
    function's (vmin, vmax), ``level`` the isosurface's."""
    vmin, vmax = window
    kw = dict(vmin=vmin, vmax=vmax, out_hw=hw)
    return {
        "gather_volume": lambda v, az, el, d: render3d.render_volume(
            v, az, el, n_steps=steps, device=d, **kw),
        "gather_volume_shaded": lambda v, az, el, d: render3d.render_volume(
            v, az, el, n_steps=steps, shaded=True, device=d, **kw),
        "gather_isosurface": lambda v, az, el, d: render3d.render_isosurface(
            v, level, az, el, out_hw=hw, n_steps=steps, device=d),
        "sw_composite": lambda v, az, el, d: render3d.render_volume_sw(
            v, az, el, device=d, **kw),
        "sw_mip": lambda v, az, el, d: render3d.render_volume_sw(
            v, az, el, mode="mip", device=d, **kw),
        "sw_isosurface": lambda v, az, el, d: render3d.render_isosurface_sw(
            v, level, az, el, out_hw=hw, device=d),
    }


def render_diff(got, want) -> dict:
    """Largest image difference of two renders; for isosurfaces also the
    share of pixels whose hit differs and the largest depth difference
    where both hit (images compared where the hits agree)."""
    if not isinstance(got, tuple):
        return {"img": float(np.abs(got.cpu().numpy()
                                    - want.cpu().numpy()).max())}
    (rgb, depth), (rgb_w, depth_w) = ([a.cpu().numpy() for a in x]
                                      for x in (got, want))
    hit, hit_w = np.isfinite(depth), np.isfinite(depth_w)
    same, both = hit == hit_w, hit & hit_w
    return {"img": float(np.abs(rgb[same] - rgb_w[same]).max()),
            "hit_mismatch": float((hit != hit_w).mean()),
            "depth": float(np.abs(depth[both] - depth_w[both]).max())
            if both.any() else 0.0}


def render_crop(torch, spec):
    """Every engine at every pose on a central RENDER_CROP of the
    specimen, the card against the CPU, within the CPU tests' limits."""
    from magellanmapper_torch.ops import preproc, render3d

    lo = [(s - c) // 2 for s, c in zip(spec.shape, RENDER_CROP)]
    crop = np.ascontiguousarray(spec[tuple(
        slice(o, o + c) for o, c in zip(lo, RENDER_CROP))], np.float32)
    level = float(preproc.otsu_threshold(torch.from_numpy(crop)))
    engines = render_engines(render3d, (level, float(crop.max())), level,
                             RENDER_CROP_HW, RENDER_CROP_STEPS)
    on_card = torch.from_numpy(crop).cuda()
    worst = {}
    t0 = time.perf_counter()
    for name, fn in engines.items():
        for az, el in RENDER_POSES:
            diff = render_diff(fn(on_card, az, el, "cuda"),
                               fn(crop, az, el, "cpu"))
            for k, v in diff.items():
                worst[f"{name}.{k}"] = max(worst.get(f"{name}.{k}", 0.0), v)
    print(f"render crop {RENDER_CROP} at {RENDER_CROP_HW}, "
          f"{RENDER_CROP_STEPS} steps, card against CPU "
          f"({time.perf_counter() - t0:.1f} s): {json.dumps(worst)}",
          flush=True)
    limits = {"img": RENDER_ATOL, "hit_mismatch": RENDER_HIT_MISMATCH,
              "depth": RENDER_DEPTH_ATOL}
    for key, v in worst.items():
        if v > limits[key.rsplit(".", 1)[1]]:
            fail(f"render crop: {key} {v} on the card against the CPU")


def sphere_pins(torch):
    """The analytic sphere pins of ``tests/test_render3d.py`` at
    RENDER_HW on the card: the volume renderer's silhouette and centre,
    the background, the isosurface's centre depth (both engines),
    shear-warp against the gather engines, zoom, and the MIP's centre."""
    from magellanmapper_torch.ops import render3d

    zz, yy, xx = np.indices(SPHERE_SHAPE).astype(np.float32)
    c = (np.asarray(SPHERE_SHAPE, np.float32) - 1) / 2
    r = np.sqrt((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
    v = torch.from_numpy(np.clip(1.0 - (r - SPHERE_R) / 3.0, 0.0, 1.0)
                         .astype(np.float32)).cuda()
    h = RENDER_HW[0]
    mid = h // 2
    span = float(np.linalg.norm(SPHERE_SHAPE))
    px = (h - 1) / span
    kw = dict(vmin=0.2, vmax=1.0, out_hw=RENDER_HW, opacity=0.15)

    def lum(img):
        return img.cpu().numpy().mean(-1)

    def hits(depth):
        return np.isfinite(depth.cpu().numpy())

    def iou(a, b):
        return (a & b).sum() / max((a | b).sum(), 1)

    out = {}
    vol = lum(render3d.render_volume(v, 30.0, 20.0, n_steps=RENDER_STEPS,
                                     **kw))
    ys, xs = np.nonzero(vol > 0.05)
    out["silhouette_px"] = float(np.sqrt((ys - (h - 1) / 2) ** 2
                                         + (xs - (h - 1) / 2) ** 2).max())
    out["silhouette_bound_px"] = (SPHERE_R + 3.0 + 2 * span / 95) * px
    out["centre_lum"] = float(vol[mid, mid])
    sw = lum(render3d.render_volume_sw(v, 30.0, 20.0, **kw))
    out["sw_vs_gather_iou"] = float(iou(vol > 0.05, sw > 0.05))
    bg = (0.0, 0.25, 0.5)
    out["bg_err"] = max(float(np.abs(
        fn(v, 10.0, 10.0, bg=bg, **kw).cpu().numpy()[1, 1] - bg).max())
        for fn in (functools.partial(render3d.render_volume,
                                     n_steps=RENDER_STEPS),
                   render3d.render_volume_sw))
    want = span / 2 - (SPHERE_R + 1.5)
    rgb_g, dep_g = render3d.render_isosurface(
        v, 0.5, 25.0, 15.0, out_hw=RENDER_HW, n_steps=RENDER_STEPS)
    rgb_s, dep_s = render3d.render_isosurface_sw(v, 0.5, 25.0, 15.0,
                                                 out_hw=RENDER_HW)
    out["iso_centre_depth_err"] = abs(float(dep_g[mid, mid]) - want)
    out["sw_iso_centre_depth_err"] = abs(float(dep_s[mid, mid]) - want)
    both = hits(dep_g) & hits(dep_s)
    out["iso_iou"] = float(iou(hits(dep_g), hits(dep_s)))
    out["iso_median_depth_diff"] = float(np.median(np.abs(
        dep_g.cpu().numpy()[both] - dep_s.cpu().numpy()[both])))
    areas = [(lum(render3d.render_volume_sw(v, 25.0, 10.0, zoom=z, **kw))
              > 0.05).sum() for z in (1.0, 2.0)]
    out["zoom_area_ratio"] = float(areas[1] / areas[0])
    mip = lum(render3d.render_volume_sw(v, 33.0, 21.0, vmin=0.0, vmax=1.0,
                                        out_hw=RENDER_HW, mode="mip"))
    out["mip_centre"] = float(mip[mid, mid])
    print(f"render sphere pins at {RENDER_HW}: {json.dumps(out)}",
          flush=True)
    if not (out["silhouette_px"] <= out["silhouette_bound_px"]
            and out["centre_lum"] > 0.3 and out["bg_err"] < 1e-3
            and out["iso_centre_depth_err"] < 1.0
            and out["sw_iso_centre_depth_err"] < 1.5
            and out["sw_vs_gather_iou"] > 0.85 and out["iso_iou"] > 0.85
            and out["iso_median_depth_diff"] < 1.5
            and 3.3 < out["zoom_area_ratio"] < 4.7
            and abs(out["mip_centre"] - 1.0) < 0.03):
        fail(f"render: an analytic sphere pin failed: {out}")


def mip_gate(torch, vol, window):
    """The independent gate on the specimen: shear-warp's MIP at the
    axis-aligned pose (azimuth 0, elevation 0: rays along -x) against the
    volume's own maximum along x (``torch.amax``), windowed, sampled
    bilinearly (zero outside) at each film pixel's (z, y) from the orbit
    camera's formula in float64. Returns the largest and the mean
    difference."""
    from magellanmapper_torch.ops import render3d

    vmin, vmax = window
    img = render3d.render_volume_sw(vol, 0.0, 0.0, vmin=vmin, vmax=vmax,
                                    out_hw=RENDER_HW, mode="mip")
    lum = torch.clamp((torch.amax(vol, dim=2) - vmin) / (vmax - vmin), 0, 1)
    lum = np.pad(lum.cpu().numpy().astype(np.float64), 1)
    h, w = RENDER_HW
    shape = np.asarray(vol.shape, np.float64)
    span = np.linalg.norm(shape)
    ys = (np.arange(h) / (h - 1) - 0.5) * span
    xs = (np.arange(w) / (w - 1) - 0.5) * span
    # up is +z and right is -y at this pose: film (r, c) sits at
    # (z, y) = centre - up * ys[r] + right * xs[c]
    z = (shape[0] - 1) / 2 - ys[:, None] + 1 + 0 * xs[None, :]
    y = (shape[1] - 1) / 2 - xs[None, :] + 0 * ys[:, None] + 1
    z0, y0 = np.floor(z).astype(int), np.floor(y).astype(int)
    fz, fy = z - z0, y - y0

    def at(zi, yi):
        ok = (zi >= 0) & (zi < lum.shape[0]) & (yi >= 0) & (yi < lum.shape[1])
        return np.where(ok, lum[np.clip(zi, 0, lum.shape[0] - 1),
                                np.clip(yi, 0, lum.shape[1] - 1)], 0.0)

    want = ((1 - fz) * (1 - fy) * at(z0, y0) + (1 - fz) * fy * at(z0, y0 + 1)
            + fz * (1 - fy) * at(z0 + 1, y0) + fz * fy * at(z0 + 1, y0 + 1))
    diff = np.abs(img.cpu().numpy()[..., 0] - want)
    return float(diff.max()), float(diff.mean())


def render_frames(torch, vol, engines, blobs, card):
    """Each engine at each pose at RENDER_HW on the specimen: ms a frame
    (CUDA events, after a warm-up frame), peak device memory a frame
    (the resident volume included), finite images; the blobs projected
    under each pose's isosurface depth (``render_blobs_overlay``).
    Returns the timings."""
    from magellanmapper_torch.ops import render3d

    stats = {}
    for name, fn in engines.items():
        fn(vol, *RENDER_POSES[0], "cuda")
        ms, peaks, visible = [], [], []
        for az, el in RENDER_POSES:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(vol, az, el, "cuda")
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            peaks.append(torch.cuda.max_memory_allocated() / 2**20)
            img = (out[0] if isinstance(out, tuple) else out).cpu().numpy()
            if img.shape != RENDER_HW + (3,) or not np.isfinite(img).all() \
                    or img.min() < 0 or img.max() > 1:
                fail(f"render {name} at ({az}, {el}): image {img.shape}, "
                     f"range [{img.min()}, {img.max()}]")
            if isinstance(out, tuple):
                depth = out[1]
                if not torch.isfinite(depth).any():
                    fail(f"render {name} at ({az}, {el}): no hit")
                over = render3d.render_blobs_overlay(
                    depth, blobs, tuple(vol.shape), az, el, RENDER_HW)
                visible.append(float(over[:, 2].mean()))
        stats[name] = {"ms": ms, "ms_mean": float(np.mean(ms)),
                       "peak_mib": max(peaks)}
        if visible:
            stats[name]["blobs_visible_share"] = visible
        print(f"render {name} ({card}): " + json.dumps(stats[name]),
              flush=True)
        if max(peaks) > RENDER_PEAK_MIB:
            fail(f"render {name}: a frame peaked at {max(peaks):.0f} MiB")
    return stats


def render_path(torch, spec, blobs, coloc, work, launches, card):
    """Phase 11: visualisation and the plane and ROI exports.

    Phase 6's (640, 960, 800) specimen goes to the card as float32 and
    each engine renders it at RENDER_HW at RENDER_POSES (principal axes z,
    y and x; the gather engines at RENDER_STEPS); ``render_blobs_overlay``
    projects its detected blobs under each isosurface; the MIP at the
    axis-aligned pose is held to the volume's own maximum (:func:`mip_gate`);
    ``export_stack.render_rotation`` (the frames of
    ``animate_rotation_3d``) orbits it in ORBIT_FRAMES frames at ORBIT_HW
    in MIP and isosurface modes; ``render_channels_sw`` renders phase 9's
    two-channel volume ``coloc``; ``plot_3d.deconvolve`` runs DECONV_ITERS
    iterations on a DECONV_ROI of it. Then the analytic sphere pins at
    RENDER_HW, every engine and pose card against CPU on a crop
    (:func:`render_crop`), deconvolution card against CPU, and ``--proc
    extract`` and ``--proc export_rois`` through the CLI (each output equal
    to its source). The matplotlib exports (``--proc export_planes[_
    channels]|animated``, ``--plot_2d``, the GIF writer of
    ``animate_rotation_3d``) are left out by design: the card's machine
    has no matplotlib; the CPU tests hold them against the reference.
    Gates: each frame finite in [0, 1] and under RENDER_PEAK_MIB, the MIP
    gate, the pins, the card against the CPU, the exports. The path
    reuses phase 6's blobs, so it launches none of K1-K4 (counted as
    ``render``). ``card`` is the card's name and power limit, printed
    beside each time and memory figure."""
    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch import testing
    from magellanmapper_torch.io import cli, export_stack, np_io
    from magellanmapper_torch.ops import preproc, render3d
    from magellanmapper_torch.plot import plot_3d

    dev_mod.reset_launches()
    t_phase = t0 = time.perf_counter()
    vol = (torch.from_numpy(spec.view(np.int16)).cuda().to(torch.int32)
           & 0xFFFF).to(torch.float32)
    level = float(preproc.otsu_threshold(vol))
    window = (level, float(torch.amax(vol)))
    torch.cuda.synchronize()
    print(f"render: specimen {tuple(vol.shape)} float32 on the card "
          f"({vol.numel() * 4} B) in {time.perf_counter() - t0:.1f} s; "
          f"Otsu level {level}, window {window}; {len(blobs)} blobs",
          flush=True)
    engines = render_engines(render3d, window, level, RENDER_HW,
                             RENDER_STEPS)
    stats = render_frames(torch, vol, engines, blobs, card)
    err, mean = mip_gate(torch, vol, window)
    print(f"render MIP along x against the volume's maximum: largest "
          f"difference {err:.3g}, mean {mean:.3g} (limits {MIP_ATOL}, "
          f"{MIP_MEAN_ATOL})", flush=True)
    if err > MIP_ATOL or mean > MIP_MEAN_ATOL:
        fail(f"render: the axis-aligned MIP is {err} off the volume's max "
             f"({mean} on average)")
    for mode in ("mip", "isosurface"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = export_stack.render_rotation(vol, ORBIT_FRAMES, mode,
                                              out_hw=ORBIT_HW)
        wall = time.perf_counter() - t0
        if len(frames) != ORBIT_FRAMES or any(
                f.shape != ORBIT_HW + (3,) or not np.isfinite(f).all()
                for f in frames):
            fail(f"render: the {mode} orbit's frames are wrong")
        stats[f"orbit_{mode}"] = {"wall_s": wall,
                                  "frames_per_s": ORBIT_FRAMES / wall}
        print(f"render orbit {mode} ({card}): {ORBIT_FRAMES} frames at "
              f"{ORBIT_HW} in {wall:.2f} s = {ORBIT_FRAMES / wall:.2f} "
              "frames/s", flush=True)
    del vol
    torch.cuda.empty_cache()

    two = np_io.read_file(coloc).img[0]
    vol_c = (torch.from_numpy(np.array(two).view(np.int16))
             .cuda().to(torch.int32) & 0xFFFF).to(torch.float32)
    top = [float(torch.amax(vol_c[..., c])) for c in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    img = render3d.render_channels_sw(
        vol_c, 30.0, 20.0, vmin=[0.2 * t for t in top], vmax=top,
        out_hw=RENDER_HW)
    end.record()
    torch.cuda.synchronize()
    img = img.cpu().numpy()
    stats["channels"] = {"shape": list(vol_c.shape),
                         "ms": start.elapsed_time(end),
                         "peak_mib": torch.cuda.max_memory_allocated()
                         / 2**20,
                         "green_mean": float(img[..., 1].mean()),
                         "red_mean": float(img[..., 0].mean())}
    print(f"render channels ({card}): " + json.dumps(stats["channels"]),
          flush=True)
    if not np.isfinite(img).all() or img[..., 0].mean() <= 0 \
            or img[..., 1].mean() <= 0:
        fail("render_channels_sw: a channel's colour is missing")
    del vol_c, two
    torch.cuda.empty_cache()

    lo = [(s - c) // 2 for s, c in zip(spec.shape, DECONV_ROI)]
    roi = np.ascontiguousarray(spec[tuple(
        slice(o, o + c) for o, c in zip(lo, DECONV_ROI))], np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = plot_3d.deconvolve(roi, DECONV_ITERS)
    stats["deconvolve"] = {"roi": list(DECONV_ROI), "iterations":
                           DECONV_ITERS, "wall_s": time.perf_counter() - t0,
                           "flux_ratio": float(est.sum() / roi.sum())}
    print(f"render deconvolve ({card}): " + json.dumps(stats["deconvolve"]),
          flush=True)
    if est.shape != roi.shape or not np.isfinite(est).all():
        fail("deconvolve: non-finite or misshapen estimate")
    launches["render"] = dict(dev_mod.LAUNCHES)
    print(f"render: launches {launches['render']}", flush=True)

    sphere_pins(torch)
    render_crop(torch, spec)
    small = np.ascontiguousarray(roi[:DECONV_CROP[0], :DECONV_CROP[1],
                                     :DECONV_CROP[2]])
    est_card = plot_3d.deconvolve(small, DECONV_ITERS)
    est_cpu = plot_3d.deconvolve(small, DECONV_ITERS, device="cpu")
    rel = float(np.abs(est_card - est_cpu).max() / np.abs(est_cpu).max())
    print(f"render deconvolve {DECONV_CROP} card against CPU: relative "
          f"{rel:.3g}", flush=True)
    if rel > DECONV_RTOL:
        fail(f"deconvolve: the card is {rel} off the CPU, relative")

    lo = np.subtract(spec.shape, SPEC_CROP) // 2
    crop = np.ascontiguousarray(spec[tuple(
        slice(o, o + c) for o, c in zip(lo, SPEC_CROP))])
    path = os.path.join(work, "crop.npy")
    np_io.write_npy(path, crop, resolutions=[[1.0, 1.0, 1.0]])
    plane = cli.main(["--img", path, "--proc", "extract", "--offset",
                      "0,0,10"])
    saved = np.load(os.path.join(work, "crop_planexy10.npy"))
    rel = np.round(blobs[:, :3]) - lo
    inside = np.unique(rel[np.all((rel >= 0) & (rel < SPEC_CROP), axis=1)],
                       axis=0)
    truth = testing.write_truth_db(os.path.join(work, "truth.db"), inside,
                                   crop.shape)
    df = cli.main(["--img", path, "--proc", "export_rois", "--truth_db",
                   truth])
    roi_img = np.load(os.path.join(work, "crop_rois", "roi_1.npy"))
    with open(os.path.join(work, "crop_rois", "roi_1_blobs.csv")) as f:
        n_rows = sum(1 for _ in f) - 1
    print(f"render CLI: extract {saved.shape}, export_rois {len(df)} ROI, "
          f"{n_rows} blobs of {len(inside)}", flush=True)
    if not (np.array_equal(saved, crop[10]) and np.array_equal(plane, saved)
            and np.array_equal(roi_img, crop) and len(df) == 1
            and n_rows == len(inside)):
        fail("render CLI: an export differs from its source")
    stats["wall_s"] = time.perf_counter() - t_phase
    print(f"render ({card}): " + json.dumps(stats), flush=True)


def fast_log_block(torch, prof, vol):
    """One detect block's LoG by the float32 route and the fast route on
    the card: ``(largest absolute difference, largest |LoG|, fp32 ms,
    fast ms)``. Fails unless TF32 is off again afterwards."""
    from magellanmapper_torch.cv import stack_detect as sd
    from magellanmapper_torch.ops import filters

    blocks = sd.setup_blocks(prof, vol.shape, (1.0, 1.0, 1.0))
    block_shape = np.minimum(blocks.max_pixels + blocks.overlap, vol.shape)
    params = sd.step_params(prof, blocks, block_shape, (1.0, 1.0, 1.0),
                            float(np.percentile(vol[::16], 99.5)))
    # the block window at the volume's centre
    window = tuple(slice((n - b) // 2, (n - b) // 2 + b)
                   for n, b in zip(vol.shape, (int(v) for v in block_shape)))
    block = torch.from_numpy(np.ascontiguousarray(vol[window])).cuda()
    pre = sd.preprocess_block(block, params.denoise_shape,
                              params.preproc_items)
    ref = filters.log_pyramid(pre, params.sigmas)
    fast = filters.log_pyramid(pre, params.sigmas,
                               precision=filters.FAST_PRECISION)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 stayed on after the fast LoG")
    err = float((fast - ref).abs().max())
    peak = float(ref.abs().max())
    ms = cuda_ms(torch, lambda: filters.log_pyramid(pre, params.sigmas))
    ms_fast = cuda_ms(torch, lambda: filters.log_pyramid(
        pre, params.sigmas, precision=filters.FAST_PRECISION))
    return err, peak, ms, ms_fast


def blob_changes(fast, ref):
    """How the fast route's blobs differ from the float32 route's: rows
    equal in z, y, x and radius, then the rest matched by the verifier's
    optimal assignment within ``VERIFY_TOL`` (moved), and those left on
    either side (added, removed)."""
    from magellanmapper_torch.cv import verifier

    def keys(rows):
        return {tuple(r) for r in np.round(rows[:, :4], 4).tolist()}

    same = keys(fast) & keys(ref)
    only_fast = np.asarray([r for r in fast if tuple(np.round(
        r[:4], 4).tolist()) not in same]).reshape(-1, fast.shape[1])
    only_ref = np.asarray([r for r in ref if tuple(np.round(
        r[:4], 4).tolist()) not in same]).reshape(-1, ref.shape[1])
    thresh, scaling, *_ = verifier.setup_match_blobs_roi(VERIFY_TOL)
    found, _, _ = verifier.find_closest_blobs_cdist(
        only_fast, only_ref, thresh, scaling)
    return {"equal": len(same), "moved": int(len(found)),
            "added": int(len(only_fast) - len(found)),
            "removed": int(len(only_ref) - len(found))}


def fast_detect_path(torch, vol, centres, fp32, work, launches):
    """The fast LoG route on the detect slice through the port's CLI
    (``--roi_profile lightsheet,<fast.yml>``), beside the float32 route's
    ``fp32`` readings of phase 4: the bars against the planted nuclei,
    the same launches of K1, K3 and K4, band products run with TF32 on
    (``device.TF32_SCOPES``: the CLI's route reached the fast products),
    the blobs that differ, Mvox/s beside phase 4's (both routes in turns:
    ``tools/profile_slice.py --turns``), and one block's LoG difference,
    which must be above 0 (TF32 changed the products) and under
    ``FAST_LOG_ATOL``."""
    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch import testing
    from magellanmapper_torch.cv import stack_detect as sd
    from magellanmapper_torch.io import cli

    yml = os.path.join(work, "fast_log.yml")
    with open(yml, "w") as f:
        f.write(FAST_YML)
    path = os.path.join(work, "nuclei.npy")
    np.save(path, vol)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dev_mod.reset_launches()
    t0 = time.perf_counter()
    blobs = cli.main(["--img", path, "--proc", "detect", "--roi_profile",
                      f"lightsheet,{yml}", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["detect_fast"] = dict(dev_mod.LAUNCHES)
    tf32 = dev_mod.TF32_SCOPES["band_products"]
    peak_mem = torch.cuda.max_memory_allocated()
    print(f"fast slice: launches {launches['detect_fast']}; band-product "
          f"blocks with TF32 on {tf32}", flush=True)
    if tf32 <= 0:
        fail("fast slice: the CLI ran no band product with TF32 on")
    for name in ("peak_candidates", "prune_overlap", "tile_percentiles"):
        if launches["detect_fast"][name] != launches["detect"][name]:
            fail(f"fast slice: {name} launched "
                 f"{launches['detect_fast'][name]} times, the float32 "
                 f"route {launches['detect'][name]}")
    det = blobs.blobs
    if det is None or det.shape[1] != 10 or not np.all(np.isfinite(det)):
        fail("fast slice: no or non-finite blobs")
    sens, ppv = testing.sens_ppv(
        det, centres, SLICE_SHAPE, VERIFY_TILE, VERIFY_TOL)
    changes = blob_changes(det, fp32["blobs"])
    mvox = float(np.prod(SLICE_SHAPE) / 1e6 / wall)
    print(f"fast slice: {len(det)} blobs (float32 route {len(fp32['blobs'])})"
          f"; sensitivity {sens:.4f} PPV {ppv:.4f} (float32 "
          f"{fp32['sens']:.4f} / {fp32['ppv']:.4f}); wall {wall:.3f} s"
          f" = {mvox:.2f} Mvox/s (phase 4's float32 {fp32['mvox']:.2f}); "
          f"peak device memory {peak_mem / 2**20:.1f} MiB; against the "
          f"float32 route's blobs {json.dumps(changes)}", flush=True)
    if not (sens > 0.85 and ppv > 0.7):
        fail(f"fast slice below the bars: sens {sens} ppv {ppv}")
    err, peak, ms, ms_fast = fast_log_block(
        torch, sd.roi_profile("lightsheet"), vol)
    print(f"fast LoG, one block: max_abs_diff {err} from the float32 route "
          f"(limit {FAST_LOG_ATOL}; max |LoG| {peak:.4f}); LoG {ms:.3f} ms "
          f"float32, {ms_fast:.3f} ms fast", flush=True)
    if not 0 < err < FAST_LOG_ATOL:
        fail(f"fast LoG differs from the float32 route by {err}: 0 means "
             f"the fast route did not run, the limit is {FAST_LOG_ATOL}")
    return {"mvox_fast": mvox, "mvox_fp32": fp32["mvox"], "tf32": tf32,
            "sens": sens, "ppv": ppv, "blobs": len(det),
            "log_diff": err, "log_ms": ms, "log_ms_fast": ms_fast,
            **changes}


def fast_grid_path(torch, roi, centres, fp32_df, work, launches):
    """Phase 5's sweep with the fast LoG route through the CLI: K2 and K3
    launched, the table beside the float32 sweep's, the best row at the
    bars."""
    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch import testing
    from magellanmapper_torch.io import cli
    from magellanmapper_torch.stats import mlearn

    yml = os.path.join(work, "fast_log.yml")
    with open(yml, "w") as f:
        f.write(FAST_YML)
    img = os.path.join(work, "roi.npy")
    np.save(img, roi)
    truth = testing.write_truth_db(
        os.path.join(work, "truth.db"), centres, GRID_SHAPE)
    dev_mod.reset_launches()
    t0 = time.perf_counter()
    df = cli.main(["--img", img, "--grid_search", "gridtest",
                   "--roi_profile", f"4xnuc,{yml}", "--truth_db", truth,
                   "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["grid_fast"] = dict(dev_mod.LAUNCHES)
    tf32 = dev_mod.TF32_SCOPES["band_products"]
    print(f"fast grid search: launches {launches['grid_fast']}; band-product "
          f"blocks with TF32 on {tf32}; wall {wall:.3f} s", flush=True)
    if tf32 <= 0:
        fail("fast grid search: the CLI ran no band product with TF32 on")
    for name in ("extract_candidates", "prune_overlap"):
        if launches["grid_fast"][name] <= 0:
            fail(f"kernel {name} was not launched by the fast grid search")
    if len(df) != len(fp32_df):
        fail(f"fast grid: {len(df)} rows, float32 {len(fp32_df)}")
    ref = fp32_df.sort_values("detection_threshold").reset_index(drop=True)
    got = df.sort_values("detection_threshold").reset_index(drop=True)
    for (_, a), (_, b) in zip(got.iterrows(), ref.iterrows()):
        print(f"fast grid: threshold {a['detection_threshold']:.2f} TP "
              f"{int(a['TP'])} FP {int(a['FP'])} SENS {a['SENS']:.4f} PPV "
              f"{a['PPV']:.4f} | float32 TP {int(b['TP'])} FP "
              f"{int(b['FP'])} SENS {b['SENS']:.4f} PPV {b['PPV']:.4f}",
              flush=True)
    best = mlearn.parse_grid_stats(df).iloc[0]
    if not (best["SENS"] > 0.85 and best["PPV"] > 0.7):
        fail(f"fast grid search below the bars: {best.to_dict()}")


def crop_blobs(blobs, origin, shape):
    """The blobs inside the box at ``origin`` of ``shape``, shifted into
    it."""
    lo = np.asarray(origin)
    inside = np.all((blobs[:, :3] >= lo) & (blobs[:, :3] < lo + shape),
                    axis=1)
    out = np.array(blobs[inside])
    out[:, :3] -= lo
    return out


def segmentation_crop(torch, vol, blobs):
    """``segment_rw``, ``segment_ws``, ``labels_to_markers_blob`` and
    ``borders_distance`` on a ``SEG_CROP`` of the slice, card against
    CPU: masks, labels, markers and indices exactly, probabilities within
    ``RW_PROB_ATOL`` (a mask voxel may differ only where the CPU's
    probability lies that close to 0.5; counted), distances within
    ``DIST_ATOL``."""
    from magellanmapper_torch.cv import cv_nd, segmenter

    origin = [(n - c) // 2 for n, c in zip(SLICE_SHAPE, SEG_CROP)]
    crop = np.ascontiguousarray(vol[tuple(
        slice(o, o + c) for o, c in zip(origin, SEG_CROP))])
    local = crop_blobs(blobs, origin, SEG_CROP)
    out = {"blobs": len(local)}
    (w_card,) = segmenter.segment_rw(crop, blobs=local, device="cuda")
    (w_cpu,) = segmenter.segment_rw(crop, blobs=local, device="cpu")
    seg = crop.astype(np.float32)
    seeds_fg = np.zeros(seg.shape, bool)
    seeds_fg[tuple(np.clip(local[:, :3].astype(int), 0,
                           np.asarray(seg.shape) - 1).T)] = True
    seeds_bg = (seg < np.percentile(seg, 25)) & ~seeds_fg
    p_card, p_cpu = (segmenter._random_walker_cg(*(
        torch.from_numpy(a).to(d) for a in (seg, seeds_fg, seeds_bg)))
        .cpu().numpy() for d in ("cuda", "cpu"))
    near = np.abs(p_cpu - 0.5) <= RW_PROB_ATOL
    out["rw_prob_err"] = float(np.abs(p_card - p_cpu).max())
    out["rw_near_half"] = int(near.sum())
    out["rw_mask_diff"] = int(np.sum(w_card != w_cpu))
    if out["rw_prob_err"] > RW_PROB_ATOL or np.any((w_card != w_cpu)
                                                   & ~near):
        fail(f"segment_rw crop: the card differs from the CPU: {out}")
    ws_card = segmenter.segment_ws(crop, blobs=local, device="cuda")
    ws_cpu = segmenter.segment_ws(crop, blobs=local, device="cpu")
    mk_card = segmenter.labels_to_markers_blob(ws_card, device="cuda")
    mk_cpu = segmenter.labels_to_markers_blob(ws_cpu, device="cpu")
    fg = w_cpu == 1
    shifted = np.roll(fg, 1, axis=2)
    bd = [cv_nd.borders_distance(
        cv_nd.perimeter_nd(fg, device="cpu"),
        cv_nd.perimeter_nd(shifted, device="cpu"), fg, (2.0, 1.0, 1.0), 3,
        device=d) for d in ("cuda", "cpu")]
    out.update(ws_labels=int(ws_cpu.max()),
               marker_voxels=int(np.sum(mk_cpu != 0)),
               dist_err=float(np.abs(bd[0][0] - bd[1][0]).max()))
    print(f"segmentation crop {SEG_CROP}, card against CPU: "
          f"{json.dumps(out)}", flush=True)
    if not (np.array_equal(ws_card, ws_cpu)
            and np.array_equal(mk_card, mk_cpu)
            and out["dist_err"] <= DIST_ATOL
            and np.array_equal(bd[0][1], bd[1][1])
            and np.array_equal(bd[0][2], bd[1][2])):
        fail(f"segmentation crop: the card differs from the CPU: {out}")


def segmentation_path(torch, vol, blobs, launches):
    """The random walker on the whole detect slice seeded by its blobs,
    the distance watershed and ``segment_ws`` on a central
    ``SEG_CENTRAL`` region (walls, peak memory, the watershed's sweeps),
    and the crop card against CPU; none launches a hand-written kernel
    (their counts are printed, 0)."""
    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch.cv import segmenter

    dev_mod.reset_launches()
    (walker,), rw = timed(torch, lambda: segmenter.segment_rw(
        vol, blobs=blobs, device="cuda"))
    coords = np.clip(blobs[:, :3].astype(int), 0,
                     np.asarray(SLICE_SHAPE) - 1)
    seeded = walker[tuple(coords.T)]
    rw.update(foreground_voxels=int(np.sum(walker == 1)),
              blob_voxels_foreground=int(np.sum(seeded == 1)))
    print(f"segment_rw {SLICE_SHAPE}, {len(blobs)} blob seeds: "
          f"{json.dumps(rw)}", flush=True)
    if walker.shape != SLICE_SHAPE or not np.all(
            (walker == 1) | (walker == 2)) or np.any(seeded != 1):
        fail("segment_rw: a mask value or a seed is wrong")
    del walker
    origin = [(n - c) // 2 for n, c in zip(SLICE_SHAPE, SEG_CENTRAL)]
    region = np.ascontiguousarray(vol[tuple(
        slice(o, o + c) for o, c in zip(origin, SEG_CENTRAL))])
    local = crop_blobs(blobs, origin, SEG_CENTRAL)
    with LogRecords("magellanmapper_torch.cv.segmenter") as logs:
        ws, ws_t = timed(torch, lambda: segmenter.segment_ws(
            region, blobs=local, device="cuda"))
        fg = region > np.percentile(region, 90)
        wd, wd_t = timed(torch, lambda: segmenter.watershed_distance(
            fg, device="cuda"))
    sweeps = [a[0] for a in logs.args("watershed flood")]
    ws_t.update(labels=int(len(np.unique(ws)) - 1), sweeps=sweeps[0])
    wd_t.update(labels=int(len(np.unique(wd)) - 1), sweeps=sweeps[1])
    print(f"segment_ws {SEG_CENTRAL}, {len(local)} blob markers: "
          f"{json.dumps(ws_t)}; watershed_distance of its top decile: "
          f"{json.dumps(wd_t)}", flush=True)
    if not (0 < ws_t["labels"] <= len(local) and ws.min() >= 0
            and wd_t["labels"] > 0 and np.all(wd[fg] > 0)):
        fail("segment_ws or watershed_distance: labels out of range")
    segmentation_crop(torch, vol, blobs)
    launches["segment"] = dict(dev_mod.LAUNCHES)
    print(f"segmentation: launches {launches['segment']}", flush=True)


def same_table(a, b) -> bool:
    """Two tables equal: the same columns and integers, floats within
    ``TASK_RTOL`` (NaN where the other has NaN)."""
    if list(a.columns) != list(b.columns) or len(a) != len(b):
        return False
    for col in a.columns:
        x, y = a[col].to_numpy(), b[col].to_numpy()
        if x.dtype.kind == "f" or y.dtype.kind == "f":
            if not np.allclose(x.astype(float), y.astype(float),
                               rtol=TASK_RTOL, atol=0, equal_nan=True):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


def register_tasks_path(torch, labels, work, launches):
    """``labels_to_markers_blob`` at the 25 um atlas's size (wall), then
    three ``--register`` tasks through the CLI on the labels and those
    markers as two registered samples, on the card and with ``--device
    cpu``: ``vol_compare`` (its table), ``labels_diff`` (CSV and MHD) and
    ``labels_dist`` (CSV), files equal, floats within ``TASK_RTOL``."""
    import pandas as pd

    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch.cv import segmenter
    from magellanmapper_torch.io import cli, sitk_io

    dev_mod.reset_launches()
    markers, mk = timed(torch, lambda: segmenter.labels_to_markers_blob(
        labels, device="cuda"))
    ids = np.unique(labels)
    mk.update(ids=int(len(ids) - (ids[0] == 0)),
              marker_voxels=int(np.sum(markers != 0)),
              labels_with_marker=int(len(np.unique(markers)) - 1))
    print(f"labels_to_markers_blob {labels.shape}: {json.dumps(mk)}",
          flush=True)
    if np.any((markers != 0) & (markers != labels)):
        fail("labels_to_markers_blob: a marker lies outside its label")
    a, b = os.path.join(work, "labels.npy"), os.path.join(work, "markers.npy")
    for base, img in ((a, labels), (b, markers)):
        sitk_io.write_med_img(sitk_io.reg_out_path(base, "annotation.mhd"),
                              sitk_io.MedImage(img, (0.025,) * 3))
    walls = {}
    outs = {}
    for dev in ("cuda", "cpu"):
        os.makedirs(os.path.join(work, dev))
        prefix = os.path.join(work, dev, "labels")
        for task in ("vol_compare", "labels_diff", "labels_dist"):
            t0 = time.perf_counter()
            outs[dev, task] = cli.main(
                ["--img", a, b, "--register", task, "--prefix", prefix,
                 "--device", dev])
            walls[f"{task}_{dev}_s"] = time.perf_counter() - t0
    for task in ("vol_compare", "labels_diff", "labels_dist"):
        if not same_table(outs["cuda", task], outs["cpu", task]):
            fail(f"--register {task}: the card's table differs from the "
                 "CPU's")
    for name in ("labels_labels_diff.csv", "labels_labels_dist.csv"):
        got, want = (pd.read_csv(os.path.join(work, d, name))
                     for d in ("cuda", "cpu"))
        if not same_table(got, want):
            fail(f"{name}: the card's file differs from the CPU's")
    diff = [open(os.path.join(work, d, "labels_annotationDiff.raw"),
                 "rb").read() for d in ("cuda", "cpu")]
    if diff[0] != diff[1]:
        fail("annotationDiff: the card's image differs from the CPU's")
    launches["register_tasks"] = dict(dev_mod.LAUNCHES)
    dsc = outs["cuda", "vol_compare"]["VolDSC"]
    print(f"register tasks at {labels.shape}: {len(dsc)} regions, VolDSC "
          f"labels against markers {float(dsc.min()):.4f}-"
          f"{float(dsc.max()):.4f}; files equal card/CPU; "
          f"{json.dumps(walls)}; launches {launches['register_tasks']}",
          flush=True)


def phase12(torch, vol, centres, fp32, grid_roi, grid_centres, grid_df,
            labels, work, launches):
    """Phase 12: the fast LoG route on the detect slice and the grid
    sweep, segmentation, and the atlas-register tasks; prints its wall."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        fast = fast_detect_path(torch, vol, centres, fp32, tmp, launches)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        fast_grid_path(torch, grid_roi, grid_centres, grid_df, tmp,
                       launches)
    torch.cuda.empty_cache()
    segmentation_path(torch, vol, fp32["blobs"], launches)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        register_tasks_path(torch, labels, tmp, launches)
    torch.cuda.empty_cache()
    print(f"phase 12: {json.dumps(fast)}; wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def write_vendor(form, vol, path):
    """Write ``vol`` at 1 um as one of ``VENDOR_FORMS``."""
    from magellanmapper_torch import testing
    from magellanmapper_torch.io import czi_lif

    _, fmt, compression, _ = form
    if fmt == "czi":
        czi_lif.write_czi(path, vol, resolutions=(1.0, 1.0, 1.0),
                          compression=compression)
    elif fmt == "lif":
        czi_lif.write_lif(path, vol, resolutions=(1.0, 1.0, 1.0))
    else:
        # contiguous, its extents one micrometre a voxel (axis 0 is x)
        nz, ny, nx = vol.shape
        testing.write_ims(path, [vol], vol.shape, ext={
            "ExtMin0": 0, "ExtMax0": nx, "ExtMin1": 0, "ExtMax1": ny,
            "ExtMin2": 0, "ExtMax2": nz})


def jpeg_czi(work):
    """A small Gray8 CZI of JPEG subblocks through ``--proc import_only``,
    within ``JPEG_ATOL`` of its source. Where the JPEG codec cannot be
    built (no libjpeg or ``jpeglib.h``), a JPEG subblock must raise by
    name instead; returns whether the form ran."""
    from magellanmapper_torch import testing
    from magellanmapper_torch.io import _jpegcodec, cli, czi_lif

    try:
        _jpegcodec.library()
    except (RuntimeError, OSError) as err:
        path = os.path.join(work, "nojpeg.czi")
        with open(path, "wb") as f:
            f.write(testing.czi_segment(b"ZISRAWFILE", b"\x00" * 512)
                    + testing.czi_segment(b"ZISRAWSUBBLOCK",
                                          testing.czi_subblock(
                                              b"\xff\xd8\xff",
                                              [(b"Y", 0, 2), (b"X", 0, 2)],
                                              pixel_type=0, compression=1)))
        try:
            czi_lif.read_czi(path)
        except (RuntimeError, OSError) as raised:
            if "libjpeg" not in str(raised):
                fail(f"a JPEG CZI without its codec raised {raised}")
        else:
            fail("a JPEG CZI read without its codec")
        print(f"vendor import: czi_jpeg not run: the JPEG codec did not "
              f"build ({str(err).splitlines()[0]}); a JPEG subblock "
              "raises naming libjpeg", flush=True)
        return False
    plane = np.full((1,) + JPEG_PLANE, 40, np.uint8)
    plane[0, :128, :160] = 200
    plane[0, 96:224, 96:288] = 120
    src = os.path.join(work, "jpeg.czi")
    czi_lif.write_czi(src, plane, compression="jpeg")
    img5d = cli.main(["--img", src, "--proc", "import_only", "--prefix",
                      os.path.join(work, "jpeg.npy")])
    got = np.asarray(img5d.img[0])
    err = int(np.abs(got.astype(int) - plane.astype(int)).max())
    print(f"vendor import: czi_jpeg {plane.shape} uint8, max |difference| "
          f"{err} from the source (limit {JPEG_ATOL})", flush=True)
    if got.shape != plane.shape or got.dtype != np.uint8 or err > JPEG_ATOL:
        fail(f"JPEG CZI import: {got.shape} {got.dtype}, {err} from the "
             "source")
    return True


def vendor_path(torch, vol, centres, fp32, work, launches):
    """Phase 13: phase 4's volume written as each of ``VENDOR_FORMS``,
    imported through ``--proc import_only`` (each array equal to the
    source, resolutions 1 um; write and import MB/s), the small JPEG CZI,
    and ``--proc detect`` on the Zstd1 CZI's import (launches of the
    ``vendor`` path; phase 4's bars and its blobs). A form whose system
    library is absent is named as not run."""
    import ctypes.util

    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch import testing
    from magellanmapper_torch.io import cli, hdf5_native
    from magellanmapper_torch.utils import profiler

    t_phase = time.perf_counter()
    found = {name: ctypes.util.find_library(name) for name in VENDOR_LIBS}
    have = {"zstd": found["zstd"] is not None,
            "hdf5": hdf5_native.available()}
    print("vendor import: system libraries " + json.dumps(found)
          + f"; libhdf5 bound {have['hdf5']}", flush=True)
    mb = vol.nbytes / 1e6
    rates, not_run, imported = {}, [], {}
    for form in VENDOR_FORMS:
        name, fmt, _, lib = form
        if lib is not None and not have[lib]:
            not_run.append(name)
            print(f"vendor import: {name} not run: lib{lib} absent",
                  flush=True)
            continue
        src = os.path.join(work, f"{name}.{fmt}")
        t0 = time.perf_counter()
        write_vendor(form, vol, src)
        t_write = time.perf_counter() - t0
        out = os.path.join(work, f"{name}.npy")
        t0 = time.perf_counter()
        img5d = cli.main(["--img", src, "--proc", "import_only", "--prefix",
                          out])
        t_import = time.perf_counter() - t0
        res = np.asarray(img5d.meta.get("resolutions")).tolist()
        if img5d.img.shape != (1,) + vol.shape or img5d.img.dtype != \
                vol.dtype or not np.array_equal(img5d.img[0], vol):
            fail(f"vendor import: {name} imported {img5d.img.shape} "
                 f"{img5d.img.dtype}, not the source")
        # LIF stores extents in metres: 1 um comes back within rounding
        if not np.allclose(res, [[1.0, 1.0, 1.0]], rtol=1e-12, atol=0):
            fail(f"vendor import: {name} resolutions {res}, not 1 um")
        rates[name] = {"write_mb_per_s": mb / t_write,
                       "import_mb_per_s": mb / t_import,
                       "file_mb": os.path.getsize(src) / 1e6,
                       "write_s": t_write, "import_s": t_import}
        print(f"vendor import: {name} equal to the source, resolutions "
              f"{res}; " + json.dumps(rates[name]), flush=True)
        os.remove(src)
        imported[name] = out
        del img5d
    if not jpeg_czi(work):
        not_run.append("czi_jpeg")

    # detection on the CZI import: the Zstd1 form, or zlib without libzstd
    name = "czi_zstd1hilo" if "czi_zstd1hilo" in imported else "czi_zlib"
    torch.cuda.synchronize()
    dev_mod.reset_launches()
    rate = profiler.Throughput()
    rate.start()
    blobs = cli.main(["--img", imported[name], "--proc", "detect",
                      "--roi_profile", "lightsheet", "--device", "cuda"])
    torch.cuda.synchronize()
    rate.stop(vol.size)
    launches["vendor"] = dict(dev_mod.LAUNCHES)
    for kernel in ("peak_candidates", "prune_overlap", "tile_percentiles"):
        if launches["vendor"][kernel] != launches["detect"][kernel]:
            fail(f"vendor detect: {kernel} launched "
                 f"{launches['vendor'][kernel]} times, phase 4 "
                 f"{launches['detect'][kernel]}")
    det = blobs.blobs
    if det is None or det.shape[1] != 10 or not np.all(np.isfinite(det)):
        fail("vendor detect: no or non-finite blobs")
    sens, ppv = testing.sens_ppv(
        det, centres, SLICE_SHAPE, VERIFY_TILE, VERIFY_TOL)
    changes = blob_changes(det, fp32["blobs"])
    print(f"vendor detect on the {name} import: launches "
          f"{launches['vendor']}; {len(det)} blobs, sensitivity {sens:.4f} "
          f"PPV {ppv:.4f}; against phase 4's blobs {json.dumps(changes)}; "
          f"profiler.Throughput {json.dumps(rate.summary())}", flush=True)
    if not (sens > 0.85 and ppv > 0.7):
        fail(f"vendor detect below the bars: sens {sens} ppv {ppv}")
    print(f"vendor import: phase 13 wall {time.perf_counter() - t_phase:.1f}"
          f" s; not run: {not_run or 'none'}", flush=True)
    return rates


def profiler_path(torch, vol, work, launches):
    """Phase 14: a detect block of phase 4's volume stepped twice under
    ``utils.profiler.trace``, the second time in ``annotate``'s range; in
    the written Chrome trace, the range on the device must hold K1, K3
    and K4 (``TRACE_KERNELS``); then ``entry.entry(device="cuda")``'s
    step once (launches of the ``profile`` path)."""
    import glob

    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch import entry
    from magellanmapper_torch.cv import stack_detect as sd
    from magellanmapper_torch.utils import profiler

    t_phase = time.perf_counter()
    params, block = detect_block(torch, sd.roi_profile("lightsheet"), vol,
                                 torch.device("cuda"))
    log_dir = os.path.join(work, "trace")
    torch.cuda.synchronize()
    dev_mod.reset_launches()
    with profiler.trace(log_dir):
        # one step before the range: after an earlier trace in the
        # process, the first kernels of a trace can go unrecorded
        sd.detect_step(block, params)
        torch.cuda.synchronize()
        with profiler.annotate(TRACE_RANGE):
            _, valid, count = sd.detect_step(block, params)
            torch.cuda.synchronize()
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    if len(files) != 1:
        fail(f"profiler: {len(files)} trace files in {log_dir}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == TRACE_RANGE
             and e.get("cat") == "gpu_user_annotation"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"
               and any(lo <= e["ts"] <= hi for lo, hi in spans)}
    missing = [k for k in TRACE_KERNELS
               if not any(k in name for name in kernels)]
    print(f"profiler: trace of one block {tuple(block.shape)} "
          f"({int(valid.sum())} blobs of {count} peaks): "
          f"{os.path.getsize(files[0])} bytes, {len(events)} events, "
          f"{len(spans)} device range(s) {TRACE_RANGE} holding "
          f"{len(kernels)} kernel names; {TRACE_KERNELS} missing {missing}",
          flush=True)
    if missing or not spans:
        fail(f"profiler: the range {TRACE_RANGE} on the device lacks "
             f"kernels {missing} or is not in the trace")
    fn, (batch,) = entry.entry(device="cuda")
    raws, valids, counts = fn(batch)
    torch.cuda.synchronize()
    launches["profile"] = dict(dev_mod.LAUNCHES)
    print(f"profiler: entry() step on {tuple(batch.shape)}: raws "
          f"{tuple(raws.shape)}, valid rows {valids.sum(1).tolist()}, "
          f"counts {counts.tolist()}; launches {launches['profile']}; "
          f"phase 14 wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    if raws.shape != (2, 256, 4) or not bool(torch.isfinite(raws).all()) \
            or int(valids.sum()) <= 0:
        fail("profiler: entry()'s step gave no or non-finite blobs")


def study_brains(torch, labels, intensity, work):
    """The study's twelve brains (``STUDY_CONDS`` x ``STUDY_BRAINS``) on
    the 25 um ``labels``: each a seeded Poisson heat map drawn on the
    card, measured by ``vols.measure_labels_metrics`` on the card and
    written as ``--register vol_stats`` writes it
    (``<brain>_vols.csv``); the first brain goes through ``--register
    vol_stats`` itself (its registered images written beside it), and its
    table must equal the direct call's (floats within ``TASK_RTOL``: the
    card's float sums add in no fixed order). Returns the brains' names,
    conditions, table paths, the planted regions, the regions' IDs and
    expected nuclei, and the walls (with the float columns of the CLI's
    table that equal the direct call's bit for bit)."""
    from magellanmapper_torch.io import cli, sitk_io
    from magellanmapper_torch.stats import vols

    dev = torch.device("cuda")
    lab = torch.from_numpy(labels).to(dev).abs()
    ids, counts = torch.unique(lab, return_counts=True)
    ids, counts = ids[1:].cpu().numpy(), counts[1:].cpu().numpy()
    expect = counts * STUDY_NUCLEI_PER_VOXEL
    rng = np.random.default_rng(SEED)
    planted = np.sort(rng.choice(ids[expect >= STUDY_MIN_NUCLEI],
                                 STUDY_PLANTED, replace=False))
    base = (lab != 0).to(torch.float32) * STUDY_NUCLEI_PER_VOXEL
    boost = torch.isin(lab, torch.from_numpy(planted).to(dev))
    rates = {STUDY_CONDS[0]: base,
             STUDY_CONDS[1]: base * torch.where(boost, 1 + STUDY_EFFECT, 1)}
    del lab, boost
    names, conds, paths, walls = [], [], [], {}
    for i in range(2 * STUDY_BRAINS):
        cond = STUDY_CONDS[i // STUDY_BRAINS]
        name = f"{cond}{i % STUDY_BRAINS + 1}"
        gen = torch.Generator(device=dev).manual_seed(SEED + 1 + i)
        heat = torch.poisson(rates[cond], generator=gen).to(
            torch.int32).cpu().numpy()
        img = os.path.join(work, f"{name}.npy")
        t0 = time.perf_counter()
        df = vols.measure_labels_metrics(intensity, labels, heat_map=heat,
                                         device="cuda")
        walls[f"{name}_s"] = time.perf_counter() - t0
        if i == 0:
            sitk_io.write_reg_images({
                "atlasVolume.mhd": sitk_io.MedImage(intensity),
                "annotation.mhd": sitk_io.MedImage(labels),
                "heat.mhd": sitk_io.MedImage(heat)}, img)
            t0 = time.perf_counter()
            got = cli.main(["--img", img, "--register", "vol_stats",
                            "--device", "cuda"])
            walls["vol_stats_cli_s"] = time.perf_counter() - t0
            # float sums on the card add in no fixed order: integers
            # equal, floats within TASK_RTOL
            if not same_table(got, df):
                fail("study: --register vol_stats's table differs from "
                     "measure_labels_metrics on the same images")
            walls["vol_stats_cli_float_cols_bit_equal"] = [
                c for c in df.columns if df[c].dtype.kind == "f"
                and np.array_equal(df[c].to_numpy(), got[c].to_numpy(),
                                   equal_nan=True)]
        else:
            df.to_csv(os.path.join(work, f"{name}_vols.csv"), index=False)
        names.append(name)
        conds.append(cond)
        paths.append(os.path.join(work, f"{name}_vols.csv"))
    del rates, base
    return names, conds, paths, planted, expect, ids, walls


def smoothing_table(labels, work):
    """``smooth_labels(metrics=True)`` on a central crop of ``labels``
    (each axis a quarter) at ``STUDY_FILTER_SIZES``: the aggregated rows,
    written as ``smoothing.csv`` (``config.PATH_SMOOTHING_METRICS``).
    Returns its path and the crop's number of labels."""
    import pandas as pd

    from magellanmapper_torch.atlas import atlas_refiner
    from magellanmapper_torch.settings import config

    crop = tuple(slice(s // 2 - s // 8, s // 2 + s // 8)
                 for s in labels.shape)
    rows = []
    for size in STUDY_FILTER_SIZES:
        smoothed = np.array(labels[crop])
        aggr, _ = atlas_refiner.smooth_labels(smoothed, size, metrics=True,
                                              device="cuda")
        rows.append(aggr)
    path = os.path.join(work, config.PATH_SMOOTHING_METRICS)
    pd.concat(rows, ignore_index=True).to_csv(path, index=False)
    return path, len(np.unique(labels[crop])) - 1


def run_task(walls, name, argv, out=None):
    """``cli.main(argv)`` in this process, its wall in ``walls[name]``;
    fails unless it returns a result and writes ``out`` when given."""
    from magellanmapper_torch.io import cli

    t0 = time.perf_counter()
    res = cli.main(argv)
    walls[name] = time.perf_counter() - t0
    if res is None or (hasattr(res, "__len__") and not len(res)):
        fail(f"study: {name} returned no result")
    if out is not None and not os.path.isfile(out):
        fail(f"study: {name} did not write {out}")
    return res


def study_tables(torch, labels, intensity, vol, work, launches):
    """Phase 15, the study tables: twelve brains' ``vol_stats`` tables
    (:func:`study_brains`), merged, reshaped and normalised by ``--df``
    tasks and summarised by the ``--register`` table tasks through the
    CLI; ``clrstats.meas_group_stats`` over every region by each of
    ``STUDY_MODELS``, the t-test gated on the planted regions; the
    difference image of the conditions' mean density painted on the card
    by ``reg_tasks.build_labels_diff_images`` (held bit for bit against
    the host loop on ``STUDY_LOOP_PLANES`` central planes, and at each
    planted region against the pivoted table); ``load_env``'s probe; and
    ``extract_blocks`` on a float32 memmap against numpy slicing. Prints
    each task's wall and the phase's."""
    import io

    import pandas as pd

    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch.atlas import reg_tasks
    from magellanmapper_torch.cv import stack_detect as sd
    from magellanmapper_torch.io import _blockio, load_env
    from magellanmapper_torch.stats import clrstats, vols

    t_phase = time.perf_counter()
    dev_mod.reset_launches()
    walls = {}
    names, conds, paths, planted, expect, ids, brain_walls = study_brains(
        torch, labels, intensity, work)
    walls["brains_s"] = time.perf_counter() - t_phase
    print(f"study: {len(names)} brains on {labels.shape} labels, "
          f"{len(ids)} regions ({int(np.sum(expect >= STUDY_MIN_NUCLEI))} "
          f"expecting {STUDY_MIN_NUCLEI}+ nuclei), planted "
          f"{planted.tolist()}; " + json.dumps(brain_walls), flush=True)

    # each brain's table with its sample and condition (the study's sample
    # sheet), merged through the entry point
    study_paths = []
    for name, cond, path in zip(names, conds, paths):
        df = pd.read_csv(path)
        df.insert(0, "Condition", cond)
        df.insert(0, "Sample", name)
        study_paths.append(path.replace("_vols.csv", "_study.csv"))
        df.to_csv(study_paths[-1], index=False)
    # the merge runs through the entry point in a fresh interpreter while
    # this one fits the statistics to the same rows concatenated here
    study = os.path.join(work, "study.csv")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "magellanmapper_torch.io.cli", "--df",
         "merge_csvs", *study_paths, "--prefix", study],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        cwd=ROOT)
    # the rows as the merged file will read back (a CSV round trip may
    # move a float's last bit)
    merged = pd.read_csv(io.StringIO(pd.concat(
        [pd.read_csv(p) for p in study_paths],
        ignore_index=True).to_csv(index=False)))
    stats, model_s = {}, {}
    for model in STUDY_MODELS:
        t1 = time.perf_counter()
        stats[model] = clrstats.meas_group_stats(
            merged, "Density", conds=list(STUDY_CONDS), model=model)
        model_s[model] = time.perf_counter() - t1
    _, err = proc.communicate()
    walls["df merge_csvs (python -m, beside the statistics)"] = \
        time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.isfile(study):
        fail(f"study: python -m ... --df merge_csvs exited "
             f"{proc.returncode}: {err[-2000:]}")
    if not pd.read_csv(study).equals(merged):
        fail("study: merge_csvs's table differs from the brains' rows")

    def out(name):
        return os.path.join(work, name)

    df_tasks = (
        ("df append_csvs_cols", ["--df", "append_csvs_cols", *paths,
                                 "--groups", *names, "--prefix",
                                 out("study_wide.csv")], "study_wide.csv"),
        ("df zscore", ["--df", "zscore", study, "--labels",
                       "group_cols=Region", "metric_cols=Density,Nuclei",
                       "--prefix", out("study_z.csv")], "study_z.csv"),
        ("df pivot_table", ["--df", "pivot_table", study, "--labels",
                            "index=Region", "columns=Condition",
                            "values=Density", "--prefix",
                            out("study_piv.csv")], "study_piv.csv"),
        ("df exps_by_region", ["--df", "exps_by_region", study], None),
        ("df divide_cols", ["--df", "divide_cols", out("study_piv.csv"),
                            "--labels", f"col1={STUDY_CONDS[1]}",
                            f"col2={STUDY_CONDS[0]}", "name=Ratio",
                            "--prefix", out("study_ratio.csv")],
         "study_ratio.csv"),
        ("df melt_cols", ["--df", "melt_cols", out("study_piv.csv"),
                          "--labels", "id_cols=Region",
                          "melt_cols=" + ",".join(STUDY_CONDS), "--prefix",
                          out("study_long.csv")], "study_long.csv"),
        ("df replace_vals", ["--df", "replace_vals", out("study_long.csv"),
                             "--labels", f"vals_from={STUDY_CONDS[0]}",
                             "vals_to=ctl", "cols=Group", "--prefix",
                             out("study_ctl.csv")], "study_ctl.csv"),
        ("df normalize", ["--df", "normalize", out("study_ctl.csv"),
                          "--labels", "id_cols=Region", "cond_col=Group",
                          "cond_base=ctl", "metric_cols=Value", "--prefix",
                          out("study_norm.csv")], "study_norm.csv"),
    )
    for name, argv, path in df_tasks:
        run_task(walls, name, argv, path and out(path))
    ratio = pd.read_csv(out("study_ratio.csv")).set_index("Region")["Ratio"]
    norm = pd.read_csv(out("study_norm.csv"))
    norm = norm[norm["Group"] == STUDY_CONDS[1]].set_index("Region")["Value"]
    if not np.array_equal(norm.loc[ratio.index].to_numpy(),
                          ratio.to_numpy()):
        fail("study: normalize's ratios differ from divide_cols'")

    # the statistics' calls, then the --register table tasks
    ttest = stats["ttest"]
    ttest.to_csv(out("study_ttest.csv"), index=False)
    called = ttest[(ttest["Padj"] < STUDY_ALPHA) & (ttest["Effect"] > 0)]
    hits = int(np.isin(planted, called["Region"]).sum())
    others = ttest[~ttest["Region"].isin(planted)]
    false_share = float(np.mean(others["Padj"] < STUDY_ALPHA))
    calls = {m: {"regions": len(t), "planted_called": int(np.isin(
        planted, t[t["Padj"] < STUDY_ALPHA]["Region"]).sum()),
        "others_called": int(np.sum((t["Padj"] < STUDY_ALPHA)
                                    & ~t["Region"].isin(planted))),
        "s": model_s[m]} for m, t in stats.items()}
    print("study: meas_group_stats of Density " + json.dumps(calls),
          flush=True)
    if hits < STUDY_MIN_CALLED or false_share > STUDY_MAX_FALSE:
        fail(f"study: the t-test called {hits} of {STUDY_PLANTED} planted "
             f"regions with a positive effect and {false_share:.4f} of the "
             "others")

    t0 = time.perf_counter()
    smoothing, n_smoothed = smoothing_table(labels, work)
    walls["smoothing table"] = time.perf_counter() - t0
    reg_tasks_ = (
        ("register combine_cols", study, "study.csv_combined.csv"),
        ("register zscores", study, "study_zscores.csv"),
        ("register coefvar", study, None),
        ("register melt_cols", study, "study.csv_melted.csv"),
        ("register pivot_conds", study, "study.csv_pivoted.csv"),
        ("register meas_improvement", out("study_ttest.csv"), None),
        ("register smoothing_peaks", smoothing, None),
    )
    for name, img, path in reg_tasks_:
        res = run_task(walls, name, ["--img", img, "--register",
                                     name.split()[1]], path and out(path))
    print(f"study: smoothing_peaks on smoothing.csv ({n_smoothed} labels, "
          f"filter sizes {list(STUDY_FILTER_SIZES)}): best row "
          f"{json.dumps(res.to_dict())}", flush=True)

    # the conditions' mean density difference painted on the card
    long_df = pd.read_csv(out("study_long.csv"))
    paint_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        painted = reg_tasks.build_labels_diff_images(
            labels, long_df, "Value", cond_col="Group", conds=STUDY_CONDS,
            device="cuda")
        torch.cuda.synchronize()
        paint_ms.append((time.perf_counter() - t0) * 1e3)
    paint_mib = torch.cuda.max_memory_allocated() / 2**20
    t0 = time.perf_counter()
    written = reg_tasks.build_labels_diff_images(
        labels, long_df, "Value", cond_col="Group", conds=STUDY_CONDS,
        out_path=out("study_diff.mhd"), device="cuda")
    write_s = time.perf_counter() - t0
    if not np.array_equal(written, painted):
        fail("study: the difference image changed between calls")
    del written
    piv = pd.read_csv(out("study_piv.csv")).set_index("Region")
    diff = (piv[STUDY_CONDS[1]] - piv[STUDY_CONDS[0]]).dropna()
    table = pd.DataFrame({"Region": diff.index, "Value": diff.values})
    z0 = (labels.shape[0] - STUDY_LOOP_PLANES) // 2
    slab = slice(z0, z0 + STUDY_LOOP_PLANES)
    t0 = time.perf_counter()
    loop = vols.map_meas_to_labels(labels[slab], table, "Value")
    loop_s = time.perf_counter() - t0
    if painted.dtype != loop.dtype or not np.array_equal(
            painted[slab], loop):
        fail("study: the card's difference image differs from the host "
             "loop's")
    lab_t = torch.from_numpy(labels).cuda().abs()
    painted_t = torch.from_numpy(painted).cuda()
    for region in planted:
        vals = painted_t[lab_t == int(region)]
        if not bool((vals == float(diff.loc[region])).all()):
            fail(f"study: region {region}'s painted value is not its "
                 "difference in the pivoted table")
    del lab_t, painted_t
    slab_vox = int(np.prod(loop.shape))
    print("study: build_labels_diff_images of the mean Density "
          + json.dumps({
              "shape": list(labels.shape), "rows": len(table),
              "card_ms": paint_ms, "card_peak_device_mib": paint_mib,
              "card_mvox_per_s": painted.size / min(paint_ms) / 1e3,
              "with_mhd_write_s": write_s,
              "host_loop_planes": STUDY_LOOP_PLANES,
              "host_loop_s": loop_s,
              "host_loop_mvox_per_s": slab_vox / loop_s / 1e6})
          + "; equal to the host loop there and to the pivoted table at "
          "every planted region", flush=True)

    accel = load_env.check_accelerator()
    print(f"study: load_env.check_accelerator() {json.dumps(accel)}",
          flush=True)
    if accel["platform"] != "gpu" or accel["device_count"] < 1:
        fail(f"study: check_accelerator reported {accel}")

    # extract_blocks: the detect slice's first block windows from a float32
    # memmap of the planes they cover, against numpy slicing
    blocks = sd.setup_blocks(sd.roi_profile("lightsheet"), vol.shape,
                             (1.0, 1.0, 1.0))
    shape = np.minimum(blocks.max_pixels + blocks.overlap, vol.shape)
    starts = np.asarray([sd._window_for_block(vol.shape, o, shape)
                         for o in blocks.sub_rois_offsets.reshape(-1, 3)])
    starts = starts[:STUDY_EXTRACT_BLOCKS]
    depth = int(starts[:, 0].max() + shape[0])
    mm_path = out("slab_f32.npy")
    mm = np.lib.format.open_memmap(mm_path, "w+", np.float32,
                                   (depth,) + vol.shape[1:])
    mm[:] = vol[:depth]
    mm.flush()
    del mm
    t0 = time.perf_counter()
    _blockio.library()
    walls["blockio build"] = time.perf_counter() - t0
    ways = {
        "extract_blocks": lambda mm: _blockio.extract_blocks(
            mm, starts, shape),
        "numpy": lambda mm: np.stack([
            mm[z:z + shape[0], y:y + shape[1], x:x + shape[2]]
            for z, y, x in starts])}
    rates, got = {name: [] for name in ways}, {}
    for _ in range(2):
        for name, fn in ways.items():
            # a fresh mapping each time: each pays its own page faults
            mm = np.load(mm_path, mmap_mode="r")
            t0 = time.perf_counter()
            got[name] = fn(mm)
            rates[name].append(got[name].nbytes / 1e6
                               / (time.perf_counter() - t0))
            del mm
    print(f"study: {len(starts)} windows of "
          f"{tuple(int(v) for v in shape)} from a float32 memmap (MB/s, "
          f"two turns): {json.dumps(rates)}", flush=True)
    if got["extract_blocks"].dtype != got["numpy"].dtype or \
            not np.array_equal(got["extract_blocks"], got["numpy"]):
        fail("study: extract_blocks differs from numpy slicing")
    del got
    os.remove(mm_path)

    launches["stats"] = dict(dev_mod.LAUNCHES)
    print("study: not run on the card (matplotlib absent there): "
          "--register plot_region_dev, plot_lateral_unlabeled, "
          "plot_intens_nuc, plot_cluster_blobs and clrstats.plot_volcano; "
          f"launches {launches['stats']}; task walls {json.dumps(walls)}; "
          f"phase 15 wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def suite_main() -> None:
    """``--gauntlet-suite``: the reference's suite on the card alone."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not os.path.isdir(os.path.join(ROOT, "magellanmapper_torch")):
        fail(f"run from a checkout of the repository ({ROOT} has no "
             "magellanmapper_torch package)")
    sys.path.insert(0, ROOT)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}", flush=True)
    gauntlet_suite(SUITE_SEEDS, SUITE_TRUNCATED)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def study_main() -> None:
    """``--study-tables``: phase 15 alone, on the labels of the seed-0
    pair at 25 um and the detect slice's volume."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, ROOT)
    from magellanmapper_torch import testing
    from magellanmapper_torch.atlas import gauntlet

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {smi}", flush=True)
    pair = gauntlet.build_pair(REG_SHAPE, seed=SEED, device="cuda")
    labels, intensity = ccf25_labels(torch, pair)
    del pair
    vol, _ = testing.make_nuclei_volume(SLICE_SHAPE, SEED)
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    launches = {}
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        study_tables(torch, labels, intensity, vol, tmp, launches)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not os.path.isdir(os.path.join(ROOT, "magellanmapper_torch")):
        fail(f"run from a checkout of the repository ({ROOT} has no "
             "magellanmapper_torch package)")
    sys.path.insert(0, ROOT)
    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch import testing
    from magellanmapper_torch.cv import stack_detect as sd
    from magellanmapper_torch.io import cli
    from magellanmapper_torch.io import _tiffcodec
    from magellanmapper_torch.kernels import _build
    from magellanmapper_torch.cv import detector
    from magellanmapper_torch.kernels import (
        extract_candidates as k2, peak_candidates as k1,
        prune_overlap as k3, tile_percentiles as k4)

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}", flush=True)

    # 2. build
    _build.library()
    print(f"build: {_build.build_seconds:.1f} s", flush=True)
    t0 = time.perf_counter()
    tiffcodec = _tiffcodec.library()
    print(f"build: TIFF decoders {tiffcodec._name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_log.splitlines():
        if any(k in line for k in ("registers", "Compiling entry", "spill")):
            print("  ptxas:", line.strip(), flush=True)

    prof = sd.roi_profile("lightsheet")
    t0 = time.perf_counter()
    vol, centres = testing.make_nuclei_volume(SLICE_SHAPE, SEED)
    print(f"volume {vol.shape} {vol.dtype}, {len(centres)} planted nuclei, "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    grid_roi, grid_centres = testing.make_grid_roi(GRID_SHAPE, SEED)
    grid_sigmas = tuple(float(s) for s in detector.sigma_list(3, 4, 10))
    print(f"grid ROI {grid_roi.shape} {grid_roi.dtype}, "
          f"{len(grid_centres)} planted nuclei", flush=True)

    # 3. kernels against their plain versions
    mods = {"peak_candidates": k1, "extract_candidates": k2,
            "prune_overlap": k3, "tile_percentiles": k4}
    results = {name: {"name": name, "route": "cuda", "source": m.SOURCE,
                      "replaces": m.REPLACES} for name, m in mods.items()}
    dev = torch.device("cuda")
    params, block, cube, ragged = block_inputs(torch, prof, vol, dev)
    check_k4(torch, params, block, results, dev)
    check_k1(torch, cube, ragged, params.threshold, results, dev)
    check_k3(torch, cube, params, results, dev)
    del block, cube, ragged
    check_k2(torch, grid_roi, grid_sigmas, results, torch.device("cuda"))
    torch.cuda.empty_cache()

    # 4. the detect slice through the port's CLI
    launches = {}
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        path = os.path.join(tmp, "nuclei.npy")
        np.save(path, vol)  # no metadata: the CLI takes 1 um spacing
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dev_mod.reset_launches()
        t0 = time.perf_counter()
        blobs = cli.main(["--img", path, "--proc", "detect",
                          "--roi_profile", "lightsheet", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["detect"] = dict(dev_mod.LAUNCHES)
        peak_mem = torch.cuda.max_memory_allocated()
        with np.load(os.path.join(tmp, "nuclei_blobs.npz")) as archive:
            saved = archive["segments"]
        with open(os.path.join(
                tmp, "nuclei_stack_detection_times.csv")) as f:
            times = {k: float(v) for k, v in next(csv.DictReader(f)).items()}
    print(f"slice: launches {launches['detect']}", flush=True)
    if dev_mod.TF32_SCOPES["band_products"]:
        fail("slice: the float32 route ran band products with TF32")
    for name in ("peak_candidates", "prune_overlap", "tile_percentiles"):
        if launches["detect"][name] <= 0:
            fail(f"kernel {name} was not launched by the slice")
    det = blobs.blobs
    if det is None or det.ndim != 2 or det.shape[1] != 10:
        fail(f"unexpected blob array {None if det is None else det.shape}")
    if not np.all(np.isfinite(det)):
        fail("non-finite blob values")
    if saved is None or not np.array_equal(saved, det):
        fail("blobs.npz differs from the returned blobs")
    sens, ppv = testing.sens_ppv(
        det, centres, SLICE_SHAPE, VERIFY_TILE, VERIFY_TOL)
    mvox = np.prod(SLICE_SHAPE) / 1e6 / wall
    print(f"slice: {len(det)} blobs for {len(centres)} nuclei; "
          f"sensitivity {sens:.4f} PPV {ppv:.4f}", flush=True)
    print(f"slice: wall {wall:.3f} s = {mvox:.2f} Mvox/s end to end; "
          + ", ".join(f"{k} {times[k]:.3f} s" for k in (
              "Detection", "Pruning", "Stage_h2d", "Pull_wait",
              "Gather_host"))
          + f"; h2d {int(times['h2d_bytes'])} B; peak device memory "
          f"{peak_mem / 2**20:.1f} MiB", flush=True)
    if not (sens > 0.85 and ppv > 0.7):
        fail(f"detection quality below the bars: sens {sens} ppv {ppv}")
    fp32 = {"blobs": det, "sens": sens, "ppv": ppv, "mvox": mvox}

    crop = np.ascontiguousarray(vol[:CROP[0], :CROP[1], :CROP[2]])
    t0 = time.perf_counter()
    on_card, _ = sd.detect_blobs_blocks(
        crop, prof, (1.0, 1.0, 1.0), device="cuda")
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu, _ = sd.detect_blobs_blocks(
        crop, prof, (1.0, 1.0, 1.0), device="cpu")
    t_cpu = time.perf_counter() - t0
    print(f"crop {CROP}: {0 if on_card is None else len(on_card)} blobs on "
          f"the card ({t_card:.2f} s), "
          f"{0 if on_cpu is None else len(on_cpu)} on the CPU "
          f"({t_cpu:.2f} s)", flush=True)
    if not testing.rows_equal(on_card, on_cpu):
        fail("the crop's blobs on the card differ from the CPU's")
    det_crop = np.ascontiguousarray(vol[:DETECT_CROP[0], :DETECT_CROP[1],
                                        :DETECT_CROP[2]])
    coloc_work = tempfile.TemporaryDirectory(dir=work)
    coloc, coloc_truth = coloc_volume(vol, centres, coloc_work.name)

    # 5. the grid search through the port's CLI, its crop, the tap route
    os.makedirs(work, exist_ok=True)
    grid_df = grid_search_path(torch, grid_roi, grid_centres, work, results,
                               launches)
    check_taps(torch, grid_sigmas)
    torch.cuda.empty_cache()

    # 6. the specimen chain (its register step is the registration task
    # through the CLI), vol_stats at the 25 um atlas's size, the gauntlet,
    # the register crop
    from magellanmapper_torch.atlas import gauntlet
    t0 = time.perf_counter()
    pair = gauntlet.build_pair(REG_SHAPE, seed=SEED, device="cuda")
    print(f"gauntlet pair {REG_SHAPE}: built in "
          f"{time.perf_counter() - t0:.1f} s; ground-truth displacement "
          f"{json.dumps(pair['gt']['disp_stats'])}", flush=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        spec_blobs, spec = specimen_chain(torch, pair, tmp, launches)
    # phase 10's scene: the specimen with its nuclei at a random z phase
    # a column (so the detector's near-max does not hang on the depth)
    # and no noise, each tile adding its own
    scene, scene_centres = testing.make_specimen(
        pair, SPEC_FACTOR, SEED, "cuda", z_lattice=False, noise=0.0)
    torch.cuda.empty_cache()
    ccf25 = vol_stats_25um(torch, pair, spec_blobs)
    torch.cuda.empty_cache()
    gauntlet_suite((SEED,), None)
    register_crop()
    register_crop(truncated=True)

    # 7. detect_blobs, card against CPU
    detect_blobs_crop(torch, det_crop, launches)

    # 8. atlas construction: groupwise registration, stage checkpoints,
    # atlas import and edge-aware reannotation at the 25 um atlas's size
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        groupwise_path(torch, pair, tmp, launches)
    torch.cuda.empty_cache()
    groupwise_crop()
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        resume_path(torch, tmp)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        atlas, labels = atlas_path(torch, pair, tmp, launches)
    del pair
    torch.cuda.empty_cache()
    atlas_crop(atlas, labels)
    del atlas

    # 9. blob analysis: colocalization, the classifier and clustering on
    # the two-channel volume
    blob_analysis(torch, coloc, coloc_truth, coloc_work.name, launches)
    torch.cuda.empty_cache()

    # 10. acquisition: the specimen as tiles, stitched, transformed and
    # detected by run_pipeline; import and export of TIFF files
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        acquisition_path(torch, spec, scene, scene_centres, tmp, launches)
    del scene
    torch.cuda.empty_cache()

    # 11. visualisation: the specimen rendered by every engine, its orbit,
    # the two-channel volume, deconvolution, the plane and ROI exports
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        render_path(torch, spec, spec_blobs, coloc, tmp, launches, smi)
    coloc_work.cleanup()
    del spec
    torch.cuda.empty_cache()

    # 12. the fast LoG route on the detect slice and the grid sweep, the
    # random walker and the watersheds, the atlas-register tasks
    phase12(torch, vol, centres, fp32, grid_roi, grid_centres, grid_df,
            labels, work, launches)
    del grid_roi, labels

    # 13. vendor import: the slice as CZI, LIF and IMS files through
    # --proc import_only, then --proc detect on the CZI's import
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        vendor_path(torch, vol, centres, fp32, tmp, launches)
    # 14. the profiler: one detect block traced, entry()'s step
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        profiler_path(torch, vol, tmp, launches)
    # 15. the study tables: twelve brains' region tables on phase 6's
    # 25 um labels through --df and the --register table tasks, the group
    # statistics, the difference image painted on the card
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        study_tables(torch, *ccf25, vol, tmp, launches)
    del vol, ccf25

    for name in results:
        n = sum(path[name] for path in launches.values())
        if n <= 0:
            fail(f"kernel {name} was launched on no path")
        results[name]["launches"] = n
        results[name]["launches_by_path"] = {
            path: counts[name] for path, counts in launches.items()}
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "magellanmapper_tpu"))
    if loaded:
        fail(f"the port must run without jax and the reference package, "
             f"but these were imported: {loaded[:10]}")

    # results
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--k4-times", action="store_true",
                        help="time K4 alone instead of the smoke run")
    parser.add_argument("--root", default=ROOT,
                        help="checkout whose K4 --k4-times times")
    parser.add_argument("--gauntlet-suite", action="store_true",
                        help="run the reference's gauntlet suite instead")
    parser.add_argument("--study-tables", action="store_true",
                        help="run phase 15, the study tables, alone")
    args = parser.parse_args()
    if args.k4_times:
        k4_times(args.root)
    elif args.gauntlet_suite:
        suite_main()
    elif args.study_tables:
        study_main()
    else:
        main()
