#!/usr/bin/env python3
"""The acquisition path alone: tile stitching of the specimen, its error
by pair, and detection on the fused volume.

Run from the root of a checkout: ``python3 tools/profile_acquisition.py
[--device cuda|cpu] [--factor 4] [--shift 6] [--z-lattice]
[--specimen-noise 0] [--tile-noise 15] [--no-phase10]``. On the card it
prints the card's name and power limit (``nvidia-smi``) first. Then, on
a specimen of the gauntlet pair (``testing.make_specimen`` at
``--factor`` times the pair's (160, 240, 200), 4 being the smoke run's
(640, 960, 800); its nuclei at a random z phase a column, or on a z
lattice with ``--z-lattice``; noise of ``--specimen-noise`` counts) cut
into the smoke run's 3 x 3 tile set (``testing.make_tiles``, y/x offsets
within +-``--shift``, each tile ``--tile-noise`` counts of its own
noise). The defaults are phase 10's scene and tiles; ``--z-lattice
--specimen-noise 15 --tile-noise 10`` are phase 6's specimen with the
tile noise of ``testing.TILE_NOISE``:

0. ``specimen``: the near-max the detector samples (the 99.5th
   percentile of every ``Z // 16``-th plane) at the volume's depth and
   at 1 and 3 planes less, and detection on the volume itself
   (``lightsheet``, phase 6's sensitivity and PPV);
1. ``pairs``: each adjacent pair's planted offset against the one the
   reference's phase correlation of whole tiles measures
   (``stitcher.phase_shifts``), with its score, and against the port's
   (``stitcher.compute_pairwise_shifts``: the same peak refined by the
   overlap's cross-correlation), then each tile's error after the global
   optimisation of either, and the walls of both;
2. ``fused at the planted positions``: the tiles fused where they were
   cut, detected with ``lightsheet``: blobs, sensitivity and PPV against
   the planted nuclei more than ``chip_smoke.ACQ_EDGE`` voxels inside the
   tiles and under every tile, blobs and nuclei by depth from the
   uncovered voxels (``chip_smoke.fused_detection``), and the near-max
   the detector samples beside the specimen's own; then the same with
   the uncovered voxels filled from the specimen and a tile's noise,
   which leaves the zero border out and nothing else;
3. on the card, unless ``--no-phase10``, ``chip_smoke.py``'s phase 10
   on the specimen (``acquisition_path``: the same lines, walls and
   gates as the smoke run's, with tiles of phase 10's noise whatever
   the flags, and its TIFF round trips on this specimen).

``--device cpu --factor 2 --shift 3`` rehearses 1-2 at half scale on the
CPU (a few minutes).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def near_max(vol) -> float:
    """The detector's near-max: the 99.5th percentile of every
    ``Z // 16``-th plane (``stack_detect.detect_blobs_blocks``)."""
    return float(np.percentile(vol[::max(1, vol.shape[0] // 16)], 99.5))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("--factor", type=int, default=4,
                        help="the specimen's upsampling of the pair")
    parser.add_argument("--shift", type=int, default=6,
                        help="largest planted y/x offset of a tile")
    parser.add_argument("--z-lattice", action="store_true",
                        help="nuclei on phase 6's z lattice")
    parser.add_argument("--specimen-noise", type=float, default=0.0,
                        help="the specimen's noise, in counts")
    parser.add_argument("--tile-noise", type=float, default=15.0,
                        help="each tile's own noise, in counts")
    parser.add_argument("--no-phase10", action="store_true",
                        help="leave out the smoke run's phase 10")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from magellanmapper_torch import testing
    from magellanmapper_torch.atlas import gauntlet
    from magellanmapper_torch.cv import stack_detect
    from magellanmapper_torch.settings.roi_prof import ROIProfile
    from magellanmapper_torch.stitch import stitcher

    on_card = args.device == "cuda"
    if on_card:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    pair = gauntlet.build_pair(chip_smoke.REG_SHAPE, seed=chip_smoke.SEED,
                               device=args.device)
    vol, centres = testing.make_specimen(
        pair, args.factor, chip_smoke.SEED, args.device,
        z_lattice=args.z_lattice, noise=args.specimen_noise)
    del pair
    prof = ROIProfile()
    prof.add_profiles("lightsheet")

    # 0. specimen
    t0 = time.perf_counter()
    blobs, _ = stack_detect.detect_blobs_stack(vol, prof, (1.0, 1.0, 1.0),
                                               device=args.device)
    t_det = time.perf_counter() - t0
    sens, ppv = testing.sens_ppv(
        blobs.blobs, centres, vol.shape,
        (vol.shape[0],) + chip_smoke.SPEC_TILE_YX, chip_smoke.VERIFY_TOL)
    print(f"specimen: near-max {near_max(vol)}, {near_max(vol[1:])} and "
          f"{near_max(vol[3:])} at 1 and 3 planes less; detection "
          f"{t_det:.2f} s, {len(blobs.blobs)} blobs for {len(centres)} "
          f"nuclei, sensitivity {sens:.4f} PPV {ppv:.4f}", flush=True)
    del blobs
    tiles, planted = testing.make_tiles(
        vol, *chip_smoke.ACQ_GRID, chip_smoke.ACQ_OVERLAP, chip_smoke.SEED,
        max_shift=args.shift, noise=args.tile_noise, device=args.device)
    print(f"specimen {vol.shape}, {len(centres)} nuclei, tiles "
          f"{tiles[0].shape}, made in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 1. pairs
    grid = stitcher.TileGrid(*chip_smoke.ACQ_GRID, tiles[0].shape,
                             chip_smoke.ACQ_OVERLAP)
    walls = {}
    results = {}
    for name, fn in (("phase", stitcher.phase_shifts),
                     ("refined", stitcher.compute_pairwise_shifts)):
        t0 = time.perf_counter()
        results[name] = fn(tiles, grid, args.device)
        walls[name] = time.perf_counter() - t0
    print(f"pairs: {len(results['phase'])} pairs, the reference's phase "
          f"correlation {walls['phase']:.3f} s, refined by the overlap's "
          f"cross-correlation {walls['refined']:.3f} s", flush=True)
    for (i, j, d_ph, score), (_, _, d_ij, _) in zip(results["phase"],
                                                    results["refined"]):
        want = planted[j] - planted[i]
        print(f"  {i}-{j}: planted {want.tolist()}, phase "
              f"{np.round(d_ph, 3).tolist()} (error "
              f"{np.abs(d_ph - want).max():.3f}, score {score:.3g}), "
              f"refined {np.round(d_ij, 3).tolist()} (error "
              f"{np.abs(d_ij - want).max():.3f})", flush=True)
    for name, pairs in results.items():
        positions = stitcher.globally_optimize(pairs, len(tiles),
                                               grid.nominal_positions())
        err = np.abs((positions - positions[0]) - (planted - planted[0]))
        print(f"pairs: {name}: tile errors after the optimisation "
              f"{np.round(err.max(axis=1), 3).tolist()}", flush=True)

    # 2. fused at the planted positions
    at = planted.astype(float)
    fused = stitcher.fuse_tiles(tiles, at, device=args.device)
    ipos, extent = stitcher.fuse_layout(tiles, at)
    t0 = time.perf_counter()
    blobs, _ = stack_detect.detect_blobs_stack(fused, prof, (1.0, 1.0, 1.0),
                                               device=args.device)
    t_det = time.perf_counter() - t0
    cover = chip_smoke.coverage(torch, tiles, ipos, extent, args.device)
    quality = chip_smoke.fused_detection(
        torch, blobs.blobs, centres, cover, planted[0] - ipos[0], vol.shape)
    print(f"fused at the planted positions: {extent}, detection "
          f"{t_det:.2f} s, {json.dumps(quality)}; near-max "
          f"{near_max(fused)} (specimen {near_max(vol)})", flush=True)
    # the same volume with its uncovered voxels filled from the specimen
    # and a tile's noise, as if a tile had imaged them: the border alone
    origin = planted[0] - ipos[0]
    under = torch.from_numpy(vol[tuple(
        slice(o, o + n) for o, n in zip(origin, extent))].astype(
            np.float32)).to(cover.device)
    under += torch.empty_like(under).normal_(0.0, args.tile_noise)
    filled = torch.where(cover == 0, under, torch.from_numpy(fused).to(
        cover.device)).cpu().numpy()
    del fused, under
    blobs, _ = stack_detect.detect_blobs_stack(
        filled, prof, (1.0, 1.0, 1.0), device=args.device)
    quality = chip_smoke.fused_detection(
        torch, blobs.blobs, centres, cover, origin, vol.shape)
    print(f"fused with the uncovered voxels filled: "
          f"{json.dumps(quality)}", flush=True)
    del filled, cover

    # 3. phase 10
    if on_card and not args.no_phase10:
        work = os.path.join(ROOT, "build", "smoke")
        os.makedirs(work, exist_ok=True)
        launches = {}
        with tempfile.TemporaryDirectory(dir=work) as tmp:
            chip_smoke.acquisition_path(torch, vol, vol, centres, tmp,
                                        launches)
        print("phase 10 done", flush=True)


if __name__ == "__main__":
    main()
