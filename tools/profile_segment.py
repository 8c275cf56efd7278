#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` alone, on one CUDA card.

Run from the root of a checkout: ``python3 tools/profile_segment.py``. It
prints the card's name and power limit (``nvidia-smi``), builds the
kernels, then makes the inputs phase 12 takes from the earlier phases:
phase 4's seeded (256, 1024, 1024) volume of planted nuclei detected by
``--proc detect --roi_profile lightsheet`` (the float32 route: its blobs,
sensitivity, PPV and Mvox/s, and its launches), phase 5's (64, 512, 512)
``4xnuc``/``gridtest`` sweep (``chip_smoke.grid_search_path``) and labels
at the 25 um atlas's (528, 320, 456) (``testing.make_atlas`` of the
gauntlet pair, not imported: one side, planes cut); and runs
``chip_smoke.phase12`` on them: the same lines and gates as the smoke
run's. A call takes about as long as phase 12 plus a minute.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as smoke
    from magellanmapper_torch import device as dev_mod
    from magellanmapper_torch import testing
    from magellanmapper_torch.atlas import gauntlet
    from magellanmapper_torch.io import cli
    from magellanmapper_torch.kernels import _build

    if not torch.cuda.is_available():
        smoke.fail("this tool needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    _build.library()
    vol, centres = testing.make_nuclei_volume(smoke.SLICE_SHAPE, smoke.SEED)
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    launches = {}
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        path = os.path.join(tmp, "nuclei.npy")
        np.save(path, vol)
        dev_mod.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blobs = cli.main(["--img", path, "--proc", "detect",
                          "--roi_profile", "lightsheet", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["detect"] = dict(dev_mod.LAUNCHES)
    sens, ppv = testing.sens_ppv(blobs.blobs, centres, smoke.SLICE_SHAPE,
                                 smoke.VERIFY_TILE, smoke.VERIFY_TOL)
    fp32 = {"blobs": blobs.blobs, "sens": sens, "ppv": ppv,
            "mvox": np.prod(smoke.SLICE_SHAPE) / 1e6 / wall}
    print(f"float32 slice: {len(blobs.blobs)} blobs, sensitivity "
          f"{sens:.4f} PPV {ppv:.4f}, {fp32['mvox']:.2f} Mvox/s; launches "
          f"{launches['detect']}", flush=True)
    grid_roi, grid_centres = testing.make_grid_roi(smoke.GRID_SHAPE,
                                                   smoke.SEED)
    grid_df = smoke.grid_search_path(torch, grid_roi, grid_centres, work,
                                     {}, launches)
    pair = gauntlet.build_pair(smoke.REG_SHAPE, seed=smoke.SEED,
                               device="cuda")
    labels = testing.make_atlas(pair, smoke.CCF25_SHAPE, smoke.CCF25_SPLIT,
                                smoke.ATLAS_CUT_PLANES,
                                device="cuda")["labels"]
    del pair
    torch.cuda.empty_cache()
    smoke.phase12(torch, vol, centres, fp32, grid_roi, grid_centres,
                  grid_df, labels, work, launches)


if __name__ == "__main__":
    main()
