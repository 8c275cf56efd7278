#!/usr/bin/env python3
"""Where the time of the port's 3D rendering goes, on one CUDA card.

Run from the root of a checkout: ``python3 tools/profile_render.py
[--top 12] [--reps 3] [--no-phase11]``. It prints the card's name and
power limit (``nvidia-smi``), makes phase 6's specimen (the gauntlet
pair's fixed image upsampled 4 times to (640, 960, 800), nuclei planted
in its brain, ``testing.make_specimen``) and detects its blobs
(``lightsheet``), puts it on the card as float32, then:

1. ``engine``: one JSON line an engine of ``chip_smoke.py``'s phase 11
   (the gather volume renderer at 256 steps, flat and shaded, the gather
   isosurface at the specimen's Otsu level, shear-warp's composite, MIP
   and isosurface), each for one 512^2 frame at each of phase 11's poses:
   ms a frame by CUDA events (the mean of ``--reps`` frames after a
   warm-up), peak device memory, and under ``torch.profiler`` the frame's
   wall, the union of its device activities and that union's share of the
   wall (the busy share, as ``tools/profile_slice.py`` takes it), and the
   ``--top`` device operations by self device time;
2. unless ``--no-phase11``, phase 11 itself on the same specimen and its
   blobs (``chip_smoke.render_path``: the same lines and gates as the
   smoke run's, with phase 9's two-channel volume made here by
   ``chip_smoke.coloc_volume``).
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--top", type=int, default=12,
                        help="device operations to print an engine")
    parser.add_argument("--reps", type=int, default=3,
                        help="timed frames a pose after the warm-up")
    parser.add_argument("--no-phase11", action="store_true",
                        help="leave out the smoke run's phase 11")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from profile_slice import device_intervals, union_us
    from magellanmapper_torch import testing
    from magellanmapper_torch.atlas import gauntlet
    from magellanmapper_torch.cv import stack_detect
    from magellanmapper_torch.kernels import _build
    from magellanmapper_torch.ops import preproc, render3d
    from magellanmapper_torch.settings.roi_prof import ROIProfile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    if not torch.cuda.is_available():
        sys.exit("profile_render: no CUDA card")
    _build.library()
    t0 = time.perf_counter()
    pair = gauntlet.build_pair(chip_smoke.REG_SHAPE, seed=chip_smoke.SEED,
                               device="cuda")
    spec, _ = testing.make_specimen(pair, chip_smoke.SPEC_FACTOR,
                                    chip_smoke.SEED, "cuda")
    del pair
    prof = ROIProfile()
    prof.add_profiles("lightsheet")
    blobs = stack_detect.detect_blobs_stack(spec, prof, (1.0, 1.0, 1.0),
                                            device="cuda")[0].blobs
    vol = (torch.from_numpy(spec.view(np.int16)).cuda().to(torch.int32)
           & 0xFFFF).to(torch.float32)
    level = float(preproc.otsu_threshold(vol))
    window = (level, float(torch.amax(vol)))
    print(f"specimen {spec.shape}, {len(blobs)} blobs, made and detected in "
          f"{time.perf_counter() - t0:.1f} s; Otsu level {level}, window "
          f"{window}", flush=True)

    engines = chip_smoke.render_engines(render3d, window, level,
                                        chip_smoke.RENDER_HW,
                                        chip_smoke.RENDER_STEPS)
    for name, fn in engines.items():
        fn(vol, *chip_smoke.RENDER_POSES[0], "cuda")
        poses = []
        for az, el in chip_smoke.RENDER_POSES:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = chip_smoke.cuda_ms(torch, lambda: fn(vol, az, el, "cuda"),
                                    reps=args.reps)
            peak = torch.cuda.max_memory_allocated() / 2**20
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as trace:
                t0 = time.perf_counter()
                fn(vol, az, el, "cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            busy = union_us(device_intervals(trace)) / 1e3
            poses.append({"pose": [az, el], "ms": ms, "peak_mib": peak,
                          "profiled_wall_ms": wall * 1e3,
                          "device_busy_ms": busy,
                          "busy_share": busy / (wall * 1e3)})
            rows = trace.key_averages()
        top = [{"name": r.key[:60], "calls": r.count,
                "self_device_ms": r.self_device_time_total / 1e3}
               for r in sorted(rows, key=lambda r: -r.self_device_time_total)
               [:args.top]]
        print("engine: " + json.dumps({
            "card": smi, "engine": name, "hw": list(chip_smoke.RENDER_HW),
            "poses": poses,
            "ms_mean": float(np.mean([p["ms"] for p in poses])),
            "top_device_last_pose": top}), flush=True)
    del vol
    torch.cuda.empty_cache()

    if not args.no_phase11:
        work = os.path.join(ROOT, "build", "smoke")
        os.makedirs(work, exist_ok=True)
        nuclei, centres = testing.make_nuclei_volume(chip_smoke.SLICE_SHAPE,
                                                     chip_smoke.SEED)
        with tempfile.TemporaryDirectory(dir=work) as tmp:
            coloc, _ = chip_smoke.coloc_volume(nuclei, centres, tmp)
            del nuclei
            chip_smoke.render_path(torch, spec, blobs, coloc, tmp, {}, smi)
        print("phase 11 done", flush=True)


if __name__ == "__main__":
    main()
