#!/usr/bin/env python3
"""Where the time of the port's block detection goes, on one CUDA card.

Run from the root of a checkout: ``python3 tools/profile_slice.py
[--blocks 24] [--top 25] [--fast] [--turns N]``. It makes
``chip_smoke.py``'s seeded (256, 1024, 1024) planted-nuclei volume with
the ``lightsheet`` profile (``--fast``: with ``log_dtype: bfloat16``, the
fast LoG route) and prints, one JSON object a line:

1. the card's name, power limit and SM clock (``nvidia-smi``);
2. ``stages``: CUDA events between the stages of the per-block step for
   the first ``--blocks`` blocks of the grid, staged resident:
   preprocessing (K4 inside), the LoG pyramid, ``find_peaks`` (K1 and
   selection, with its count sync), the overlap prune (K3) and the pull
   of the rows to the host, in ms per block, and the wall per block.
   Each stage's events also span the host's launch gaps inside it;
3. ``run``: one whole ``detect_blobs_blocks`` run on the card under
   ``torch.profiler`` (after one warm-up run): its wall seconds and stage
   timings, the union of device-activity intervals (kernels and memcpys)
   and that union over the wall, the device's busy share;
4. ``top``: the ``--top`` rows of device time by kernel or memcpy name,
   with their call counts;
5. with ``--turns N``, ``turns``: the wall of ``N`` pairs of unprofiled
   runs of the float32 and the fast route in turns (float32, fast, fast,
   float32, ...), so the two routes are compared in one process.

The profiler slows the host, so the profiled run's wall is longer than
an unprofiled one; read the busy share as a lower bound.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (256, 1024, 1024)
RES = (1.0, 1.0, 1.0)


def device_intervals(prof):
    """``(name, start_us, end_us)`` of every device activity the profiler
    recorded (kernels, memcpys, memsets)."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        if ev.name.startswith("Activity Buffer"):
            continue  # the profiler's own buffer bookkeeping
        out.append((ev.name, ev.time_range.start, ev.time_range.end))
    return out


def union_us(intervals) -> float:
    total, end = 0.0, -np.inf
    for _, s, e in sorted(intervals, key=lambda t: t[1]):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def stage_split(torch, sd, filters, peaks, vol, prof, n_blocks):
    """ms per block of each stage of the device step (CUDA events)."""
    dev = torch.device("cuda")
    blocks = sd.setup_blocks(prof, vol.shape, RES)
    block_shape = np.minimum(blocks.max_pixels + blocks.overlap, vol.shape)
    params = sd.step_params(
        prof, blocks, block_shape, RES,
        float(np.percentile(vol[::max(1, vol.shape[0] // 16)], 99.5)))
    bz, by, bx = (int(v) for v in block_shape)
    staged = torch.from_numpy(vol).to(dev)
    coords = list(np.ndindex(*blocks.sub_roi_slices.shape))[:n_blocks]
    names = ("preprocess", "log_pyramid", "find_peaks", "prune", "pull")
    totals = dict.fromkeys(names, 0.0)

    def one_block(coord, record):
        z, y, x = (int(v) for v in sd._window_for_block(
            vol.shape, blocks.sub_rois_offsets[coord], block_shape))
        block = staged[z:z + bz, y:y + by, x:x + bx]
        record(0)
        pre = sd.preprocess_block(
            block, params.denoise_shape, params.preproc_items)
        record(1)
        cube = filters.log_pyramid(
            pre, params.sigmas,
            precision=filters.FAST_PRECISION if params.fast else None)
        record(2)
        coords4, _, count = peaks.find_peaks(
            cube, params.threshold, params.capacity)
        record(3)
        valid = torch.arange(params.capacity, device=dev) < count
        sig = filters.sigma_tensor(params.sigmas, dev)[coords4[:, 0].long()]
        pos = coords4[:, 1:].to(torch.float32).contiguous()
        valid = peaks.prune_overlapping_blobs(
            pos, sig, valid, params.overlap)
        record(4)
        torch.cat([pos, sig[:, None]], dim=1)[valid].cpu()
        record(5)

    one_block(coords[0], lambda i: None)  # warm-up
    torch.cuda.synchronize()
    wall0 = time.perf_counter()
    for coord in coords:
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        one_block(coord, lambda i: evs[i].record())
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            totals[name] += evs[i].elapsed_time(evs[i + 1])
    wall = time.perf_counter() - wall0
    n = len(coords)
    return {"blocks": n,
            "ms_per_block": {k: round(v / n, 4) for k, v in totals.items()},
            "wall_ms_per_block": round(wall * 1e3 / n, 4)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--blocks", type=int, default=24)
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--fast", action="store_true",
                        help="profile the fast LoG route")
    parser.add_argument("--turns", type=int, default=0,
                        help="pairs of unprofiled runs of both routes")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_slice: needs a CUDA card")
    sys.path.insert(0, ROOT)
    from magellanmapper_torch import testing
    from magellanmapper_torch.cv import stack_detect as sd
    from magellanmapper_torch.ops import filters, peaks

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    prof = sd.roi_profile("lightsheet")
    fast = sd.roi_profile("lightsheet")
    fast["log_dtype"] = "bfloat16"
    if args.fast:
        prof = fast
    vol, _ = testing.make_nuclei_volume(SHAPE, seed=0)

    print(json.dumps({"stages": stage_split(
        torch, sd, filters, peaks, vol, prof, args.blocks)}), flush=True)

    sd.detect_blobs_blocks(vol, prof, RES, device="cuda")  # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        _, timing = sd.detect_blobs_blocks(vol, prof, RES, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    intervals = device_intervals(p)
    if not intervals:
        sys.exit("profile_slice: the profiler recorded no device activity")
    busy = union_us(intervals) / 1e6
    print(json.dumps({"run": {
        "wall_s": wall, "timing": timing, "device_busy_s": busy,
        "device_busy_share": busy / wall,
        "device_activities": len(intervals)}}), flush=True)

    by_name = {}
    for name, s, e in intervals:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (e - s) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    print(json.dumps({"top": [
        {"name": name[:120], "ms": round(ms, 3), "calls": n}
        for name, (ms, n) in top]}), flush=True)

    walls = {"fp32": [], "fast": []}
    for i in range(2 * args.turns):
        route = ("fp32", "fast", "fast", "fp32")[i % 4]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sd.detect_blobs_blocks(
            vol, fast if route == "fast" else sd.roi_profile("lightsheet"),
            RES, device="cuda")
        torch.cuda.synchronize()
        walls[route].append(round(time.perf_counter() - t0, 4))
    if args.turns:
        print(json.dumps({"turns": walls}), flush=True)


if __name__ == "__main__":
    main()
