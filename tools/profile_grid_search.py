#!/usr/bin/env python3
"""Where the time of the port's batched grid search goes, on one CUDA card.

Run from the root of a checkout: ``python3 tools/profile_grid_search.py
[--reps 3] [--top 20]``. It makes ``chip_smoke.py``'s seeded
(64, 512, 512) grid-search ROI (planted nuclei and dimmer decoys, [0, 1])
with the ``4xnuc`` profile and the ``gridtest`` thresholds (0.05 to 0.20),
and prints, one JSON object a line:

1. the card's name, power limit and SM clock (``nvidia-smi``);
2. ``stages``: the steps of one ``make_fn_detect_multi`` call, split by
   CUDA events and averaged over ``--reps`` calls: the LoG pyramid, the
   local-maximum mask (once per pyramid), then per chunk of thresholds the
   masked peak fields, ``_sparse_top_k`` (K2 and the selection, with their
   syncs), the peak buffers and K3 per threshold, and the pull of the rows;
   then the host's verification of every threshold against the truth
   (host clock). ``k2_ms`` is K2 alone on the same rows, timed apart;
3. ``run``: one whole ``grid_search`` (detection and verification) under
   ``torch.profiler``: wall seconds, the union of device-activity
   intervals and its share of the wall (the device's busy share);
4. ``top``: the ``--top`` rows of device time by kernel or memcpy name.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import OrderedDict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.profile_slice import device_intervals, union_us  # noqa: E402

SHAPE = (64, 512, 512)
RES = (1.0, 1.0, 1.0)
THRESHOLDS = (0.05, 0.1, 0.15, 0.2)


def stage_split(torch, roi, truth, reps):
    from magellanmapper_torch.cv import detector, stack_detect, verifier
    from magellanmapper_torch.kernels import extract_candidates as k2
    from magellanmapper_torch.ops import filters, peaks

    dev = torch.device("cuda")
    prof = stack_detect.roi_profile("4xnuc")
    sigmas = tuple(float(s) for s in detector.sigma_list(
        prof["min_sigma_factor"], prof["max_sigma_factor"],
        prof["num_sigma"]))
    cap = max(int(prof["max_blobs_per_block"]),
              min(1 << 17, max(4096, roi.size // 1024)))
    k_chunk = int(max(1, min(8, (2 << 30) // (len(sigmas) * roi.size * 5))))
    tol = detector.calc_overlap(RES) * np.asarray(prof["verify_tol_factor"])
    vol = torch.from_numpy(roi).to(dev)
    lut = filters.sigma_tensor(sigmas, dev)
    names = ("log_pyramid", "local_max", "masks", "sparse_top_k",
             "buffers_and_k3", "pull")
    totals = OrderedDict((n, 0.0) for n in names)
    k2_ms = verify_s = 0.0
    for rep in range(reps + 1):           # the first call warms up
        evs = {}

        def mark(name):
            evs.setdefault(name, []).append(torch.cuda.Event(
                enable_timing=True))
            evs[name][-1].record()

        torch.cuda.synchronize()
        mark("start")
        cube = filters.log_pyramid(vol, sigmas)
        mark("log_pyramid")
        lm = peaks.local_maxima(cube)
        mark("local_max")
        rows_out = []
        for c0 in range(0, len(THRESHOLDS), k_chunk):
            chunk = [float(t) for t in np.asarray(
                THRESHOLDS[c0:c0 + k_chunk], np.float32)]
            mark("chunk")
            flat, counts = peaks._masked_fields(cube, lm, chunk)
            mark("masks")
            tops = peaks._sparse_top_k(flat, cap)
            mark("sparse_top_k")
            pulled = []
            for (v, i), c in zip(tops, counts):
                coords4, values, count = peaks._peak_buffers(
                    cube.shape, v, i, min(c, cap), cap)
                valid = (torch.arange(cap, device=dev) < count) \
                    & torch.isfinite(values)
                sig = lut[coords4[:, 0].long()]
                pos = coords4[:, 1:].to(torch.float32).contiguous()
                valid = peaks.prune_overlapping_blobs(
                    pos, sig, valid, float(prof["overlap"]))
                pulled.append(torch.cat([pos, sig[:, None]], dim=1)[valid])
            mark("buffers_and_k3")
            rows_out += [p.cpu().numpy() for p in pulled]
            mark("pull")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            rows = flat.reshape(-1, k2.GROUP)
            start.record()
            k2.extract_candidates(rows)
            end.record()
            torch.cuda.synchronize()
            if rep:
                k2_ms += start.elapsed_time(end)
            del flat, tops, rows
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for raw in rows_out:
            raw = raw.astype(float)
            raw[:, 3] *= np.sqrt(3)
            verifier.verify_stack(raw, truth, tol)
        if rep:
            verify_s += time.perf_counter() - t0
            totals["log_pyramid"] += evs["start"][0].elapsed_time(
                evs["log_pyramid"][0])
            totals["local_max"] += evs["log_pyramid"][0].elapsed_time(
                evs["local_max"][0])
            for j, ev in enumerate(evs["chunk"]):
                totals["masks"] += ev.elapsed_time(evs["masks"][j])
                for a, b in zip(names[2:], names[3:]):
                    totals[b] += evs[a][j].elapsed_time(evs[b][j])
        del cube, lm
    per = {k: round(v / reps, 4) for k, v in totals.items()}
    return {"reps": reps, "chunk": k_chunk, "capacity": cap,
            "ms_per_call": per, "device_ms_per_call": round(
                sum(per.values()), 4),
            "k2_ms_per_call": round(k2_ms / reps, 4),
            "verify_s_per_call": round(verify_s / reps, 4)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--top", type=int, default=20)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_grid_search: needs a CUDA card")
    from magellanmapper_torch import testing
    from magellanmapper_torch.cv import detector, stack_detect
    from magellanmapper_torch.stats import mlearn

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    roi, centres = testing.make_grid_roi(SHAPE, 0)
    truth = np.column_stack([centres, np.full(len(centres), 3.0)])
    print(json.dumps({"stages": stage_split(
        torch, roi, truth, args.reps)}), flush=True)

    prof = stack_detect.roi_profile("4xnuc")
    tol = detector.calc_overlap(RES) * np.asarray(prof["verify_tol_factor"])
    grid = OrderedDict(detection_threshold=list(THRESHOLDS))

    def run():
        fn = mlearn.make_fn_detect_multi(roi, RES, prof, "cuda")
        return mlearn.grid_search(grid, None, truth, tol, fn)

    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        df = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    intervals = device_intervals(p)
    if not intervals:
        sys.exit("profile_grid_search: the profiler recorded no device "
                 "activity")
    busy = union_us(intervals) / 1e6
    print(json.dumps({"run": {
        "wall_s": wall, "device_busy_s": busy,
        "device_busy_share": busy / wall,
        "device_activities": len(intervals),
        "rows": df[["detection_threshold", "TP", "FP", "SENS",
                    "PPV"]].to_dict("records")}}), flush=True)
    by_name = {}
    for name, s, e in intervals:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (e - s) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    print(json.dumps({"top": [
        {"name": name[:120], "ms": round(ms, 3), "calls": n}
        for name, (ms, n) in top]}), flush=True)


if __name__ == "__main__":
    main()
