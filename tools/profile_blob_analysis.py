#!/usr/bin/env python3
"""Where the time of the port's blob analysis goes, on one CUDA card.

Run from the root of a checkout: ``python3 tools/profile_blob_analysis.py
[--top 15]``. It prints the card's name and power limit (``nvidia-smi``),
then:

1. ``chip_smoke.py``'s blob-analysis phase alone on its seeded
   (256, 1024, 1024, 2) volume (``coloc_volume``, ``blob_analysis``: the
   same lines, walls and gates as the smoke run's phase 9, but in a
   process whose first patch-CNN training step also initialises cuDNN);
2. ``train``: the patch classifier's training, one JSON line a run of
   fresh models on 16,384 seeded patches: 1, 1 and 3 epochs (the first
   run of the process pays cuDNN's start), wall and steps per second;
3. ``profile``: one epoch under ``torch.profiler``: its wall, the host's
   summed self time, the union of device activities and its share of the
   wall (as ``tools/profile_slice.py`` takes it), and the ``--top`` rows
   by host and by device self time (rows of ``record_function`` ranges,
   such as the optimiser's step, count their kernels again).
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
PATCHES = 16384


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--top", type=int, default=15,
                        help="profiler rows to print by host and by device")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from profile_slice import device_intervals, union_us
    from magellanmapper_torch import testing
    from magellanmapper_torch.cv import classifier
    from magellanmapper_torch.kernels import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _build.library()
    vol, centres = testing.make_nuclei_volume(chip_smoke.SLICE_SHAPE,
                                              chip_smoke.SEED)
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        path, truth = chip_smoke.coloc_volume(vol, centres, tmp)
        del vol
        chip_smoke.blob_analysis(torch, path, truth, tmp, {})

    rng = np.random.default_rng(0)
    x = rng.random((PATCHES, classifier.PATCH_SIZE, classifier.PATCH_SIZE),
                   dtype=np.float32)
    y = (rng.random(PATCHES) > 0.1).astype(np.float32)
    steps_per_epoch = -(-PATCHES // 128)
    for epochs in (1, 1, 3):
        clf = classifier.BlobClassifier(device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clf.train(x, y, epochs=epochs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print("train: " + json.dumps({
            "epochs": epochs, "wall_s": wall,
            "steps_per_s": epochs * steps_per_epoch / wall}), flush=True)

    clf = classifier.BlobClassifier(device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        clf.train(x, y, epochs=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    host = sum(r.self_cpu_time_total for r in rows) / 1e3
    device = union_us(device_intervals(prof)) / 1e3

    def top(key):
        return [{"name": r.key[:60], "calls": r.count,
                 "self_ms": getattr(r, key) / 1e3}
                for r in sorted(rows, key=lambda r: -getattr(r, key))
                [:args.top]]

    print("profile: " + json.dumps({
        "steps": steps_per_epoch, "wall_s": wall, "host_self_ms": host,
        "device_busy_ms": device, "busy_share": device / 1e3 / wall,
        "top_host": top("self_cpu_time_total"),
        "top_device": top("self_device_time_total")}), flush=True)


if __name__ == "__main__":
    main()
