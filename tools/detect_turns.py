#!/usr/bin/env python3
"""The detect slice's wall for several checkouts in turns, on one CUDA card.

Run from the root of a checkout: ``python3 tools/detect_turns.py --roots
build/parent . . build/parent [--calls 3]``, an older commit unpacked
with ``git archive`` under ``build/`` (gitignored). It writes
``chip_smoke.py``'s seeded (256, 1024, 1024) planted-nuclei volume once,
then, for each root in the order given, starts one process that imports
that root's ``magellanmapper_torch``, builds its kernels and runs ``--proc
detect --roi_profile lightsheet`` through its CLI ``--calls`` times. It
prints the card's name and power limit (``nvidia-smi``), then one JSON
line a root: its blobs and each call's wall seconds and Mvox/s (the first
call of a process pays its warm-up). Comparing commits only inside one
such call keeps them on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (256, 1024, 1024)


def time_root(root: str, vol: str, calls: int) -> None:
    """Run the detect task of ``root``'s package ``calls`` times on
    ``vol``; print one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from magellanmapper_torch.io import cli
    from magellanmapper_torch.kernels import _build

    _build.library()
    walls = []
    with tempfile.TemporaryDirectory(dir=os.path.dirname(vol)) as tmp:
        for i in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blobs = cli.main([
                "--img", vol, "--proc", "detect", "--roi_profile",
                "lightsheet", "--prefix", os.path.join(tmp, f"run{i}.npy"),
                "--device", "cuda"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    voxels = float(SHAPE[0] * SHAPE[1] * SHAPE[2])
    print(json.dumps({"root": root, "blobs": len(blobs), "wall_s": walls,
                      "mvox_per_s": [voxels / 1e6 / w for w in walls]}),
          flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--roots", nargs="+", default=[ROOT],
                        help="checkouts to time, in turn")
    parser.add_argument("--calls", type=int, default=3,
                        help="detect calls in each root's process")
    parser.add_argument("--time", help=argparse.SUPPRESS)
    parser.add_argument("--vol", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.time:
        time_root(args.time, args.vol, args.calls)
        return
    sys.path.insert(0, ROOT)
    import numpy as np
    from magellanmapper_torch import testing

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    work = os.path.join(ROOT, "build", "turns")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        vol = os.path.join(tmp, "nuclei.npy")
        np.save(vol, testing.make_nuclei_volume(SHAPE, 0)[0])
        for root in args.roots:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--time", root, "--vol", vol, "--calls",
                            str(args.calls)], check=True)


if __name__ == "__main__":
    main()
