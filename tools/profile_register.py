#!/usr/bin/env python3
"""Where the time of the port's ``--register single`` goes, on one CUDA
card.

Run from the root of a checkout: ``python3 tools/profile_register.py
[--profile-scale 0.125] [--top 40]``. It builds the seeded
(160, 240, 200) gauntlet pair on the card, writes it as the task reads it
(``sample.npy`` and an ``atlasVolume``/``annotation`` directory under
``build/``), and prints, one JSON object a line:

1. the card's name, power limit and SM clock (``nvidia-smi``);
2. ``stages``: one whole ``register.register`` with the default atlas
   profile (after a short warm-up registration of a small pair), its host
   wall, and CUDA events around each call of its stages, summed by stage:
   the image pyramids, the optimiser levels (by transform kind), the
   full-resolution warps (``RegResult.transform_tensor``: the moved atlas
   and the labels), the Otsu overlaps, the label curation (carve and
   in-paint), the labels' overlap, and the writing of the images and the
   stats CSV; ``other`` is the wall minus their sum. Each stage's events
   also span the host's launch gaps inside it;
3. ``levels``: each optimiser level's steps, seconds and steps per second;
4. ``fidelity``: that run's per-region label transfer against the pair's
   ground truth (median, p10, min), of the curated labels it returns and
   of the labels before curation, and the five worst regions with their
   voxel counts in the ground truth; ``curated_truth`` scores the ground
   truth itself after the task's curation (what the carve alone costs);
5. ``run``: the same registration at ``--profile-scale`` times the
   iterations, twice without a profiler and once under ``torch.profiler``
   tracing only the card's activity (CUPTI; no host operators): the walls,
   the union of device-activity intervals (kernels, memcpys, memsets), the
   device's busy share (that union over the mean unprofiled wall, and over
   the profiled wall), the activity count and the activities per step;
6. ``top``: the ``--top`` rows of device time by kernel or memcpy name,
   with their call counts;
7. ``jitter_off``: item 4 for a whole registration whose strided levels
   sample the unjittered grid every step, a second witness of the
   default schedule's label transfer.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
from profile_slice import device_intervals, union_us  # noqa: E402

SHAPE = (160, 240, 200)
WARMUP_SHAPE = (20, 28, 28)


class StageClock:
    """CUDA events around calls of wrapped functions, summed by stage
    once the run has synchronised."""

    def __init__(self, torch):
        self.torch = torch
        self.marks = []

    def wrap(self, owner, attr, stage):
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            name = stage(args) if callable(stage) else stage
            self.marks.append((name, start, end))
            return out

        setattr(owner, attr, timed)

    def totals_ms(self):
        out = {}
        for name, start, end in self.marks:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


def instrument(torch):
    """Wrap the register path's stages with a :class:`StageClock`."""
    from magellanmapper_torch.atlas import (
        atlas_refiner, metrics, reg_engine, register)
    from magellanmapper_torch.io import sitk_io

    clock = StageClock(torch)
    clock.wrap(reg_engine, "_pyramid", "pyramid")
    clock.wrap(reg_engine, "_smoothing_pyramid", "pyramid")
    clock.wrap(reg_engine, "_optimize_level",
               lambda args: f"optimizer_{args[4]}")
    clock.wrap(reg_engine.RegResult, "transform_tensor", "full_res_warp")
    clock.wrap(metrics, "measure_overlap", "overlap_otsu_dsc")
    clock.wrap(register, "curate_img", "curation")
    clock.wrap(atlas_refiner, "measure_overlap_combined_labels",
               "labels_overlap")
    clock.wrap(sitk_io, "write_reg_images", "write_images")
    return clock


def label_fidelity(out, pair):
    """Label transfer of a registration's curated labels and of its
    labels before curation against the pair's ground truth."""
    from magellanmapper_torch.atlas import gauntlet

    gt = pair["labels_fixed_gt"]
    sizes = np.bincount(gt.reshape(-1))
    uncurated = out["transform"].transform_img(pair["labels"], order=0)
    res = {}
    for name, pred in (("curated", out["moved_labels"]),
                       ("uncurated", uncurated)):
        lt = gauntlet.label_transfer_dsc(pred, gt)
        worst = sorted(lt["per_label"].items(), key=lambda kv: kv[1])[:5]
        res[name] = {
            "median": lt["median"], "p10": lt["p10"], "min": lt["min"],
            "worst": [{"label": k, "dsc": v,
                       "gt_voxels": int(sizes[k]) if k < len(sizes) else 0}
                      for k, v in worst]}
    res["DSC_atlas_sample"] = out["metrics"]["DSC_atlas_sample"]
    return res


def busy_run(torch, register, sample, atlas, prof_cls, scale):
    """The scaled registration unprofiled, under a CUPTI-only profiler,
    and unprofiled again; returns the walls, the steps and the device
    intervals of the profiled run."""
    def once():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = register.register(sample, atlas, prof_cls(),
                                iters_scale=scale, write_imgs=False,
                                device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    plain = [once()[0]]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
        wall_prof, out = once()
    plain.append(once()[0])
    steps = sum(row["iters"] for row in out["transform"].levels)
    return plain, wall_prof, steps, device_intervals(p)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile-scale", type=float, default=0.125)
    parser.add_argument("--top", type=int, default=40)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_register: needs a CUDA card")
    from magellanmapper_torch.atlas import gauntlet, reg_engine, register
    from magellanmapper_torch.settings.atlas_prof import AtlasProfile

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    work = os.path.join(ROOT, "build", "profile_register")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        warm = gauntlet.build_pair(WARMUP_SHAPE, seed=0, device="cuda",
                                   ffd_spacing=16.0, ffd_ctrl_sigma=3.0)
        register.register(warm["fixed"], {"atlas": warm["moving"],
                                          "labels": warm["labels"]},
                          AtlasProfile(), iters_scale=0.05,
                          write_imgs=False, device="cuda")
        pair = gauntlet.build_pair(SHAPE, seed=0, device="cuda")
        sample, atlas = gauntlet.write_register_inputs(pair, tmp)

        clock = instrument(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = register.register(sample, atlas, AtlasProfile(),
                                device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        totals = {k: v / 1e3 for k, v in clock.totals_ms().items()}
        totals["other"] = wall - sum(totals.values())
        print(json.dumps({"stages": {
            "wall_s": wall, "seconds": totals,
            "metrics": out["metrics"]}}), flush=True)
        print(json.dumps({"levels": out["transform"].levels}), flush=True)
        print(json.dumps({"fidelity": label_fidelity(out, pair)}), flush=True)
        truth = pair["labels_fixed_gt"]
        lt = gauntlet.label_transfer_dsc(register.curate_img(
            pair["fixed"], truth, device="cuda"), truth)
        print(json.dumps({"curated_truth": {
            "median": lt["median"], "p10": lt["p10"], "min": lt["min"],
            "worst": sorted(lt["per_label"].items(),
                            key=lambda kv: kv[1])[:5]}}), flush=True)
        clock.marks.clear()

        plain, wall_prof, steps, intervals = busy_run(
            torch, register, sample, atlas, AtlasProfile,
            args.profile_scale)
        if not intervals:
            sys.exit("profile_register: the profiler recorded no device "
                     "activity")
        busy = union_us(intervals) / 1e6
        wall_plain = sum(plain) / len(plain)
        print(json.dumps({"run": {
            "iters_scale": args.profile_scale, "steps": steps,
            "unprofiled_wall_s": plain, "profiled_wall_s": wall_prof,
            "device_busy_s": busy, "device_busy_share": busy / wall_plain,
            "profiled_busy_share": busy / wall_prof,
            "device_activities": len(intervals),
            "activities_per_step": len(intervals) / steps}}), flush=True)
        by_name = {}
        for name, s, e in intervals:
            ms, n = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + (e - s) / 1e3, n + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
        print(json.dumps({"top": [
            {"name": name[:120], "ms": round(ms, 3), "calls": n}
            for name, (ms, n) in top]}), flush=True)

        reg_engine._optimize_level = functools.partial(
            reg_engine._optimize_level, jitter=False)
        out = register.register(sample, atlas, AtlasProfile(),
                                write_imgs=False, device="cuda")
        print(json.dumps({"jitter_off": label_fidelity(out, pair)}),
              flush=True)


if __name__ == "__main__":
    main()
