#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``, and exits non-zero, printing no
result, on any fault. Phases:

1. device: the card's name and power limit;
2. build: the CUDA kernels from ``magellanmapper_torch/csrc`` (first use);
3. each kernel against its plain PyTorch version on the card, at the
   shapes of the detection path (K1, K3, K4) and of the grid search (K2),
   timed with CUDA events;
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
6. a JSON line of per-kernel results (launches summed over the two
   paths), the ``nvidia-smi`` line, and the final JSON line.
"""

from __future__ import annotations

import csv
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, reps=10):
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


def check_kernels(torch, prof, vol, results, dev):
    """Each kernel against its plain version on ``dev`` at the detection
    path's shapes; fills ``results[name]`` with max_abs_err, ms and
    plain_ms."""
    from magellanmapper_torch.cv import stack_detect as sd
    from magellanmapper_torch.kernels import peak_candidates as k1
    from magellanmapper_torch.kernels import prune_overlap as k3
    from magellanmapper_torch.kernels import tile_percentiles as k4
    from magellanmapper_torch.ops import filters, peaks

    blocks = sd.setup_blocks(prof, vol.shape, (1.0, 1.0, 1.0))
    block_shape = np.minimum(blocks.max_pixels + blocks.overlap, vol.shape)
    params = sd.step_params(prof, blocks, block_shape, (1.0, 1.0, 1.0),
                            float(np.percentile(vol[::16], 99.5)))
    prep = dict(params.preproc_items)
    bz, by, bx = (int(v) for v in block_shape)
    print(f"block window {(bz, by, bx)}, capacity "
          f"{params.capacity}, {len(params.sigmas)} scales", flush=True)

    # K4 on the denoise tiles of one block, as the preprocessing cuts them
    block = torch.from_numpy(np.ascontiguousarray(
        vol[64:64 + bz, 256:256 + by, 256:256 + bx])).to(dev)
    tiles = sd.to_tiles(block, params.denoise_shape)[0]
    tiles = tiles.reshape(tiles.shape[0], -1)
    rng = np.random.default_rng(SEED)
    dup = torch.from_numpy(
        rng.integers(0, 4, tiles.shape).astype(np.float32)).to(dev)
    cases4 = {
        "u16": tiles,
        "f32": tiles.to(torch.float32),
        "u16_ragged_v": tiles[:, :12345].contiguous(),
        "f32_duplicates": dup,
    }
    err4 = 0.0
    q = (prep["clip_vmin"], prep["clip_vmax"])
    for name, t in cases4.items():
        got = k4.tile_percentiles(t, *q)
        want = k4.tile_percentiles_plain(t, *q)
        err = float((got - want).abs().max())
        print(f"K4 {name} {tuple(t.shape)} {t.dtype}: max_abs_err {err}",
              flush=True)
        if not torch.equal(got, want):
            fail(f"K4 {name}: kernel != plain version")
        err4 = max(err4, err)
    results["tile_percentiles"].update(
        max_abs_err=err4,
        ms=cuda_ms(torch, lambda: k4.tile_percentiles(tiles, *q)),
        plain_ms=cuda_ms(torch, lambda: k4.tile_percentiles_plain(tiles, *q)))

    # K1 on the LoG cube of that block, and on a ragged cube
    pre = sd.preprocess_block(block, params.denoise_shape,
                              params.preproc_items)
    cube = filters.log_pyramid(pre, params.sigmas).contiguous()
    ragged_pre = sd.preprocess_block(
        torch.from_numpy(np.ascontiguousarray(
            vol[11:42, 100:164, 300:430])).to(dev),
        params.denoise_shape, params.preproc_items)
    ragged = filters.log_pyramid(ragged_pre, params.sigmas).contiguous()
    thr = params.threshold
    err1 = 0.0
    for name, c in (("block", cube), ("ragged", ragged)):
        gv, gi = k1.select_top_sparse(
            *k1.peak_candidates(c, thr), c.numel())
        wv, wi = k1.select_top_sparse(
            *k1.peak_candidates_plain(c, thr), c.numel())
        print(f"K1 {name} {tuple(c.shape)}: {gv.numel()} peaks (plain "
              f"{wv.numel()})", flush=True)
        if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
            fail(f"K1 {name}: kernel peaks != plain version")
        if gv.numel():
            err1 = max(err1, float((gv - wv).abs().max()))
    results["peak_candidates"].update(
        max_abs_err=err1,
        ms=cuda_ms(torch, lambda: k1.peak_candidates(cube, thr)),
        plain_ms=cuda_ms(torch, lambda: k1.peak_candidates_plain(cube, thr)))

    # K3 at the block capacity: the block's own peaks, then three
    # synthetic buffers (sparse, dense-crowded, all-invalid)
    k = params.capacity
    coords4, _, count = peaks.find_peaks(cube, thr, k)
    sig = torch.tensor(params.sigmas, dtype=torch.float32,
                       device=dev)[coords4[:, 0].long()]
    block_case = (coords4[:, 1:].to(torch.float32).contiguous(), sig,
                  torch.arange(k, device=dev) < count)

    def synth(lo, hi, s_lo, s_hi, frac_valid):
        c = torch.from_numpy(rng.uniform(lo, hi, (k, 3)).astype(
            np.float32)).to(dev)
        s = torch.from_numpy(rng.uniform(s_lo, s_hi, k).astype(
            np.float32)).to(dev)
        v = torch.from_numpy(rng.random(k) < frac_valid).to(dev)
        return c, s, v

    cases3 = {
        "block_peaks": block_case,
        "sparse": synth(0, 128, 2.6, 2.8, 0.15),
        "dense_crowded": synth(0, 40, 1.5, 4.0, 0.95),
        "all_invalid": synth(0, 128, 2.6, 2.8, 0.0),
    }
    mism = 0
    for name, (c, s, v) in cases3.items():
        got = k3.prune_overlap(c, s, v, params.overlap)
        want = k3.prune_overlap_plain(c, s, v, params.overlap)
        n_bad = int((got != want).sum())
        print(f"K3 {name} K={k}: {int(v.sum())} valid -> {int(got.sum())} "
              f"kept, {n_bad} mismatches", flush=True)
        if n_bad:
            fail(f"K3 {name}: kernel mask != plain version")
        mism = max(mism, n_bad)
    c, s, v = cases3["dense_crowded"]
    results["prune_overlap"].update(
        max_abs_err=float(mism),
        ms=cuda_ms(torch, lambda: k3.prune_overlap(c, s, v, params.overlap)),
        plain_ms=cuda_ms(torch, lambda: k3.prune_overlap_plain(
            c, s, v, params.overlap)))


def check_k2(torch, roi, sigmas, results, dev):
    """K2 against its plain version on ``dev``, bit for bit (values and
    lanes): one launch of the grid search (the masked fields of its first
    threshold chunk, 0.05 and 0.10, as ``peaks.find_peaks_unfused`` builds
    them), all -inf rows, plateau rows, duplicate-heavy rows and a ragged
    row count."""
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
    results["extract_candidates"].update(
        max_abs_err=err2,
        ms=cuda_ms(torch, lambda: k2.extract_candidates(field)),
        plain_ms=cuda_ms(torch, lambda: k2.extract_candidates_plain(field)))
    print(f"K2 timed at {tuple(field.shape)}", flush=True)


def grid_search_path(torch, roi, centres, work, results, launches):
    """The ``--grid_search`` task through the port's CLI on the card;
    returns nothing, fails on a fault."""
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
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
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
    check_kernels(torch, prof, vol, results, torch.device("cuda"))
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
    del vol

    # 5. the grid search through the port's CLI, its crop, the tap route
    os.makedirs(work, exist_ok=True)
    grid_search_path(torch, grid_roi, grid_centres, work, results, launches)
    check_taps(torch, grid_sigmas)

    for name in results:
        n = sum(path[name] for path in launches.values())
        if n <= 0:
            fail(f"kernel {name} was launched on no path")
        results[name]["launches"] = n
    if "jax" in sys.modules:
        fail("jax was imported: the port must run without it")

    # 6. results
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
