#!/usr/bin/env python
"""Whole-pipeline demo on the PyTorch port: proprietary import ->
registration -> detection -> regional stats -> group models -> volcano,
all through public APIs.

Mirrors the reference's end-to-end workflow (import via Bioformats ->
``--register single`` -> ``--proc detect`` -> ``--register vol_stats``
-> clrstats R models) with the port's pieces: the pure-Python CZI
reader, the smoothing-pyramid registration engine, block detection on
the card (kernels K1, K3 and K4), the regional engine with cluster
columns, and the group models.

Run: python examples/torch/demo_pipeline.py [out_dir] [--device cpu]
[--no-figures]. The device defaults to the card and raises without one;
``--no-figures`` leaves out the volcano plot (and matplotlib).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

SHAPE = (32, 96, 96)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("out_dir", nargs="?", default="demo_out/torch")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--no-figures", action="store_true")
    args = parser.parse_args(argv)
    out_dir, device = args.out_dir, args.device
    os.makedirs(out_dir, exist_ok=True)

    import numpy as np
    import pandas as pd
    import torch

    from magellanmapper_torch import device as device_mod
    from magellanmapper_torch.atlas import reg_engine, transform
    from magellanmapper_torch.cv import stack_detect
    from magellanmapper_torch.io import cli, czi_lif
    from magellanmapper_torch.settings.atlas_prof import (
        AtlasProfile, make_reg_param_map)
    from magellanmapper_torch.settings.roi_prof import ROIProfile
    from magellanmapper_torch.stats import clrstats, vols

    dev = device_mod.resolve(device)
    rng = np.random.default_rng(0)
    shape = SHAPE

    # 1. "acquire" a CZI and import it through the CLI dispatch
    zz, yy, xx = np.indices(shape).astype(np.float32)
    vol = rng.normal(120, 20, shape).astype(np.float32)
    centers = np.column_stack(
        [rng.uniform(6, s - 6, 60) for s in shape])
    for cz, cy, cx in centers:
        vol += 3500 * np.exp(
            -((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2) / 7.0)
    czi_path = os.path.join(out_dir, "sample.czi")
    czi_lif.write_czi(
        czi_path, np.clip(vol, 0, 65535).astype(np.uint16),
        resolutions=(2.0, 1.0, 1.0))
    rc = cli.process_cli_args(
        ["--img", czi_path, "--proc", "import_only",
         "--prefix", os.path.join(out_dir, "sample")])
    img5d = cli.process_tasks(rc)
    print(f"[1] imported CZI -> image5d {img5d.img.shape} "
          f"res {img5d.meta['resolutions'][0]}")

    # 2. register a synthetic "atlas" onto the sample (translation and
    #    affine stages on the smoothing pyramid)
    fixed = np.asarray(img5d.img[0], np.float32)
    fixed = fixed / fixed.max()
    warp = {"W": np.diag([0.06, -0.05, 0.04]).astype(np.float32),
            "t": np.asarray([2.0, -1.5, 1.0], np.float32)}
    atlas_img = transform.resample(
        torch.from_numpy(fixed).to(dev),
        {k: torch.from_numpy(v).to(dev) for k, v in warp.items()},
        "affine", shape).cpu().numpy()
    labels = (atlas_img > 0.25).astype(np.int32)
    labels[:, :, : shape[2] // 2] *= 2      # two regions, one per side
    prof = AtlasProfile()
    prof["reg_translation"] = make_reg_param_map(
        "translation", 64, num_resolutions=2, pyramid_mode="smoothing")
    prof["reg_affine"] = make_reg_param_map(
        "affine", 64, num_resolutions=2, pyramid_mode="smoothing")
    prof["reg_bspline"] = None
    moved, result = reg_engine.register_duo(fixed, atlas_img, prof,
                                            device=device)
    labels_reg = result.transform_img(labels, order=0).astype(np.int32)
    print(f"[2] registered atlas: DSC "
          f"{result.metrics['dsc_fixed_moved']:.3f}; labels "
          f"{sorted(np.unique(labels_reg).tolist())}")

    # 3. whole-stack blob detection on the device
    roi_prof = ROIProfile()
    roi_prof["denoise_size"] = 16
    blobs, timing = stack_detect.detect_blobs_blocks(
        np.asarray(img5d.img[0]), roi_prof, (2.0, 1.0, 1.0),
        preprocess=True, device=device)
    n = 0 if blobs is None else len(blobs)
    print(f"[3] detected {n} blobs in {timing['Total_stack']:.1f}s "
          f"(gather {timing['Gather_host']:.2f}s, "
          f"pull-wait {timing['Pull_wait']:.2f}s)")

    # 4. regional metrics with per-region cluster columns
    blob_rows = np.column_stack([
        blobs[:, :3],
        labels_reg[tuple(np.clip(blobs[:, :3].astype(int), 0,
                                 np.asarray(shape) - 1).T)]])
    df = vols.measure_labels_metrics(
        fixed, labels_reg, blobs=blob_rows, spacing=(2.0, 1.0, 1.0),
        cluster_eps=8.0, cluster_minpts=3, device=device)
    df_path = os.path.join(out_dir, "regions.csv")
    df.to_csv(df_path, index=False)
    print(f"[4] regional metrics -> {df_path}: "
          f"{df[['Region', 'Volume', 'NucCluster']].to_dict('records')}")

    # 5. cohort group model (GEE) and its volcano across mock samples
    rows = []
    for s in range(12):
        cond = "wt" if s < 6 else "ko"
        for _, r in df.iterrows():
            bump = 1.5 if (cond == "ko" and r.Region == 2) else 0.0
            rows.append({
                "Sample": s, "Condition": cond, "Side": "L",
                "Region": int(r.Region),
                "Volume": float(np.log1p(r.Volume))
                + rng.normal(bump, 0.4)})
    cohort = pd.DataFrame(rows)
    stats = clrstats.meas_group_stats(
        cohort, "Volume", conds=("wt", "ko"), model="gee")
    print("[5] GEE group stats:")
    print(stats.to_string(index=False))
    if not args.no_figures:
        volcano = os.path.join(out_dir, "volcano.png")
        clrstats.plot_volcano(stats, volcano)
        print(f"[5] volcano -> {volcano}")
    return {"image5d_shape": img5d.img.shape,
            "dsc": result.metrics["dsc_fixed_moved"],
            "labels": sorted(np.unique(labels_reg).tolist()),
            "blobs": blobs, "timing": timing, "regions": df,
            "stats": stats}


if __name__ == "__main__":
    main()
