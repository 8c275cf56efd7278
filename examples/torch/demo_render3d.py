#!/usr/bin/env python
"""Demo: shear-warp 3D rendering of a detected nuclei volume on the
PyTorch port.

Synthesizes a nuclei stack, detects blobs, then renders the scene four
ways on the card: emission-absorption volume, arbitrary-angle MIP, shaded
isosurface (the scene's blobs projected under it) and an orbit of MIP
frames (the Mayavi volume/contour3d/points3d workflow, reference
``magmap/gui/vis_3d.py``).

Run: python examples/torch/demo_render3d.py [out_dir] [--device cpu]
[--no-figures]. The device defaults to the card and raises without one;
``--no-figures`` keeps the frames in memory and writes no PNG or GIF (no
matplotlib).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

SHAPE = (64, 160, 160)
MODES = ("volume", "mip", "isosurface")
RENDER_HW = (384, 384)
#: the camera nudge a user would give, (azimuth, elevation) in degrees
ORBIT = (25.0, -5.0)
COLOR_ANCHORS = ((0.0, 0.0, 0.2), (0.8, 0.2, 0.1), (1.0, 0.9, 0.4))


def make_volume(shape=SHAPE, n=120, seed=2):
    """Seeded Gaussian nuclei over faint noise, scaled to [0, 1]."""
    rng = np.random.default_rng(seed)
    vol = rng.normal(scale=0.02, size=shape).astype(np.float32)
    centers = np.column_stack([rng.integers(8, s - 8, n) for s in shape])
    zz, yy, xx = np.indices((13, 13, 13)).astype(np.float32) - 6
    for (cz, cy, cx), r in zip(centers, rng.uniform(3, 5.5, n)):
        sig = r / np.sqrt(3)
        vol[cz-6:cz+7, cy-6:cy+7, cx-6:cx+7] += np.exp(
            -(zz**2 + yy**2 + xx**2) / (2 * sig**2))
    return np.clip(vol, 0, None) / vol.max()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("out_dir", nargs="?", default="demo_out/torch")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--no-figures", action="store_true")
    args = parser.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    from magellanmapper_torch.cv import detector
    from magellanmapper_torch.gui import vis_3d
    from magellanmapper_torch.io import export_stack
    from magellanmapper_torch.ops import render3d
    from magellanmapper_torch.settings.roi_prof import ROIProfile

    vol = make_volume()
    prof = ROIProfile()
    prof["min_sigma_factor"] = 2.0
    prof["max_sigma_factor"] = 4.0
    prof["num_sigma"] = 6
    t0 = time.perf_counter()
    blobs = detector.detect_blobs(vol, prof, resolutions=(1.0, 1.0, 1.0),
                                  device=args.device)
    detect_s = time.perf_counter() - t0
    print(f"detected {0 if blobs is None else len(blobs)} blobs in "
          f"{detect_s:.2f}s on {args.device}")

    # the canvas's renders: each mode re-renders on an orbit or zoom
    vis = vis_3d.Vis3D(vol)
    if blobs is not None:
        vis.show_blobs(blobs)
    frames, poses, visible = {}, {}, {}
    for mode in MODES:
        if args.no_figures:
            view = vis_3d.Vis3DRenderer(vis, render_mode=mode,
                                        render_hw=RENDER_HW,
                                        device=args.device, render=False)
        else:
            view = vis_3d.Vis3DCanvas(vis, render_mode=mode,
                                      render_hw=RENDER_HW,
                                      device=args.device)
        view.orbit(*ORBIT)
        frames[mode], poses[mode] = view.frame, view.camera_state()
        if blobs is not None:
            visible[mode] = int((view.project_blobs()[:, 2] > 0).sum())
        if not args.no_figures:
            out = view.save(os.path.join(args.out_dir, f"render_{mode}.png"))
            print("wrote", out)
        print(f"{mode}: frame {frames[mode].shape}, pose "
              f"{poses[mode]['azim']:.1f}/{poses[mode]['elev']:.1f}, "
              f"{visible.get(mode, 0)} blobs visible")

    # colormapped direct call (piecewise-linear transfer function)
    anchors = np.asarray(COLOR_ANCHORS, np.float32)
    frames["colormap"] = render3d.render_volume_sw(
        vol, 40.0, 25.0, vmin=0.15, vmax=1.0, out_hw=(512, 512),
        opacity=0.35, color=anchors, device=args.device).cpu().numpy()
    if not args.no_figures:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        out = os.path.join(args.out_dir, "render_colormap.png")
        plt.imsave(out, frames["colormap"])
        print("wrote", out)

    rotation = dict(n_frames=18, mode="mip", out_hw=(256, 256),
                    device=args.device)
    if args.no_figures:
        frames["rotation"] = np.stack(
            export_stack.render_rotation(vol, **rotation))
    else:
        out = export_stack.animate_rotation_3d(
            vol, os.path.join(args.out_dir, "rotation_mip.gif"), **rotation)
        print("wrote", out)
    return {"blobs": blobs, "detect_s": detect_s, "frames": frames,
            "poses": poses, "visible": visible}


if __name__ == "__main__":
    main()
