#!/usr/bin/env python
"""End-to-end demo on the PyTorch port: synthesize a volume, detect
nuclei on the card, verify against the planted truth, plot.

Run: python examples/torch/demo_detection.py [out_dir] [--device cpu]
[--no-figures]. The device defaults to the card and raises without one;
``--no-figures`` leaves out the figures (and matplotlib).
"""

import argparse
import os
import sys

# allow running directly: the repository root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

SHAPE = (48, 160, 160)


def make_volume(shape=SHAPE, n=300, seed=0):
    """Seeded Gaussian nuclei over faint noise, scaled to [0, 1]; returns
    the volume and the planted centres."""
    rng = np.random.default_rng(seed)
    vol = rng.normal(scale=0.02, size=shape).astype(np.float32)
    centers = np.column_stack([rng.integers(8, s - 8, n) for s in shape])
    zz, yy, xx = np.indices((13, 13, 13)).astype(np.float32) - 6
    for (cz, cy, cx), r in zip(centers, rng.uniform(3, 5.5, n)):
        sig = r / np.sqrt(3)
        vol[cz-6:cz+7, cy-6:cy+7, cx-6:cx+7] += np.exp(
            -(zz**2 + yy**2 + xx**2) / (2 * sig**2))
    return np.clip(vol, 0, None) / vol.max(), centers


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("out_dir", nargs="?", default="demo_out/torch")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--no-figures", action="store_true")
    args = parser.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    from magellanmapper_torch.cv import stack_detect, verifier
    from magellanmapper_torch.io import np_io
    from magellanmapper_torch.settings.roi_prof import ROIProfile

    # 1. synthetic nuclei volume
    vol, centers = make_volume()
    base = os.path.join(args.out_dir, "demo.npy")
    np_io.write_npy(base, vol[None], resolutions=[[1.0, 1.0, 1.0]])
    print(f"wrote {base}")

    # 2. whole-image detection
    prof = ROIProfile()
    prof["min_sigma_factor"] = 2.0
    prof["max_sigma_factor"] = 4.0
    prof["num_sigma"] = 8
    prof["denoise_size"] = None
    blobs, timing = stack_detect.detect_blobs_stack(
        vol, prof, (1.0, 1.0, 1.0), preprocess=False, device=args.device)
    print(f"detected {len(blobs)} blobs in "
          f"{timing['Total_stack']:.2f}s on {args.device}")

    # 3. verify against the planted truth
    truth = np.column_stack([centers, np.full(len(centers), 3.0)])
    sens, ppv, _ = verifier.verify_stack(blobs.blobs, truth, (3, 3, 3))
    print(f"sensitivity {sens:.3f}, PPV {ppv:.3f}")

    # 4. visual outputs
    if not args.no_figures:
        from magellanmapper_torch.gui import roi_review, vis_3d
        roi_review.plot_roi_planes(
            vol[:12], blobs.blobs[blobs.blobs[:, 0] < 12],
            os.path.join(args.out_dir, "roi_planes.png"), n_cols=4)
        vis_3d.plot_max_intensity_projections(
            vol, os.path.join(args.out_dir, "mips.png"), blobs.blobs)
        print(f"figures in {args.out_dir}/")
    return {"shape": vol.shape, "blobs": blobs.blobs, "sens": sens,
            "ppv": ppv, "timing": timing}


if __name__ == "__main__":
    main()
