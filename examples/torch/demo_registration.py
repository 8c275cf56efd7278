#!/usr/bin/env python
"""Demo: atlas registration end to end on synthetic volumes, on the
PyTorch port.

Runs the full Elastix-default schedule (translation -> affine ->
B-spline, Mattes MI, multi-resolution) on a synthetic atlas-scale pair
and reports DSC before/after plus the label transfer, mirroring the
reference's ``--register single`` flow.

Run: python examples/torch/demo_registration.py [--small] [--device cpu]
[--no-figures]. ``--small`` registers a (48, 64, 56) pair with the
``smalliter`` schedule instead of (160, 240, 200). The device defaults to
the card and raises without one. The demo makes no figure;
``--no-figures`` is taken as the other demos take it.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

SHAPE = (160, 240, 200)
SMALL_SHAPE = (48, 64, 56)


def make_pair(shape, device):
    """A smooth synthetic fixed image, the moving image under a known
    affine warp, and labels riding on the moving image."""
    import torch
    from magellanmapper_torch import device as device_mod
    from magellanmapper_torch.atlas import transform

    dev = device_mod.resolve(device)
    zz, yy, xx = np.indices(shape).astype(np.float32)
    c = [s / 2 for s in shape]
    w = [s / 3.2 for s in shape]
    fixed = np.exp(-(((zz - c[0]) / w[0]) ** 2 + ((yy - c[1]) / w[1]) ** 2
                     + ((xx - c[2]) / w[2]) ** 2) * 2)
    fixed += 0.15 * np.sin(zz / 7) * np.sin(yy / 9) + 0.1 * np.sin(xx / 8)
    fixed = np.clip(fixed, 0, None).astype(np.float32)
    moving = transform.resample(
        torch.from_numpy(fixed).to(dev),
        {"t": torch.tensor([3.0, -5.0, 4.0], device=dev),
         "W": torch.tensor([[1.05, 0.02, 0.0], [0.0, 0.96, 0.03],
                            [0.01, 0.0, 1.04]], device=dev)},
        "affine", shape).cpu().numpy()
    labels = (moving > 0.5 * moving.max()).astype(np.int32) * 3
    return fixed, moving, labels


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--no-figures", action="store_true")
    args = parser.parse_args(argv)
    import torch
    from magellanmapper_torch.atlas import metrics, reg_engine
    from magellanmapper_torch.settings.atlas_prof import AtlasProfile

    shape = SMALL_SHAPE if args.small else SHAPE
    fixed, moving, labels = make_pair(shape, args.device)
    prof = AtlasProfile()
    if args.small:
        prof.add_profiles("smalliter")

    thr = 0.5 * fixed.max()

    def dice(a, b):
        return float(metrics.dice(torch.from_numpy(a > thr),
                                  torch.from_numpy(b > thr)))

    dsc_before = dice(fixed, moving)
    t0 = time.perf_counter()
    moved, result = reg_engine.register_duo(fixed, moving, prof,
                                            device=args.device)
    wall = time.perf_counter() - t0
    dsc_after = dice(fixed, moved)

    # label transfer with nearest neighbours (Transformix's counterpart)
    labels_moved = result.transform_img(labels, order=0)

    print(f"shape {shape}, wall {wall:.1f}s on {args.device}")
    print(f"DSC before {dsc_before:.4f} -> after {dsc_after:.4f}")
    print(f"labels transferred: {int((labels_moved > 0).sum())} fg voxels, "
          f"dtype {labels_moved.dtype}")
    return {"shape": shape, "wall": wall, "dsc_before": dsc_before,
            "dsc_after": dsc_after, "labels_moved": labels_moved,
            "moved": moved}


if __name__ == "__main__":
    main()
