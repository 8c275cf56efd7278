"""Traffic generator ``grid_roi``: a float32 ROI in [0, 1] for a
threshold sweep, the nuclei of ``nuclei_volume`` (the truth set) plus
nuclei ``decoy`` times as bright half a grid step away on every axis,
which are not in the truth and become false positives at low
thresholds. The decoys are a second volume made from ``seed + 1``.

Parameters: those of ``nuclei_volume`` plus ``decoy``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.traffic import nuclei


def make(params, seed: int, device) -> dict:
    """``{"volume": (Z, Y, X) float32 host array, "centres": (N, 3)}``,
    the centres being the truth."""
    kw = dict(spacing=int(params["spacing"]), sigma=float(params["sigma"]),
              jitter=int(params["jitter"]), amp=params["amp"],
              noise=params["noise"], device=device, as_float=True)
    main = nuclei.nuclei_volume(params["shape"], seed, **kw)
    dim = nuclei.nuclei_volume(params["shape"], int(seed) + 1, **kw)
    half = int(params["spacing"]) // 2
    roi = main["volume"] + np.float32(params["decoy"]) * torch.roll(
        dim["volume"], (half, half, half), (0, 1, 2))
    del dim
    roi = roi / roi.max()
    return {"volume": roi.cpu().numpy(), "centres": main["centres"]}
