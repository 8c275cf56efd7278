"""Atlas curation on PyTorch: so far only what the registration task
measures, the overlap of an atlas's foreground with its labels
(``magellanmapper_tpu/atlas/atlas_refiner.py:349-360``). The rest of the
module is ROADMAP queue item 9."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.atlas import metrics as reg_metrics
from magellanmapper_torch.ops import preproc


def measure_overlap_combined_labels(
        atlas_img: np.ndarray, labels_img: np.ndarray,
        thresh: Optional[float] = None, device="cuda") -> float:
    """DSC between the atlas foreground (above ``thresh``, Otsu's when
    None) and the combined labels foreground (labels != 0), on
    ``device``."""
    dev = device_mod.resolve(device)
    atlas = torch.from_numpy(np.array(atlas_img, np.float32)).to(dev)
    if thresh is None:
        thresh = float(preproc.otsu_threshold(atlas))
    labels = torch.from_numpy(np.asarray(labels_img) != 0).to(dev)
    return float(reg_metrics.dice(atlas > thresh, labels))
