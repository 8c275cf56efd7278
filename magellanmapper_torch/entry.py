"""Entry point of the port's flagship step, as ``__graft_entry__.entry``.

:func:`entry` returns ``(fn, example_args)``: ``fn`` runs the port's
per-block detection step (:func:`.cv.stack_detect.detect_step`:
sub-block saturate/denoise, the LoG pyramid, K1's peaks and K3's prune)
over a batch of blocks with the reference entry's static arguments, on
a seeded ``(2, 32, 64, 64)`` float32 batch.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from magellanmapper_torch import device as device_mod

#: the reference entry's preprocessing items (``__graft_entry__.py:16-19``)
PREPROC_ITEMS = (
    ("clip_vmin", 5.0), ("clip_vmax", 99.5), ("max_thresh", 0.5),
    ("clip_min", 0.2), ("clip_max", 1.0), ("tot_var_denoise", 0.0),
    ("unsharp_strength", 0.3), ("erosion_threshold", 0.2),
)


def entry(device="cuda") -> Tuple[Callable, Tuple[torch.Tensor]]:
    """``(fn, (batch,))``: ``fn(batch)`` returns the stacked ``raws``
    ``(B, 256, 4)``, ``valids`` ``(B, 256)`` and pre-prune ``counts``
    ``(B,)`` of the blocks, as the reference's ``_detect_batch``."""
    from magellanmapper_torch.cv import detector, stack_detect

    dev = device_mod.resolve(device)
    params = stack_detect.StepParams(
        sigmas=tuple(float(s) for s in detector.sigma_list(2.0, 4.0, 5)),
        threshold=0.1, overlap=0.5, capacity=256,
        denoise_shape=(16, 16, 16), preproc_items=PREPROC_ITEMS)

    def fn(batch: torch.Tensor):
        outs = [stack_detect.detect_step(block, params) for block in batch]
        return (torch.stack([raw for raw, _, _ in outs]),
                torch.stack([valid for _, valid, _ in outs]),
                torch.tensor([count for _, _, count in outs]))

    rng = np.random.default_rng(0)
    example = torch.from_numpy(
        rng.random((2, 32, 64, 64), dtype=np.float32)).to(dev)
    return fn, (example,)
