"""Device selection, fp32 precision pins and kernel launch counters.

Precision: the LoG pyramid and the per-tile unsharp blur are fp32 matrix
products whose bf16-class rounding is visible at the detection threshold
(``magellanmapper_tpu/ops/filters.py:116-119``). cuBLAS runs fp32 GEMMs in
full fp32 unless TF32 is allowed, and cuDNN allows TF32 by default, so both
are pinned off here, once, on import of the package.

Launch counters: each hand-written kernel's wrapper adds one to its entry
in :data:`LAUNCHES` where it launches the kernel, and nowhere else, so a
run can show that its main path went through the kernels. Beside them,
:data:`TF32_SCOPES` counts the band-product blocks that the fast LoG route
ran with TF32 allowed on the card, so a run can show that it took that
route.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

#: launches per kernel wrapper (K1-K4 of the TPU package)
LAUNCHES: Dict[str, int] = {
    "peak_candidates": 0,
    "extract_candidates": 0,
    "prune_overlap": 0,
    "tile_percentiles": 0,
}


#: band-product blocks run with TF32 allowed on a card
#: (``ops.filters.band_precision``)
TF32_SCOPES: Dict[str, int] = {"band_products": 0}


def reset_launches() -> None:
    """Set every launch counter, and :data:`TF32_SCOPES`, to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    TF32_SCOPES["band_products"] = 0


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name``."""
    LAUNCHES[name] += 1


def require_cuda() -> torch.device:
    """The first CUDA device; raises when no card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False")
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device: Union[str, torch.device]) -> torch.device:
    """A ``torch.device`` for ``device``; a CUDA request without a card
    raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
