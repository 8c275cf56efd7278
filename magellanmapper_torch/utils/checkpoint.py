"""Stage checkpoints of a registration: ``torch.save`` of each completed
stage's parameters, so a stopped multi-stage registration resumes at its
last completed stage instead of restarting the schedule.

Port of ``magellanmapper_tpu/utils/checkpoint.py``, with the blob
classifier's helpers. The reference writes Orbax directories; the port
writes one file per checkpoint, a flat dict of CPU tensors read back with
``torch.load(weights_only=True)``, so it does not read the reference's
directories (a difference of format, not of results). A classifier's
checkpoint is its ``PatchCNN`` state dict; its model files
(``BlobClassifier.save``) are the reference's pickle and move both ways.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

_logger = logging.getLogger(__name__)


def _cpu_tensor(value) -> torch.Tensor:
    if torch.is_tensor(value):
        return value.detach().cpu()
    return torch.from_numpy(np.array(value))


def save_pytree(path: str, tree: Dict[str, Any]) -> str:
    """Save a flat dict of arrays or tensors at ``path`` (replacing any
    file there); returns the absolute path."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    torch.save({k: _cpu_tensor(v) for k, v in tree.items()}, tmp)
    os.replace(tmp, path)
    return path


def load_pytree(path: str) -> Optional[Dict[str, torch.Tensor]]:
    """The dict saved at ``path`` as CPU tensors; None when absent."""
    path = os.path.abspath(path)
    if not os.path.isfile(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


class RegistrationCheckpoint:
    """Per-stage registration checkpoints under one directory:
    ``register_duo(..., checkpoint_dir=...)`` saves each completed stage's
    transform parameters as ``<dir>/<kind>.pt``; on a rerun a stage whose
    file exists is restored instead of optimised again."""

    def __init__(self, ckpt_dir: str):
        self.dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)

    def stage_path(self, kind: str) -> str:
        return os.path.join(self.dir, f"{kind}.pt")

    def load_stage(self, kind: str) -> Optional[Dict[str, torch.Tensor]]:
        out = load_pytree(self.stage_path(kind))
        if out is not None:
            _logger.info("resumed %s stage from %s", kind, self.dir)
        return out

    def save_stage(self, kind: str, params: Dict[str, Any]) -> None:
        save_pytree(self.stage_path(kind), dict(params))


def save_classifier_state(path: str, clf) -> str:
    """Save a ``BlobClassifier``'s weights (its state dict) at ``path``."""
    return save_pytree(path, clf.model.state_dict())


def load_classifier_state(path: str, device="cuda"):
    """The ``BlobClassifier`` saved at ``path`` on ``device``, or None."""
    state = load_pytree(path)
    if state is None:
        return None
    from magellanmapper_torch.cv.classifier import BlobClassifier
    return BlobClassifier(params=state, device=device)
