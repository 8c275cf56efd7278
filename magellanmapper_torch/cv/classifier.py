"""Blob patch classifier: a small CNN over 2D patches around the blobs.

Port of ``magellanmapper_tpu/cv/classifier.py`` (a Flax CNN trained with
optax Adam): :class:`PatchCNN` has the same layers as an ``nn.Module``;
:func:`extract_patches` cuts edge-padded 16 x 16 patches at each blob's
plane and min-max scales each, on the device; :class:`BlobClassifier`
trains with ``torch.optim.Adam`` on the sigmoid cross-entropy, in the
reference's epoch order, and predicts; :func:`classify_blobs` and
:func:`classify_whole_image` write the predictions into the blobs'
``confirmed`` column.

Weights move between the packages: :func:`params_from_reference` turns the
reference's parameter tree (``{"params": {"Conv_0": {"kernel", "bias"},
..., "Dense_1": ...}}``, HWIO conv kernels, ``(in, out)`` dense kernels)
into this module's state dict and :func:`params_to_reference` back, and
:meth:`BlobClassifier.save` writes the reference's pickle. The flatten
before ``Dense_0`` is Flax's ``(H, W, C)`` order: the activations are
permuted to NHWC first, so the dense kernel only transposes.

The untrained initialisation draws from Flax's distribution (LeCun normal:
a normal truncated at two deviations, scaled to a variance of 1/fan-in;
zero biases) with an explicit ``torch.Generator``; its values cannot be
Flax's, whose generator is JAX's.
"""

from __future__ import annotations

import math
import pickle
import zipfile
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.cv import blobs as blobs_mod

#: patch edge length in px
PATCH_SIZE = 16
#: the standard deviation of a unit normal truncated at +-2, by which a
#: truncated normal initialiser widens its draw (Flax's variance scaling)
_TRUNC_STD = 0.87962566103423978
#: the reference's layer names and this module's, in order
LAYERS = (("Conv_0", "conv0"), ("Conv_1", "conv1"), ("Dense_0", "dense0"),
          ("Dense_1", "dense1"))


class PatchCNN(nn.Module):
    """Small CNN over 2D blob patches -> the logit of a true blob: conv
    3x3 16 (same), ReLU, max-pool 2, conv 3x3 32, ReLU, max-pool 2, dense
    64, ReLU, dense 1."""

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv2d(1, 16, 3, padding=1)
        self.conv1 = nn.Conv2d(16, 32, 3, padding=1)
        self.dense0 = nn.Linear(32 * (PATCH_SIZE // 4) ** 2, 64)
        self.dense1 = nn.Linear(64, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, None] if x.dim() == 3 else x
        x = F.max_pool2d(F.relu(self.conv0(x)), 2)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        # Flax flattens (H, W, C)
        x = x.permute(0, 2, 3, 1).flatten(1)
        x = F.relu(self.dense0(x))
        return self.dense1(x)[:, 0]


def init_lecun_normal(model: PatchCNN, seed: int = 0) -> PatchCNN:
    """Flax's default initialisation of ``model`` in place, drawn from a
    CPU generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, name in LAYERS:
            layer = getattr(model, name)
            fan_in = layer.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
            nn.init.zeros_(layer.bias)
    return model


def params_from_reference(tree) -> Dict[str, torch.Tensor]:
    """The state dict of :class:`PatchCNN` from the reference's parameter
    tree (numpy arrays): conv kernels HWIO -> OIHW, dense kernels
    ``(in, out)`` -> ``(out, in)``."""
    params = tree["params"] if "params" in tree else tree
    state = {}
    for ref_name, name in LAYERS:
        kernel = np.asarray(params[ref_name]["kernel"], np.float32)
        kernel = (kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4
                  else kernel.T)
        state[f"{name}.weight"] = torch.from_numpy(np.array(kernel,
                                                            order="C"))
        state[f"{name}.bias"] = torch.from_numpy(np.array(
            params[ref_name]["bias"], np.float32))
    return state


def params_to_reference(state: Dict[str, torch.Tensor]) -> dict:
    """The reference's parameter tree (numpy float32) from a state dict of
    :class:`PatchCNN`; the inverse of :func:`params_from_reference`."""
    params = {}
    for ref_name, name in LAYERS:
        weight = state[f"{name}.weight"].detach().cpu().numpy()
        kernel = (weight.transpose(2, 3, 1, 0) if weight.ndim == 4
                  else weight.T)
        params[ref_name] = {
            "bias": state[f"{name}.bias"].detach().cpu().numpy().copy(),
            "kernel": np.ascontiguousarray(kernel)}
    return {"params": params}


def _patches(roi: np.ndarray, blobs: np.ndarray, size: int,
             dev: torch.device) -> torch.Tensor:
    """:func:`extract_patches` as a tensor on ``dev``."""
    half = size // 2
    vol = torch.from_numpy(np.array(roi)).to(dev).to(torch.float32)
    # replicate pads the last two axes of a (C, H, W) tensor: numpy's edge
    padded = F.pad(vol, (half, half, half, half), mode="replicate")
    shape = np.asarray(vol.shape)
    pos = np.clip(np.round(np.asarray(blobs, float)[:, :3]), 0,
                  shape - 1).astype(np.int64)
    pos = torch.from_numpy(pos).to(dev)
    win = torch.arange(size, device=dev)
    rows = (pos[:, 1, None] + win)[:, :, None]
    cols = (pos[:, 2, None] + win)[:, None, :]
    patches = padded[pos[:, 0, None, None], rows, cols]
    lo = patches.amin(dim=(1, 2), keepdim=True)
    hi = patches.amax(dim=(1, 2), keepdim=True)
    return torch.where(hi > lo, (patches - lo) / (hi - lo), patches)


def extract_patches(
        roi: np.ndarray, blobs: np.ndarray, size: int = PATCH_SIZE,
        device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """``(n, size, size)`` float32 patches centred on each blob's rounded
    y,x at its rounded z plane (clipped into ``roi``), ``roi`` padded by
    its edge values, each patch scaled to [0, 1] unless flat; cut on
    ``device``."""
    return _patches(roi, blobs, size, device_mod.resolve(device)).cpu(
    ).numpy()


class BlobClassifier:
    """Trains and applies a :class:`PatchCNN` on ``device`` (the card
    unless ``"cpu"`` is asked for).

    Args:
        params: the reference's parameter tree or a state dict of
            :class:`PatchCNN`; None initialises from ``seed``.
        seed: seed of the initialisation's generator.
        device: where the model trains and predicts.
    """

    def __init__(self, params=None, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.device = device_mod.resolve(device)
        self.model = PatchCNN()
        if params is None:
            init_lecun_normal(self.model, seed)
        else:
            self.model.load_state_dict(_state_dict(params))
        self.model.to(self.device)

    @property
    def params(self) -> dict:
        """The weights as the reference's parameter tree."""
        return params_to_reference(self.model.state_dict())

    # -- training -------------------------------------------------------------

    def train(
            self, patches: np.ndarray, labels: np.ndarray,
            epochs: int = 10, batch_size: int = 128,
            learning_rate: float = 1e-3) -> Dict[str, float]:
        """Train on patches with binary labels by Adam on the mean sigmoid
        cross-entropy, each epoch in the order of
        ``np.random.default_rng(0)``'s next permutation; returns the last
        batch's loss and the accuracy on the training patches."""
        opt = torch.optim.Adam(self.model.parameters(), lr=learning_rate,
                               eps=1e-8)
        x = torch.from_numpy(np.asarray(patches, np.float32)).to(
            self.device)
        y = torch.from_numpy(np.asarray(labels, np.float32)).to(self.device)
        n = len(x)
        rng = np.random.default_rng(0)
        loss = torch.tensor(float("inf"))
        self.model.train()
        for _ in range(epochs):
            order = torch.from_numpy(rng.permutation(n)).to(self.device)
            for i in range(0, n, batch_size):
                idx = order[i:i + batch_size]
                loss = F.binary_cross_entropy_with_logits(
                    self.model(x[idx]), y[idx])
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
        self.model.eval()
        acc = float(np.mean(
            (self.predict(patches) > 0.5) == (np.asarray(labels) > 0.5)))
        return {"loss": float(loss.detach()), "accuracy": acc}

    def train_step_sharded(self, mesh, patches, labels,
                           learning_rate: float = 1e-3):
        """The reference's data-parallel step over a device mesh: not
        ported yet."""
        raise NotImplementedError(
            "BlobClassifier.train_step_sharded: data-parallel training over "
            "a mesh is not ported yet (ROADMAP queue item 10)")

    # -- inference ------------------------------------------------------------

    def predict_tensor(self, patches: torch.Tensor,
                       batch_size: int = 4096) -> torch.Tensor:
        """P(true blob) of each patch of a tensor, on the model's device."""
        with torch.no_grad():
            out = [torch.sigmoid(self.model(
                patches[i:i + batch_size].to(self.device)))
                for i in range(0, len(patches), batch_size)]
        return torch.cat(out) if out else torch.zeros(0, device=self.device)

    def predict(self, patches, batch_size: int = 4096) -> np.ndarray:
        """P(true blob) per patch (numpy float32)."""
        if not torch.is_tensor(patches):
            patches = torch.from_numpy(np.asarray(patches, np.float32))
        return self.predict_tensor(patches, batch_size).cpu().numpy()

    def save(self, path: str) -> None:
        """Pickle the weights in the reference's layout."""
        with open(path, "wb") as f:
            pickle.dump(self.params, f)

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda"
             ) -> "BlobClassifier":
        """A classifier from a model file of either package (the
        reference's pickle) or a checkpoint of this one (``torch.save`` of
        the state dict, ``utils.checkpoint.save_classifier_state``)."""
        if zipfile.is_zipfile(path):
            params = torch.load(path, map_location="cpu", weights_only=True)
        else:
            with open(path, "rb") as f:
                params = pickle.load(f)
        return cls(params=params, device=device)


def _state_dict(params) -> Dict[str, torch.Tensor]:
    """A state dict of :class:`PatchCNN` from the reference's tree or from
    a state dict."""
    if "params" in params or "Conv_0" in params:
        return params_from_reference(params)
    return params


def classify_blobs(
        clf: BlobClassifier, roi: np.ndarray, blobs: np.ndarray,
        threshold: float = 0.5, channel: Optional[int] = None
) -> np.ndarray:
    """Classify the blobs (of ``channel``, default all) on ``roi``'s
    patches and write ``P >= threshold`` into their ``confirmed`` column
    (a copy of ``blobs``)."""
    if blobs is None or len(blobs) == 0:
        return blobs
    mask = np.ones(len(blobs), bool)
    if channel is not None:
        mask = blobs_mod.Blobs.get_blobs_channel(blobs) == channel
    patches = _patches(roi, blobs[mask], PATCH_SIZE, clf.device)
    probs = clf.predict_tensor(patches).cpu().numpy()
    out = np.array(blobs)
    out[np.flatnonzero(mask), 4] = (probs >= threshold).astype(float)
    return out


def classify_whole_image(
        clf: BlobClassifier, image: np.ndarray, blobs: np.ndarray,
        chunk_planes: int = 100, **kwargs) -> np.ndarray:
    """:func:`classify_blobs` over ``image`` in chunks of ``chunk_planes``
    z planes, each blob in the chunk of its z (its patch's plane clipped
    into the chunk)."""
    out = np.array(blobs)
    z = blobs[:, 0]
    for z0 in range(0, image.shape[0], chunk_planes):
        z1 = min(z0 + chunk_planes, image.shape[0])
        sel = (z >= z0) & (z < z1)
        if not sel.any():
            continue
        sub_blobs = np.array(blobs[sel])
        sub_blobs[:, 0] -= z0
        classified = classify_blobs(clf, image[z0:z1], sub_blobs, **kwargs)
        out[np.flatnonzero(sel), 4] = classified[:, 4]
    return out


def classify_patches(model, x: np.ndarray, thresh: float = 0.5
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Predictions (``score > thresh``) and scores for a stack of patches;
    ``model`` is a :class:`BlobClassifier` or has a ``predict`` method."""
    y_score = np.asarray(model.predict(x)).squeeze()
    y_pred = (y_score > thresh).astype(int)
    return y_pred, y_score


def setup_classification_roi(
        image5d: np.ndarray, subimg_offset: Sequence[int],
        subimg_size: Sequence[int], blobs, patch_size: int,
        blobs_relative: bool = False):
    """A sub-image (z,y,x ``subimg_offset``/``subimg_size``) with a y,x
    border of ``patch_size // 2`` (clipped to the image), so that edge
    blobs get whole patches.

    Returns ``(roi, blobs_roi_relative, border)``: blobs outside the
    sub-image are dropped and coordinates become relative to the bordered
    ROI's origin.
    """
    half = patch_size // 2
    vol = image5d[0] if image5d.ndim >= 4 else image5d
    shape = vol.shape[:3]
    off = np.asarray(subimg_offset, int)
    size = np.asarray(subimg_size, int)
    lo = np.array([off[0], max(off[1] - half, 0), max(off[2] - half, 0)])
    hi = np.array([
        min(off[0] + size[0], shape[0]),
        min(off[1] + size[1] + half, shape[1]),
        min(off[2] + size[2] + half, shape[2])])
    roi = vol[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
    border = off - lo

    arr = blobs.blobs if hasattr(blobs, "blobs") else blobs
    if arr is None or len(arr) == 0:
        return roi, arr, border
    coords = np.array(arr[:, :3], float)
    if not blobs_relative:
        coords = coords - off
    keep = np.all((coords >= 0) & (coords < size), axis=1)
    rel = np.array(arr[keep])
    rel[:, :3] = coords[keep] + border
    return roi, rel, border


class ClassifyImage:
    """Whole-image classification: :func:`classify_whole_image` of the
    blobs on the image's first channel, as the reference does for the
    blobs of every channel."""

    def __init__(self, clf: BlobClassifier, image5d: np.ndarray,
                 blobs=None):
        self.clf = clf
        self.image5d = image5d
        self.blobs = blobs

    def classify_whole_image(self, blobs=None, **kwargs) -> np.ndarray:
        arr = blobs if blobs is not None else (
            self.blobs.blobs if hasattr(self.blobs, "blobs")
            else self.blobs)
        vol = self.image5d[0] if self.image5d.ndim >= 4 else self.image5d
        if vol.ndim > 3:
            vol = vol[..., 0]
        return classify_whole_image(self.clf, vol, arr, **kwargs)
