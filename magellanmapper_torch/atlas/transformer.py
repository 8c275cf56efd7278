"""Whole-image transpose/rescale/preprocess with out-of-core output, on
PyTorch.

Port of ``magellanmapper_tpu/atlas/transformer.py``:
``get_transposed_image_path``, the ``make_modifier_*`` helpers,
:func:`transpose_img` (plane reorientation and rescaling streamed from
the source memmap into a memmapped float32 ``.npy`` with the reference's
metadata), :func:`preprocess_img`, :func:`rotate_img` and
:class:`Downsampler`.

:func:`transpose_img` keeps the reference's two passes and their float32
arithmetic: pass 1 resizes the output's y and x per chunk of
``chunk_z`` output planes, pass 2 resizes z over the intermediate, and
only when the depth changes. Each chunk is the source's slab along the
axis that becomes the output's z, copied in the source's own order into
a pinned host buffer (a strided copy with contiguous runs, no transpose
on the host), converted to float32 and permuted on the device, then
resized there with ``ops.resize``; the result comes back to a host
intermediate. Pass 2 streams column blocks of that intermediate through
the device. So the device holds a chunk at a time, never the volume.

``mesh=`` (the reference's sharded resize) raises until ROADMAP queue
item 10.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.cv import cv_nd
from magellanmapper_torch.io import np_io
from magellanmapper_torch.ops import preproc
from magellanmapper_torch.ops import resize as resize_ops
from magellanmapper_torch.utils import libmag

_logger = logging.getLogger(__name__)

#: output axes (z, y, x) of each plane, as source axes
PLANE_AXES = {None: (0, 1, 2), "xy": (0, 1, 2), "xz": (1, 0, 2),
              "yz": (2, 1, 0)}
#: voxels a pass-2 column block may hold on the device
PASS2_VOXELS = 1 << 27


def get_transposed_image_path(
        img_path: str, scale: Optional[float] = None,
        target_size: Optional[Sequence[int]] = None,
        plane: Optional[str] = None) -> str:
    """Path for a transposed/rescaled image
    (reference ``transformer.get_transposed_image_path``)."""
    modifier = ""
    if plane and plane != "xy":
        modifier += f"_plane{plane}"
    if scale is not None:
        modifier += f"_scale{scale}"
    elif target_size is not None:
        modifier += "_resized({},{},{})".format(*target_size)
    if not modifier:
        return img_path
    return libmag.insert_before_ext(img_path, modifier)


class _Stager:
    """Copies host slabs to the device: through one reused pinned buffer
    on a card, directly from the array on the CPU."""

    def __init__(self, dev: torch.device, max_shape, dtype):
        self.dev = dev
        self.buf = None
        if dev.type == "cuda":
            self.buf = torch.empty(
                int(np.prod(max_shape)),
                dtype=torch.from_numpy(np.zeros(0, dtype)).dtype,
                pin_memory=True)

    def __call__(self, slab: np.ndarray) -> torch.Tensor:
        if self.buf is None:
            return torch.from_numpy(np.array(slab))
        # the previous slab's copy has finished: its result was pulled
        # back to the host before this call
        host = self.buf[:slab.size].view(slab.shape)
        np.copyto(host.numpy(), slab)
        return host.to(self.dev, non_blocking=True)


def transpose_img(
        img_path: str,
        plane: Optional[str] = None,
        rescale: Optional[float] = None,
        target_size: Optional[Sequence[int]] = None,
        chunk_z: int = 64, mesh=None, device="cuda") -> str:
    """Transpose and/or rescale a whole image, streaming chunks from the
    source memmap through the resize on ``device`` into a memmapped
    float32 output (reference ``transformer.transpose_img``).

    Returns the output image path base.
    """
    if mesh is not None:
        raise NotImplementedError(
            "transpose_img(mesh=...): the sharded resize is not ported "
            "yet (ROADMAP queue item 10)")
    dev = device_mod.resolve(device)
    img5d = np_io.read_file(img_path)
    vol = img5d.img
    if vol.ndim < 4:
        vol = vol[None]
    t, z, y, x = vol.shape[:4]
    res = (img5d.resolutions[0] if img5d.resolutions is not None
           else np.ones(3))

    perm = PLANE_AXES[plane]
    shape_tp = tuple(int(v) for v in np.asarray((z, y, x))[list(perm)])
    res_tp = res[list(perm)]
    if rescale is not None:
        out_shape = tuple(int(s * rescale) for s in shape_tp)
        res_out = res_tp / rescale
    elif target_size is not None:
        out_shape = tuple(int(s) for s in target_size)
        res_out = res_tp * np.divide(shape_tp, out_shape)
    else:
        out_shape = shape_tp
        res_out = res_tp

    out_path = get_transposed_image_path(img_path, rescale, target_size,
                                         plane)
    if out_path == img_path:
        return img_path  # no-op transform
    path_img, path_meta = np_io.make_filenames(out_path)
    chan = tuple(vol.shape[4:])
    full_shape = tuple(int(v) for v in (t,) + out_shape + chan)
    out = np.lib.format.open_memmap(
        path_img, mode="w+", dtype=np.float32, shape=full_shape)

    # source axis that becomes the output's z, and the permutation of a
    # source slab (t dropped) into output order, channels kept last
    z_src = perm[0]
    slab_perm = perm + tuple(range(3, 3 + len(chan)))
    slab_max = list(vol.shape[1:])
    slab_max[z_src] = min(chunk_z, shape_tp[0])
    stage = None
    for ti in range(t):
        if out_shape == shape_tp:
            out[ti] = np.transpose(vol[ti], slab_perm)
            continue
        if stage is None:
            stage = _Stager(dev, slab_max, vol.dtype)
        inter_shape = (shape_tp[0],) + tuple(out_shape[1:])
        inter = np.empty(inter_shape + chan, np.float32)
        for z0 in range(0, shape_tp[0], chunk_z):
            z1 = min(z0 + chunk_z, shape_tp[0])
            index = [slice(None)] * vol[ti].ndim
            index[z_src] = slice(z0, z1)
            src = stage(vol[ti][tuple(index)])
            src = src.to(torch.float32).permute(slab_perm)
            sub_shape = (z1 - z0,) + tuple(out_shape[1:])
            inter[z0:z1] = resize_ops.resize(src, sub_shape).cpu().numpy()
        if inter_shape[0] == out_shape[0]:
            out[ti] = inter
            continue
        # pass 2: z over column blocks of the intermediate
        row = int(np.prod(inter_shape[::2])) * int(np.prod(chan or (1,)))
        step = max(1, PASS2_VOXELS // max(row, 1))
        for y0 in range(0, inter_shape[1], step):
            y1 = min(y0 + step, inter_shape[1])
            cols = torch.from_numpy(
                np.ascontiguousarray(inter[:, y0:y1])).to(dev)
            out[ti, :, y0:y1] = resize_ops.resize(
                cols, (out_shape[0], y1 - y0, out_shape[2])).cpu().numpy()
    out.flush()

    near_min, near_max = np_io.calc_intensity_bounds(out)
    np_io.save_image_info(
        path_meta, [os.path.basename(out_path)], [full_shape],
        [list(res_out)], near_min=near_min, near_max=near_max,
        scaling=np.divide(out_shape, shape_tp).tolist(), plane=plane)
    _logger.info("Transposed %s -> %s %s on %s", img_path, out_path,
                 full_shape, dev)
    return out_path


def preprocess_img(
        image5d: np.ndarray, preprocs: Sequence[str],
        channel: Optional[int] = None, out_path: Optional[str] = None,
        device="cuda") -> np.ndarray:
    """Whole-image preprocessing tasks (reference
    ``transformer.preprocess_img``; tasks: saturate, denoise, remap,
    rotate90). Saturate (its percentiles by K4 on a card) and denoise run
    on ``device``; remap and rotate90 on the host, as in the reference."""
    dev = device_mod.resolve(device)
    vol = np.array(image5d[0] if image5d.ndim >= 4 else image5d,
                   np.float32)
    multichannel = vol.ndim > 3
    channels = (range(vol.shape[3]) if multichannel else [0]) \
        if channel is None else [channel]
    for task in preprocs:
        task = str(task).lower()
        for chl in channels:
            sub = vol[..., chl] if multichannel else vol
            if task == "saturate":
                sub = preproc.saturate(torch.from_numpy(
                    np.ascontiguousarray(sub)).to(dev), 5.0, 99.5)
                sub = sub.cpu().numpy()
            elif task == "denoise":
                sub = preproc.denoise(
                    torch.from_numpy(np.ascontiguousarray(sub)).to(dev),
                    0.2, 1.0, unsharp_strength=0.3, erosion_threshold=0.2)
                sub = sub.cpu().numpy()
            elif task == "remap":
                sub = cv_nd.remap_intensity(sub)
            elif task == "rotate90":
                sub = np.rot90(sub, axes=(1, 2))
            else:
                raise ValueError(f"unknown preprocessing task: {task}")
            if multichannel:
                vol[..., chl] = sub
            else:
                vol = sub
    out = vol[None]
    if out_path:
        np_io.write_npy(out_path, out)
    return out


def make_modifier_plane(plane: str) -> str:
    """Filename modifier for a plane transposition
    (reference ``transformer.make_modifier_plane``)."""
    return f"plane{plane.upper()}"


def make_modifier_scale(scale: float) -> str:
    """Filename modifier for rescaling; decimal points become ``pt``
    (reference ``transformer.make_modifier_scale``)."""
    return f"scale{scale}".replace(".", "pt")


def make_modifier_resized(target_size) -> str:
    """Filename modifier for a resize target (x,y,z)
    (reference ``transformer.make_modifier_resized``)."""
    return "resized({},{},{})".format(*target_size)


def rotate_img(roi: np.ndarray, rotate: dict,
               order: Optional[int] = None) -> np.ndarray:
    """Apply an atlas profile's rotation schedule on the host
    (reference ``transformer.rotate_img``); ``order=0`` for label images.
    ``rotate`` carries ``rotation`` as (angle, axis) pairs plus
    ``resize`` and default ``order``."""
    if order is None:
        order = rotate.get("order", 1)
    out = np.copy(roi)
    for angle, axis in rotate.get("rotation") or []:
        out = cv_nd.rotate_nd(
            out, angle, axis, order=order,
            resize=rotate.get("resize", False))
    return out


class Downsampler:
    """Rescale of a large image (reference ``transformer.Downsampler``):
    carries the image and rescales it through ``cv_nd.rescale_resize`` on
    ``device``."""

    def __init__(self, img: np.ndarray, device="cuda"):
        self.img = img
        self.device = device

    def rescale(self, scale=None, target_size=None, order: int = 1):
        """Rescale by factor or to a target x,y,z size; returns the
        rescaled array."""
        if target_size is not None:
            out_shape = tuple(int(s) for s in target_size[::-1])
            return cv_nd.rescale_resize(
                self.img, out_shape, order=order, preserve_range=True,
                device=self.device)
        return cv_nd.rescale_resize(
            self.img, float(scale), order=order, preserve_range=True,
            device=self.device)
