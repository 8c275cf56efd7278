"""ROI preparation, Richardson-Lucy deconvolution and voxel surfaces.

Port of ``magellanmapper_tpu/plot/plot_3d.py``. Saturation, denoising and
the Otsu threshold run through :mod:`magellanmapper_torch.ops.preproc` on
``device``; :func:`deconvolve` iterates its FFT convolutions on the device
with ``torch.fft``. The ROI helpers are host copies.
:func:`show_surface_labels` triangulates each label's exposed voxel faces
with numpy, giving the reference's vertices and faces in its order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.cv import cv_nd
from magellanmapper_torch.ops import preproc


def setup_channels(
        roi: np.ndarray, channel: Optional[Sequence[int]],
        dim_channel: int) -> Tuple[bool, Sequence[int]]:
    """``(multichannel, channels)`` of an ROI."""
    multichannel = roi.ndim > dim_channel
    if multichannel:
        channels = (range(roi.shape[dim_channel]) if channel is None
                    else np.atleast_1d(channel))
    else:
        channels = [0]
    return multichannel, channels


def _per_channel(roi: np.ndarray, channel, fn, device) -> np.ndarray:
    """``fn`` (a float32 tensor on the device to a tensor) applied to each
    channel of ``roi``; float32 on the host."""
    dev = device_mod.resolve(device)
    multichannel, channels = setup_channels(roi, channel, 3)
    out = None
    for chl in channels:
        sub = roi[..., chl] if multichannel else roi
        res = fn(torch.from_numpy(np.asarray(sub, np.float32)).to(dev),
                 chl).cpu().numpy()
        if multichannel:
            if out is None:
                out = np.zeros(roi.shape, np.float32)
            out[..., chl] = res
        else:
            out = res
    return out


def saturate_roi(
        roi: np.ndarray, clip_vmin: float = 5, clip_vmax: float = 99.5,
        max_thresh_factor: float = 0.5,
        near_max: Optional[Sequence[float]] = None,
        channel: Optional[Sequence[int]] = None,
        device="cuda") -> np.ndarray:
    """Percentile saturation of each channel: clip to its ``clip_vmin``
    and ``clip_vmax`` percentiles (the upper one raised to
    ``near_max[chl] * max_thresh_factor``) and rescale to [0, 1]."""
    def fn(t, chl):
        nm = 1.0 if near_max is None else float(near_max[chl])
        return preproc.saturate(t, clip_vmin, clip_vmax,
                                nm * max_thresh_factor)
    return _per_channel(roi, channel, fn, device)


def denoise_roi(
        roi: np.ndarray, channel: Optional[Sequence[int]] = None,
        clip_min: float = 0.2, clip_max: float = 1.0,
        tot_var_denoise=None, unsharp_strength: float = 0.3,
        erosion_threshold: float = 0.2, device="cuda") -> np.ndarray:
    """The denoise chain of each channel (:func:`preproc.denoise`)."""
    def fn(t, chl):
        return preproc.denoise(t, clip_min, clip_max, tot_var_denoise,
                               unsharp_strength, erosion_threshold)
    return _per_channel(roi, channel, fn, device)


def threshold(roi: np.ndarray, device="cuda") -> np.ndarray:
    """Mask of the voxels above the ROI's Otsu threshold."""
    dev = device_mod.resolve(device)
    t = preproc.otsu_threshold(
        torch.from_numpy(np.asarray(roi, np.float32)).to(dev))
    return roi > float(t)


def remap_intensity(roi: np.ndarray, channel=None) -> np.ndarray:
    """Histogram-equalisation remap (:func:`cv_nd.remap_intensity`)."""
    return cv_nd.remap_intensity(roi, channel)


def prepare_subimg(
        image5d: np.ndarray, offset: Sequence[int],
        size: Sequence[int]) -> np.ndarray:
    """The z,y,x sub-image of a 3-5D image."""
    vol = image5d[0] if image5d.ndim >= 4 else image5d
    sl = tuple(slice(o, o + s) for o, s in zip(offset, size))
    return vol[sl]


def prepare_roi(
        image5d: np.ndarray, offset: Sequence[int],
        size: Sequence[int]) -> np.ndarray:
    """The ROI at an x,y,z offset and size."""
    return prepare_subimg(image5d, offset[::-1], size[::-1])


def build_ground_truth(
        img3d: np.ndarray, blobs: np.ndarray,
        ellipsoid: bool = False) -> np.ndarray:
    """Blobs rasterised as spheres (or ellipsoids a third as deep in z)
    into a uint8 mask."""
    out = np.zeros(img3d.shape[:3], np.uint8)
    zz, yy, xx = np.indices(out.shape).astype(np.float32)
    for b in blobs:
        r = float(b[3])
        rz = r / 3 if ellipsoid else r
        mask = (((zz - b[0]) / max(rz, 1e-3)) ** 2
                + ((yy - b[1]) / max(r, 1e-3)) ** 2
                + ((xx - b[2]) / max(r, 1e-3)) ** 2) <= 1
        out[mask] = 1
    return out


def deconvolve(roi: np.ndarray, iterations: int = 30,
               psf: Optional[np.ndarray] = None, device="cuda"
               ) -> np.ndarray:
    """Richardson-Lucy deconvolution, by default with a 5^3 box PSF: each
    iteration two circular convolutions through ``rfftn``/``irfftn`` on
    the device, floored at 1e-12 as in the reference. Returns float32."""
    dev = device_mod.resolve(device)
    if psf is None:
        psf = np.ones((5, 5, 5), np.float32) / 125.0
    img = torch.clamp_min(
        torch.from_numpy(np.asarray(roi, np.float32)).to(dev), 1e-12)
    shape = tuple(img.shape)
    # the PSF padded to the image, its centre moved to the origin
    psf_pad = np.zeros(shape, np.float32)
    psf_pad[tuple(slice(0, s) for s in psf.shape)] = psf
    psf_pad = np.roll(psf_pad, [-(s // 2) for s in psf.shape],
                      axis=(0, 1, 2))
    otf = torch.fft.rfftn(torch.from_numpy(psf_pad).to(dev))
    otf_conj = torch.conj(otf)

    def conv(x, k):
        return torch.clamp_min(
            torch.fft.irfftn(torch.fft.rfftn(x) * k, s=shape), 1e-12)

    est = img
    for _ in range(iterations):
        est = est * conv(img / conv(est, otf), otf_conj)
    return est.cpu().numpy()


def get_isotropic_vis(settings) -> np.ndarray:
    """Isotropic rescale factor for visualisation from a profile."""
    isotropic = settings["isotropic_vis"]
    if isotropic is None:
        return np.ones(3)
    return np.asarray(isotropic, float)


def roi_center_to_offset(offset, shape, reverse: bool = False):
    """Centre to corner of an ROI (corner to centre with ``reverse``)."""
    half = np.floor_divide(shape, 2)
    out = np.add(offset, half) if reverse else np.subtract(offset, half)
    return tuple(int(v) for v in out)


def replace_vol(img: np.ndarray, vol: np.ndarray, center=None,
                offset=None, vol_as_mask=None) -> np.ndarray:
    """Place ``vol`` into ``img`` in place, cropped at its borders;
    ``center`` takes precedence over ``offset``."""
    if center is not None:
        offset = roi_center_to_offset(center, vol.shape[:img.ndim])
    offset = np.asarray(offset, int)
    lo_img = np.maximum(offset, 0)
    hi_img = np.minimum(offset + vol.shape[:img.ndim], img.shape)
    lo_vol = lo_img - offset
    hi_vol = lo_vol + (hi_img - lo_img)
    sl_img = tuple(slice(a, b) for a, b in zip(lo_img, hi_img))
    sl_vol = tuple(slice(a, b) for a, b in zip(lo_vol, hi_vol))
    if vol_as_mask is not None:
        mask = vol_as_mask[sl_vol]
        img[sl_img][mask] = vol[sl_vol][mask] if np.ndim(vol) else vol
    else:
        img[sl_img] = vol[sl_vol]
    return img


def pad_img(img: np.ndarray, offset, shape) -> np.ndarray:
    """Zero-pad an image into a larger canvas at ``offset``."""
    out_shape = list(img.shape)
    for i, s in enumerate(shape or ()):
        if s is not None:
            out_shape[i] = int(s)
    out = np.zeros(out_shape, img.dtype)
    sl = tuple(slice(int(o), int(o) + s)
               for o, s in zip(offset, img.shape))
    out[sl] = img
    return out


#: a voxel's six faces in the reference's order: (axis, direction)
_FACES = ((0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1))


def _voxel_surface_mesh(mask: np.ndarray):
    """``(verts, faces)`` of a mask's exposed voxel faces, two triangles a
    face.

    The reference walks the voxels in C order, each voxel's faces in
    :data:`_FACES` order, and numbers each face's corners (its origin,
    then one step along each of the other two axes, then both) on first
    sight. Here the exposed faces are listed in that order at once and
    their corners numbered by first occurrence, which gives the same
    vertices and faces.
    """
    coords = np.argwhere(mask)
    padded = np.pad(mask, 1)
    corners = []
    for ax, d in _FACES:
        nb = coords + 1
        nb[:, ax] += d
        exposed = ~padded[tuple(nb.T)]
        origin = coords.astype(float)
        if d > 0:
            origin[:, ax] += 1
        o0, o1 = (a for a in range(3) if a != ax)
        steps = np.zeros((4, 3))
        steps[1, o0] = steps[2, o1] = steps[3, o0] = steps[3, o1] = 1
        quad = origin[:, None, :] + steps[None]
        corners.append(np.where(exposed[:, None, None], quad, np.nan))
    # (voxel, face, corner, axis) in the reference's walk; drop the faces
    # that are not exposed
    quads = np.stack(corners, axis=1).reshape(-1, 4, 3)
    quads = quads[~np.isnan(quads[:, 0, 0])]
    if not len(quads):
        return np.asarray([], float), np.asarray([], int)
    seq = quads.reshape(-1, 3)
    uniq, first, inverse = np.unique(seq, axis=0, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first)
    rank = np.empty(len(order), int)
    rank[order] = np.arange(len(order))
    ids = rank[inverse.reshape(-1)].reshape(-1, 4)
    i00, i10, i01, i11 = ids.T
    faces = np.stack([np.stack([i00, i10, i11], 1),
                      np.stack([i00, i11, i01], 1)], 1).reshape(-1, 3)
    return uniq[order], faces


def show_surface_labels(segments: np.ndarray, vis=None) -> list:
    """``(label_id, verts, faces)`` of each positive label's voxel
    surface; appended to ``vis.surfaces`` when given."""
    meshes = []
    for lid in np.unique(segments):
        if lid <= 0:
            continue
        verts, faces = _voxel_surface_mesh(segments == lid)
        if len(faces):
            meshes.append((int(lid), verts, faces))
    if vis is not None and hasattr(vis, "surfaces"):
        vis.surfaces.extend(meshes)
    return meshes
