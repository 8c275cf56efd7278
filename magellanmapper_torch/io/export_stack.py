"""Plane export and animation.

Port of ``magellanmapper_tpu/io/export_stack.py``: z-planes to image files
(:func:`export_planes`, one file a channel with ``separate_channels``), a
montage (:func:`stack_to_img`), plane animations (:func:`animate_imgs`),
orbit animations of a 3D render (:func:`animate_rotation_3d`), and the
plane-stack state (:class:`StackPlaneIO`, :func:`setup_stack`,
:func:`reg_planes_to_img`). The files are matplotlib's, as the
reference's, imported when a writer is called; the orbit's frames
(:func:`render_rotation`) render on ``device`` through
:mod:`magellanmapper_torch.ops.render3d` and need no matplotlib.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

import numpy as np

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.ops import preproc, render3d
from magellanmapper_torch.plot import plot_support

_logger = logging.getLogger(__name__)


def _pyplot():
    """``(pyplot, animation)`` on the Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation
    return plt, animation


def export_planes(
        image: np.ndarray, out_dir: str, ext: str = "png",
        channel: Optional[int] = None,
        separate_channels: bool = False) -> list:
    """Write each z-plane as ``plane_<z>.<ext>`` (multichannel planes
    overlaid in the channel colours, or one channel), or each channel of
    each plane as ``plane_<z>_chl<c>.<ext>``; returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    vol = image[0] if image.ndim >= 4 and image.shape[0] == 1 else image
    paths = []
    multichannel = vol.ndim > 3
    for z in range(vol.shape[0]):
        plane = vol[z]
        if multichannel and channel is not None:
            plane = plane[..., channel]
        if separate_channels and multichannel:
            for c in range(plane.shape[2]):
                path = os.path.join(
                    out_dir, f"plane_{z:05d}_chl{c}.{ext}")
                _save_plane(plane[..., c], path)
                paths.append(path)
        else:
            path = os.path.join(out_dir, f"plane_{z:05d}.{ext}")
            rgb = plot_support.overlay_images(plane) if (
                multichannel and channel is None) else plane
            _save_plane(rgb, path)
            paths.append(path)
    _logger.info("exported %d planes to %s", len(paths), out_dir)
    return paths


def _save_plane(plane: np.ndarray, path: str) -> None:
    plt, _ = _pyplot()
    fig, ax = plt.subplots()
    ax.imshow(plane, cmap=None if plane.ndim > 2 else "gray")
    ax.axis("off")
    fig.savefig(path, dpi=150, bbox_inches="tight", pad_inches=0)
    plt.close(fig)


def _write_animation(frames, n_frames: int, first: np.ndarray,
                     out_path: str, fps: int, cmap) -> str:
    """Animate ``frames(i)`` for ``i < n_frames`` into ``out_path``: an MP4
    through ffmpeg where the path asks for one and ffmpeg is there,
    otherwise a GIF (Pillow)."""
    plt, animation = _pyplot()
    fig, ax = plt.subplots()
    ax.axis("off")
    im = ax.imshow(first, cmap=cmap, animated=True)

    def update(i):
        im.set_array(frames(i))
        return [im]

    anim = animation.FuncAnimation(fig, update, frames=n_frames, blit=True)
    if out_path.endswith(".mp4") and animation.FFMpegWriter.isAvailable():
        anim.save(out_path, writer=animation.FFMpegWriter(fps=fps))
    else:
        if out_path.endswith(".mp4"):
            _logger.warning(
                "ffmpeg not available; writing GIF instead of %s", out_path)
        if not out_path.endswith(".gif"):
            out_path = (out_path[:-4] if out_path.endswith(".mp4")
                        else out_path) + ".gif"
        anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    _logger.info("saved animation to %s", out_path)
    return out_path


def animate_imgs(
        image: np.ndarray, out_path: str, fps: int = 10,
        channel: Optional[int] = None) -> str:
    """Animate the z-planes into a GIF, or an MP4 for an ``.mp4`` path
    when ffmpeg is there (a GIF beside it otherwise); multichannel planes
    are overlaid unless ``channel`` picks one. Returns the written path."""
    vol = image[0] if image.ndim >= 4 and image.shape[0] == 1 else image
    multichannel = vol.ndim > 3

    def frame(z):
        plane = vol[z]
        if multichannel:
            plane = (plane[..., channel] if channel is not None
                     else plot_support.overlay_images(plane))
        return plane

    return _write_animation(frame, vol.shape[0], frame(0), out_path, fps,
                            None if multichannel else "gray")


def render_rotation(
        vol, n_frames: int = 36, mode: str = "mip", elev: float = 20.0,
        out_hw=(384, 384), level: Optional[float] = None,
        vmin_frac: float = 0.1, device="cuda") -> List[np.ndarray]:
    """The frames of an orbit: ``n_frames`` azimuth steps through the
    shear-warp engines on ``device``, (H, W, 3) float32 on the host.
    ``mode``: ``"mip"`` or ``"volume"``
    (:func:`~magellanmapper_torch.ops.render3d.render_volume_sw`, window
    from ``vmin_frac`` of the maximum to the maximum) or ``"isosurface"``
    (:func:`~magellanmapper_torch.ops.render3d.render_isosurface_sw` at
    ``level``, by default the volume's Otsu threshold)."""
    dev = device_mod.resolve(device)
    v = render3d._volume(vol, dev)
    vmax = float(v.max())
    if mode == "isosurface" and level is None:
        level = float(preproc.otsu_threshold(v))
    frames = []
    for i in range(n_frames):
        az = 360.0 * i / n_frames
        if mode == "isosurface":
            rgb, _ = render3d.render_isosurface_sw(
                v, level, az, elev, out_hw=tuple(out_hw), device=dev)
        else:
            rgb = render3d.render_volume_sw(
                v, az, elev, vmin=vmin_frac * vmax, vmax=vmax,
                out_hw=tuple(out_hw),
                mode="mip" if mode == "mip" else "composite", device=dev)
        frames.append(rgb.cpu().numpy())
    return frames


def animate_rotation_3d(
        vol: np.ndarray, out_path: str, n_frames: int = 36,
        mode: str = "mip", elev: float = 20.0, fps: int = 12,
        out_hw=(384, 384), level: Optional[float] = None,
        vmin_frac: float = 0.1, device="cuda") -> str:
    """Orbit animation of a 3D render (the rotation videos the reference
    scripts through the Mayavi camera): :func:`render_rotation`'s frames
    written as a GIF, or an MP4 for an ``.mp4`` path when ffmpeg is
    there. Returns the written path."""
    frames = render_rotation(vol, n_frames, mode, elev, out_hw, level,
                             vmin_frac, device)
    if not (out_path.endswith(".mp4") or out_path.endswith(".gif")):
        out_path = out_path.rsplit(".", 1)[0] + ".gif"
    return _write_animation(lambda i: frames[i], len(frames), frames[0],
                            out_path, fps, None)


def stack_to_img(
        image: np.ndarray, out_path: str,
        slice_range: Optional[Sequence[int]] = None,
        n_cols: int = 4) -> str:
    """Montage of z-planes (``slice_range``: start, stop[, step]) in one
    figure of ``n_cols`` columns; returns the saved path."""
    plt, _ = _pyplot()
    vol = image[0] if image.ndim >= 4 and image.shape[0] == 1 else image
    zs = range(vol.shape[0]) if slice_range is None else range(
        *slice_range)
    zs = list(zs)
    n_rows = -(-len(zs) // n_cols)
    fig, axes = plt.subplots(
        n_rows, n_cols, figsize=(3 * n_cols, 3 * n_rows))
    axes = np.atleast_1d(axes).ravel()
    for ax in axes:
        ax.axis("off")
    for ax, z in zip(axes, zs):
        plane = vol[z]
        if plane.ndim > 2:
            plane = plot_support.overlay_images(plane)
        ax.imshow(plane, cmap=None if plane.ndim > 2 else "gray")
        ax.set_title(f"z={z}", fontsize=8)
    return plot_support.save_fig(fig, out_path)


class StackPlaneIO:
    """Plane-stack export state: the images (intensity first, then label
    images), their rescale factor, colormaps and display settings; builds
    the rescaled planes on ``device``."""

    def __init__(self, images=None, rescale: float = 1.0,
                 cmaps_labels=None, origin=None, aspect=None,
                 device="cuda"):
        self.images = images
        self.rescale = rescale
        self.cmaps_labels = cmaps_labels
        self.origin = origin
        self.aspect = aspect
        self.fn_process = None
        self.device = device

    @classmethod
    def set_data(cls, images, fn_process=None, rescale: float = 1.0,
                 device="cuda"):
        """State of ``images`` with a per-plane ``fn_process(i, plane)``
        returning ``(_, plane)``."""
        obj = cls(images, rescale, device=device)
        obj.fn_process = fn_process
        return obj

    def build_stack(self, slice_vals=None):
        """For each plane (``slice_vals``: start, stop[, step]) the list of
        each image's plane, rescaled (labels at order 0) and processed."""
        if not self.images:
            return None
        from magellanmapper_torch.cv import cv_nd
        imgs = self.images
        n = len(imgs[0])
        idx = range(n) if slice_vals is None else range(*slice_vals)
        out = []
        for i in idx:
            planes = []
            for j, img in enumerate(imgs):
                plane = np.asarray(img[i])
                if self.rescale and self.rescale != 1:
                    plane = cv_nd.rescale_resize(
                        plane, self.rescale, order=1 if j == 0 else 0,
                        preserve_range=True, device=self.device)
                if self.fn_process is not None:
                    _, plane = self.fn_process(i, plane)
                planes.append(plane)
            out.append(planes)
        return out


def setup_stack(image5d: Optional[np.ndarray] = None,
                path: Optional[str] = None, offset=None, roi_size=None,
                slice_vals=None, rescale: Optional[float] = None,
                labels_imgs=None, device="cuda") -> StackPlaneIO:
    """A plane stack of a volume (or the image at ``path``) and its label
    images, cut to the z,y,x ``offset`` and ``roi_size`` when given."""
    if image5d is None and path:
        from magellanmapper_torch.io import np_io
        image5d = np_io.read_file(path).img
    vol = image5d[0] if image5d is not None and image5d.ndim >= 4 \
        else image5d
    if offset is not None and roi_size is not None:
        off = np.asarray(offset, int)
        size = np.asarray(roi_size, int)
        vol = vol[off[0]:off[0] + size[0], off[1]:off[1] + size[1],
                  off[2]:off[2] + size[2]]
    images = [vol]
    for labels_img in labels_imgs or ():
        if labels_img is not None:
            img = labels_img
            if offset is not None and roi_size is not None:
                img = img[off[0]:off[0] + size[0],
                          off[1]:off[1] + size[1],
                          off[2]:off[2] + size[2]]
            images.append(img)
    io = StackPlaneIO(images, rescale or 1.0, device=device)
    io.slice_vals = slice_vals
    return io


def reg_planes_to_img(imgs, path: Optional[str] = None, ax=None):
    """One plane of each registered image (intensity, then labels and
    borders overlaid at half opacity) in one frame, saved to ``path``."""
    from magellanmapper_torch.plot import colormaps
    plt, _ = _pyplot()
    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.get_figure()
    ax.imshow(imgs[0], cmap="gray")
    for overlay in imgs[1:]:
        cmap = colormaps.get_labels_discrete_colormap(overlay, 0)
        ax.imshow(cmap(overlay), alpha=0.5)
    plot_support.hide_axes(ax, True)
    if path:
        fig.savefig(path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return fig
