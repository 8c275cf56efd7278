"""Figure support: multichannel overlays, planes, axes and saving.

Copy of ``magellanmapper_tpu/plot/plot_support.py``: channel and label
overlays (``overlay_images``, ``ImageOverlayer``), plane extraction and
orientation (``extract_planes``, ``transpose_images``), display
downsampling, axes helpers and ``save_fig``. matplotlib is imported only
by the helpers that make a figure.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np

from magellanmapper_torch.plot import colormaps
from magellanmapper_torch.utils import libmag

_logger = logging.getLogger(__name__)

#: max displayed pixels per plane edge before downsampling
DOWNSAMPLE_MAX_ELTS = 1000


def transpose_images(
        plane: Optional[str], arrs: Sequence[np.ndarray]) -> list:
    """Reorient z,y,x arrays for the given viewing plane."""
    if plane in (None, "xy"):
        return list(arrs)
    out = []
    for arr in arrs:
        if plane == "xz":
            out.append(np.swapaxes(arr, 0, 1))
        elif plane == "yz":
            out.append(np.swapaxes(arr, 0, 2))
        else:
            raise ValueError(f"unknown plane: {plane}")
    return out


def get_downsample_max_sizes(
        shape: Sequence[int],
        max_elts: int = DOWNSAMPLE_MAX_ELTS) -> Optional[int]:
    """Downsampling step so plane edges stay under ``max_elts``."""
    largest = max(shape[1:3]) if len(shape) > 2 else max(shape)
    if largest <= max_elts:
        return None
    return int(np.ceil(largest / max_elts))


def overlay_images(
        plane_img: np.ndarray,
        channels: Optional[Sequence[int]] = None,
        alphas: Optional[Sequence[float]] = None,
        vmins: Optional[Sequence[float]] = None,
        vmaxs: Optional[Sequence[float]] = None,
        labels_plane: Optional[np.ndarray] = None,
        labels_cmap: Optional[colormaps.DiscreteColormap] = None,
        labels_alpha: float = 0.5) -> np.ndarray:
    """Blend a multichannel 2D plane (+ optional labels) into RGB, each
    channel windowed to its range and tinted by its channel colour."""
    multichannel = plane_img.ndim > 2
    if channels is None:
        channels = range(plane_img.shape[2]) if multichannel else [0]
    out = np.zeros(plane_img.shape[:2] + (3,), dtype=float)
    for ci, chl in enumerate(channels):
        sub = plane_img[..., chl] if multichannel else plane_img
        vmin = vmins[ci] if vmins else float(np.nanmin(sub))
        vmax = vmaxs[ci] if vmaxs else float(np.nanmax(sub))
        span = max(vmax - vmin, 1e-12)
        norm = np.clip((sub - vmin) / span, 0, 1)
        color = np.asarray(
            colormaps.CHANNEL_COLORS[chl % len(colormaps.CHANNEL_COLORS)])
        alpha = alphas[ci] if alphas else 1.0
        out += alpha * norm[..., None] * color
    out = np.clip(out, 0, 1)
    if labels_plane is not None:
        if labels_cmap is None:
            labels_cmap = colormaps.DiscreteColormap(
                np.unique(labels_plane))
        rgba = labels_cmap(labels_plane)
        mask = rgba[..., 3] > 0
        out[mask] = ((1 - labels_alpha) * out[mask]
                     + labels_alpha * rgba[mask, :3])
    return out


def save_fig(
        fig, path: str, fmt: Optional[str] = None, dpi: int = 150) -> str:
    """Save a matplotlib figure, backing up existing output."""
    if fmt and not path.endswith(f".{fmt}"):
        path = f"{os.path.splitext(path)[0]}.{fmt}"
    libmag.backup_file(path)
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    _logger.info("saved figure to %s", path)
    return path


def alpha_blend_intersection(
        img1: np.ndarray, img2: np.ndarray, alpha: float = 0.5,
        mask1: Optional[np.ndarray] = None,
        mask2: Optional[np.ndarray] = None):
    """Blend two images only where their foregrounds intersect, keeping
    full opacity elsewhere. Returns per-image
    alpha maps ``(alpha1, alpha2)``."""
    if mask1 is None:
        mask1 = img1 != 0
    if mask2 is None:
        mask2 = img2 != 0
    inter = mask1 & mask2
    a1 = np.where(inter, alpha, np.where(mask1, 1.0, 0.0))
    a2 = np.where(inter, 1.0 - alpha, np.where(mask2, 1.0, 0.0))
    return a1, a2


def extract_planes(image5d: np.ndarray, plane_n, plane: str = "xy",
                   max_intens_proj: bool = False):
    """Extract 2D plane(s) along a planar orientation. Returns
    ``(img2d, aspect, origin)``."""
    img3d = image5d[0] if image5d.ndim >= 4 else image5d
    axis = {"xy": 0, "xz": 1, "yz": 2}.get(plane, 0)
    moved = np.moveaxis(img3d, axis, 0) if axis else img3d
    origin = None
    aspect = 1.0
    if plane == "xz":
        origin = "lower"
    img2d = moved[plane_n]
    if max_intens_proj and img2d.ndim > 2:
        img2d = np.max(img2d, axis=0)
    return img2d, aspect, origin


def max_plane(img3d: np.ndarray, plane: str = "xy") -> int:
    """Number of planes along a planar orientation's axis."""
    return img3d.shape[{"xy": 0, "xz": 1, "yz": 2}.get(plane, 0)]


def get_aspect_ratio(plane: str = "xy",
                     resolutions=None) -> tuple:
    """Aspect ratio and imshow origin for a planar orientation."""
    aspect = None
    origin = None
    if resolutions is not None:
        res = np.asarray(resolutions, float)   # z,y,x
        if plane == "xz":
            origin = "lower"
            aspect = res[0] / res[2]
        elif plane == "yz":
            origin = "lower"
            aspect = res[0] / res[1]
        else:
            aspect = res[1] / res[2]
    return aspect, origin


def scroll_plane(event, z_overview: int, max_size: int, jump=None,
                 max_scroll: Optional[int] = None) -> int:
    """New plane index from a scroll/arrow-key event."""
    step = 0
    if hasattr(event, "step") and event.step:
        step = int(event.step)
        if max_scroll is not None:
            step = int(np.clip(step, -max_scroll, max_scroll))
    elif getattr(event, "key", None) in ("up", "right"):
        step = 1
    elif getattr(event, "key", None) in ("down", "left"):
        step = -1
    elif getattr(event, "key", None) == "j" and jump is not None:
        target = jump(event)
        if target is not None:
            return int(np.clip(target, 0, max_size - 1))
    return int(np.clip(z_overview + step, 0, max_size - 1))


def hide_axes(ax, frame_off: bool = False) -> None:
    """Hide axes ticks and optionally the frame."""
    ax.get_xaxis().set_visible(False)
    ax.get_yaxis().set_visible(False)
    if frame_off:
        ax.set_frame_on(False)


def scale_axes(ax, scale_x: Optional[str] = None,
               scale_y: Optional[str] = None) -> None:
    """Apply matplotlib axis scale modes."""
    if scale_x:
        ax.set_xscale(scale_x)
    if scale_y:
        ax.set_yscale(scale_y)


def fit_frame_to_image(fig, shape=None, aspect=None) -> None:
    """Shrink a figure to its image content."""
    if shape is not None:
        if aspect is None:
            aspect = 1.0
        fig.set_size_inches(
            shape[1] / fig.dpi, shape[0] * aspect / fig.dpi)
    fig.tight_layout(pad=0)


def add_scale_bar(ax, downsample=None, plane: str = "xy",
                  resolutions=None, color: str = "w") -> None:
    """Draw a micron scale bar from the x-resolution."""
    if resolutions is None:
        return
    res = np.asarray(resolutions, float)
    res_x = {"xy": res[2], "xz": res[2], "yz": res[1]}.get(plane, res[2])
    if downsample:
        res_x *= downsample
    xlim = ax.get_xlim()
    width_px = abs(xlim[1] - xlim[0])
    # pick a round micron length near 1/5 of the view
    target_um = width_px * res_x / 5
    mag = 10 ** np.floor(np.log10(max(target_um, 1e-12)))
    bar_um = float(mag * min(
        (1, 2, 5, 10), key=lambda m: abs(m * mag - target_um)))
    bar_px = bar_um / res_x
    y = ax.get_ylim()[0]
    ax.plot([xlim[0] + width_px * 0.05,
             xlim[0] + width_px * 0.05 + bar_px],
            [y, y], color=color, linewidth=3)
    ax.annotate(f"{bar_um:g} µm",
                (xlim[0] + width_px * 0.05 + bar_px / 2, y),
                color=color, ha="center", va="bottom")


def get_plane_axis(plane: str, get_index: bool = False):
    """Axis name (or z,y,x index) orthogonal to a plane."""
    mapping = {"xy": ("z", 0), "xz": ("y", 1), "yz": ("x", 2)}
    name, idx = mapping.get(plane, ("z", 0))
    return idx if get_index else name


def set_overview_title(ax, plane: str, z_overview, zoom: str = "",
                       level: int = 0,
                       max_intens_proj: bool = False) -> None:
    """Title an overview plot with plane position and zoom."""
    plane_axis = get_plane_axis(plane)
    if level == 0:
        title = f"{plane_axis}={z_overview}"
        if max_intens_proj:
            title += " (MIP)"
    else:
        title = f"{zoom}x" if zoom else f"level {level}"
    ax.set_title(title)


def set_scinot(ax, lims=(-3, 4), lbls=None, units=None) -> None:
    """Scientific-notation ticks with exponents folded into labels."""
    try:
        ax.ticklabel_format(style="sci", scilimits=lims, useMathText=True)
    except AttributeError:
        pass
    if lbls:
        if len(lbls) > 0 and lbls[0]:
            unit = f" ({units[0]})" if units and units[0] else ""
            ax.set_ylabel(f"{lbls[0]}{unit}")
        if len(lbls) > 1 and lbls[1]:
            unit = f" ({units[1]})" if units and len(units) > 1 and \
                units[1] else ""
            ax.set_xlabel(f"{lbls[1]}{unit}")


def scale_xticks(ax, rotation=80, x_labels=None) -> None:
    """Rotate/replace x tick labels."""
    if x_labels is not None:
        ax.set_xticks(range(len(x_labels)))
        ax.set_xticklabels(x_labels)
    for lbl in ax.get_xticklabels():
        lbl.set_rotation(rotation)
        lbl.set_horizontalalignment("right")


def setup_vspans(df, col_vspan: str, vspan_fmt: str = "{}"):
    """Vertical span start indices + labels from an ordered group column."""
    vals = df[col_vspan].to_numpy()
    changes = np.concatenate(
        [[0], np.flatnonzero(vals[1:] != vals[:-1]) + 1])
    labels = [vspan_fmt.format(vals[i]) for i in changes]
    return changes, labels


def add_vspans(ax, spans, labels=None, alt_color: str = "0.9",
               n_rows: Optional[int] = None) -> None:
    """Shade alternating vertical spans."""
    n = n_rows if n_rows is not None else ax.get_xlim()[1]
    bounds = list(spans) + [n]
    for i in range(len(spans)):
        if i % 2 == 1:
            ax.axvspan(
                bounds[i] - 0.5, bounds[i + 1] - 0.5, facecolor=alt_color,
                alpha=0.4, zorder=0)
        if labels is not None:
            ax.annotate(
                labels[i], ((bounds[i] + bounds[i + 1]) / 2 - 0.5,
                            ax.get_ylim()[1]),
                ha="center", va="top", annotation_clip=False)


def setup_fig(nrows: int = 1, ncols: int = 1, size=None):
    """Figure + GridSpec."""
    import matplotlib.pyplot as plt
    from matplotlib import gridspec
    fig = plt.figure(figsize=size, constrained_layout=True)
    gs = gridspec.GridSpec(nrows, ncols, figure=fig)
    return fig, gs


def show(block: bool = True) -> None:
    """Show open figures."""
    import matplotlib.pyplot as plt
    plt.show(block=block)


def setup_images_for_plane(plane: str, imgs3d) -> list:
    """Transpose each 3D image for viewing along a planar orientation."""
    axis = get_plane_axis(plane, get_index=True)
    out = []
    for img in imgs3d:
        if img is None:
            out.append(None)
        else:
            out.append(np.moveaxis(img, axis, 0) if axis else img)
    return out


class ImageOverlayer:
    """Overlay channel/label/border images on one axes; wraps
    :func:`overlay_images` with held display settings."""

    def __init__(self, ax, aspect=None, origin=None,
                 ignore_invis: bool = False, rgb: bool = False):
        self.ax = ax
        self.aspect = aspect
        self.origin = origin
        self.ignore_invis = ignore_invis
        self.rgb = rgb

    def overlay_images(self, imgs2d, channels=None, cmaps=None,
                       alphas=None, vmins=None, vmaxs=None):
        """Blend the first image's channels (+ a labels plane when a
        second image is given), draw onto the held axes, and return the
        blended RGB array."""
        imgs2d = list(imgs2d)
        labels_plane = imgs2d[1] if len(imgs2d) > 1 else None
        rgb = overlay_images(
            np.asarray(imgs2d[0]), channels=channels, alphas=alphas,
            vmins=vmins, vmaxs=vmaxs, labels_plane=labels_plane)
        if self.ax is not None:
            self.ax.imshow(rgb, aspect=self.aspect, origin=self.origin)
        return rgb


class ImageSyncMixin:
    """Shared plumbing for multi-view editors that keep plane/offset
    state in sync."""

    def __init__(self, img5d=None):
        self.img5d = img5d
        self.plot_eds: dict = {}
        #: callbacks fired when any view updates
        self.fn_update_coords = None
        self.fn_status_bar = None

    def get_img_display_settings(self, imgi: int, **kwargs):
        for ed in self.plot_eds.values():
            if hasattr(ed, "get_displayed_img"):
                return ed.get_displayed_img(imgi, **kwargs)
        return None

    def update_coords(self, coords) -> None:
        """Propagate a crosshair move to all linked editors."""
        for ed in self.plot_eds.values():
            if hasattr(ed, "editor"):
                for ax, c in enumerate(coords[:3]):
                    ed.editor.set_position(ax, c)
        if self.fn_update_coords is not None:
            self.fn_update_coords(coords)

    def update_alpha(self, alpha: float) -> None:
        """Sync the label-overlay opacity across all linked editors
        (the alpha slider)."""
        for ed in self.plot_eds.values():
            if hasattr(ed, "alpha"):
                ed.alpha = float(alpha)

    def update_intensity(self, vmin, vmax) -> None:
        """Sync the intensity window across all linked editors."""
        for ed in self.plot_eds.values():
            if hasattr(ed, "update_intensity"):
                ed.update_intensity(vmin, vmax)
