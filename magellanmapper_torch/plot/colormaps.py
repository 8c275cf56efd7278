"""Colormaps for labels and channels.

Copy of ``magellanmapper_tpu/plot/colormaps.py``: ``DiscreteColormap`` for
label images (deterministic per-ID colours, +/-id sharing a colour for
mirrored hemispheres), the channel colours and dark-background channel
colormaps, the default registry and discrete palettes. Only the functions
that build a matplotlib colormap import matplotlib, when called, so the
module imports where matplotlib is not installed.
"""

from __future__ import annotations

from enum import Enum, auto
from typing import Dict, Optional, Sequence

import numpy as np


def _mcolors():
    """``matplotlib.colors``; ``ImportError`` without matplotlib."""
    try:
        from matplotlib import colors
    except ImportError as err:
        raise ImportError("matplotlib required") from err
    return colors


#: colorblind-friendly channel base colors
CHANNEL_COLORS = (
    (0.0, 0.447, 0.698),   # blue
    (0.902, 0.624, 0.0),   # orange
    (0.0, 0.620, 0.451),   # green
    (0.835, 0.369, 0.0),   # vermillion
    (0.8, 0.475, 0.655),   # purple-pink
    (0.941, 0.894, 0.259), # yellow
)


def discrete_colors(
        ids: Sequence[int], seed: int = 1442,
        alpha: float = 1.0,
        symmetric_colors: bool = True) -> Dict[int, tuple]:
    """Deterministic RGBA color per label ID; +/-id share a color when
    ``symmetric_colors`` (mirrored hemispheres)."""
    rng = np.random.RandomState(seed)
    out: Dict[int, tuple] = {}
    keys = sorted({abs(int(i)) for i in ids})
    for key in keys:
        rgb = rng.rand(3) * 0.85 + 0.1
        out[key] = (*rgb, alpha)
    colors = {}
    for i in ids:
        i = int(i)
        if i == 0:
            colors[i] = (0.0, 0.0, 0.0, 0.0)
            continue
        base = out[abs(i)]
        if not symmetric_colors and i < 0:
            base = tuple(np.clip(np.asarray(base[:3]) * 0.6, 0, 1)) + (
                base[3],)
        colors[i] = base
    return colors


class DiscreteColormap:
    """Label colormap mapping IDs to RGBA."""

    def __init__(self, ids: Sequence[int], alpha: float = 1.0,
                 seed: int = 1442, symmetric_colors: bool = True):
        self.ids = np.asarray(sorted(set(int(i) for i in ids)))
        self.colors = discrete_colors(
            self.ids, seed, alpha, symmetric_colors)

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        """Map a labels array to an RGBA image."""
        out = np.zeros(labels.shape + (4,), dtype=float)
        for lid, rgba in self.colors.items():
            out[labels == lid] = rgba
        return out

    def to_mpl(self):
        """As a matplotlib ``ListedColormap`` + ``BoundaryNorm``."""
        mcolors = _mcolors()
        ids = self.ids
        cmap = mcolors.ListedColormap(
            [self.colors[int(i)] for i in ids])
        bounds = np.append(ids - 0.5, ids[-1] + 0.5)
        norm = mcolors.BoundaryNorm(bounds, cmap.N)
        return cmap, norm


def channel_colormap(channel: int):
    """Dark-background linear colormap for an intensity channel."""
    base = CHANNEL_COLORS[channel % len(CHANNEL_COLORS)]
    return _mcolors().LinearSegmentedColormap.from_list(
        f"chl{channel}", [(0, 0, 0), base])


class DiscreteModes(Enum):
    """Discrete colormap generation modes."""
    RANDOMN = auto()
    GRID = auto()


#: default colormaps registry
CMAPS: Dict = {}


def make_dark_linear_cmap(name: str, color):
    """Linear colormap from black to ``color``."""
    return _mcolors().LinearSegmentedColormap.from_list(
        name, [(0, 0, 0), color])


def setup_cmaps() -> Dict:
    """Populate :data:`CMAPS` with the default dark-background maps."""
    for name, color in (("green_black", "green"), ("red_black", "red"),
                        ("blue_black", "blue"), ("cyan_black", "cyan"),
                        ("magenta_black", "magenta"),
                        ("yellow_black", "yellow")):
        CMAPS[name] = make_dark_linear_cmap(name, color)
    return CMAPS


def discrete_colormap(
        num_colors: int, alpha: int = 255, prioritize_default=True,
        seed: Optional[int] = None, min_val=0, max_val=255, min_any=0,
        symmetric_colors: bool = False, dup_offset: int = 0,
        jitter: int = 0,
        mode: DiscreteModes = DiscreteModes.RANDOMN) -> np.ndarray:
    """``num_colors x 4`` RGBA int array of visually distinct colors."""
    rng = np.random.RandomState(seed if seed is not None else 1442)
    if mode is DiscreteModes.GRID:
        # evenly spaced grid walk through RGB space
        side = int(np.ceil(num_colors ** (1 / 3)))
        grid = np.linspace(min_val, max_val, max(side, 2))
        rgb = np.array(np.meshgrid(grid, grid, grid)).T.reshape(-1, 3)
        rgb = rgb[:num_colors]
    else:
        rgb = rng.randint(min_val, max_val + 1, (num_colors, 3))
    if min_any:
        # ensure at least one channel is bright enough to be visible
        dim = np.all(rgb < min_any, axis=1)
        rgb[dim, rng.randint(0, 3)] = min_any
    if jitter:
        rgb = np.clip(
            rgb + rng.randint(-jitter, jitter + 1, rgb.shape),
            min_val, max_val)
    out = np.column_stack(
        [rgb, np.full(len(rgb), alpha)]).astype(int)
    defaults = np.array([
        [255, 0, 0, alpha], [0, 255, 0, alpha], [0, 0, 255, alpha]])
    if prioritize_default is True:
        n = min(len(defaults), len(out))
        out[:n] = defaults[:n]
    elif isinstance(prioritize_default, str) and \
            prioritize_default == "cn":
        cn = (np.asarray(CHANNEL_COLORS) * 255).astype(int)
        n = min(len(cn), len(out))
        out[:n, :3] = cn[:n]
    return out[:num_colors]


def get_labels_discrete_colormap(
        labels_img: Optional[np.ndarray], alpha_bkgd: int = 255,
        use_orig_labels: bool = False, **kwargs) -> DiscreteColormap:
    """Default discrete colormap over a labels image's IDs."""
    ids = ([0] if labels_img is None
           else np.unique(labels_img).tolist())
    cmap = DiscreteColormap(ids, **kwargs)
    cmap.colors[0] = (0.0, 0.0, 0.0, alpha_bkgd / 255.0)
    if use_orig_labels and labels_img is not None:
        cmap.orig_ids = np.unique(labels_img)
    return cmap


def get_borders_colormap(
        borders_img: Optional[np.ndarray], labels_img: np.ndarray,
        cmap_labels: DiscreteColormap):
    """Colormaps for border channels: label colors shifted in intensity,
    regenerated if the ID sets differ."""
    if borders_img is None:
        return None
    cmaps = []
    channels = 1 if borders_img.ndim <= 3 else borders_img.shape[-1]
    for chl in range(channels):
        borders = borders_img if channels == 1 else borders_img[..., chl]
        ids = np.unique(borders)
        if len(ids) == len(cmap_labels.ids):
            shifted = DiscreteColormap(ids)
            shifted.colors = {
                lid: tuple(np.clip(
                    np.asarray(rgba[:3]) * (0.5 + 0.25 * chl), 0, 1)
                ) + (rgba[3],)
                for lid, rgba in cmap_labels.colors.items()}
            cmaps.append(shifted)
        else:
            cmaps.append(DiscreteColormap(ids, seed=1442 + chl))
    return cmaps


def make_binary_cmap(binary_colors) -> DiscreteColormap:
    """Discrete colormap for a 0/1 image."""
    mcolors = _mcolors()
    cmap = DiscreteColormap([0, 1])
    cmap.colors = {
        0: mcolors.to_rgba(binary_colors[0]),
        1: mcolors.to_rgba(binary_colors[1])}
    return cmap


def get_cmap(cmap, n: Optional[int] = None):
    """Resolve a string/registry key (or list of them) to a Colormap."""
    _mcolors()
    if n is not None and isinstance(cmap, (list, tuple)):
        cmap = cmap[n % len(cmap)]
    if isinstance(cmap, str):
        if cmap in CMAPS:
            return CMAPS[cmap]
        import matplotlib.pyplot as plt
        return plt.get_cmap(cmap)
    return cmap


def setup_colormaps(num_channels: int) -> list:
    """Per-channel colormaps."""
    return [channel_colormap(c) for c in range(num_channels)]


def setup_labels_cmap(labels_img: Optional[np.ndarray],
                      background=(0, 0, 0, 0)) -> DiscreteColormap:
    """Discrete colormap for a labels image with transparent background."""
    cmap = get_labels_discrete_colormap(labels_img, 0)
    cmap.colors[0] = tuple(
        c / 255.0 if isinstance(c, (int, np.integer)) and c > 1 else c
        for c in background)
    return cmap
