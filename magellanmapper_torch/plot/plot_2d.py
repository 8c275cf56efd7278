"""2D task plots (matplotlib, the Agg backend).

Copy of ``magellanmapper_tpu/plot/plot_2d.py``: bar, line, scatter,
swarm, histogram and category plots over stats tables, ROC curves of
grid-search output, overlays of registered planes, and the ``--plot_2d``
task's dispatch (:func:`main`).
"""

from __future__ import annotations

import logging
from enum import Enum, auto
from typing import Optional, Sequence

import numpy as np
import pandas as pd

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from magellanmapper_torch.plot import plot_support  # noqa: E402

_logger = logging.getLogger(__name__)


class Plot2DTypes(Enum):
    """The ``--plot_2d`` task names."""
    BAR_PLOT = auto()
    LINE_PLOT = auto()
    SCATTER_PLOT = auto()
    ROC_CURVE = auto()
    SWARM_PLOT = auto()
    HISTOGRAM = auto()
    CAT_PLOT = auto()
    BAR_PLOT_VOLS_STATS = auto()
    BAR_PLOT_VOLS_STATS_EFFECTS = auto()
    DECORATE_PLOT = auto()


def plot_bars(
        df: pd.DataFrame, x_col: str, y_col: str,
        path: Optional[str] = None, title: Optional[str] = None):
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.bar(df[x_col].astype(str), df[y_col])
    ax.set_xlabel(x_col)
    ax.set_ylabel(y_col)
    if title:
        ax.set_title(title)
    ax.tick_params(axis="x", rotation=60)
    if path:
        plot_support.save_fig(fig, path)
    plt.close(fig)
    return fig


def plot_lines(
        df: pd.DataFrame, x_col: str, y_cols: Sequence[str],
        path: Optional[str] = None, title: Optional[str] = None):
    fig, ax = plt.subplots(figsize=(7, 4))
    for col in y_cols:
        ax.plot(df[x_col], df[col], marker="o", label=col)
    ax.set_xlabel(x_col)
    ax.legend()
    if title:
        ax.set_title(title)
    if path:
        plot_support.save_fig(fig, path)
    plt.close(fig)
    return fig


def plot_scatter(
        df: pd.DataFrame, x_col: str, y_col: str,
        group_col: Optional[str] = None,
        path: Optional[str] = None, annot_col: Optional[str] = None):
    fig, ax = plt.subplots(figsize=(6, 6))
    if group_col:
        for name, grp in df.groupby(group_col):
            ax.scatter(grp[x_col], grp[y_col], label=str(name), s=14)
        ax.legend()
    else:
        ax.scatter(df[x_col], df[y_col], s=14)
    if annot_col:
        for _, row in df.iterrows():
            ax.annotate(str(row[annot_col]), (row[x_col], row[y_col]),
                        fontsize=6)
    ax.set_xlabel(x_col)
    ax.set_ylabel(y_col)
    if path:
        plot_support.save_fig(fig, path)
    plt.close(fig)
    return fig


def plot_roc(
        df: pd.DataFrame, path: Optional[str] = None,
        show_labels: bool = True):
    """ROC-style plot of grid-search stats: FDR vs sensitivity."""
    fig, ax = plt.subplots(figsize=(6, 6))
    param_cols = [c for c in df.columns
                  if c not in ("POS", "TP", "FP", "FN", "FDR", "SENS",
                               "PPV", "Distance")]
    ax.plot(df["FDR"], df["SENS"], "o-")
    if show_labels and param_cols:
        for _, row in df.iterrows():
            label = ",".join(f"{row[c]:.3g}" if isinstance(
                row[c], (int, float)) else str(row[c])
                for c in param_cols)
            ax.annotate(label, (row["FDR"], row["SENS"]), fontsize=6)
    ax.set_xlabel("False discovery rate")
    ax.set_ylabel("Sensitivity")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.05)
    if path:
        plot_support.save_fig(fig, path)
    plt.close(fig)
    return fig


def main(task: Plot2DTypes, df: pd.DataFrame, path: Optional[str] = None,
         **kwargs):
    """Dispatch a plot task."""
    if task is Plot2DTypes.BAR_PLOT:
        return plot_bars(df, path=path, **kwargs)
    if task is Plot2DTypes.LINE_PLOT:
        return plot_lines(df, path=path, **kwargs)
    if task is Plot2DTypes.SCATTER_PLOT:
        return plot_scatter(df, path=path, **kwargs)
    if task is Plot2DTypes.SWARM_PLOT:
        return plot_swarm(df, path=path, **kwargs)
    if task is Plot2DTypes.HISTOGRAM:
        return plot_histogram(df, path=path, **kwargs)
    if task is Plot2DTypes.ROC_CURVE:
        return plot_roc(df, path=path, **kwargs)
    raise ValueError(task)


def plot_histogram(
        df_or_vals, col: Optional[str] = None,
        path: Optional[str] = None, bins: int = 50,
        title: Optional[str] = None):
    """Histogram task."""
    vals = df_or_vals[col] if col is not None else df_or_vals
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(np.asarray(vals), bins=bins)
    ax.set_xlabel(col or "value")
    ax.set_ylabel("count")
    if title:
        ax.set_title(title)
    if path:
        plot_support.save_fig(fig, path)
    plt.close(fig)
    return fig


def plot_swarm(
        df: pd.DataFrame, group_col: str, value_col: str,
        path: Optional[str] = None, jitter: float = 0.25,
        seed: int = 0):
    """Jittered category scatter with each group's median."""
    rng = np.random.default_rng(seed)
    fig, ax = plt.subplots(figsize=(6, 4))
    groups = list(pd.unique(df[group_col]))
    for gi, name in enumerate(groups):
        vals = df[df[group_col] == name][value_col].to_numpy()
        xs = gi + rng.uniform(-jitter, jitter, len(vals))
        ax.scatter(xs, vals, s=14, alpha=0.7)
        ax.plot([gi - 0.3, gi + 0.3],
                [np.median(vals)] * 2, c="k", lw=1.5)
    ax.set_xticks(range(len(groups)))
    ax.set_xticklabels([str(g) for g in groups])
    ax.set_ylabel(value_col)
    if path:
        plot_support.save_fig(fig, path)
    plt.close(fig)
    return fig


def plot_image(img: np.ndarray, path: Optional[str] = None,
               show: bool = False):
    """Borderless single-image figure, optionally saved."""
    fig, ax = plt.subplots()
    ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
    plot_support.hide_axes(ax, True)
    fig.subplots_adjust(left=0, right=1, top=1, bottom=0)
    if path:
        fig.savefig(path, bbox_inches="tight", pad_inches=0)
    if not show:
        plt.close(fig)
    return fig


def decorate_plot(ax, title=None, xlabel=None, ylabel=None,
                  xunit=None, yunit=None, xlim=None, ylim=None,
                  xscale=None, yscale=None, xticks=None, yticks=None,
                  **kwargs):
    """Apply labels/limits/scales to an axes."""
    if title:
        ax.set_title(title)
    if xlabel or xunit:
        ax.set_xlabel(
            f"{xlabel or ''}" + (f" ({xunit})" if xunit else ""))
    if ylabel or yunit:
        ax.set_ylabel(
            f"{ylabel or ''}" + (f" ({yunit})" if yunit else ""))
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if xscale:
        ax.set_xscale(xscale)
    if yscale:
        ax.set_yscale(yscale)
    if xticks is not None:
        ax.set_xticks(xticks)
    if yticks is not None:
        ax.set_yticks(yticks)
    return ax


def setup_style(style: Optional[str] = None, rc_params=None) -> None:
    """Apply a Matplotlib style plus RC overrides."""
    plt.style.use(style or "default")
    for params in rc_params or ():
        matplotlib.rcParams.update(
            params.value if hasattr(params, "value") else params)


def post_plot(ax, out_path: Optional[str] = None,
              save_ext: Optional[str] = None, show: bool = False) -> None:
    """Save and/or show after plotting."""
    fig = ax.get_figure()
    if out_path and save_ext:
        fig.savefig(f"{out_path}.{save_ext}", bbox_inches="tight")
    elif out_path:
        fig.savefig(out_path, bbox_inches="tight")
    if not show:
        plt.close(fig)


def plot_overlays(imgs, z: int, cmaps=None, title: Optional[str] = None,
                  out_path: Optional[str] = None):
    """Overlay multiple aligned volumes at one z-plane with increasing
    transparency."""
    fig, ax = plt.subplots()
    for i, img in enumerate(imgs):
        plane = img[z] if img.ndim > 2 else img
        cmap = None if cmaps is None else cmaps[i % len(cmaps)]
        ax.imshow(plane, cmap=cmap or "gray",
                  alpha=1.0 if i == 0 else 0.5)
    if title:
        ax.set_title(title)
    if out_path:
        fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_overlays_reg(exp_path: str, atlas_path: str,
                      z: Optional[int] = None,
                      out_path: Optional[str] = None):
    """Overlay an experiment plane with its registered atlas."""
    from magellanmapper_torch.io import np_io, sitk_io
    exp = np_io.read_file(exp_path).img[0]
    atlas = sitk_io.read_med_img(sitk_io.find_sitk_file(atlas_path)).img
    if z is None:
        z = exp.shape[0] // 2
    return plot_overlays(
        [np.asarray(exp), np.asarray(atlas)], z, title="registered",
        out_path=out_path)


def plot_probability(df: pd.DataFrame, conds, metric_cols, col_size: str,
                     **kwargs):
    """Probability/fraction plot per condition."""
    fig, ax = plt.subplots()
    for col in metric_cols:
        for cond in conds:
            sub = df[df["Condition"] == cond] if "Condition" in \
                df.columns else df
            frac = sub[col] / sub[col_size].replace(0, np.nan)
            ax.plot(np.arange(len(frac)), frac, label=f"{col}:{cond}")
    ax.set_ylabel("Probability")
    ax.legend()
    plt.close(fig)
    return fig


def plot_catplot(df: pd.DataFrame, x: str, y: str,
                 hue: Optional[str] = None,
                 kind: str = "strip", out_path: Optional[str] = None):
    """Categorical plot via seaborn when available, Matplotlib strip
    fallback otherwise."""
    try:
        import seaborn as sns
        g = sns.catplot(data=df, x=x, y=y, hue=hue, kind=kind)
        if out_path:
            g.savefig(out_path)
        return g
    except ImportError:
        fig, ax = plt.subplots()
        cats = list(df[x].unique())
        rng = np.random.default_rng(0)
        for i, cat in enumerate(cats):
            vals = df.loc[df[x] == cat, y]
            ax.scatter(i + rng.uniform(-0.15, 0.15, len(vals)), vals, s=10)
        ax.set_xticks(range(len(cats)))
        ax.set_xticklabels([str(c) for c in cats])
        ax.set_xlabel(x)
        ax.set_ylabel(y)
        if out_path:
            fig.savefig(out_path, bbox_inches="tight")
        plt.close(fig)
        return fig
