"""Atlas-level statistics.

Copy of ``magellanmapper_tpu/stats/atlas_stats.py``: Dice
(``meas_dice``), the optimal smoothing filter (``smoothing_peak``),
landmark distances, z-scores and coefficients of variation of the
regions' tables, improvement counts (``meas_improvement``) and the
matplotlib plots behind the ``--register`` plot tasks (host only; each
imports matplotlib when called).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import pandas as pd

from magellanmapper_torch.cv import verifier

calc_sens_ppv = verifier.calc_sens_ppv


def meas_dice(
        mask1: np.ndarray, mask2: np.ndarray,
        img: Optional[np.ndarray] = None) -> float:
    """Dice coefficient of two masks, optionally weighted by an
    intensity image (reference ``meas_dice :577``)."""
    if img is not None:
        inter = float(img[mask1 & mask2].sum())
        denom = float(img[mask1].sum() + img[mask2].sum())
    else:
        inter = float(np.logical_and(mask1, mask2).sum())
        denom = float(mask1.sum() + mask2.sum())
    return 2 * inter / denom if denom else np.nan


def smoothing_peak(
        df: pd.DataFrame,
        quality_col: str = "SmoothingQuality",
        filter_col: str = "Filter") -> pd.Series:
    """Row with the highest smoothing quality — the optimal filter size
    (reference ``smoothing_peak :281``)."""
    idx = df[quality_col].idxmax()
    return df.loc[idx]


def meas_landmark_dist(
        coords1: np.ndarray, coords2: np.ndarray,
        spacing: Optional[Sequence[float]] = None) -> pd.DataFrame:
    """Pairwise landmark distances between two coordinate sets
    (reference ``meas_landmark_dist :535``)."""
    if spacing is None:
        spacing = (1.0,) * coords1.shape[1]
    deltas = (np.asarray(coords1) - np.asarray(coords2)) * np.asarray(
        spacing)
    dists = np.linalg.norm(deltas, axis=1)
    return pd.DataFrame({
        "Landmark": np.arange(len(dists)), "Dist": dists})


def coefvar(vals: np.ndarray) -> float:
    """Coefficient of variation."""
    vals = np.asarray(vals, float)
    mean = vals.mean()
    return float(vals.std() / mean) if mean else np.nan


def meas_plot_zscores(path, metric_cols, extra_cols, composites,
                      size=None, show: bool = False):
    """Z-score each metric column, combine composites, and plot
    (reference ``atlas_stats.meas_plot_zscores :190``)."""
    from magellanmapper_torch.io import df_io
    df = pd.read_csv(path) if isinstance(path, str) else path
    out = df[list(extra_cols)].copy() if extra_cols else pd.DataFrame()
    for col in metric_cols:
        vals = df[col].astype(float)
        sd = np.nanstd(vals)
        out[col] = (vals - np.nanmean(vals)) / sd if sd else np.nan
    if composites:
        df_io.combine_cols(out, composites)
    if isinstance(path, str):
        out.to_csv(f"{os.path.splitext(path)[0]}_zscores.csv",
                   index=False)
    return out


def meas_plot_coefvar(path, id_cols, cond_col, cond_base, metric_cols,
                      size_col=None, show: bool = False):
    """Coefficient of variation per group then condition-normalized
    (reference ``atlas_stats.meas_plot_coefvar :241``)."""
    from magellanmapper_torch.io import df_io
    df = pd.read_csv(path) if isinstance(path, str) else path
    cv = df_io.coefvar_df(df, id_cols, metric_cols, size_col)
    return df_io.cond_to_cols_df(
        cv, id_cols[:-1] if len(id_cols) > 1 else id_cols,
        cond_col, cond_base, metric_cols) if cond_col in cv.columns \
        else cv


def plot_intensity_nuclei(paths, labels, size=None, show: bool = False,
                          unit: Optional[str] = None) -> pd.DataFrame:
    """Scatter of intensity-based vs nuclei-based metrics across samples
    (reference ``atlas_stats.plot_intensity_nuclei :309``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    dfs = []
    for path in paths:
        df = pd.read_csv(path) if isinstance(path, str) else path
        keep = [l for l in labels if l in df.columns]
        dfs.append(df[keep])
    merged = pd.concat(dfs, axis=0, ignore_index=True)
    if len(labels) >= 2 and all(l in merged.columns for l in labels[:2]):
        fig, ax = plt.subplots()
        ax.scatter(merged[labels[0]], merged[labels[1]], s=8)
        ax.set_xlabel(labels[0])
        ax.set_ylabel(labels[1] + (f" ({unit})" if unit else ""))
        plt.close(fig)
    return merged


def meas_improvement(path, col_effect, col_p, thresh_impr: float = 0,
                     thresh_p: float = 0.05, col_wt=None, suffix=None,
                     df=None) -> pd.DataFrame:
    """Counts and sums of improved vs worsened effects, optionally
    weighted (reference ``atlas_stats.meas_improvement :379``)."""
    if df is None:
        df = pd.read_csv(path)
    effects = df[col_effect]
    mask_impr = effects > thresh_impr
    mask_ss = df[col_p] < thresh_p
    mask_impr_ss = mask_impr & mask_ss
    mask_wors = effects < thresh_impr
    mask_wors_ss = mask_wors & mask_ss
    metrics = {
        "n": [len(effects)],
        "n_impr": [int(mask_impr.sum())],
        "n_impr_ss": [int(mask_impr_ss.sum())],
        "n_wors": [int(mask_wors.sum())],
        "n_wors_ss": [int(mask_wors_ss.sum())],
        col_effect: [float(effects.sum())],
        f"{col_effect}_impr": [float(effects[mask_impr].sum())],
        f"{col_effect}_impr_ss": [float(effects[mask_impr_ss].sum())],
        f"{col_effect}_wors": [float(effects[mask_wors].sum())],
        f"{col_effect}_wors_ss": [float(effects[mask_wors_ss].sum())],
    }
    if col_wt:
        metrics[col_wt] = [float(df[col_wt].sum())]
        for name, m_all, m_ss in (
                ("impr", mask_impr, mask_impr_ss),
                ("wors", mask_wors, mask_wors_ss)):
            wt = df.loc[m_all, col_wt]
            wt_ss = df.loc[m_ss, col_wt]
            metrics[f"{col_wt}_{name}"] = [float(wt.sum())]
            metrics[f"{col_wt}_{name}_ss"] = [float(wt_ss.sum())]
            metrics[f"{col_effect}_{name}_by_{col_wt}"] = [
                float(wt.multiply(df.loc[m_all, col_effect]).sum())]
            metrics[f"{col_effect}_{name}_by_{col_wt}_ss"] = [
                float(wt_ss.multiply(df.loc[m_ss, col_effect]).sum())]
    return pd.DataFrame(metrics)


def plot_region_development(metric: str, df: pd.DataFrame,
                            size=None, show: bool = False):
    """Line plot of a regional metric across developmental ages
    (reference ``atlas_stats.plot_region_development :60``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    for region, grp in df.groupby("Region"):
        ax.plot(grp["Age"], grp[metric], label=str(region))
    ax.set_xlabel("Age")
    ax.set_ylabel(metric)
    plt.close(fig)
    return fig


def plot_unlabeled_hemisphere(path, cols, size=None, show: bool = False):
    """Bar plot of unlabeled-hemisphere fractions per sample
    (reference ``atlas_stats.plot_unlabeled_hemisphere :108``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    df = pd.read_csv(path) if isinstance(path, str) else path
    fig, ax = plt.subplots()
    x = np.arange(len(df))
    for i, col in enumerate(cols):
        ax.bar(x + i * 0.8 / len(cols), df[col], width=0.8 / len(cols),
               label=col)
    ax.legend()
    plt.close(fig)
    return fig


def plot_clusters_by_label(path, z, suffix=None, show: bool = False,
                           scaling=None):
    """Scatter blobs colored by cluster at one z-plane
    (reference ``atlas_stats.plot_clusters_by_label :430``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    blobs = np.load(path) if isinstance(path, str) else path
    arr = blobs["blobs"] if hasattr(blobs, "files") else np.asarray(blobs)
    sel = np.abs(arr[:, 0] - z) < 1
    fig, ax = plt.subplots()
    clusters = arr[sel, -1].astype(int) if arr.shape[1] > 4 else \
        np.zeros(int(sel.sum()), int)
    ax.scatter(arr[sel, 2], arr[sel, 1], c=clusters, s=6, cmap="tab20")
    ax.invert_yaxis()
    plt.close(fig)
    return fig
