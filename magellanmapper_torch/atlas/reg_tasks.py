"""Registered-image tasks: labels-difference images.

Copy of ``magellanmapper_tpu/atlas/reg_tasks.py``
(``build_labels_diff_images``): the per-region difference of a metric
between two conditions is built on the host, as in the reference, and
painted into the labels image on ``device``. The reference paints with
``stats.vols.map_meas_to_labels``, which compares the whole labels image
with each row's region in turn; here the table's region IDs are sorted
once, every voxel's label is looked up among them with
``torch.searchsorted`` and the row's value is gathered, which gives the
loop's image bit for bit: labels absent from the table get 0, a region
listed twice takes its last row, and with ``combine_sides`` the labels'
absolute values are looked up.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import pandas as pd
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.io import sitk_io


def _lookup_keys(region_ids: np.ndarray, values: np.ndarray, dtype
                 ) -> tuple:
    """The table's regions as sorted keys of the labels' ``dtype``, each
    with the value of its last row. The host loop compares each voxel
    with the region as numpy does: an integer labels image matches only
    integral regions inside its type's range, so the others are dropped;
    NaN matches nothing."""
    # last row of each region wins: unique over the reversed rows
    rev_ids, rev_vals = region_ids[::-1], values[::-1]
    keep = ~np.isnan(rev_ids)
    rev_ids, rev_vals = rev_ids[keep], rev_vals[keep]
    keys, first = np.unique(rev_ids, return_index=True)
    vals = rev_vals[first]
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        ok = (keys == np.floor(keys)) & (keys >= info.min) & (
            keys <= info.max)
        keys, vals = keys[ok].astype(dtype), vals[ok]
    return keys, vals


def _paint_labels(
        labels_img: np.ndarray, df: pd.DataFrame, meas: str,
        combine_sides: bool = True,
        device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """The image of ``vols.map_meas_to_labels(labels_img, df, meas,
    combine_sides)`` (float64, the row's ``meas`` in each voxel whose
    label is the row's ``Region``), painted on ``device`` by one sorted
    lookup and one gather."""
    dev = device_mod.resolve(device)
    labels = np.asarray(labels_img)
    if labels.dtype.kind in "ub":
        # torch's lookups and abs want signed types
        labels = labels.astype(np.int16 if labels.itemsize == 1
                               else np.int64)
    elif labels.dtype.kind == "f":
        # numpy compares a float image with the region in float64
        labels = labels.astype(np.float64)
    region_ids = np.asarray(df["Region"], dtype=np.float64)
    values = np.asarray(df[meas], dtype=np.float64)
    keys, vals = _lookup_keys(region_ids, values, labels.dtype)
    if not len(keys):
        return np.zeros(labels.shape, dtype=float)
    work = torch.from_numpy(np.ascontiguousarray(labels)).to(dev)
    if combine_sides:
        work = torch.abs(work)
    keys_t = torch.from_numpy(keys).to(dev)
    idx = torch.searchsorted(keys_t, work, out_int32=True)
    idx.clamp_(max=len(keys) - 1)
    miss = keys_t[idx] != work
    del work
    out = torch.from_numpy(vals).to(dev)[idx]
    del idx
    out.masked_fill_(miss, 0.0)
    return out.cpu().numpy()


def build_labels_diff_images(
        labels_img: np.ndarray, df: pd.DataFrame, metric: str,
        cond_col: str = "Condition",
        conds: Optional[Sequence[str]] = None,
        out_path: Optional[str] = None,
        device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Per-region difference image between two conditions
    (reference ``build_labels_diff_images``).

    ``df`` holds per-region metric values with a condition column; the
    output image carries ``metric[cond1] - metric[cond0]`` per label
    (float64, painted on ``device``), written as float32 to ``out_path``
    when given.
    """
    dev = device_mod.resolve(device)
    if conds is None:
        conds = list(pd.unique(df[cond_col]))[:2]
    if len(conds) < 2:
        raise ValueError("need two conditions to difference")
    d0 = df[df[cond_col] == conds[0]].set_index("Region")[metric]
    d1 = df[df[cond_col] == conds[1]].set_index("Region")[metric]
    diff = (d1 - d0).dropna()
    diff_df = pd.DataFrame(
        {"Region": diff.index, metric: diff.values})
    out = _paint_labels(labels_img, diff_df, metric, device=dev)
    if out_path:
        sitk_io.write_med_img(
            out_path, sitk_io.MedImage(out.astype(np.float32)))
    return out
