"""Pandas data-frame engine for stats outputs.

Copy of ``magellanmapper_tpu/io/df_io.py``: CSV write with backup
(``data_frames_to_csv``), dict to frame (``dict_to_data_frame``), the
merge, join, melt, pivot, normalize, z-score, coefficient-of-variation and
column-arithmetic operations, and the ``--df`` task vocabulary
(:class:`DFTasks`) that the command line dispatches.
"""

from __future__ import annotations

import logging
from enum import Enum, auto
from typing import Dict, Optional, Sequence, Union

import numpy as np
import pandas as pd

from magellanmapper_torch.utils import libmag

_logger = logging.getLogger(__name__)


class DFTasks(Enum):
    """``--df`` tasks (reference ``config.DFTasks``, core subset)."""
    MERGE_CSVS = auto()
    MERGE_CSVS_COLS = auto()
    APPEND_CSVS_COLS = auto()
    EXPS_BY_REGION = auto()
    MELT_COLS = auto()
    PIVOT_TABLE = auto()
    SUM_COLS = auto()
    SUBTRACT_COLS = auto()
    MULTIPLY_COLS = auto()
    DIVIDE_COLS = auto()
    NORMALIZE = auto()
    ZSCORE = auto()
    REPLACE_VALS = auto()


def dict_to_data_frame(
        d: Dict, records_cols: Optional[Sequence[str]] = None,
        sort_cols: Optional[Union[str, Sequence[str]]] = None
) -> pd.DataFrame:
    """Build a frame from a dict of columns or records
    (reference ``dict_to_data_frame :594``)."""
    df = pd.DataFrame(d, columns=records_cols) if records_cols else \
        pd.DataFrame(d)
    if sort_cols:
        df = df.sort_values(sort_cols).reset_index(drop=True)
    return df


def data_frames_to_csv(
        dfs: Union[pd.DataFrame, Sequence[pd.DataFrame]],
        path: str, sort_cols=None, index: bool = False) -> pd.DataFrame:
    """Concatenate frames and write CSV, backing up any existing file
    (reference ``data_frames_to_csv :647``)."""
    if isinstance(dfs, pd.DataFrame):
        dfs = [dfs]
    df = pd.concat(dfs, ignore_index=True) if len(dfs) > 1 else dfs[0]
    if sort_cols:
        df = df.sort_values(sort_cols)
    libmag.backup_file(path)
    df.to_csv(path, index=index)
    _logger.info("wrote %d rows to %s", len(df), path)
    return df


def merge_csvs(paths: Sequence[str], out_path: Optional[str] = None
               ) -> pd.DataFrame:
    """Concatenate CSVs row-wise."""
    df = pd.concat([pd.read_csv(p) for p in paths], ignore_index=True)
    if out_path:
        data_frames_to_csv(df, out_path)
    return df


def join_dfs(
        dfs: Sequence[pd.DataFrame], on: str,
        suffixes: Optional[Sequence[str]] = None) -> pd.DataFrame:
    """Outer-join frames on a key column."""
    out = dfs[0]
    for i, df in enumerate(dfs[1:], 1):
        sfx = ("", f"_{suffixes[i] if suffixes else i}")
        out = out.merge(df, on=on, how="outer", suffixes=sfx)
    return out


def melt_cols(
        df: pd.DataFrame, id_cols: Sequence[str],
        melt_cols_: Sequence[str], var_name: str = "Group",
        value_name: str = "Value") -> pd.DataFrame:
    """Wide -> long (reference melt ops)."""
    return df.melt(
        id_vars=id_cols, value_vars=melt_cols_, var_name=var_name,
        value_name=value_name)


def pivot_table(
        df: pd.DataFrame, index: str, columns: str, values: str
) -> pd.DataFrame:
    return df.pivot_table(
        index=index, columns=columns, values=values).reset_index()


def normalize_df(
        df: pd.DataFrame, id_cols: Sequence[str], cond_col: str,
        cond_base: str, metric_cols: Sequence[str]) -> pd.DataFrame:
    """Normalize metric columns to a baseline condition."""
    base = df[df[cond_col] == cond_base].set_index(list(id_cols))
    out = df.copy()
    for col in metric_cols:
        base_vals = out[id_cols[0]].map(base[col]) if len(id_cols) == 1 \
            else pd.MultiIndex.from_frame(out[list(id_cols)]).map(base[col])
        out[col] = out[col] / base_vals
    return out


def zscore_df(
        df: pd.DataFrame, group_cols: Sequence[str],
        metric_cols: Sequence[str]) -> pd.DataFrame:
    """Z-score metrics within groups."""
    out = df.copy()
    for col in metric_cols:
        grp = out.groupby(list(group_cols))[col]
        out[col] = (out[col] - grp.transform("mean")) / grp.transform("std")
    return out


def print_data_frame(df: pd.DataFrame, sep: str = " ") -> str:
    """Format a frame for logging (reference ``print_data_frame``)."""
    s = df.to_string(index=False)
    _logger.info("\n%s", s)
    return s


def weight_mean(vals, weights) -> float:
    """Weighted arithmetic mean, NaN-aware (reference
    ``df_io.weight_mean :34``): weights of NaN values drop out of the
    total weight."""
    vals = np.asarray(vals, float)
    weights = np.asarray(weights, float)
    tot = np.sum(weights[~np.isnan(vals)])
    return float(np.nansum(vals * weights) / tot) if tot else float("nan")


def weight_std(vals, weights):
    """Weighted standard deviation; returns ``(std, mean)``
    (reference ``df_io.weight_std :51``)."""
    vals = np.asarray(vals, float)
    mean = weight_mean(vals, weights)
    std = float(np.sqrt(weight_mean((vals - mean) ** 2, weights)))
    return std, mean


def df_div(df0: pd.DataFrame, df1: pd.DataFrame, axis: int = 1):
    """Functional ``DataFrame.div`` (reference ``df_div :67``)."""
    return df0.div(df1, axis=axis)


def df_add(df0: pd.DataFrame, df1: pd.DataFrame, axis: int = 1,
           fill_value=0):
    """Functional ``DataFrame.add`` (reference ``df_add :83``)."""
    return df0.add(df1, axis=axis, fill_value=fill_value)


def df_subtract(df0: pd.DataFrame, df1: pd.DataFrame, axis: int = 1,
                fill_value=0):
    """Functional ``DataFrame.subtract`` (reference ``df_subtract :100``)."""
    return df0.subtract(df1, axis=axis, fill_value=fill_value)


def func_to_paired_cols(df: pd.DataFrame, col1: str, col2: str, fn,
                        name: str) -> None:
    """Apply ``fn`` to a column pair into a new column, in place
    (reference ``func_to_paired_cols :118``)."""
    df[name] = fn(df[col1], df[col2])


def add_cols_df(df: pd.DataFrame, cols: dict) -> pd.DataFrame:
    """Add default-valued columns (reference ``add_cols_df :459``)."""
    for key, val in cols.items():
        df[key] = val
    return df


def append_cols(dfs, labels, fn_col=None, extra_cols=None,
                data_cols=None) -> pd.DataFrame:
    """Concatenate data frames column-wise, prefixing each frame's
    columns with its label (reference ``append_cols :408``). Assumes
    identical sample ordering across frames."""
    out = []
    for i, (df, label) in enumerate(zip(dfs, labels)):
        cols = list(df.columns)
        if fn_col is not None or data_cols:
            cols = list(data_cols) if data_cols else cols
            if fn_col is not None:
                cols = [c for c in cols if fn_col(c)]
            if i == 0 and extra_cols:
                cols = list(extra_cols) + cols
            df = df[cols]
        renames = {c: f"{label}.{c}" for c in df.columns
                   if not (i == 0 and extra_cols and c in extra_cols)}
        out.append(df.rename(columns=renames))
    return pd.concat(out, axis=1)


def combine_cols(df: pd.DataFrame, combos) -> pd.DataFrame:
    """Aggregate column groups into new columns. Each combo is an Enum
    whose value is ``(new_col, (member_enums...), fn_aggr)``
    (reference ``combine_cols :381``)."""
    import warnings as _warnings
    for combo in combos:
        name, members, fn_aggr = combo.value
        metrics = [m.name for m in members if m.name in df.columns]
        if len(metrics) < len(members):
            _warnings.warn(
                f"Could not find all metrics for {name}; using {metrics}")
        if metrics:
            df.loc[:, name] = fn_aggr(df.loc[:, metrics])
    return df


def coefvar_df(df: pd.DataFrame, id_cols, metric_cols,
               size_col=None) -> pd.DataFrame:
    """Coefficient of variation of each metric per group; the size
    column becomes its mean (reference ``coefvar_df :309``)."""
    aggs = {m: lambda v: np.nanstd(v) / np.nanmean(v)
            for m in metric_cols}
    if size_col:
        aggs[size_col] = np.nanmean
    return df.groupby(list(id_cols)).agg(aggs).reset_index()


def cond_to_cols_df(df: pd.DataFrame, id_cols, cond_col, cond_base,
                    metric_cols, sep: str = "_") -> pd.DataFrame:
    """Pivot metric rows per condition into ``metric<sep>condition``
    columns (reference ``cond_to_cols_df :339``)."""
    conds = list(df[cond_col].unique())
    if cond_base is None:
        cond_base = conds[0]
    if cond_base in conds:
        conds.remove(cond_base)
        conds.insert(0, cond_base)
    out = None
    for cond in conds:
        sub = df[df[cond_col] == cond][
            list(id_cols) + list(metric_cols)].copy()
        sub = sub.rename(
            columns={m: f"{m}{sep}{cond}" for m in metric_cols})
        out = sub if out is None else out.merge(
            sub, on=list(id_cols), how="outer")
    return out


def exps_by_regions(path, filter_zeros: bool = True,
                    sample_delim: str = "-"):
    """Pivot a volumes-by-regions CSV into one frame per measurement with
    regions as rows and samples as columns (reference
    ``exps_by_regions :133``)."""
    df = pd.read_csv(path)
    measurements = [c for c in ("Volume", "Nuclei") if c in df.columns]
    out = {}
    for meas in measurements:
        piv = df.pivot_table(
            values=meas, index="Region", columns="Sample",
            aggfunc="sum")
        if sample_delim is not None:
            piv = piv.rename(columns={
                c: str(c).split(sample_delim)[0] for c in piv.columns})
        if filter_zeros:
            piv = piv[(piv.fillna(0) != 0).any(axis=1)]
        out[meas] = piv
    return out


def pivot_with_conditions(df: pd.DataFrame, index, columns, values,
                          aggfunc="first"):
    """Pivot to wide format with condition sub-columns; returns
    ``(pivoted, column_names)``
    (reference ``df_io.pivot_with_conditions :526``)."""
    piv = df.pivot_table(
        values=values, index=index, columns=columns, aggfunc=aggfunc)
    return piv, piv.columns.tolist()


def filter_dfs_on_vals(dfs, cols=None, row_matches=None):
    """Filter each frame by a (col, val) criterion then concatenate
    (reference ``df_io.filter_dfs_on_vals :713``)."""
    filtered = []
    for i, df in enumerate(dfs):
        if row_matches is not None and row_matches[i] is not None:
            col, val = row_matches[i]
            df = df[df[col] == val]
        if cols is not None:
            df = df[list(cols)]
        filtered.append(df)
    return pd.concat(filtered, ignore_index=True), filtered


def merge_excels(paths, out_path: str, names=None) -> str:
    """Merge Excel files into sheets of one workbook
    (reference ``df_io.merge_excels :746``)."""
    from magellanmapper_torch.utils import libmag
    libmag.backup_file(out_path)
    with pd.ExcelWriter(out_path) as writer:
        if not names:
            names = [libmag.get_filename_without_ext(p) for p in paths]
        for path, name in zip(paths, names):
            pd.read_excel(path, index_col=0).to_excel(
                writer, sheet_name=name, index=False)
    return out_path


def replace_vals(df: pd.DataFrame, vals_from, vals_to,
                 cols=None) -> pd.DataFrame:
    """Replace values in selected columns
    (reference ``df_io.replace_vals :766``)."""
    from magellanmapper_torch.utils import libmag
    out = df.copy()
    targets = list(cols) if libmag.is_seq(cols) else (
        [cols] if cols is not None else list(out.columns))
    sub = out[targets].replace(
        list(np.atleast_1d(vals_from)),
        list(np.atleast_1d(vals_to)))
    out[targets] = sub
    return out
