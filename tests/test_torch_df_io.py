"""``io.df_io`` and the ``--df`` tasks of ``magellanmapper_torch`` against
the JAX package's, on the CPU.

Tolerance: none. The port's copy runs the same pandas and numpy code, so
every table equals the reference's exactly and every ``--df`` task's file
equals the reference CLI's byte for byte; ``merge_excels`` (openpyxl) has
the reference's outcome, its workbook or its exception and message.
"""

import os

import numpy as np
import pandas as pd
import pytest

from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.io import df_io as ref_df_io
from magellanmapper_tpu.stats import vols as ref_vols
from magellanmapper_torch import testing
from magellanmapper_torch.io import cli, df_io
from magellanmapper_torch.stats import vols

from test_torch_export_stack import assert_same_files


def _vols_table(seed=0, samples=("s1-a", "s2-a", "s3-b", "s4-b"),
                regions=(1, 2, 3, 5)):
    """A region table of several samples, as the study tables hold."""
    rng = np.random.default_rng(seed)
    rows = []
    for i, sample in enumerate(samples):
        for region in regions:
            vol = float(rng.integers(50, 500))
            rows.append({
                "Sample": sample, "Region": region,
                "Condition": "ctl" if i < len(samples) // 2 else "exp",
                "Volume": vol, "Nuclei": int(rng.poisson(vol * 2)),
                "VarIntensity": rng.random(), "MeanIntensity": rng.random(),
                "VarNuclei": rng.random(), "MeanNuclei": rng.random(),
                "EdgeDistSum": rng.random()})
    return pd.DataFrame(rows)


def _both(fn_name, *args, **kwargs):
    """The port's and the reference's ``df_io.<fn_name>`` on copies of the
    same arguments; returns both results."""
    copy = (lambda a: a.copy() if isinstance(a, pd.DataFrame) else a)
    got = getattr(df_io, fn_name)(*map(copy, args), **kwargs)
    want = getattr(ref_df_io, fn_name)(*map(copy, args), **kwargs)
    return got, want


def _assert_equal(got, want):
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    elif isinstance(want, pd.Series):
        pd.testing.assert_series_equal(got, want, check_exact=True)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _assert_equal(got[key], want[key])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_equal(a, b)
    else:
        assert got == want or (np.isnan(got) and np.isnan(want))


def test_dftasks_match_reference():
    assert [t.name for t in df_io.DFTasks] == [
        t.name for t in ref_df_io.DFTasks]
    assert len(df_io.DFTasks) == 13


@pytest.mark.parametrize("fn_name,args,kwargs", [
    ("dict_to_data_frame", ({"a": [3, 1, 2], "b": [1.0, 2.0, 3.0]},),
     {"sort_cols": "a"}),
    ("dict_to_data_frame", ([(1, 2.0), (0, 1.0)],),
     {"records_cols": ["x", "y"]}),
    ("join_dfs", ([_vols_table(1)[["Sample", "Region", "Volume"]],
                   _vols_table(2)[["Sample", "Region", "Nuclei"]]],
                  "Region"), {}),
    ("melt_cols", (_vols_table(), ["Sample", "Region"],
                   ["Volume", "Nuclei"]), {}),
    ("pivot_table", (_vols_table(), "Region", "Condition", "Volume"), {}),
    ("normalize_df", (_vols_table().drop_duplicates(
        ["Region", "Condition"]), ["Region"], "Condition", "ctl",
        ["Volume", "Nuclei"]), {}),
    ("normalize_df", (_vols_table().drop_duplicates(
        ["Sample", "Region"]), ["Sample", "Region"], "Condition", "ctl",
        ["Volume"]), {}),
    ("zscore_df", (_vols_table(), ["Region"], ["Volume", "Nuclei"]), {}),
    ("weight_mean", ([1.0, np.nan, 3.0], [1.0, 5.0, 2.0]), {}),
    ("weight_mean", ([np.nan], [1.0]), {}),
    ("weight_std", ([1.0, 2.0, 4.0], [1.0, 1.0, 2.0]), {}),
    ("add_cols_df", (_vols_table(), {"Level": 3, "Tag": "x"}), {}),
    ("append_cols", ([_vols_table(1), _vols_table(2)], ["A", "B"]), {}),
    ("append_cols", ([_vols_table(1), _vols_table(2)], ["A", "B"]),
     {"fn_col": lambda c: c.startswith("Vol"), "extra_cols": ["Region"]}),
    ("append_cols", ([_vols_table(1), _vols_table(2)], ["A", "B"]),
     {"data_cols": ["Nuclei"]}),
    ("combine_cols", (_vols_table(), list(ref_vols.MetricCombos)), {}),
    ("coefvar_df", (_vols_table(), ["Region"], ["Volume", "Nuclei"]), {}),
    ("coefvar_df", (_vols_table(), ["Region", "Condition"], ["Volume"]),
     {"size_col": "Nuclei"}),
    ("cond_to_cols_df", (_vols_table(), ["Sample", "Region"], "Condition",
                         "exp", ["Volume"]), {}),
    ("cond_to_cols_df", (_vols_table(), ["Region", "Sample"], "Condition",
                         None, ["Volume", "Nuclei"]), {"sep": "."}),
    ("pivot_with_conditions", (_vols_table(), "Sample", "Condition",
                               "Volume"), {}),
    ("pivot_with_conditions", (_vols_table(), "Region", "Condition",
                               "Nuclei"), {"aggfunc": "sum"}),
    ("filter_dfs_on_vals", ([_vols_table(1), _vols_table(2)],),
     {"cols": ["Region", "Volume"],
      "row_matches": [("Region", 2), None]}),
    ("replace_vals", (_vols_table(), "ctl", "control"), {"cols": "Condition"}),
    ("replace_vals", (_vols_table(), [1, 2], [10, 20]),
     {"cols": ["Region"]}),
    ("replace_vals", (_vols_table(), 3, -3), {}),
    ("df_div", (_vols_table()[["Volume", "Nuclei"]],
                _vols_table()["Volume"]), {"axis": 0}),
    ("df_add", (_vols_table()[["Volume"]], _vols_table(1)[["Volume"]]), {}),
    ("df_subtract", (_vols_table()[["Volume"]],
                     _vols_table(1)[["Nuclei"]]), {}),
])
def test_df_io_functions_match_reference(fn_name, args, kwargs):
    _assert_equal(*_both(fn_name, *args, **kwargs))


def test_combine_cols_with_missing_members_warns_as_reference():
    df = _vols_table().drop(columns=["EdgeDistSum"])
    with pytest.warns(UserWarning, match="Homogeneity"):
        got = df_io.combine_cols(df.copy(), list(vols.MetricCombos))
    with pytest.warns(UserWarning, match="Homogeneity"):
        want = ref_df_io.combine_cols(df.copy(), list(ref_vols.MetricCombos))
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_func_to_paired_cols_matches_reference():
    got, want = _vols_table(), _vols_table()
    df_io.func_to_paired_cols(got, "Nuclei", "Volume", np.divide, "Density")
    ref_df_io.func_to_paired_cols(want, "Nuclei", "Volume", np.divide,
                                  "Density")
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_print_data_frame_matches_reference():
    df = _vols_table()
    assert df_io.print_data_frame(df) == ref_df_io.print_data_frame(df)


def test_csv_writers_and_readers_match_reference(tmp_path):
    """``data_frames_to_csv`` (concatenated, sorted, the old file backed
    up), ``merge_csvs`` and ``exps_by_regions`` on the same files."""
    for sub, mod in (("port", df_io), ("ref", ref_df_io)):
        d = tmp_path / sub
        d.mkdir()
        parts = [_vols_table(1), _vols_table(2)]
        out = str(d / "out.csv")
        mod.data_frames_to_csv(parts[0], out)
        mod.data_frames_to_csv(parts, out, sort_cols=["Region", "Sample"])
        for i, part in enumerate(parts):
            part.to_csv(str(d / f"p{i}.csv"), index=False)
        mod.merge_csvs([str(d / "p0.csv"), str(d / "p1.csv")],
                       str(d / "merged.csv"))
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "ref"))
    path = str(tmp_path / "port" / "merged.csv")
    for kwargs in ({}, {"filter_zeros": False, "sample_delim": None}):
        _assert_equal(df_io.exps_by_regions(path, **kwargs),
                      ref_df_io.exps_by_regions(path, **kwargs))


def test_merge_excels_has_the_reference_outcome(tmp_path):
    """Without openpyxl both raise the same error; with it both write the
    same sheets."""
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"t{i}.xlsx"))
        (tmp_path / f"t{i}.xlsx").write_bytes(b"")
    testing.same_outcome(
        lambda: ref_df_io.merge_excels(paths, str(tmp_path / "want.xlsx")),
        lambda: df_io.merge_excels(paths, str(tmp_path / "got.xlsx")))


def test_null_condition_reads_back_missing_in_both(tmp_path):
    """pandas' CSV reader takes "null" for a missing value, so a condition
    named so (a key of ``config.GROUPS_NUMERIC``) is lost by the table
    tasks of both packages alike; pinned as the reference's behaviour."""
    df = _vols_table()
    df["Condition"] = np.where(df["Condition"] == "ctl", "WT", "null")
    path = str(tmp_path / "v.csv")
    df.to_csv(path, index=False)
    got = cli.main(["--df", "pivot_table", path, "--labels", "index=Region",
                    "columns=Condition", "values=Volume"])
    want = ref_cli.main(["--df", "pivot_table", path, "--labels",
                         "index=Region", "columns=Condition",
                         "values=Volume"])
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert list(got.columns) == ["Region", "WT"]


#: every --df task, its arguments after the task's name (``{d}``: the
#: run's directory) and the file it writes there
_DF_TASKS = [
    ("merge_csvs", ["{d}/a.csv", "{d}/b.csv", "--prefix", "{d}/out.csv"]),
    ("merge_csvs_cols", ["{d}/a.csv", "{d}/b.csv", "--labels",
                         "id_col=Region", "--prefix", "{d}/out.csv"]),
    ("append_csvs_cols", ["{d}/a.csv", "{d}/b.csv", "--groups", "A", "B",
                          "--prefix", "{d}/out.csv"]),
    ("append_csvs_cols", ["{d}/a.csv", "{d}/b.csv", "--prefix",
                          "{d}/out.csv"]),
    ("melt_cols", ["{d}/a.csv", "--labels", "id_cols=Sample,Region",
                   "melt_cols=Volume,Nuclei", "--prefix", "{d}/out.csv"]),
    ("pivot_table", ["{d}/a.csv", "--labels", "index=Region",
                     "columns=Condition", "values=Volume", "--prefix",
                     "{d}/out.csv"]),
    ("pivot_table", ["{d}/a.csv", "--prefix", "{d}/out.csv"]),
    ("sum_cols", ["{d}/a.csv", "--prefix", "{d}/out.csv"]),
    ("subtract_cols", ["{d}/a.csv", "--labels", "col1=Nuclei",
                       "col2=Volume", "--prefix", "{d}/out.csv"]),
    ("multiply_cols", ["{d}/a.csv", "--labels", "col1=Volume",
                       "col2=MeanNuclei", "name=Prod", "--prefix",
                       "{d}/out.csv"]),
    ("divide_cols", ["{d}/a.csv", "--labels", "col1=Nuclei",
                     "col2=Volume", "name=Density", "--prefix",
                     "{d}/out.csv"]),
    ("normalize", ["{d}/n.csv", "--labels", "id_cols=Region",
                   "cond_col=Condition", "cond_base=ctl",
                   "metric_cols=Volume,Nuclei", "--prefix", "{d}/out.csv"]),
    ("zscore", ["{d}/a.csv", "--labels", "group_cols=Region",
                "metric_cols=Volume,Nuclei", "--prefix", "{d}/out.csv"]),
    ("zscore", ["{d}/a.csv", "--prefix", "{d}/out.csv"]),
    ("replace_vals", ["{d}/a.csv", "--labels", "vals_from=ctl",
                      "vals_to=control", "cols=Condition", "--prefix",
                      "{d}/out.csv"]),
    ("exps_by_region", ["{d}/a.csv"]),
]


@pytest.mark.parametrize("task,args", _DF_TASKS)
def test_df_task_files_match_reference_cli(tmp_path, task, args):
    """``--df <task>`` through both CLIs on copies of the same tables:
    the same files, byte for byte, and the same returned tables; the
    tables also given by ``--img`` instead of after the task's name."""
    results = {}
    for sub, main in (("port", cli.main), ("ref", ref_cli.main)):
        d = tmp_path / sub
        d.mkdir()
        _vols_table(1).to_csv(str(d / "a.csv"), index=False)
        _vols_table(2).to_csv(str(d / "b.csv"), index=False)
        _vols_table(3).drop_duplicates(["Region", "Condition"]).to_csv(
            str(d / "n.csv"), index=False)
        argv = [a.format(d=str(d)) for a in args]
        results[sub] = main(["--df", task] + argv)
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "ref"))
    _assert_equal(results["port"], results["ref"])
    if args[0] == "{d}/a.csv" and "{d}/b.csv" not in args:
        d = str(tmp_path / "port")
        by_img = cli.main(["--df", task, "--img", f"{d}/a.csv"] + [
            a.format(d=d) for a in args[1:] if "--prefix" not in a
            and a != "{d}/out.csv"])
        _assert_equal(by_img, results["ref"])


def test_df_tasks_run_on_the_host_whatever_the_device(tmp_path):
    path = str(tmp_path / "a.csv")
    _vols_table().to_csv(path, index=False)
    out = cli.main(["--df", "zscore", path, "--device", "cuda"])
    assert len(out) == 16


@pytest.mark.parametrize("argv,named", [
    (["--df"], "--df needs a task"),
    (["--df", "no_such_task", "a.csv"], "unknown --df task: no_such_task"),
    (["--df", "zscore"], "--df zscore needs --img"),
])
def test_df_task_errors_name_the_task(argv, named):
    with pytest.raises(SystemExit, match=named):
        cli.process_cli_args(argv)


def test_df_parses_as_the_reference():
    argv = ["--df", "append_csvs_cols", "a.csv", "b.csv", "--groups", "A",
            "B", "--prefix", "o.csv", "--labels", "id_col=Region"]
    got, want = cli.process_cli_args(argv), ref_cli.process_cli_args(argv)
    for name in ("df_task", "groups", "prefix", "labels", "filenames"):
        assert getattr(got, name) == getattr(want, name), name
    assert os.path.basename(got.prefix) == "o.csv"
