"""``stats.atlas_stats`` and the ``--register`` table tasks of
``magellanmapper_torch`` against the JAX package's, on the CPU.

Tolerance: none. The port's copies run the same pandas, numpy and
matplotlib code: tables and series equal the reference's exactly, the
tasks' CSV files byte for byte, and every figure (the plot functions
close theirs and return them, as the reference's do) equals the
reference's by the pixels of its PNG rendering.
"""

import io

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.stats import atlas_stats as ref_stats
from magellanmapper_tpu.stats import vols as ref_vols
from magellanmapper_torch import testing
from magellanmapper_torch.io import cli
from magellanmapper_torch.stats import atlas_stats, vols

from test_torch_export_stack import assert_same_files


def fig_pixels(fig) -> np.ndarray:
    """A figure rendered to PNG, as RGBA pixels."""
    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    buf.seek(0)
    with Image.open(buf) as img:
        return np.asarray(img.convert("RGBA"))


def assert_same(got, want):
    """Equal results: frames exactly, figures by pixels."""
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    elif isinstance(want, pd.Series):
        pd.testing.assert_series_equal(got, want, check_exact=True)
    elif hasattr(want, "savefig"):
        np.testing.assert_array_equal(fig_pixels(got), fig_pixels(want))
    else:
        assert got == want or (np.isnan(got) and np.isnan(want))


def _study(seed=0, n=4, regions=(1, 2, 3, 7)):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(2 * n):
        for region in regions:
            rows.append({
                "Sample": f"b{i}", "Condition": "WT" if i < n else "het",
                "Region": region, "Age": 10 + i,
                "Volume": float(rng.integers(100, 900)),
                "VarIntensity": rng.random(), "MeanIntensity": rng.random(),
                "VarNuclei": rng.random(), "MeanNuclei": rng.random(),
                "EdgeDistSum": rng.random(), "Density": rng.random(),
                "DensityIntens": rng.random(), "Unlabeled": rng.random(),
                "Effect": rng.normal(), "P": rng.random()})
    return pd.DataFrame(rows)


def test_calc_sens_ppv_is_the_verifiers():
    args = (5, 3, 2, 1)
    assert atlas_stats.calc_sens_ppv(*args) == ref_stats.calc_sens_ppv(*args)


@pytest.mark.parametrize("weighted", [False, True])
def test_meas_dice_matches_reference(weighted):
    rng = np.random.default_rng(1)
    a, b = rng.random((2, 6, 7, 8)) > 0.5
    img = rng.random(a.shape) if weighted else None
    assert atlas_stats.meas_dice(a, b, img) == ref_stats.meas_dice(a, b, img)
    none = np.zeros_like(a)
    assert np.isnan(atlas_stats.meas_dice(none, none))


@pytest.mark.parametrize("cols", [
    ("SmoothingQuality", "Filter"), ("Smoothing_quality", "Filter_size")])
def test_smoothing_peak_matches_reference(cols):
    df = pd.DataFrame({cols[0]: [0.1, 0.4, 0.2], cols[1]: [1, 2, 3]})
    assert_same(atlas_stats.smoothing_peak(df, *cols),
                ref_stats.smoothing_peak(df, *cols))


@pytest.mark.parametrize("spacing", [None, (2.0, 1.0, 0.5)])
def test_meas_landmark_dist_and_coefvar_match_reference(spacing):
    rng = np.random.default_rng(2)
    c1, c2 = rng.random((2, 9, 3)) * 10
    assert_same(atlas_stats.meas_landmark_dist(c1, c2, spacing),
                ref_stats.meas_landmark_dist(c1, c2, spacing))
    vals = rng.random(12)
    assert atlas_stats.coefvar(vals) == ref_stats.coefvar(vals)
    assert np.isnan(atlas_stats.coefvar(np.zeros(3)))


def test_meas_plot_zscores_matches_reference(tmp_path):
    df = _study()
    metrics = [m.name for m in vols.VAR_METRICS]
    assert_same(atlas_stats.meas_plot_zscores(
        df, metrics, ["Region"], [vols.MetricCombos.HOMOGENEITY]),
        ref_stats.meas_plot_zscores(
            df, metrics, ["Region"], [ref_vols.MetricCombos.HOMOGENEITY]))
    assert_same(atlas_stats.meas_plot_zscores(df, ["Volume"], [], None),
                ref_stats.meas_plot_zscores(df, ["Volume"], [], None))


@pytest.mark.parametrize("id_cols,size_col", [
    (["Region"], None), (["Region", "Condition"], "Volume"),
    (["Sample", "Condition"], None)])
def test_meas_plot_coefvar_matches_reference(id_cols, size_col):
    df = _study()
    args = (df, id_cols, "Condition", "WT", ["Density"], size_col)
    assert_same(atlas_stats.meas_plot_coefvar(*args),
                ref_stats.meas_plot_coefvar(*args))


@pytest.mark.parametrize("col_wt", [None, "Volume"])
def test_meas_improvement_matches_reference(col_wt):
    df = _study(seed=3)
    kwargs = {"col_wt": col_wt, "df": df}
    assert_same(atlas_stats.meas_improvement(None, "Effect", "P", **kwargs),
                ref_stats.meas_improvement(None, "Effect", "P", **kwargs))


def test_plots_match_reference_by_pixels(tmp_path):
    df = _study(seed=4)
    assert_same(atlas_stats.plot_region_development("Volume", df),
                ref_stats.plot_region_development("Volume", df))
    assert_same(atlas_stats.plot_unlabeled_hemisphere(df, ["Unlabeled",
                                                           "Density"]),
                ref_stats.plot_unlabeled_hemisphere(df, ["Unlabeled",
                                                         "Density"]))
    assert_same(atlas_stats.plot_intensity_nuclei(
        [df, df.iloc[:5]], ["DensityIntens", "Density"], unit="mm"),
        ref_stats.plot_intensity_nuclei(
            [df, df.iloc[:5]], ["DensityIntens", "Density"], unit="mm"))
    rng = np.random.default_rng(5)
    blobs = np.column_stack([rng.integers(0, 3, 40), rng.random((40, 2)) * 50,
                             np.ones(40), rng.integers(-1, 4, 40)])
    for arr in (blobs, blobs[:, :4]):
        assert_same(atlas_stats.plot_clusters_by_label(arr, 1),
                    ref_stats.plot_clusters_by_label(arr, 1))


def _inputs(d):
    """Copies of every table task's inputs in the directory ``d``."""
    df = _study(seed=6)
    df.to_csv(str(d / "study.csv"), index=False)
    df.to_csv(str(d / "other.csv"), index=False)
    pd.DataFrame({"Filter_size": [1, 2, 3], "Compaction": [0.1, 0.3, 0.2],
                  "Smoothing_quality": [0.05, 0.2, 0.1]}).to_csv(
        str(d / "smoothing.csv"), index=False)
    pd.DataFrame({"Filter": [1, 2], "SmoothingQuality": [0.3, 0.2]}).to_csv(
        str(d / "smoothing2.csv"), index=False)
    rng = np.random.default_rng(7)
    blobs = np.column_stack([rng.integers(0, 4, 30), rng.random((30, 2)) * 40,
                             np.ones(30), rng.integers(-1, 3, 30)])
    np.savez(str(d / "c_blobs.npz"), blobs=blobs)


#: the --register table tasks and their arguments (``{d}``: the run's
#: directory)
_TASKS = [
    ("smoothing_peaks", ["--img", "{d}/smoothing.csv"]),
    ("smoothing_peaks", ["--img", "{d}/smoothing2.csv"]),
    ("combine_cols", ["--img", "{d}/study.csv"]),
    ("combine_cols", ["--img", "{d}/study.csv", "--prefix", "{d}/out"]),
    ("zscores", ["--img", "{d}/study.csv"]),
    ("coefvar", ["--img", "{d}/study.csv"]),
    ("melt_cols", ["--img", "{d}/study.csv"]),
    ("pivot_conds", ["--img", "{d}/study.csv", "--prefix", "{d}/out"]),
    ("meas_improvement", ["--img", "{d}/study.csv"]),
    ("meas_improvement", ["--img", "{d}/study.csv", "--proc", "detect",
                          "col_wt=Volume"]),
    ("plot_region_dev", ["--img", "{d}/study.csv"]),
    ("plot_lateral_unlabeled", ["--img", "{d}/study.csv"]),
    ("plot_intens_nuc", ["--img", "{d}/study.csv", "{d}/other.csv"]),
    ("plot_cluster_blobs", ["--img", "{d}/c.npy", "--offset", "0,0,2"]),
    ("plot_cluster_blobs", ["--img", "{d}/c.npy"]),
]


@pytest.mark.parametrize("task,args", _TASKS)
def test_register_table_tasks_match_reference_cli(tmp_path, task, args):
    """``--register <task>`` through both CLIs on copies of the same
    inputs: the same files (CSV byte for byte) and the same results."""
    results = {}
    for sub, main in (("port", cli.main), ("ref", ref_cli.main)):
        d = tmp_path / sub
        d.mkdir()
        _inputs(d)
        results[sub] = main(["--register", task]
                            + [a.format(d=str(d)) for a in args])
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "ref"))
    assert_same(results["port"], results["ref"])


def test_plot_cluster_blobs_of_a_blob_archive_fails_as_reference(tmp_path):
    """A saved blob archive keeps its rows as ``segments``: the task
    reads ``blobs`` and raises in both packages alike."""
    from magellanmapper_torch.cv import blobs as blobs_mod
    archive = blobs_mod.Blobs(np.ones((3, 10)))
    archive.path = str(tmp_path / "s_blobs.npz")
    archive.save_archive()
    argv = ["--img", str(tmp_path / "s.npy"), "--register",
            "plot_cluster_blobs"]
    testing.same_outcome(lambda: ref_cli.main(argv), lambda: cli.main(argv))


def test_table_tasks_run_on_the_host_whatever_the_device(tmp_path):
    _inputs(tmp_path)
    out = cli.main(["--img", str(tmp_path / "study.csv"), "--register",
                    "coefvar", "--device", "cuda"])
    assert len(out) == 4
