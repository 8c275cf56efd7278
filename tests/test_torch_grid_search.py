"""The port's ``--grid_search`` task against the JAX reference's, both on
the CPU (the port through its kernels' plain versions).

The tables must be equal (``pd.testing.assert_frame_equal``): same rows in
the same order, same counts and rates. ``4xnuc`` takes the batched route
(one LoG pyramid for every threshold, K2 and K3); ``lightsheet`` sets
``isotropic``, so it takes the plain route (block detection per
threshold). The ROI holds 10 scales x (24, 48, 48) = 4,320 groups of 128
lanes, above the 4,096 capacity floor, so the batched route harvests
through K2.
"""

import os
import subprocess
import sys

import pandas as pd
import pytest
import torch

from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.io import np_io
from magellanmapper_tpu.settings.roi_prof import ROIProfile
from magellanmapper_tpu.stats import mlearn as ref_mlearn
from magellanmapper_torch import testing
from magellanmapper_torch.io import cli
from magellanmapper_torch.kernels import extract_candidates as k2
from magellanmapper_torch.stats import mlearn

torch.set_num_threads(1)

SHAPE = (24, 48, 48)
#: the checkout's root: a fresh interpreter imports the port from there,
#: whatever directory an earlier test left the process in
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def roi():
    """Planted nuclei (the truth) plus dimmer untruthed ones between
    them, which turn into false positives at low thresholds; [0, 1]."""
    return testing.make_grid_roi(SHAPE, 0, spacing=12, jitter=2)


def _write_inputs(directory, roi):
    vol, centres = roi
    img = str(directory / "roi.npy")
    np_io.write_npy(img, vol, resolutions=[[1.0, 1.0, 1.0]])
    truth = testing.write_truth_db(
        str(directory / "truth.db"), centres, SHAPE)
    return img, truth


def _argv(img, truth, profile):
    return ["--img", img, "--grid_search", "gridtest", "--roi_profile",
            profile, "--truth_db", truth]


@pytest.fixture
def k2_rows(monkeypatch):
    calls = []
    original = k2.extract_candidates

    def spy(rows):
        calls.append(rows.shape[0])
        return original(rows)

    monkeypatch.setattr(k2, "extract_candidates", spy)
    return calls


@pytest.mark.parametrize("profile,batched", [
    ("4xnuc", True), ("lightsheet", False)])
def test_grid_search_cli_matches_reference(
        tmp_path, roi, k2_rows, profile, batched):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_img, ref_truth = _write_inputs(tmp_path / "ref", roi)
    img, truth = _write_inputs(tmp_path / "port", roi)
    want = ref_cli.main(_argv(ref_img, ref_truth, profile))
    got = cli.main(_argv(img, truth, profile) + ["--device", "cpu"])
    assert isinstance(got, pd.DataFrame) and len(got) == 4
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(
        pd.read_csv(img + "_gridsearch.csv"),
        pd.read_csv(ref_img + "_gridsearch.csv"))
    # the threshold matters: the table holds more than one outcome
    assert got["FP"].nunique() > 1 and got["TP"].nunique() > 1
    # 4 thresholds in chunks of 8: one K2 launch over 4 x 4,320 rows
    assert k2_rows == ([4 * 4320] if batched else [])


def test_make_fn_detect_multi_matches_reference(roi):
    """The batched callback alone, with a second combination key, at the
    capacity rule's floor (4,096) and with a threshold chunk of 8."""
    vol = roi[0]
    prof = ROIProfile()
    prof.add_profiles("4xnuc")
    thresholds = [0.04, 0.08, 0.12]
    want = ref_mlearn.make_fn_detect_multi(vol, (1.0, 1.0, 1.0), prof)(
        {"overlap": 0.3}, thresholds)
    got = mlearn.make_fn_detect_multi(
        vol, (1.0, 1.0, 1.0), prof, "cpu")({"overlap": 0.3}, thresholds)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert testing.rows_equal(g, w)


def test_grid_search_host_helpers_copy(roi):
    vol = roi[0]
    prof = ROIProfile()
    prof.add_profiles("lightsheet")
    for keys, p in ((["detection_threshold"], ROIProfile()),
                    (["detection_threshold"], prof),
                    (["min_sigma_factor", "isotropic"], ROIProfile())):
        assert mlearn.multi_path_applicable(vol, keys, p) == \
            ref_mlearn.multi_path_applicable(vol, keys, p)
    assert mlearn.MULTI_SUPPORTED_KEYS == ref_mlearn.MULTI_SUPPORTED_KEYS
    assert mlearn.MULTI_SWEEP_KEY == ref_mlearn.MULTI_SWEEP_KEY
    assert [s.value for s in mlearn.GridSearchStats] == [
        s.value for s in ref_mlearn.GridSearchStats]
    df = pd.DataFrame({"detection_threshold": [0.1, 0.2, 0.3],
                       "SENS": [0.9, 0.5, 0.95], "FDR": [0.1, 0.0, 0.3]})
    pd.testing.assert_frame_equal(
        mlearn.parse_grid_stats(df), ref_mlearn.parse_grid_stats(df))


def test_cli_truth_db_needs_grid_search(tmp_path, roi):
    """``--truth_db`` with ``--proc detect`` verifies the detections into
    ``verify.csv``, as the reference's task does (the table equal), and
    ``--grid_search`` still needs a truth database."""
    (tmp_path / "ref").mkdir()
    img, truth = _write_inputs(tmp_path, roi)
    ref_img, _ = _write_inputs(tmp_path / "ref", roi)
    argv = ["--proc", "detect", "--roi_profile", "4xnuc", "--truth_db",
            truth]
    got = cli.main(["--img", img] + argv + ["--device", "cpu"])
    want = ref_cli.main(["--img", ref_img] + argv)
    pd.testing.assert_frame_equal(pd.DataFrame(got.blobs),
                                  pd.DataFrame(want.blobs))
    table = pd.read_csv(img.replace(".npy", "_verify.csv"))
    pd.testing.assert_frame_equal(
        table, pd.read_csv(ref_img.replace(".npy", "_verify.csv")))
    assert list(table.columns) == ["sens", "ppv"]
    assert table["sens"][0] > 0.5 and table["ppv"][0] > 0.3
    with pytest.raises(SystemExit):
        cli.main(["--img", img, "--grid_search", "gridtest",
                  "--roi_profile", "4xnuc", "--device", "cpu"])
    assert not os.path.exists(img + "_gridsearch.csv")


_GRID_SEARCH_WITHOUT_JAX = """
import sys
from magellanmapper_torch.io import cli
df = cli.main(sys.argv[1:])
assert "jax" not in sys.modules, sorted(
    m for m in sys.modules if m.startswith("jax"))
ref = sorted(m for m in sys.modules if m.startswith("magellanmapper_tpu"))
assert not ref, ref
print(len(df))
"""


def test_grid_search_cli_runs_without_jax(tmp_path, roi):
    """The whole task, imports made inside functions included, leaves jax
    and the reference package out of ``sys.modules`` (conftest imports
    jax here, so a fresh process)."""
    img, truth = _write_inputs(tmp_path, roi)
    out = subprocess.run(
        [sys.executable, "-c", _GRID_SEARCH_WITHOUT_JAX,
         *_argv(img, truth, "4xnuc"), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "4"
