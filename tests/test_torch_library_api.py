"""The reference's library names in the port, each against the reference on
the same inputs, and the reference's own calls of them replayed on the
port: ``io/cli``'s programmatic set-up (``setup_*``,
``process_proc_tasks``, ``RunConfig.proc`` as a ``ProcessTypes`` member),
the constants and small helpers, ``sqlite.select_or_insert_roi``, the
shared-array container, the Java gate, the aliases and the parameters
``cache_dir``, ``coloc`` and ``blob_matches``. Every comparison is exact.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magellanmapper_tpu.atlas import atlas_refiner as ref_refiner
from magellanmapper_tpu.atlas import gauntlet as ref_gauntlet
from magellanmapper_tpu.cv import blobs as ref_blobs
from magellanmapper_tpu.cv import chunking as ref_chunking
from magellanmapper_tpu.cv import cv_nd as ref_cv_nd
from magellanmapper_tpu.cv import stack_detect as ref_sd
from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.io import importer as ref_importer
from magellanmapper_tpu.io import naming as ref_naming
from magellanmapper_tpu.io import sqlite as ref_sqlite
from magellanmapper_tpu.ops import peaks as ref_peaks
from magellanmapper_tpu.settings import roi_prof as ref_roi_prof
from magellanmapper_tpu.stats import mlearn as ref_mlearn
from magellanmapper_torch import testing
from magellanmapper_torch.atlas import atlas_refiner, gauntlet
from magellanmapper_torch.cv import blobs, chunking, cv_nd, stack_detect
from magellanmapper_torch.io import cli, importer, naming, np_io, sqlite
from magellanmapper_torch.ops import peaks
from magellanmapper_torch.settings import roi_prof
from magellanmapper_torch.stats import mlearn

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- io/cli: ProcessTypes and RunConfig ----------------------------------------

def test_parse_args_replays_the_reference_test():
    """``tests/test_cli_exports.py:28-39`` on the port."""
    rc = cli.process_cli_args([
        "--img", "a.npy", "--proc", "detect",
        "--channel", "0", "--roi_profile", "lightsheet,4xnuc",
        "--reg_suffixes", "atlas=atlasVolume.mhd",
        "--set_meta", "resolutions=2,1,1"])
    assert rc.filenames == ["a.npy"]
    assert rc.proc is cli.ProcessTypes.DETECT
    assert rc.channel == [0]
    assert rc.roi_profile["min_sigma_factor"] == 3
    assert rc.reg_suffixes["atlas"] == "atlasVolume.mhd"
    assert rc.resolutions == [2.0, 1.0, 1.0]


@pytest.mark.parametrize("task", [t.name.lower() for t in cli.ProcessTypes])
def test_proc_is_the_member_of_the_task(task):
    argv = ["--img", "a.npy", "--proc", task]
    if task == "preprocess":
        argv.append("saturate")
    got = cli.process_cli_args(argv)
    want = ref_cli.process_cli_args(argv)
    assert got.proc is cli.ProcessTypes[want.proc.name]
    assert got.proc_args == want.proc_args


def test_process_types_and_run_config_fields_are_the_reference():
    assert [t.name for t in cli.ProcessTypes] == [
        t.name for t in ref_cli.ProcessTypes]
    assert cli.TASKS == tuple(cli.ProcessTypes)
    got = {f.name: f.default for f in dataclasses.fields(cli.RunConfig)}
    want = {f.name: f.default for f in dataclasses.fields(ref_cli.RunConfig)}
    assert set(want) <= set(got)
    assert got["plot_2d_task_args"] is want["plot_2d_task_args"] is None
    assert cli.RunConfig().device == "cuda"


@pytest.mark.parametrize("names,channel", [
    (None, 0), (["lightsheet"], 0), (["lightsheet", "4xnuc"], 1),
    (["lightsheet", "4xnuc"], 2)])
def test_get_roi_profile_matches_reference(names, channel):
    rc = cli.RunConfig()
    ref_rc = ref_cli.RunConfig()
    if names:
        rc.roi_profiles = cli.setup_roi_profiles(names)
        ref_rc.roi_profiles = ref_cli.setup_roi_profiles(names)
    assert dict(rc.get_roi_profile(channel)) == dict(
        ref_rc.get_roi_profile(channel))


def test_setup_roi_profiles_replays_the_reference_test():
    """``tests/test_ref_parity2.py:244`` on the port, and each profile
    equal to the reference's."""
    assert len(cli.setup_roi_profiles(["default", "lightsheet"])) == 2
    for names in (None, [], ["default"], ["lightsheet,4xnuc", "default"]):
        got = cli.setup_roi_profiles(names)
        want = ref_cli.setup_roi_profiles(names)
        assert [dict(p) for p in got] == [dict(p) for p in want]


@pytest.mark.parametrize("name", [None, "default", "abap56", "ncc,nobspline"])
def test_setup_atlas_profiles_matches_reference(name):
    assert dict(cli.setup_atlas_profiles(name)) == dict(
        ref_cli.setup_atlas_profiles(name))


@pytest.mark.parametrize("name", [None, "gridtest"])
def test_setup_grid_search_profiles_matches_reference(name):
    assert dict(cli.setup_grid_search_profiles(name)) == dict(
        ref_cli.setup_grid_search_profiles(name))


def test_update_profiles_resets_to_the_defaults_pin():
    """The reference's ``update_profiles`` reads ``roi_profile_names`` and
    ``atlas_profile_name``, which ``RunConfig`` does not have, so it resets
    ``roi_profiles`` to one default profile and ``atlas_profile`` to the
    defaults; the port keeps that for parity (ROADMAP section 3)."""
    argv = ["--img", "a.npy", "--proc", "detect", "--roi_profile",
            "lightsheet", "4xnuc", "--atlas_profile", "abap56"]
    got = cli.update_profiles(cli.process_cli_args(argv))
    want = ref_cli.update_profiles(ref_cli.process_cli_args(argv))
    assert [dict(p) for p in got.roi_profiles] == [
        dict(p) for p in want.roi_profiles] == [dict(roi_prof.ROIProfile())]
    assert dict(got.atlas_profile) == dict(want.atlas_profile) == dict(
        cli.setup_atlas_profiles())


def test_setup_labels_matches_reference(tmp_path):
    path = tmp_path / "ref.csv"
    path.write_text("Region,RegionName,Level\n1,root,0\n2,cortex,1\n"
                    "4,layer1,2\n")
    assert cli.setup_labels(None) is None is ref_cli.setup_labels(None)
    got = cli.setup_labels(str(path), level=1)
    want = ref_cli.setup_labels(str(path), level=1)
    assert sorted(got.ref_lookup) == sorted(want.ref_lookup)
    assert got.get_ref_lookup_as_df().astype(str).equals(
        want.get_ref_lookup_as_df().astype(str))


def _image(path, shape=(6, 20, 18), seed=3):
    vol = np.random.default_rng(seed).integers(
        0, 3000, shape).astype(np.uint16)
    np_io.write_npy(path, vol, resolutions=[[2.0, 1.0, 1.5]])
    return vol


@pytest.mark.parametrize("sub", [None, ([1, 2, 3], [4, 5, 2])])
def test_setup_image_matches_reference(tmp_path, sub):
    path = str(tmp_path / "img.npy")
    _image(path)
    rcs = [cli.RunConfig(filenames=[path]), ref_cli.RunConfig(
        filenames=[path])]
    for rc in rcs:
        if sub:
            rc.subimg_offsets, rc.subimg_sizes = [sub[0]], [sub[1]]
        rc.resolutions = [3.0, 1.0, 1.0]
    got = cli.setup_image(rcs[0])
    want = ref_cli.setup_image(rcs[1])
    np.testing.assert_array_equal(np.asarray(got.img), np.asarray(want.img))
    assert got.meta == want.meta
    assert got.subimg_offset == want.subimg_offset
    assert got.subimg_size == want.subimg_size


def test_setup_dbs_and_select_or_insert_roi_match_reference(tmp_path):
    rows = {}
    for name, mod, sql in (("port", cli, sqlite), ("ref", ref_cli,
                                                   ref_sqlite)):
        rc = mod.RunConfig(db_path=str(tmp_path / f"{name}.db"),
                           truth_db=str(tmp_path / f"{name}_truth.db"))
        db, truth = mod.setup_dbs(rc)
        try:
            exp = db.select_or_insert_experiment("samp")
            out = [sql.select_or_insert_roi(db.conn, db.cur, exp, 0, off,
                                            (10, 12, 4))
                   for off in ((0, 0, 0), (5, 0, 2), (0, 0, 0), (5, 0, 2))]
            out.append(sql.insert_roi(db.conn, db.cur, exp, 1, (0, 0, 0),
                                      (1, 1, 1)))
            rows[name] = (out, [tuple(r) for r in sql.select_rois(db.cur)],
                          truth.path)
        finally:
            db.close()
            truth.close()
        assert mod.setup_dbs(mod.RunConfig(
            db_path=str(tmp_path / f"{name}.db")))[1] is None
    assert rows["port"][:2] == rows["ref"][:2]
    assert [s for _, s in rows["port"][0]] == [
        "inserted", "inserted", "exists", "exists", "inserted"]
    assert rows["port"][2] == str(tmp_path / "port_truth.db")


def _detect_volume(tmp_path):
    vol = testing.make_nuclei_volume((24, 64, 64), seed=4)[0]
    paths = []
    for name in ("port", "ref"):
        path = str(tmp_path / f"{name}.npy")
        np_io.write_npy(path, vol, resolutions=[[1.0, 1.0, 1.0]])
        paths.append(path)
    return paths


def test_process_proc_tasks_by_hand_matches_reference(tmp_path):
    """A run config built by hand, ``setup_image`` then
    ``process_proc_tasks``, gives the reference's blob rows and archive."""
    paths = _detect_volume(tmp_path)
    rc = cli.RunConfig(filenames=[paths[0]], proc=cli.ProcessTypes.DETECT,
                       device="cpu")
    rc.roi_profiles = cli.setup_roi_profiles(["lightsheet"])
    rc.roi_profile = rc.roi_profiles[0]
    ref_rc = ref_cli.RunConfig(filenames=[paths[1]],
                               proc=ref_cli.ProcessTypes.DETECT)
    ref_rc.roi_profiles = ref_cli.setup_roi_profiles(["lightsheet"])
    ref_rc.roi_profile = ref_rc.roi_profiles[0]
    assert cli.setup_image(rc).img.shape == ref_cli.setup_image(
        ref_rc).img.shape
    got = cli.process_proc_tasks(rc)
    want = ref_cli.process_proc_tasks(ref_rc)
    assert len(want.blobs) > 0
    assert testing.rows_equal(got.blobs, want.blobs)
    saved = blobs.Blobs().load_blobs(str(tmp_path / "port_blobs.npz"))
    np.testing.assert_array_equal(saved.blobs, got.blobs)
    parsed = cli.main(["--img", paths[0], "--proc", "detect",
                       "--roi_profile", "lightsheet", "--device", "cpu"])
    np.testing.assert_array_equal(parsed.blobs, got.blobs)


def test_process_proc_tasks_without_a_task_does_nothing():
    assert cli.process_proc_tasks(cli.RunConfig()) is None
    assert ref_cli.process_proc_tasks(ref_cli.RunConfig()) is None


def test_process_proc_tasks_rejects_a_task_name(tmp_path):
    """``proc`` holds a member: a name is not taken for it."""
    rc = cli.RunConfig(filenames=[str(tmp_path / "v.npy")], proc="detect",
                       device="cpu")
    with pytest.raises(SystemExit, match="ProcessTypes member"):
        cli.process_proc_tasks(rc)


def test_host_task_by_hand_runs_on_the_host(tmp_path):
    path = str(tmp_path / "img.npy")
    vol = _image(path)
    rc = cli.RunConfig(filenames=[path], proc=cli.ProcessTypes.LOAD)
    np.testing.assert_array_equal(
        np.asarray(cli.process_proc_tasks(rc).img[0]), vol)


_LIBRARY_ALONE = """
import sys
from magellanmapper_torch.io import cli
rc = cli.RunConfig(filenames=[sys.argv[1]], proc=cli.ProcessTypes.DETECT,
                   device="cpu")
rc.roi_profiles = cli.setup_roi_profiles(["lightsheet"])
rc.roi_profile = rc.roi_profiles[0]
img5d = cli.setup_image(rc)
blobs = cli.process_proc_tasks(rc)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "magellanmapper_tpu"))
assert not loaded, loaded
cli.shutdown()
print(img5d.img.shape, len(blobs.blobs))
"""


def test_library_entry_runs_without_the_reference(tmp_path):
    """``setup_image`` then ``process_proc_tasks`` with ``device="cpu"``
    in a fresh interpreter: no ``jax*`` or ``magellanmapper_tpu*`` module
    is loaded, and the blobs equal the reference's."""
    paths = _detect_volume(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", _LIBRARY_ALONE, paths[0]],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    want = ref_cli.main(["--img", paths[1], "--proc", "detect",
                         "--roi_profile", "lightsheet"])
    assert out.stdout.split() == ["(1,", "24,", "64,", "64)",
                                  str(len(want.blobs))]
    got = blobs.Blobs().load_blobs(str(tmp_path / "port_blobs.npz"))
    assert testing.rows_equal(got.blobs, want.blobs)


# -- constants and small helpers -----------------------------------------------

def test_constants_are_the_reference():
    assert mlearn.GRID_SEARCH_STATS == ref_mlearn.GRID_SEARCH_STATS
    assert roi_prof.BLOB_PREPROCESSING == ref_roi_prof.BLOB_PREPROCESSING
    assert set(roi_prof.BLOB_PREPROCESSING) <= set(roi_prof.ROIProfile())


def _grid_volume(tmp_path, shape=(24, 40, 40), n=10, seed=4):
    """``tests/test_cli_exports.py:14-24``'s volume."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    zz, yy, xx = np.indices(shape).astype(np.float32)
    centers = np.column_stack([rng.uniform(6, s - 6, n) for s in shape])
    for cz, cy, cx in centers:
        vol += np.exp(-((zz-cz)**2 + (yy-cy)**2 + (xx-cx)**2) / 8.0)
    vol /= vol.max()
    base = str(tmp_path / "samp.npy")
    np_io.write_npy(base, vol[None], resolutions=[[1.0, 1.0, 1.0]])
    return base, centers


def test_grid_search_columns_replay_the_reference_test(tmp_path):
    """``tests/test_cli_exports.py:320-348`` on the port: the grid
    search's table carries ``mlearn.GRID_SEARCH_STATS``."""
    base, centers = _grid_volume(tmp_path)
    db = sqlite.load_db(str(tmp_path / "truth.db"))
    exp = db.select_or_insert_experiment("samp")
    roi_id, _ = db.select_or_insert_roi(exp, 0, (0, 0, 0), (40, 40, 24))
    truth = np.column_stack([
        centers, np.full(len(centers), 3.0), np.ones(len(centers)),
        np.ones(len(centers)), np.zeros(len(centers))])
    db.insert_blobs(roi_id, truth)
    db.close()
    df = cli.main([
        "--img", base, "--grid_search", "gridtest", "--roi_profile", "4xnuc",
        "--truth_db", str(tmp_path / "truth.db"), "--device", "cpu"])
    assert os.path.exists(base + "_gridsearch.csv")
    assert len(df) == 4
    assert set(mlearn.GRID_SEARCH_STATS) <= set(df.columns)
    by_thr = df.sort_values("detection_threshold")
    n_det = (by_thr["TP"] + by_thr["FP"]).to_numpy()
    assert (np.diff(n_det) <= 0).all()
    assert by_thr.iloc[0]["SENS"] > 0.5


@pytest.mark.parametrize("path,offset,size", [
    ("/d/b.npy", (1, 2, 3), (4, 5, 6)), ("/d/b.npy", (1, 2, 3), None),
    ("rel/img.tif", np.array([10, 0, 7]), np.array([3, 3, 3])),
    ("noext", (0, 0, 0), (1, 2, 3))])
def test_get_roi_path_matches_reference(path, offset, size):
    assert naming.get_roi_path(path, offset, size) == \
        ref_naming.get_roi_path(path, offset, size)


def test_get_roi_path_replays_the_reference_test():
    """``tests/test_editors.py:159-162`` on the port."""
    assert naming.get_roi_path("/d/b.npy", (1, 2, 3), (4, 5, 6)) \
        == "/d/b_offset(1,2,3)x(4,5,6)"


def test_show_blobs_per_channel_matches_reference():
    rng = np.random.default_rng(5)
    rows = np.column_stack([rng.random((12, 4)) * 10,
                            rng.integers(0, 3, 12)]).astype(float)
    got = blobs.Blobs(rows.copy())
    got.format_blobs()
    want = ref_blobs.Blobs(rows.copy())
    want.format_blobs()
    assert got.show_blobs_per_channel() == want.show_blobs_per_channel()
    assert sum(got.show_blobs_per_channel().values()) == 12
    assert blobs.Blobs().show_blobs_per_channel() == {} == \
        ref_blobs.Blobs().show_blobs_per_channel()


def test_blobs_positional_parameters_match_reference():
    """``Blobs(arr, None, colocs)``: ``blob_matches`` is second, as in the
    reference, so colocalizations bind third."""
    rows = np.ones((3, 10))
    colocs = np.array([[1, 0], [0, 1], [1, 1]])
    got = blobs.Blobs(rows, "matches", colocs, "p.npz", None)
    want = ref_blobs.Blobs(rows, "matches", colocs, "p.npz", None)
    for attr in ("blob_matches", "colocalizations", "path", "cols"):
        assert np.array_equal(getattr(got, attr), getattr(want, attr)), attr
    assert blobs.Blobs().blob_matches is None


def test_stack_detector_keeps_coloc_as_reference():
    vol = np.zeros((4, 8, 8), np.float32)
    prof = roi_prof.ROIProfile()
    got = stack_detect.StackDetector(vol, prof, (1.0,) * 3, 0, True)
    want = ref_sd.StackDetector(vol, prof, (1.0,) * 3, 0, True)
    assert (got.channel, got.coloc) == (want.channel, want.coloc) == (0, True)
    assert got.device == "cuda"
    assert stack_detect.StackDetector(vol, prof, (1.0,) * 3).coloc is False


# -- the shared-array container ------------------------------------------------

@pytest.fixture
def containers():
    saved = (chunking.SharedArrsContainer.shared_arrs,
             ref_chunking.SharedArrsContainer.shared_arrs)
    chunking.SharedArrsContainer.shared_arrs = {}
    ref_chunking.SharedArrsContainer.shared_arrs = {}
    yield chunking.SharedArrsContainer, ref_chunking.SharedArrsContainer
    (chunking.SharedArrsContainer.shared_arrs,
     ref_chunking.SharedArrsContainer.shared_arrs) = saved


def test_shared_arrays_replay_the_reference_test(containers):
    """``tests/test_ref_parity3.py:160-168`` on the port."""
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    chunking.SharedArrsContainer.to_shared("x", arr)
    back = chunking.SharedArrsContainer.from_shared("x")
    np.testing.assert_array_equal(back, arr)
    assert chunking.set_mp_start_method() in ("spawn", "fork", "forkserver")
    assert isinstance(chunking.is_fork(), bool)


@pytest.mark.parametrize("dtype,shape", [
    (np.uint16, (4, 5, 6)), (np.float64, (7,)), (np.int32, (0, 3))])
def test_shared_arrays_match_reference(containers, dtype, shape):
    arr = np.random.default_rng(1).integers(0, 100, shape).astype(dtype)
    for cls in containers:
        shared = cls.to_shared("a", arr)
        assert (shared.shape, shared.dtype) == (arr.shape, arr.dtype)
        assert isinstance(shared, tuple) and len(shared) == 3
        back = cls.from_shared("a")
        assert back.dtype == arr.dtype
        np.testing.assert_array_equal(back, arr)
        plain = arr + 1
        cls.set_data(b=plain)
        assert list(cls.shared_arrs) == ["b"] and cls.from_shared("b") is plain


# -- the Java gate -------------------------------------------------------------

def test_java_gate_replays_the_reference_test():
    """``tests/test_ref_parity3.py:115-120`` on the port."""
    assert not importer.is_javabridge_loaded()
    with pytest.raises(ImportError, match="javabridge"):
        importer.start_jvm()


@pytest.mark.parametrize("name,args", [
    ("start_jvm", ()), ("start_jvm", ("2G",)), ("parse_ome", ("a.czi",)),
    ("parse_ome_raw", ("a.czi",))])
def test_java_gate_raises_as_reference(name, args):
    with pytest.raises(ImportError) as want:
        getattr(ref_importer, name)(*args)
    with pytest.raises(ImportError) as got:
        getattr(importer, name)(*args)
    assert str(got.value) == str(want.value)


def test_stop_jvm_without_java_is_a_no_op():
    assert importer.is_javabridge_loaded() == \
        ref_importer.is_javabridge_loaded()
    assert importer.stop_jvm() is None is ref_importer.stop_jvm()


# -- aliases ---------------------------------------------------------------------

@pytest.mark.parametrize("seed,k", [(0, 40), (1, 200)])
def test_prune_overlapping_blobs_auto_matches_reference(seed, k):
    assert peaks.prune_overlapping_blobs_auto is peaks.prune_overlapping_blobs
    rng = np.random.default_rng(seed)
    coords = (rng.random((k, 3)) * 30).astype(np.float32)
    sigmas = rng.uniform(1.0, 3.0, k).astype(np.float32)
    valid = rng.random(k) < 0.9
    got = peaks.prune_overlapping_blobs_auto(
        torch.from_numpy(coords), torch.from_numpy(sigmas),
        torch.from_numpy(valid), 0.5)
    want = ref_peaks.prune_overlapping_blobs_auto(
        jnp.asarray(coords), jnp.asarray(sigmas), jnp.asarray(valid), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("thresh", [(None, None), (0.3, 0.5)])
def test_measure_overlap_alias_matches_reference(thresh):
    rng = np.random.default_rng(2)
    a = rng.random((12, 14, 10)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, None).astype(np.float32)
    got = atlas_refiner.measure_overlap(a, b, *thresh, device="cpu")
    want = ref_refiner.measure_overlap(a, b, *thresh)
    assert got == want


@pytest.mark.parametrize("scale,res", [
    (1.0, (2.0, 1.0, 1.0)), (0.5, (5.0, 1.5, 1.5)),
    ((1.0, 0.5, 0.5), (1.0, 1.0, 2.0))])
def test_isotropic_aliases_match_reference(scale, res):
    np.testing.assert_array_equal(
        cv_nd.calc_isotropic_factor(scale, res),
        ref_cv_nd.calc_isotropic_factor(scale, res))
    vol = np.random.default_rng(3).random((6, 10, 8)).astype(np.float32)
    got = cv_nd.make_isotropic(torch.from_numpy(vol), scale, res)
    want = ref_cv_nd.make_isotropic(jnp.asarray(vol), scale, res)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# -- cache_dir -----------------------------------------------------------------

SHAPE = (20, 28, 28)
GT_KWARGS = dict(ffd_spacing=12.0, ffd_ctrl_sigma=2.0)


def _same_pair(got, want):
    for key in ("moving", "labels", "fixed", "labels_fixed_gt"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("grid", "spacing", "disp_stats"):
        np.testing.assert_equal(got["gt"][key], want["gt"][key])
    for key in ("W", "t"):
        np.testing.assert_array_equal(got["gt"]["affine"][key],
                                      want["gt"]["affine"][key])


def test_build_pair_cache_reads_back_what_was_built(tmp_path):
    built = gauntlet.build_pair(SHAPE, 1, 0.6, str(tmp_path), device="cpu",
                                **GT_KWARGS)
    files = os.listdir(tmp_path)
    assert files == ["gauntlet_20_28_28_s1_rc0.6_ffd_ctrl_sigma=2.0_"
                     "ffd_spacing=12.0_cpu.npz"]
    cached = gauntlet.build_pair(SHAPE, 1, 0.6, str(tmp_path), device="cpu",
                                 **GT_KWARGS)
    _same_pair(cached, built)
    _same_pair(gauntlet.build_pair(SHAPE, 1, device="cpu", **GT_KWARGS),
               built)
    # another argument is another file
    gauntlet.build_pair(SHAPE, 2, 0.6, str(tmp_path), device="cpu",
                        **GT_KWARGS)
    assert len(os.listdir(tmp_path)) == 2


def test_build_pair_cache_matches_reference(tmp_path):
    """The reference's cache and the port's, each read back: the same
    arrays as the reference's pair within the parity limits of
    ``test_torch_register.py`` (``fixed`` within 1e-5, the rest exact)."""
    want = ref_gauntlet.build_pair(SHAPE, 0, 0.6, str(tmp_path / "ref"),
                                   **GT_KWARGS)
    want = ref_gauntlet.build_pair(SHAPE, 0, 0.6, str(tmp_path / "ref"),
                                   **GT_KWARGS)
    got = gauntlet.build_pair(SHAPE, 0, 0.6, str(tmp_path / "port"),
                              device="cpu", **GT_KWARGS)
    got = gauntlet.build_pair(SHAPE, 0, 0.6, str(tmp_path / "port"),
                              device="cpu", **GT_KWARGS)
    for key in ("moving", "labels", "labels_fixed_gt"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["fixed"], want["fixed"], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got["gt"]["grid"], want["gt"]["grid"])
    assert got["gt"]["spacing"] == want["gt"]["spacing"]
    with np.load(os.path.join(tmp_path / "port", os.listdir(
            tmp_path / "port")[0])) as p, np.load(os.path.join(
                tmp_path / "ref", os.listdir(tmp_path / "ref")[0])) as r:
        assert sorted(p.files) == sorted(r.files)
        for key in r.files:
            assert p[key].dtype == r[key].dtype, key


def test_truncated_pair_and_suite_take_cache_dir(tmp_path):
    got = gauntlet.build_truncated_pair(SHAPE, 0, 0.7, str(tmp_path),
                                        device="cpu", **GT_KWARGS)
    want = ref_gauntlet.build_truncated_pair(SHAPE, 0, 0.7, str(tmp_path),
                                             **GT_KWARGS)
    assert got["gated_labels"] == want["gated_labels"]
    np.testing.assert_array_equal(got["fixed_mask"], want["fixed_mask"])
    np.testing.assert_array_equal(got["labels_fixed_gt"],
                                  want["labels_fixed_gt"])
    assert len(os.listdir(tmp_path)) == 2  # one file each package
    suite = gauntlet.run_gauntlet_suite(
        SHAPE, (0,), None, str(tmp_path), 0.01, device="cpu", **GT_KWARGS)
    assert list(suite["pairs"]) == ["seed0"]
    assert len(os.listdir(tmp_path)) == 2  # read from the cache
