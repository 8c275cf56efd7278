"""The host runtime of ``magellanmapper_torch`` against the JAX package's,
on the CPU: ``settings.config``'s vocabularies, ``settings.logs``,
``utils.timing``, ``io.packaging``, ``settings.prefs_prof``,
``profiles.SettingsDict``/``RegParamMap``,
``grid_search_prof.make_hyperparm_arr``, ``io.load_env`` (its probe of
``torch.cuda``), ``brain_globe`` (a cache built in ``tmp_path``), every
helper of ``utils.libmag``, ``cv.chunking``'s pool and merge helpers,
``np_io.update_image5d_np_ver(img=)``, and the command line's flags.

Tolerance: none. Every copy computes what the reference computes on the
same inputs, exactly; the one designed difference is ``check_accelerator``
probing ``torch.cuda`` instead of JAX's devices, with the same keys.
"""

import dataclasses
import enum
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from magellanmapper_tpu import brain_globe as ref_brain_globe
from magellanmapper_tpu.cv import chunking as ref_chunking
from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.io import load_env as ref_load_env
from magellanmapper_tpu.io import np_io as ref_np_io
from magellanmapper_tpu.io import packaging as ref_packaging
from magellanmapper_tpu.settings import config as ref_config
from magellanmapper_tpu.settings import grid_search_prof as ref_gs_prof
from magellanmapper_tpu.settings import logs as ref_logs
from magellanmapper_tpu.settings import prefs_prof as ref_prefs_prof
from magellanmapper_tpu.settings import profiles as ref_profiles
from magellanmapper_tpu.utils import libmag as ref_libmag
from magellanmapper_tpu.utils import timing as ref_timing
from magellanmapper_torch import brain_globe, testing
from magellanmapper_torch.cv import chunking
from magellanmapper_torch.io import cli, load_env, np_io, packaging, tiff
from magellanmapper_torch.settings import (
    config, grid_search_prof, logs, prefs_prof, profiles)
from magellanmapper_torch.utils import libmag, timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == want
        assert type(got) is type(want)


# -- settings.config ----------------------------------------------------------

_ENUMS = [name for name, obj in vars(ref_config).items()
          if isinstance(obj, type) and issubclass(obj, enum.Enum)
          and obj is not enum.Enum and obj.__module__ == ref_config.__name__]


@pytest.mark.parametrize("name", _ENUMS)
def test_config_enums_match_reference(name):
    got, want = getattr(config, name), getattr(ref_config, name)
    assert [(m.name, m.value) for m in got] == [
        (m.name, m.value) for m in want]


def test_config_constants_and_classes_match_reference():
    for name in ("SUB_SEG_MULT", "REGION_ALL", "PATH_SMOOTHING_METRICS",
                 "PATH_SMOOTHING_RAW_METRICS", "PATH_ATLAS_IMPORT_METRICS",
                 "PATH_COMMON_LABELS", "GROUPS_NUMERIC"):
        assert getattr(config, name) == getattr(ref_config, name), name
    for cls in ("Config", "ClassifierData"):
        got = [(f.name, f.default) for f in dataclasses.fields(
            getattr(config, cls))]
        want = [(f.name, f.default) for f in dataclasses.fields(
            getattr(ref_config, cls))]
        assert got == want, cls
    for args in (("foo",), ("foo-bar", "foo"), ("x", "y", "plots")):
        assert config.format_import_err(*args) == \
            ref_config.format_import_err(*args)
    cfg = config.Config()
    assert dict(cfg.get_roi_profile(3)) == dict(
        ref_config.Config().get_roi_profile(3))
    assert cfg.get_roi_profile(0) is cfg.roi_profiles[0]


def test_cli_reads_register_types_from_config():
    assert cli.RegisterTypes is config.RegisterTypes
    assert len(cli.REGISTER_TASKS) == 39
    assert [t.name for t in cli.REGISTER_TASKS] == [
        t.name for t in ref_config.RegisterTypes]


# -- logs, timing, packaging, prefs -------------------------------------------

def test_log_writer_and_logger_setup_match_reference(tmp_path):
    lines = {}
    for name, mod in (("port", logs), ("ref", ref_logs)):
        got = []
        writer = mod.LogWriter(got.append)
        writer.write("one\ntwo")
        writer.write(" more\n\n  \nthree")
        writer.flush()
        lines[name] = got
        logger = mod.setup_logger(f"test_{name}", logging.DEBUG)
        assert logger.level == logging.DEBUG
        n = len(logger.handlers)
        mod.setup_logger(f"test_{name}")
        assert len(logger.handlers) == n
        path = tmp_path / name / "out.log"
        for _ in range(2):
            handler = mod.add_file_handler(logger, str(path))
            logger.info("hello")
            handler.close()
            logger.removeHandler(handler)
        assert sorted(os.listdir(tmp_path / name)) == ["out.log",
                                                       "out.log.1"]
        mod.update_log_level(logger, "warning")
        assert logger.level == logging.WARNING
    assert lines["port"] == lines["ref"] == ["one", "two more", "three"]


def test_redirect_std_streams_matches_reference():
    for mod in (logs, ref_logs):
        got = []
        logger = logging.getLogger(f"redirect_{mod.__name__}")
        out, err = sys.stdout, sys.stderr
        try:
            mod.redirect_std_streams(logger)
            assert isinstance(sys.stdout, mod.LogWriter)
            assert isinstance(sys.stderr, mod.LogWriter)
            sys.stdout.fn_logger = got.append
            print("routed")
        finally:
            sys.stdout, sys.stderr = out, err
        assert got == ["routed"]


def test_timing_matches_reference(tmp_path):
    for mod in (timing, ref_timing):
        watch = mod.StopWatch()
        assert watch.stop() is None
        watch.start("a")
        watch.start("b")
        assert watch.stop() >= 0 and set(watch.times) == {"a", "b"}
    assert timing.mvox_per_sec(2e6, 4.0) == ref_timing.mvox_per_sec(2e6, 4.0)
    assert timing.mvox_per_sec(1, 0) == ref_timing.mvox_per_sec(1, 0)
    assert timing.STACK_TIMES_CSV == ref_timing.STACK_TIMES_CSV
    for name, mod in (("port", timing), ("ref", ref_timing)):
        path = str(tmp_path / f"{name}.csv")
        mod.save_stack_times({"Detection": 1.5, "Pruning": 0.25}, path)
        mod.save_stack_times({"Detection": 2.0, "Pruning": 0.5}, path)
    with open(tmp_path / "port.csv") as a, open(tmp_path / "ref.csv") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", ["numpy", "no_such_package_xyz"])
@pytest.mark.parametrize("prefix", [None, "bundle"])
def test_packaging_matches_reference(name, prefix):
    assert packaging.get_pkg_egg(name, prefix) == \
        ref_packaging.get_pkg_egg(name, prefix)
    assert packaging.get_pkg_path(name, prefix) == \
        ref_packaging.get_pkg_path(name, prefix)


def test_prefs_profile_round_trips_with_reference(tmp_path):
    got, want = prefs_prof.PrefsProfile(), ref_prefs_prof.PrefsProfile()
    assert dict(got) == dict(want)
    assert prefs_prof.PREFS_FILE == ref_prefs_prof.PREFS_FILE
    got["theme"], got["max_scroll"] = "dark", 7
    path = got.save_prefs(str(tmp_path / "prefs.yaml"))
    loaded = ref_prefs_prof.PrefsProfile().load_prefs(path)
    assert loaded["theme"] == "dark" and loaded["max_scroll"] == 7
    back = prefs_prof.PrefsProfile().load_prefs(
        ref_prefs_prof.PrefsProfile(roi_plane="xz").save_prefs(
            str(tmp_path / "ref.yaml")))
    assert back["roi_plane"] == "xz"
    assert dict(prefs_prof.PrefsProfile().load_prefs(
        str(tmp_path / "none.yaml"))) == dict(want)


# -- profiles and grid search -------------------------------------------------

def test_settings_dict_and_reg_param_map_match_reference(tmp_path):
    for mod in (profiles, ref_profiles):
        assert issubclass(mod.SettingsDict, mod.Profile)
    got = profiles.SettingsDict(a=1, b={"c": 2})
    want = ref_profiles.SettingsDict(a=1, b={"c": 2})
    got.update_settings({"b": {"d": 3}})
    want.update_settings({"b": {"d": 3}})
    assert dict(got) == dict(want)
    paths = [str(tmp_path / f"{n}.yml") for n in ("port", "ref")]
    got.save_settings(paths[0])
    want.save_settings(paths[1])
    assert open(paths[0]).read() == open(paths[1]).read()
    assert [(f.name, f.default) for f in dataclasses.fields(
        profiles.RegParamMap)] == [(f.name, f.default) for f in
                                   dataclasses.fields(
                                       ref_profiles.RegParamMap)]
    mods = {"map_name": "bspline", "max_iter": 12}
    assert dataclasses.asdict(profiles.RegParamMap().update(mods)) == \
        dataclasses.asdict(ref_profiles.RegParamMap().update(mods))


@pytest.mark.parametrize("args", [
    (0.1, 0.9, 5, 3, 1), (1, 4, 4, 2, 0, 0.5), (2.0, 2.0, 1, 1, 0)])
def test_make_hyperparm_arr_matches_reference(args):
    _same(grid_search_prof.make_hyperparm_arr(*args),
          ref_gs_prof.make_hyperparm_arr(*args))


# -- load_env -----------------------------------------------------------------

def test_check_accelerator_probes_torch_with_the_reference_keys():
    got = load_env.check_accelerator()
    want = ref_load_env.check_accelerator()
    assert set(got) == set(want) == {"platform", "device_count", "devices"}
    assert len(got["devices"]) == got["device_count"]
    if torch.cuda.is_available():
        assert got["platform"] == "gpu"
        assert got["device_count"] == torch.cuda.device_count()
    else:
        # JAX on the CPU reports "cpu" (with as many devices as the tests'
        # XLA flags ask for); the probe reports the one CPU
        assert got["platform"] == want["platform"] == "cpu"
        assert got["device_count"] == 1


def test_check_accelerator_reports_a_broken_runtime(monkeypatch):
    def broken():
        raise RuntimeError("CUDA runtime gone")

    monkeypatch.setattr(torch.cuda, "is_available", broken)
    got = load_env.check_accelerator()
    assert got == {"platform": "unavailable", "device_count": 0,
                   "devices": [], "error": "CUDA runtime gone"}


def test_environment_checks_match_reference(monkeypatch):
    for env in ("mag-dev", "other", None):
        if env is None:
            monkeypatch.delenv("CONDA_DEFAULT_ENV", raising=False)
        else:
            monkeypatch.setenv("CONDA_DEFAULT_ENV", env)
        assert load_env.is_conda_activated() == \
            ref_load_env.is_conda_activated()
    assert load_env.is_venv_activated() == ref_load_env.is_venv_activated()
    assert load_env.ENV_NAME == ref_load_env.ENV_NAME


def test_launch_runs_the_port_cli(tmp_path, monkeypatch):
    """``build_launch_args`` names the port's CLI where the reference's
    names its own; ``launch_magmap`` runs it (here ``--version``) and
    returns its exit code."""
    got = load_env.build_launch_args(["--version"])
    want = ref_load_env.build_launch_args(["--version"])
    assert got == [a.replace("magellanmapper_tpu", "magellanmapper_torch")
                   for a in want]
    monkeypatch.chdir(ROOT)
    assert load_env.launch_magmap(["--version"]) == 0
    assert load_env.launch_subprocess(
        [sys.executable, "-c", "raise SystemExit(3)"]) == 3
    assert load_env.launch_subprocess(["exit 4"], sys_shell=True) == 4
    records = []
    monkeypatch.setattr(load_env._logger, "critical",
                        lambda *a, **k: records.append(k["exc_info"][0]))
    load_env.log_uncaught_exception(ValueError, ValueError("x"), None)
    assert records == [ValueError]


# -- brain_globe --------------------------------------------------------------

def _bg_cache(root, name="allen_mouse_25um_v1.2", meta=True):
    d = root / name
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    tiff.write_tiff(str(d / "reference.tiff"),
                    rng.integers(0, 255, (4, 8, 8)).astype(np.uint16))
    tiff.write_tiff(str(d / "annotation.tiff"),
                    rng.integers(0, 9, (4, 8, 8)).astype(np.uint16))
    if meta:
        (d / "metadata.json").write_text('{"resolution": [25, 25, 25]}')


def test_brain_globe_cache_matches_reference(tmp_path):
    _bg_cache(tmp_path)
    _bg_cache(tmp_path, "kim_mouse_10um_v1.0", meta=False)
    (tmp_path / "stray.txt").write_text("x")
    got = brain_globe.BrainGlobeMM(str(tmp_path))
    want = ref_brain_globe.BrainGlobeMM(str(tmp_path))
    assert got.get_avail_atlases() == want.get_avail_atlases() == [
        "allen_mouse_25um_v1.2", "kim_mouse_10um_v1.0"]
    for name in ("allen_mouse", "kim_mouse"):
        (img, ann, meta), (rimg, rann, rmeta) = (
            got.get_atlas(name), want.get_atlas(name))
        _same(img.img, rimg.img)
        _same(ann, rann)
        assert meta == rmeta and img.meta == rimg.meta
        assert img.img_io == rimg.img_io == "brain_globe"
    assert brain_globe.BrainGlobeMM(str(tmp_path / "none")) \
        .get_avail_atlases() == []


def test_brain_globe_missing_atlas_and_download_match_reference(tmp_path):
    """Not cached: ``FileNotFoundError``; with ``download`` and no
    ``brainglobe-atlasapi``, the reference's ``ImportError``."""
    for download in (False, True):
        testing.same_outcome(
            lambda: ref_brain_globe.BrainGlobeMM(str(tmp_path)).get_atlas(
                "absent", download),
            lambda: brain_globe.BrainGlobeMM(str(tmp_path)).get_atlas(
                "absent", download))


def test_brain_globe_controller_and_tasks(tmp_path):
    _bg_cache(tmp_path)
    msgs, tables, opened = [], [], []
    ctrl = brain_globe.BrainGlobeCtrl(tables.append, msgs.append,
                                      fn_opened_atlas=opened.append)
    ctrl.bg_mm = brain_globe.BrainGlobeMM(str(tmp_path))
    assert ctrl.update_atlas_table() == ["allen_mouse_25um_v1.2"]
    img, _, _ = ctrl.open_atlas("allen_mouse")
    assert img.img.shape == (1, 4, 8, 8) and len(opened) == 1
    done = []
    task = brain_globe.SetupAtlasesThread(ctrl.bg_mm, done.append,
                                          msgs.append)
    assert task.start() == tables[0] == done[0]
    atlas = brain_globe.AccessAtlasThread(ctrl.bg_mm, "allen_mouse").start()
    assert atlas[0].img.shape == img.img.shape
    assert ctrl.remove_atlas("allen_mouse") is True
    assert ctrl.remove_atlas("allen_mouse") is False
    assert msgs[-2:] == ["removed atlas allen_mouse",
                         "could not remove allen_mouse"]


# -- libmag -------------------------------------------------------------------

class _Color(enum.Enum):
    RED = 1
    DARK_BLUE = 2


#: calls of every libmag helper the port did not have before, with the
#: reference's results to equal (the side-effect helpers: below)
_LIBMAG_CALLS = [
    ("get_filename_without_ext", ("/a/b/c.ome.tiff",)),
    ("normalize", (np.array([1.0, 3.0, 5.0]), 0, 10)),
    ("normalize", (np.array([0.0, 2.0, 4.0, 0.0]), -1, 1, 0.0)),
    ("normalize", (np.array([2.0, 2.0]), 0, 1)),
    ("dtype_within_range", (0, 300)),
    ("dtype_within_range", (-5, 70000)),
    ("dtype_within_range", (0, 3.0e38, False)),
    ("dtype_within_range", (0, 200, True, True)),
    ("to_seq", (3, 2)), ("to_seq", ([4], 3)), ("to_seq", (None,)),
    ("pad_seq", ([1, 2], 4, 0)), ("pad_seq", ((1, 2, 3), 2)),
    ("is_binary", (np.array([0, 1, 1]),)),
    ("is_binary", (np.array([0, 1, 2]),)),
    ("format_bytes", (512,)), ("format_bytes", (3.5 * 1024 ** 3,)),
    ("npstr_to_array", ("[1.5 -2. 3e-4]",)), ("npstr_to_array", ("x",)),
    ("make_abs_path", ("rel/p", "/base")), ("make_abs_path", ("/abs",)),
    ("swap_elements", ((1, 2, 3), 0, 2)),
    ("swap_elements", ([1, 2, 3, 4], 0, 1, 1)),
    ("transpose_1d", ((1, 2, 3), "xz")), ("transpose_1d", ([1, 2, 3], "yz")),
    ("transpose_1d", ((1, 2, 3), "xy")),
    ("transpose_1d_rev", ((1, 2, 3), "xz")),
    ("transpose_1d_rev", ((2, 3, 1), "yz")),
    ("roll_elements", ((1, 2, 3), 1)),
    ("roll_elements", (np.arange(6).reshape(2, 3), 1, 1)),
    ("replace_seq", ([1, 2, 3], [9, 8])),
    ("replace_seq", ((1, 2), [7, 6, 5])),
    ("combine_arrs", ([np.ones(2), None, np.zeros(0), np.arange(3.)],)),
    ("combine_arrs", ([None],)), ("combine_arrs", (None,)),
    ("make_out_path", ("dir/img.npy", "pre_", "_s")),
    ("make_out_path", ("dir/img.npy", "pre_", None, True)),
    ("make_out_path", (None, None, "_x")),
    ("get_int", ("3",)), ("get_int", ("2.5",)), ("get_int", ("abc",)),
    ("is_int", ("4.0",)), ("is_int", ("4.5",)), ("is_int", (None,)),
    ("is_number", ("1e3",)), ("is_number", ("x",)),
    ("series_as_str", (12,)),
    ("splice_before", ("file_image5d.npy", "_image5d", "_s1")),
    ("splice_before", ("abc", "z", "_s", "x")),
    ("str_to_disp", (" a_b_c ",)),
    ("crop_mid_str", (["abcdefghijklmn", "abcdefghijxyzn", "short"], 8)),
    ("make_acronym", ("Nucleus of the solitary tract",)),
    ("make_acronym", ("Cortex", " ", None, True)), ("make_acronym", ("",)),
    ("is_nan", (float("nan"),)), ("is_nan", ("text",)),
    ("format_num", (3.0,)), ("format_num", (0.000123456, 2)),
    ("format_num", (1234.5678, 2, False)), ("format_num", ("n/a",)),
    ("truncate_decimal_digit", (3.0000000000000004,)),
    ("truncate_decimal_digit", (0.1 + 0.2,)),
    ("truncate_decimal_digit", (1e-20,)),
    ("convert_bin_magnitude", (3 * 1024 ** 2, 2)),
    ("convert_indices_to_int", ({"a": "3", "b": [1.0, "2"], "c": None},)),
    ("compact_float", ("2.0",)), ("compact_float", (2.345, 2)),
    ("compact_float", ("x",)),
    ("coords_for_indexing", (np.array([[1, 2], [3, 4], [5, 6]]),)),
    ("get_dtype_info", (np.zeros(2, np.uint16),)),
    ("get_dtype_info", (np.dtype(np.float32),)),
    ("get_if_within", ([1, 2, 3], 1)), ("get_if_within", ([1], 4, "d")),
    ("get_if_within", (7, 2)),
    ("enum_names_aslist", (_Color,)),
    ("enum_dict_aslist", ({_Color.RED: 1, "k": 2},)),
    ("get_enum", ("dark_blue", _Color)), ("get_enum", (_Color.RED, _Color)),
    ("get_enum", ("green", _Color)),
    ("get_dict_keys_from_val", ({"a": 1, "b": 2, "c": 1}, 1)),
    ("add_missing_keys", ({"a": 1, "b": 2}, {"b": 3})),
    ("scale_slice", (slice(2, 10, 3), 0.5)),
    ("scale_slice", (slice(None, None), 2.0, 40)),
    ("flatten", ([1, [2, (3, np.array([4, 5]))], 6],)),
]


@pytest.mark.parametrize("name,args", _LIBMAG_CALLS)
def test_libmag_helpers_match_reference(name, args):
    got = getattr(libmag, name)(*args)
    want = getattr(ref_libmag, name)(*args)
    if name == "flatten":
        got, want = list(got), list(want)
    if name == "get_dtype_info":
        assert type(got) is type(want) and str(got) == str(want)
        return
    if name in ("get_enum", "enum_dict_aslist") or "enum" in name:
        assert got == want
        return
    _same(got, want)


def test_libmag_has_every_reference_helper():
    def helpers(mod):
        return {name for name, obj in vars(mod).items()
                if callable(obj) and getattr(obj, "__module__", "")
                == mod.__name__}
    assert helpers(ref_libmag) <= helpers(libmag)
    assert len(helpers(ref_libmag)) - 6 >= 52


def test_libmag_file_helpers_match_reference(tmp_path):
    for name, mod in (("port", libmag), ("ref", ref_libmag)):
        d = tmp_path / name
        d.mkdir()
        path = str(d / "a.txt")
        with open(path, "w") as f:
            f.write("1\n2\n3\n")
        assert mod.last_lines(path, 2) == ["2\n", "3\n"]
        assert mod.last_lines(str(d / "none"), 2) is None
        assert os.path.basename(mod.copy_backup(path)) == "a_bkup.txt"
        assert mod.copy_backup(str(d / "none")) is None
        assert mod.create_symlink(path, str(d / "link.txt")) is True
        assert mod.remove_file(str(d / "link.txt")) is True
        assert mod.remove_file(str(d / "none")) is False
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref"))


def test_libmag_output_helpers_match_reference(capsys):
    for mod in (libmag, ref_libmag):
        seen = []
        mod.printcb("msg", seen.append)
        mod.verbose = True
        mod.printv("loud")
        mod.verbose = False
        mod.printv("quiet")
        mod.log_once(seen.append, f"once {mod.__name__}")
        mod.log_once(seen.append, f"once {mod.__name__}")
        mod.print_compact(np.array([1.23456, 2.0]), "arr")
        mod.show_full_arrays()
        mod.show_full_arrays(False)
        with pytest.warns(UserWarning, match="careful"):
            mod.warn("careful")
        assert seen == ["msg", f"once {mod.__name__}"]
    out = capsys.readouterr().out.split("msg\n")
    assert out[1] == out[2]


def test_libmag_version_and_commit():
    import magellanmapper_torch
    assert libmag.get_version() == magellanmapper_torch.__version__
    commit = libmag.get_git_commit(ROOT)
    assert commit == ref_libmag.get_git_commit(ROOT)
    assert commit is None or len(commit) == 40
    assert libmag.get_git_commit("/") == ref_libmag.get_git_commit("/")


# -- chunking and np_io -------------------------------------------------------

@pytest.mark.parametrize("shape,max_pixels,overlap", [
    ((10, 33, 20), (4, 16, 8), (1, 3, 2)), ((5, 8, 8), (5, 8, 8), (0, 0, 0)),
    ((12, 20, 17), (5, 7, 6), (2, 0, 1))])
@pytest.mark.parametrize("channels", [0, 2])
def test_split_stack_merges_match_reference(shape, max_pixels, overlap,
                                            channels):
    full = (np.arange(int(np.prod(shape + ((channels,) if channels else ())))
                      ).reshape(shape + ((channels,) if channels else ()))
            .astype(np.float32))
    slices, _ = chunking.stack_splitter(shape, max_pixels, overlap)
    sub_rois = np.empty(slices.shape, dtype=object)
    for coord in np.ndindex(*slices.shape):
        sub_rois[coord] = full[slices[coord]]
    total = chunking.get_split_stack_total_shape(sub_rois, overlap)
    _same(total, ref_chunking.get_split_stack_total_shape(sub_rois, overlap))
    merged = chunking.merge_split_stack(sub_rois, max_pixels, overlap)
    _same(merged, ref_chunking.merge_split_stack(sub_rois, max_pixels,
                                                 overlap))
    outs = [np.zeros(full.shape, np.float32) for _ in range(2)]
    chunking.merge_split_stack2(sub_rois, overlap, 0, outs[0])
    ref_chunking.merge_split_stack2(sub_rois, overlap, 0, outs[1])
    _same(outs[0], outs[1])
    if tuple(total[:3]) == shape:
        # no block but the last was cut by the stack's edge: the merge
        # gives the stack back (both trim a full overlap off the others)
        np.testing.assert_array_equal(merged, full)
        np.testing.assert_array_equal(outs[0], full)


def _square(x):
    return x * x


def test_mp_helpers_match_reference():
    import multiprocessing
    # the method in use (setting another would change it for the process)
    method = multiprocessing.get_start_method()
    assert chunking.set_mp_start_method(method) == \
        ref_chunking.set_mp_start_method(method) == method
    assert chunking.is_fork() == ref_chunking.is_fork()
    with chunking.get_mp_pool(2) as pool:
        assert pool.map(_square, range(5)) == [0, 1, 4, 9, 16]
    for mod in (chunking, ref_chunking):
        token = object()
        mod.init_shared_container(token)
        assert mod._SHARED_CONTAINER is token


@pytest.mark.parametrize("ver,meta", [
    (9, {"resolutions": [[1.0, 1.0, 1.0]]}),
    (12, {"near_min": [1.0], "near_max": [9.0], "zoom": 2.0}),
    (13, {"near_min": None}), (15, {"zoom": 3.0})])
@pytest.mark.parametrize("with_img", [False, True])
def test_update_image5d_np_ver_matches_reference(ver, meta, with_img):
    img = (np.random.default_rng(ver).random((1, 6, 20, 20)) * 500).astype(
        np.uint16) if with_img else None
    got = np_io.update_image5d_np_ver(dict(meta), ver, img=img)
    want = ref_np_io.update_image5d_np_ver(dict(meta), ver, img=img)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key], object),
                                      np.asarray(want[key], object), key)


# -- the command line's flags -------------------------------------------------

_FLAGS = [
    ["--img", "v.npy", "--proc", "detect", "--meta", "a.yml", "b.yml",
     "--prefix", "p", "--prefix_out", "q", "--suffix", "_s"],
    ["--img", "v.npy", "--proc", "detect", "--offset", "1,2,3", "--size",
     "4,5,6", "--db", "m.db", "--cpus", "3", "--load", "blobs",
     "blob_matches=1"],
    ["--img", "v.npy", "--proc", "export_planes", "--theme", "dark",
     "--show", "--alphas", "0.5", "1", "--vmin", "10", "--vmax", "200.5",
     "300", "--rgb"],
    ["--img", "v.npy", "--proc", "detect", "-v", "--seed", "7"],
    ["--img", "v.npy", "--proc", "detect", "--verbose", "lvl", "--groups",
     "WT", "het"],
]


@pytest.mark.parametrize("argv", _FLAGS)
def test_remaining_flags_parse_as_the_reference(argv):
    root = logging.getLogger()
    level = root.level
    try:
        np.random.seed(0)
        got = cli.process_cli_args(argv)
        got_draw = np.random.random()
        np.random.seed(0)
        want = ref_cli.process_cli_args(argv)
        want_draw = np.random.random()
    finally:
        root.setLevel(level)
    for name in ("filenames", "prefix", "prefix_out", "suffix", "size",
                 "offset", "db_path", "cpus", "meta_paths", "load_data",
                 "theme", "show", "alphas", "vmin", "vmax", "rgb",
                 "verbose", "groups"):
        assert getattr(got, name) == getattr(want, name), name
    # --seed seeds numpy's global generator in both
    assert got_draw == want_draw


def test_verbose_sets_the_root_logger_to_debug():
    root = logging.getLogger()
    level = root.level
    try:
        root.setLevel(logging.INFO)
        cli.process_cli_args(["--img", "v.npy", "--proc", "detect", "-v"])
        assert root.level == logging.DEBUG
    finally:
        root.setLevel(level)


def test_version_prints_the_port_and_exits(capsys):
    import magellanmapper_torch
    with pytest.raises(SystemExit) as err:
        cli.process_cli_args(["--version"])
    assert err.value.code == 0
    assert capsys.readouterr().out.strip() == (
        f"magellanmapper_torch {magellanmapper_torch.__version__}")


@pytest.mark.parametrize("flag,item", [
    (["--mesh", "1,1"], "mesh"), (["--notify", "http://x"], None),
    (["--ec2_start", "a"], None), (["--ec2_list"], None),
    (["--ec2_terminate", "i-1"], None)])
def test_only_the_cloud_and_mesh_flags_are_rejected(flag, item):
    """No flag is rejected any more: ``--mesh`` (ROADMAP item 10, now
    ported) and the cloud flags are taken with the reference's values."""
    argv = ["--img", "v.npy", "--proc", "detect"] + flag
    got = cli.process_cli_args(argv)
    want = ref_cli.process_cli_args(argv)
    if item is not None:
        assert got.mesh == want.mesh == [1, 1]
        assert not cli.cloud_task(got)
        return
    for name in ("ec2_start", "ec2_list", "ec2_terminate", "notify_url"):
        assert getattr(got, name) == getattr(want, name), name
    assert cli.cloud_task(got)

