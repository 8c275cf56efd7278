"""The ``--register single`` task of ``magellanmapper_torch`` against the
reference: the port's copies of ``sitk_io`` and ``atlas_prof``, label
curation, the gauntlet fixture and its scoring, and the task through both
command lines on a seeded (20, 28, 28) pair (every metric stride 1).

Tolerances: medical images written from equal arrays are byte for byte
the reference's files; profiles, curation (also of a (64, 96, 80) pair's
ground truth at the default hole size), landmarks, the gauntlet's
anatomy, labels and scoring exactly; the gauntlet's warped image within
1e-5. Through the command lines, where each engine runs its own
optimisation: the same file names and ``.mhd`` headers, the sample image
byte for byte, the moved atlas within 2e-3, the labels equal in all but
0.1% of voxels (a voxel whose mapped position sits on a rounding
boundary may flip with float32 noise in the B-spline lattice; the
reference's own transform gives equal labels,
``test_torch_reg_engine.py::test_reference_transform_through_the_port``),
and the stats CSV's DSC columns within 2e-3.
"""

import filecmp
import os

import numpy as np
import pandas as pd
import pytest
import torch

from magellanmapper_tpu.atlas import gauntlet as ref_gauntlet
from magellanmapper_tpu.atlas import register as ref_register
from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.io import sitk_io as ref_sitk
from magellanmapper_tpu.settings import atlas_prof as ref_prof
from magellanmapper_torch.atlas import gauntlet, register
from magellanmapper_torch.io import cli, np_io, sitk_io
from magellanmapper_torch.settings import atlas_prof

torch.set_num_threads(1)

SHAPE = (20, 28, 28)
DSC_ATOL = 2e-3
#: a YAML atlas profile with a short schedule, read by both CLIs
TINY_PROFILE = """reg_translation:
  max_iter: 48
reg_affine:
  max_iter: 32
reg_bspline:
  max_iter: 16
  grid_space_voxels: 8
"""


@pytest.fixture(scope="module")
def pair():
    return ref_gauntlet.build_pair(SHAPE, seed=0, ffd_spacing=16.0,
                                   ffd_ctrl_sigma=3.0)


# -- the port's copies of sitk_io and atlas_prof ------------------------------

@pytest.mark.parametrize("ext", [".mhd", ".mha", ".nrrd", ".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint16])
def test_medical_images_are_the_reference_bytes(tmp_path, ext, dtype):
    arr = np.random.default_rng(1).integers(0, 500, (4, 6, 5)).astype(dtype)
    med = (sitk_io.MedImage(arr, (2.0, 1.0, 0.5), (1.0, 2.0, 3.0)),
           ref_sitk.MedImage(arr, (2.0, 1.0, 0.5), (1.0, 2.0, 3.0)))
    paths = [str(tmp_path / f"{who}{ext}") for who in ("port", "ref")]
    sitk_io.write_med_img(paths[0], med[0])
    ref_sitk.write_med_img(paths[1], med[1])
    if ext == ".mhd":
        for a, b in ((paths[0], paths[1]),
                     (paths[0][:-4] + ".raw", paths[1][:-4] + ".raw")):
            got, want = open(a, "rb").read(), open(b, "rb").read()
            assert got.replace(b"port.raw", b"ref.raw") == want
    elif not ext.endswith(".gz"):
        assert filecmp.cmp(paths[0], paths[1], shallow=False)
    for path in paths:
        got, want = sitk_io.read_med_img(path), ref_sitk.read_med_img(path)
        np.testing.assert_array_equal(got.img, want.img)
        assert (got.spacing, got.origin, got.meta) == (
            want.spacing, want.origin, want.meta)


def test_registered_image_paths_copy(tmp_path):
    base = str(tmp_path / "sample.npy")
    for name in ("exp.mhd", "annotation", "stats"):
        assert sitk_io.reg_out_path(base, name) == \
            ref_sitk.reg_out_path(base, name)
    assert sitk_io.reg_out_path("a/b.nii.gz", "x.mhd", True) == \
        ref_sitk.reg_out_path("a/b.nii.gz", "x.mhd", True)
    arr = np.arange(60, dtype=np.int32).reshape(3, 4, 5)
    imgs = {"annotation.mhd": arr, "atlasVolume": arr.astype(np.float32)}
    got = sitk_io.write_reg_images(
        {k: sitk_io.MedImage(v) for k, v in imgs.items()}, base)
    (tmp_path / "ref").mkdir()
    want = ref_sitk.write_reg_images(
        {k: ref_sitk.MedImage(v) for k, v in imgs.items()},
        str(tmp_path / "ref" / "sample.npy"))
    assert [os.path.basename(p) for p in got.values()] == [
        os.path.basename(p) for p in want.values()]
    for name, arr in imgs.items():
        np.testing.assert_array_equal(
            sitk_io.load_registered_img(base, name), arr)
        np.testing.assert_array_equal(
            sitk_io.load_registered_img(base, name),
            ref_sitk.load_registered_img(base, name))
    assert sitk_io.find_sitk_file(str(tmp_path / "sample_annotation")) == \
        ref_sitk.find_sitk_file(str(tmp_path / "sample_annotation"))
    with pytest.raises(FileNotFoundError):
        sitk_io.find_sitk_file(str(tmp_path / "missing"))


@pytest.mark.parametrize(
    "names", ["default"] + sorted(ref_prof.AtlasProfile().profiles)
    + ["ncc,nobspline", "smalliter,finer,points"])
def test_atlas_profile_copy(names):
    got, want = atlas_prof.AtlasProfile(), ref_prof.AtlasProfile()
    assert got.profiles == want.profiles
    got.add_profiles(names)
    want.add_profiles(names)
    assert dict(got) == dict(want)
    assert vars(atlas_prof.RegKeys).keys() == vars(ref_prof.RegKeys).keys()


def test_curation_and_landmarks_match_reference(tmp_path, pair):
    labels = pair["labels_fixed_gt"].copy()
    labels[pair["fixed"] > 0.6] = 0                # unlabeled foreground
    got = register.curate_img(pair["fixed"], labels, [pair["moving"]],
                              holes_area=20, device="cpu")
    want = ref_register.curate_img(pair["fixed"], labels, [pair["moving"]],
                                   holes_area=20)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    path = tmp_path / "fix_pts.txt"
    path.write_text("point\n3\n1 2 3\n4.5 5 6\n7 8 9.25\n")
    np.testing.assert_array_equal(register.load_elastix_points(str(path)),
                                  ref_register.load_elastix_points(str(path)))
    assert [n.value for n in register.RegNames] == [
        n.value for n in ref_register.RegNames]


def test_curation_of_the_truth_matches_reference():
    """Curation at its default hole size on a (64, 96, 80) gauntlet pair's
    ground-truth annotation: equal to the reference's, and it alone costs
    the regions that the specimen shows dim (the carve keeps voxels above
    Otsu's threshold and fills only background holes under 5,000 voxels),
    so a curated transfer's worst regions are the carve's, not the
    warp's."""
    big = ref_gauntlet.build_pair((64, 96, 80), seed=0)
    truth = big["labels_fixed_gt"]
    got = register.curate_img(big["fixed"], truth, device="cpu")
    np.testing.assert_array_equal(
        got, ref_register.curate_img(big["fixed"], truth))
    assert gauntlet.label_transfer_dsc(got, truth)["min"] < 0.8


# -- the gauntlet -------------------------------------------------------------

@pytest.mark.parametrize("shape,gt_kwargs", [
    ((24, 32, 28), dict(ffd_spacing=16.0, ffd_ctrl_sigma=3.0)),
    ((40, 48, 44), {})])
def test_gauntlet_pair_matches_reference(shape, gt_kwargs):
    want = ref_gauntlet.build_pair(shape, seed=0, **gt_kwargs)
    got = gauntlet.build_pair(shape, seed=0, device="cpu", **gt_kwargs)
    for key in ("moving", "labels", "labels_fixed_gt"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["fixed"], want["fixed"], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got["gt"]["grid"],
                                  np.asarray(want["gt"]["grid"]))
    for k in ("W", "t"):
        np.testing.assert_array_equal(got["gt"]["affine"][k],
                                      np.asarray(want["gt"]["affine"][k]))
    assert got["gt"]["spacing"] == want["gt"]["spacing"]
    for k, v in want["gt"]["disp_stats"].items():
        assert abs(got["gt"]["disp_stats"][k] - v) <= 1e-5
    trunc = gauntlet.build_truncated_pair(shape, seed=0, device="cpu",
                                          **gt_kwargs)
    ref_trunc = ref_gauntlet.build_truncated_pair(shape, seed=0,
                                                  **gt_kwargs)
    assert trunc["gated_labels"] == ref_trunc["gated_labels"]
    np.testing.assert_array_equal(trunc["fixed_mask"],
                                  ref_trunc["fixed_mask"])


def test_gauntlet_scoring_matches_reference(pair):
    rng = np.random.default_rng(2)
    pred = np.where(rng.random(SHAPE) < 0.05, 0, pair["labels_fixed_gt"])
    for only in (None, [1, 2, 3, 5]):
        got = gauntlet.label_transfer_dsc(pred, pair["labels_fixed_gt"],
                                          only_labels=only)
        want = ref_gauntlet.label_transfer_dsc(
            pred, pair["labels_fixed_gt"], only_labels=only)
        assert got == want
    for args in ((0.95, 0.9, 0.8, 0.85, 0.05, 0.5), (0.96, 0.93, 0.7, 0.86,
                                                     0.01, 0.6),
                 (0.97, 0.95, 0.9, 0.9, 0.01, 0.2)):
        assert gauntlet.gates_pass(*args) == ref_gauntlet.gates_pass(*args)
    for affine, gain in ((0.944, 0.042), (None, 0.1), (1.0, 0.0)):
        assert gauntlet.bspline_gap_closure(affine, gain) == \
            ref_gauntlet.bspline_gap_closure(affine, gain)


def test_run_gauntlet_scores_the_port():
    small = gauntlet.build_pair((24, 32, 28), seed=0, device="cpu",
                                ffd_spacing=16.0, ffd_ctrl_sigma=3.0)
    out = gauntlet.run_gauntlet(small, iters_scale=1 / 128, device="cpu")
    assert set(out) == {
        "wall_s", "dsc", "stage_dsc", "bspline_dsc_gain",
        "bspline_gap_closure", "label_dsc_median", "label_dsc_min",
        "label_dsc_p10", "warp_err_vox", "warp_err_p95_vox", "gt_disp_vox",
        "passes"}
    assert sorted(out["stage_dsc"]) == ["affine", "bspline", "translation"]
    assert out["passes"] == gauntlet.gates_pass(
        out["dsc"], out["label_dsc_median"], out["label_dsc_min"],
        out["label_dsc_p10"], out["bspline_dsc_gain"],
        out["bspline_gap_closure"])
    assert out["dsc"] > 0.9 and out["warp_err_vox"] < out["gt_disp_vox"]


# -- --register single through both command lines ----------------------------

@pytest.fixture(scope="module")
def both_clis(tmp_path_factory, pair):
    root = tmp_path_factory.mktemp("register")
    atlas = root / "atlas"
    atlas.mkdir()
    ref_sitk.write_med_img(str(atlas / "atlasVolume.mhd"),
                           ref_sitk.MedImage(pair["moving"]))
    ref_sitk.write_med_img(str(atlas / "annotation.mhd"),
                           ref_sitk.MedImage(pair["labels"]))
    prof = root / "atlas_tiny.yml"
    prof.write_text(TINY_PROFILE)
    out = {}
    for who in ("ref", "port"):
        (root / who).mkdir()
        img = str(root / who / "fixed.npy")
        np_io.write_npy(img, pair["fixed"], resolutions=[[2.0, 1.0, 1.0]])
        argv = ["--img", img, str(atlas), "--register", "single",
                "--atlas_profile", str(prof)]
        if who == "ref":
            res = ref_cli.process_tasks(ref_cli.process_cli_args(argv))
        else:
            res = cli.main(argv + ["--device", "cpu"])
        out[who] = (root / who, res)
    return out


def test_register_single_cli_writes_the_reference_files(both_clis):
    (port_dir, port), (ref_dir, ref) = both_clis["port"], both_clis["ref"]
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(port_dir)) == names
    for suffix in ("exp", "atlasVolume", "annotation", "stats"):
        assert f"fixed_{suffix}.{'csv' if suffix == 'stats' else 'mhd'}" \
            in names
    for name in names:
        if name.endswith(".mhd") or name == "fixed_exp.raw":
            assert filecmp.cmp(port_dir / name, ref_dir / name,
                               shallow=False), name
    read = {who: {n: sitk_io.load_registered_img(str(d / "fixed.npy"), n)
                  for n in ("atlasVolume.mhd", "annotation.mhd")}
            for who, d in (("port", port_dir), ("ref", ref_dir))}
    np.testing.assert_allclose(read["port"]["atlasVolume.mhd"],
                               read["ref"]["atlasVolume.mhd"], rtol=0,
                               atol=2e-3)
    labels = [read[w]["annotation.mhd"] for w in ("port", "ref")]
    assert labels[0].dtype == labels[1].dtype == np.int32
    assert np.mean(labels[0] != labels[1]) <= 1e-3
    np.testing.assert_array_equal(port["moved_labels"], labels[0])
    csv = [pd.read_csv(d / "fixed_stats.csv") for d in (port_dir, ref_dir)]
    assert list(csv[0].columns) == list(csv[1].columns)
    for col in ("DSC_atlas_sample", "DSC_sample_labels"):
        assert abs(csv[0][col][0] - csv[1][col][0]) <= DSC_ATOL
        assert abs(port["metrics"][col] - ref["metrics"][col]) <= DSC_ATOL
    assert sorted(port["paths"]) == sorted(ref["paths"])


def test_register_rev_swaps_the_roles(pair):
    prof = atlas_prof.AtlasProfile()
    prof.add_profiles("nobspline")
    prof["reg_translation"]["max_iter"] = 16
    prof["reg_affine"]["max_iter"] = 8
    rev = register.register_rev(
        pair["fixed"], {"atlas": pair["moving"], "labels": pair["labels"]},
        prof, write_imgs=False, device="cpu")
    fwd = register.register(
        pair["moving"], {"atlas": pair["fixed"],
                         "labels": np.zeros(SHAPE, np.int32)},
        prof, write_imgs=False, device="cpu")
    np.testing.assert_array_equal(rev["moved_atlas"], fwd["moved_atlas"])
    assert rev["metrics"]["DSC_atlas_sample"] == \
        fwd["metrics"]["DSC_atlas_sample"]


@pytest.mark.parametrize("argv", [
    ["--img", "s.npy", "atlas", "--register", "single"],
    ["--img", "s.npy", "atlas", "--register", "single", "--atlas_profile",
     "ncc,nobspline", "--reg_suffixes", "atlas=avg.mhd",
     "annotation=labels.mhd", "--prefix", "out/p"],
    ["--img", "s.npy", "atlas", "--register", "register_rev"],
])
def test_register_cli_parses_as_the_reference(argv):
    got = cli.process_cli_args(argv + ["--device", "cpu"])
    want = ref_cli.process_cli_args(argv)
    assert got.register_type.name == want.register_type.name
    assert got.filenames == want.filenames and got.prefix == want.prefix
    assert got.reg_suffixes == want.reg_suffixes
    assert dict(got.atlas_profile) == dict(want.atlas_profile)
    assert [t.name for t in cli.RegisterTypes] == [
        t.name for t in type(want.register_type)]


@pytest.mark.parametrize("argv", [
    ["--img", "s.npy", "--proc", "transform", "--transform",
     "rescale=0.25"],
    ["--img", "s.npy", "--proc", "transform", "--transform", "rescale=0.5",
     "--plane", "yz", "--prefix", "out/p"],
    ["--img", "s.npy", "--proc", "preprocess", "saturate", "denoise",
     "remap", "rotate90"],
    ["--img", "s.npy", "--register", "make_density_images"],
    ["--img", "s.npy", "t.npy", "--register", "make_density_images"],
    ["--img", "s.npy", "--register", "vol_stats"],
    ["--img", "s.npy", "--register", "vol_stats", "--labels",
     "path_ref=ref.json", "level=2", "--prefix", "out/p"],
    ["--register", "export_regions", "--labels", "path_ref=ref.json",
     "level=1", "--prefix", "ids.csv"],
])
def test_pipeline_cli_parses_as_the_reference(argv):
    got = cli.process_cli_args(argv + ["--device", "cpu"])
    want = ref_cli.process_cli_args(argv)
    assert got.proc == (want.proc.name.lower() if want.proc else None)
    assert (got.register_type.name if got.register_type else None) == (
        want.register_type.name if want.register_type else None)
    for name in ("filenames", "prefix", "proc_args", "transform", "plane",
                 "labels"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("task", ["zscores", "coefvar",
                                  "melt_cols", "no_such_task"])
def test_other_register_tasks_are_rejected_by_name(task):
    """A ``--register`` task the port does not run is rejected by name.
    The port runs all of the reference's tasks, so only an unknown name is
    rejected; the table tasks once rejected here parse as the
    reference's."""
    argv = ["--img", "s.npy", "atlas", "--register", task]
    if task.upper() in cli.RegisterTypes.__members__:
        got = cli.process_cli_args(argv + ["--device", "cpu"])
        want = ref_cli.process_cli_args(argv)
        assert got.register_type in cli.REGISTER_TASKS
        assert got.register_type.name == want.register_type.name
        return
    with pytest.raises(SystemExit, match=f"--register {task}"):
        cli.process_cli_args(argv)


def test_register_entry_points_ask_for_the_card(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    prof = atlas_prof.AtlasProfile()
    imgs = {"atlas": pair["moving"], "labels": pair["labels"]}
    for call in (
            lambda: register.register(pair["fixed"], imgs, prof),
            lambda: register.register_rev(pair["fixed"], imgs, prof),
            lambda: gauntlet.build_pair((24, 32, 28)),
            lambda: gauntlet.run_gauntlet(pair),
            lambda: cli.main(["--img", "s.npy", "atlas", "--register",
                              "single"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
