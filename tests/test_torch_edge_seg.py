"""``magellanmapper_torch.atlas.edge_seg`` and the atlas-construction
``--register`` tasks against ``magellanmapper_tpu``, on a one-sided
atlas of 12 regions, imported (mirrored, its lateral edge extended) as
the ``abap56`` profile does.

Held exactly: the zero-crossing edges (where no voxel of a
neighbourhood holds a raw LoG within 1e-6 of zero, relative to its range;
the port's LoG sums in another order, and a sign there may flip), and,
given the same edges, the distance to them, the label perimeters, the
markers and interiors, the reannotated labels (both halves segmented, or
one mirrored) and their metrics, the edge distances and the sub-labels.
Through both command lines, every file each task writes is byte for byte
the reference's but the clipped LoG image (within 1e-6 relative to its
range). The tasks also run in a fresh interpreter that loads neither jax
nor the reference package.
"""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import ndimage

from magellanmapper_tpu.atlas import atlas_refiner as ref_refiner
from magellanmapper_tpu.atlas import edge_seg as ref
from magellanmapper_tpu.atlas import gauntlet as ref_gauntlet
from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_torch.atlas import atlas_refiner, edge_seg
from magellanmapper_torch.io import cli, sitk_io

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG_RTOL = 1e-6
SIGMA = 2.0


@pytest.fixture(scope="module")
def atlas():
    """The atlas, one-sided labels with their outermost planes cleared,
    and the mirrored, extended labels the reference's import makes."""
    intensity, labels = ref_gauntlet.make_anatomy((32, 36, 30), n_labels=12,
                                                  n_blobs=30, seed=2)
    img = (intensity * 100).astype(np.float32)
    img[16:] = img[15::-1]
    labels = labels.astype(np.int32)
    labels[16:] = 0
    first = int(np.flatnonzero(labels.reshape(32, -1).any(axis=1))[0])
    labels[first:first + 2] = 0
    imported = ref_refiner.extend_edge(labels, img, 10.0, 0)
    imported = ref_refiner.mirror_planes(imported, 16, mirror_mult=-1)
    return img, labels, imported


def _near_zero(img):
    """Voxels whose 3^3 neighbourhood holds a raw LoG within
    ``LOG_RTOL`` of zero, relative to its range."""
    log = ndimage.gaussian_laplace(img.astype(np.float64), SIGMA)
    small = np.abs(log) <= LOG_RTOL * np.ptp(log)
    return ndimage.binary_dilation(small, np.ones((3, 3, 3), bool))


@pytest.mark.parametrize("with_labels", [True, False])
def test_make_edge_images_matches_reference(atlas, with_labels):
    img, _, labels = atlas
    lab = labels if with_labels else None
    got = edge_seg.make_edge_images(img, lab, SIGMA, device="cpu")
    want = ref.make_edge_images(img, lab, SIGMA)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
    differ = got["atlas_edge"] != want["atlas_edge"]
    assert not np.any(differ & ~_near_zero(img))
    if not differ.any():
        np.testing.assert_array_equal(got["dist_to_edge"],
                                      want["dist_to_edge"])
    np.testing.assert_allclose(got["atlas_log"], want["atlas_log"], rtol=0,
                               atol=LOG_RTOL * np.ptp(want["atlas_log"]))
    if with_labels:
        np.testing.assert_array_equal(got["labels_edge"],
                                      want["labels_edge"])
        assert not np.any(got["atlas_edge"][labels == 0])
        # the distance is 0 exactly on the edges
        on = got["atlas_edge"] != 0
        assert np.all(got["dist_to_edge"][on] == 0)
        assert np.all(got["dist_to_edge"][~on] > 0)


@pytest.mark.parametrize("filter_size", [8, 3])
def test_erode_labels_matches_reference(atlas, filter_size):
    _, _, labels = atlas
    got = edge_seg.erode_labels(labels, filter_size, device="cpu")
    want = ref.erode_labels(labels, filter_size)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]


@pytest.mark.parametrize("mirror_axis", [None, -1])
@pytest.mark.parametrize("erosion_size", [8, 3])
def test_edge_aware_segmentation_matches_reference(atlas, mirror_axis,
                                                   erosion_size):
    img, _, labels = atlas
    got, metr = edge_seg.edge_aware_segmentation(
        img, labels, erosion_size=erosion_size, mirror_axis=mirror_axis,
        log_sigma=SIGMA, device="cpu")
    want, want_metr = ref.edge_aware_segmentation(
        img, labels, erosion_size=erosion_size, mirror_axis=mirror_axis,
        log_sigma=SIGMA)
    np.testing.assert_array_equal(got, want)
    assert metr == want_metr
    lost = atlas_refiner.find_labels_lost(np.unique(labels), np.unique(got))
    np.testing.assert_array_equal(lost, ref_refiner.find_labels_lost(
        np.unique(labels), np.unique(want)))


def test_edge_aware_segmentation_given_markers(atlas):
    img, _, labels = atlas
    markers = ref.erode_labels(labels, 4)[0]
    got, metr = edge_seg.edge_aware_segmentation(
        img, labels, markers=markers, mirror_axis=-1, log_sigma=SIGMA,
        device="cpu")
    want, want_metr = ref.edge_aware_segmentation(
        img, labels, markers=markers, mirror_axis=-1, log_sigma=SIGMA)
    np.testing.assert_array_equal(got, want)
    assert metr == want_metr


def test_given_markers_on_a_mirrored_atlas_pin(atlas):
    """On a mirrored atlas the reference masks the whole image's markers
    with the first half's labels and fails to broadcast
    (``edge_seg.py:103-106``); the port takes the half's markers, and
    equals the reference's watershed of that half, mirrored."""
    from magellanmapper_tpu.cv import segmenter as ref_segmenter

    img, _, labels = atlas
    markers = ref.erode_labels(labels, 4)[0]
    with pytest.raises(ValueError, match="broadcast"):
        ref.edge_aware_segmentation(img, labels, markers=markers,
                                    log_sigma=SIGMA)
    got, _ = edge_seg.edge_aware_segmentation(
        img, labels, markers=markers, log_sigma=SIGMA, device="cpu")
    half = labels.shape[0] // 2
    edges = ref.make_edge_images(img, labels, SIGMA)["atlas_edge"]
    seg = ref_segmenter.segment_from_labels(
        edges[:half], np.where(labels[:half] != 0, markers[:half], 0),
        labels[:half])
    np.testing.assert_array_equal(
        got, np.concatenate([seg, seg[::-1] * -1], axis=0))


def test_edge_distances_and_sub_labels_match_reference(atlas):
    img, _, labels = atlas
    imgs = ref.make_edge_images(img, labels, SIGMA)
    for spacing in (None, (2.0, 1.0, 0.5)):
        got = edge_seg.edge_distances(imgs["labels_edge"],
                                      imgs["atlas_edge"], spacing, "cpu")
        want = ref.edge_distances(imgs["labels_edge"], imgs["atlas_edge"],
                                  spacing)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    for mult in (100, 1000):
        got = edge_seg.make_sub_segmented_labels(
            labels, imgs["atlas_edge"], mult, device="cpu")
        want = ref.make_sub_segmented_labels(labels, imgs["atlas_edge"],
                                             mult)
        np.testing.assert_array_equal(got, want)
        nz = got != 0
        np.testing.assert_array_equal(np.abs(got[nz]) // mult,
                                      np.abs(labels[nz]))


def test_sub_labels_past_99_components_pin():
    """Sub-labels number a label's components from ``|id| * 100``; a
    label cut into 100 or more runs on into the next ID's range, in the
    reference as in the port (``edge_seg.py:144-160``)."""
    labels = np.full((2, 40, 80), 7, np.int32)
    labels[:, :, 40:] = 8
    edges = np.zeros_like(labels)
    edges[:, ::3] = edges[:, :, ::3] = 1
    got = edge_seg.make_sub_segmented_labels(labels, edges, device="cpu")
    want = ref.make_sub_segmented_labels(labels, edges)
    np.testing.assert_array_equal(got, want)
    k = got[labels == 7] - 700
    assert k.max() >= 100 and set(got[labels == 7] // 100) == {7, 8}


def test_merge_atlas_segmentations_matches_reference(atlas):
    img, _, labels = atlas
    samples = [(img, labels), (img[::-1].copy(), labels[::-1].copy())]
    segs, metrics = edge_seg.merge_atlas_segmentations(
        samples, 4, SIGMA, device="cpu")
    want_segs, want_metrics = ref.merge_atlas_segmentations(samples, 4,
                                                            SIGMA)
    for g, w in zip(segs, want_segs):
        np.testing.assert_array_equal(g, w)
    assert metrics == want_metrics


def _write_atlas(where, img, labels):
    where.mkdir(parents=True)
    for name, arr in (("atlasVolume", img), ("annotation", labels)):
        sitk_io.write_med_img(str(where / f"{name}.mhd"),
                              sitk_io.MedImage(arr))


def _same_files(a, b, skip=()):
    """The files of two directories are the same, byte for byte, but
    those whose names hold a ``skip`` part (their headers still)."""
    names = sorted(n for n in os.listdir(a)
                   if os.path.isfile(os.path.join(a, n)))
    assert names == sorted(n for n in os.listdir(b)
                           if os.path.isfile(os.path.join(b, n)))
    for name in names:
        if name.endswith(".mhd") or not any(s in name for s in skip):
            assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                               shallow=False), name
    return names


_PROFILE = "log_sigma: 2.0\n"


def test_atlas_construction_cli_matches_reference(atlas, tmp_path):
    """``import_atlas`` (profile ``abap56``), ``make_edge_images``,
    ``merge_atlas_segs``, ``make_subsegs``, and the ``_exp`` forms, through
    both command lines."""
    img, cut, _ = atlas
    prof = tmp_path / "sigma.yml"
    prof.write_text(_PROFILE)
    for name, main, extra in (("ref", ref_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / name / "atlas"
        _write_atlas(d, img, cut)
        main(["--img", str(d), "--register", "import_atlas",
              "--atlas_profile", "abap56"] + extra)
        base = str(d / "atlas_imported.mhd")
        for task in ("make_edge_images", "merge_atlas_segs", "make_subsegs",
                     "make_edge_images_exp", "merge_atlas_segs_exp"):
            main(["--img", base, "--register", task, "--atlas_profile",
                  str(prof), "--prefix", base] + extra)
    names = _same_files(str(tmp_path / "ref" / "atlas"),
                        str(tmp_path / "port" / "atlas"), skip=("LoG",))
    assert [n for n in names if n.endswith(".mhd")] == [
        "annotation.mhd", "atlasVolume.mhd"] + [
        f"atlas_imported_{k}.mhd" for k in (
            "annotation", "annotationDist", "annotationEdge",
            "annotationInterior", "annotationMarkers", "annotationSubseg",
            "atlasEdge", "atlasLoG", "atlasVolume")]
    log = [sitk_io.read_med_img(str(tmp_path / n / "atlas" /
                                    "atlas_imported_atlasLoG.mhd")).img
           for n in ("port", "ref")]
    np.testing.assert_allclose(log[0], log[1], rtol=0,
                               atol=LOG_RTOL * np.ptp(log[1]))
    sub = sitk_io.read_med_img(str(
        tmp_path / "port" / "atlas" / "atlas_imported_annotationSubseg.mhd"))
    labels = sitk_io.read_med_img(str(
        tmp_path / "port" / "atlas" / "atlas_imported_annotation.mhd"))
    nz = sub.img != 0
    np.testing.assert_array_equal(np.abs(sub.img[nz]) // 100,
                                  np.abs(labels.img[nz]))


def test_new_atlas_cli_matches_reference(atlas, tmp_path):
    img, cut, _ = atlas
    for name, main, extra in (("ref", ref_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / name / "atlas"
        _write_atlas(d, img, cut)
        out = main(["--img", str(d), "--register", "new_atlas",
                    "--atlas_profile", "abap56,smooth2"] + extra)
        assert sorted(out) == ["annotation.mhd", "atlasVolume.mhd",
                               "metrics"]
    _same_files(str(tmp_path / "ref"), str(tmp_path / "port"))
    _same_files(str(tmp_path / "ref" / "atlas"),
                str(tmp_path / "port" / "atlas"))


_ATLAS_TASKS_ALONE = """
import sys
import numpy as np
from magellanmapper_torch.io import cli, sitk_io
d, prof, brains = sys.argv[1], sys.argv[2], sys.argv[3:]
out = cli.main(["--img", d, "--register", "import_atlas", "--atlas_profile",
                "abap56", "--device", "cpu"])
base = out["annotation.mhd"].replace("_annotation.mhd", ".mhd")
imgs = cli.main(["--img", base, "--register", "make_edge_images",
                 "--atlas_profile", prof, "--device", "cpu"])
metr = cli.main(["--img", base, "--register", "merge_atlas_segs",
                 "--atlas_profile", prof, "--device", "cpu"])
sub = cli.main(["--img", base, "--register", "make_subsegs", "--device",
                "cpu"])
mean, params = cli.main(["--img"] + brains + ["--register", "group",
                         "--atlas_profile", prof, "--device", "cpu"])
assert imgs["atlas_edge"].any() and (sub != 0).any()
assert len(params) == len(brains) and np.isfinite(mean).all()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "magellanmapper_tpu"))
assert not loaded, loaded
print(len(metr), metr[0]["DSC_orig_new"])
"""


def test_atlas_tasks_run_without_the_reference(atlas, tmp_path):
    img, cut, _ = atlas
    d = tmp_path / "atlas"
    _write_atlas(d, img, cut)
    prof = tmp_path / "p.yml"
    prof.write_text(_PROFILE + "groupwise_iter_max: 8\nreg_bspline:\n"
                    "  max_iter: 2\n  grid_space_voxels: 12\n")
    from magellanmapper_torch.io import np_io
    brains = []
    for i in range(2):
        brains.append(str(tmp_path / f"b{i}.npy"))
        np_io.write_npy(brains[-1], np.roll(img, i, axis=1))
    out = subprocess.run(
        [sys.executable, "-c", _ATLAS_TASKS_ALONE, str(d), str(prof)]
        + brains, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n, dsc = out.stdout.split()[-2:]
    assert int(n) == 1 and float(dsc) > 0.5

