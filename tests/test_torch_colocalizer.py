"""Colocalization of the port (``magellanmapper_torch.cv.colocalizer``)
against the JAX package's: intensity flags bit for bit, channel-pair
matches, the whole-stack matcher, the match rows' database round trip
both ways, and the ``--proc detect_coloc``/``coloc_match`` tasks and
``--proc detect --truth_db``/``--save_subimg`` through both command
lines, on the CPU."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from magellanmapper_tpu.cv import colocalizer as ref_coloc
from magellanmapper_tpu.cv import verifier as ref_verifier
from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.io import sqlite as ref_sqlite
from magellanmapper_torch import testing
from magellanmapper_torch.cv import colocalizer, verifier
from magellanmapper_torch.io import cli, np_io, sqlite

torch.set_num_threads(1)

#: the two-channel fixture: shape, and the per-axis matching tolerance
SHAPE = (40, 100, 100)
TOL = (3, 4, 4)


@pytest.fixture(scope="module")
def coloc_vol():
    return testing.make_coloc_volume(SHAPE, 0)


def _blobs(seed, n=300, shape=SHAPE, margin=2):
    """Seeded blob rows (N x 10) with fractional and out-of-volume
    coordinates in two channels."""
    rng = np.random.default_rng(seed)
    b = np.zeros((n, 10))
    b[:, :3] = rng.uniform(-margin, np.add(shape, margin), (n, 3))
    b[:, 3] = rng.uniform(2, 4, n)
    b[:, 4:6] = -1
    b[:, 6] = rng.integers(0, 2, n)
    b[:, 7:10] = b[:, :3]
    return b


def _match_rows(matches):
    """A channel pair's matches as comparable rows: blob 1, blob 2 and the
    distance."""
    return {pair: [np.concatenate([np.asarray(r["Blob1"]),
                                   np.asarray(r["Blob2"]), [r["Distance"]]])
                   for _, r in bm.df.iterrows()]
            for pair, bm in matches.items()}


def _assert_matches_equal(got, want):
    got, want = _match_rows(got), _match_rows(want)
    assert sorted(got) == sorted(want)
    for pair in want:
        np.testing.assert_array_equal(np.asarray(got[pair]),
                                      np.asarray(want[pair]))


@pytest.mark.parametrize("thresh", [None, "min", 50, 97.5])
@pytest.mark.parametrize("slab", [32, 7])
def test_colocalize_blobs_matches_reference(coloc_vol, thresh, slab,
                                            monkeypatch):
    """Flags equal bit for bit whatever the slab height; blobs outside the
    volume get 0."""
    monkeypatch.setattr(colocalizer, "SLAB_PLANES", slab)
    vol = coloc_vol[0]
    blobs = _blobs(1)
    want = ref_coloc.colocalize_blobs(vol, blobs, thresh)
    got = colocalizer.colocalize_blobs(vol, blobs, thresh, device="cpu")
    assert got.dtype == np.uint8 and got.shape == (len(blobs), 2)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


def test_ball_sums_equal_the_reference_stencil_bit_for_bit(coloc_vol):
    """The slab sums over the ball, divided by its voxel count, are the
    reference's whole-channel stencil at each blob, in float32 bits, on
    integer and float channels."""
    rng = np.random.default_rng(2)
    for chl in (coloc_vol[0][..., 1],
                rng.normal(0, 1e3, SHAPE).astype(np.float32)):
        coords = np.column_stack([rng.integers(0, s, 200) for s in SHAPE])
        got = colocalizer._ball_sums(
            chl, coords, torch.device("cpu")) / np.float32(33)
        want = ref_coloc._ball_mean(chl)[tuple(coords.T)]
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_colocalize_blobs_without_channels_or_blobs():
    vol = np.zeros((4, 8, 8), np.uint16)
    assert colocalizer.colocalize_blobs(vol, _blobs(0, 5),
                                        device="cpu") is None
    assert colocalizer.colocalize_blobs(vol[..., None], None,
                                        device="cpu") is None


def test_colocalize_blobs_match_matches_reference():
    blobs = _blobs(3, 400)
    # pair every other channel-0 blob with a nearby channel-1 blob
    near = blobs[blobs[:, 6] == 0][::2].copy()
    near[:, :3] += np.random.default_rng(4).uniform(-2, 2, (len(near), 3))
    near[:, 6] = 1
    blobs = np.concatenate([blobs, near])
    offset, size = (0, 0, 0), SHAPE[::-1]
    got = colocalizer.colocalize_blobs_match(blobs, offset, size, TOL)
    want = ref_coloc.colocalize_blobs_match(blobs, offset, size, TOL)
    _assert_matches_equal(got, want)
    assert len(got[(0, 1)]) > 50


def test_match_blobs_roi_and_accuracy_copy():
    blobs, truth = _blobs(5, 200), _blobs(6, 150)
    thresh, scaling, inner, *_ = verifier.setup_match_blobs_roi(TOL)
    got = verifier.match_blobs_roi(blobs.copy(), truth.copy(), (10, 10, 5),
                                   (60, 70, 30), thresh, scaling, inner)
    want = ref_verifier.match_blobs_roi(blobs.copy(), truth.copy(),
                                        (10, 10, 5), (60, 70, 30), thresh,
                                        scaling, inner)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert len(got[4]) == len(want[4]) > 0
    for g, w in zip(got[4], want[4]):
        np.testing.assert_array_equal(np.concatenate([g[0], g[1], [g[2]]]),
                                      np.concatenate([w[0], w[1], [w[2]]]))
    for verified in (False, True):
        for maybes in (0, 1, 2):
            flagged = got[0].copy()
            flagged[::5, 4] = 2
            assert verifier.meas_detection_accuracy(
                flagged, verified, maybes) == \
                ref_verifier.meas_detection_accuracy(
                    flagged, verified, maybes)


def test_stack_colocalizer_matches_reference():
    """Blocks of 32 with halos, duplicates across blocks pruned."""
    blobs = _blobs(7, 600)
    near = blobs[blobs[:, 6] == 0].copy()
    near[:, :3] += np.random.default_rng(8).uniform(-2, 2, (len(near), 3))
    near[:, 6] = 1
    blobs = np.concatenate([blobs, near])
    got = colocalizer.StackColocalizer.colocalize_stack(
        SHAPE, blobs, TOL, block_size=32)
    want = ref_coloc.StackColocalizer.colocalize_stack(
        SHAPE, blobs, TOL, block_size=32)
    _assert_matches_equal(got, want)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_match_rows_round_trip_both_ways(tmp_path, writer):
    """Matches written by either package read back equal in both."""
    blobs = _blobs(9, 200)
    near = blobs[blobs[:, 6] == 0].copy()
    near[:, 1:3] += 1.0
    near[:, 6] = 1
    blobs = np.round(np.concatenate([blobs, near]))
    matches = ref_coloc.colocalize_blobs_match(
        blobs, (0, 0, 0), SHAPE[::-1], TOL)
    path = str(tmp_path / "matches.db")
    if writer == "port":
        db = sqlite.load_db(path)
        colocalizer.insert_matches(db, colocalizer.colocalize_blobs_match(
            blobs, (0, 0, 0), SHAPE[::-1], TOL))
    else:
        db = ref_sqlite.load_db(path)
        ref_coloc.insert_matches(db, matches)
    db.close()
    got_db, ref_db = sqlite.load_db(path), ref_sqlite.load_db(path)
    try:
        got = colocalizer.select_matches(got_db, (0, 1))
        want = ref_coloc.select_matches(ref_db, (0, 1))
        _assert_matches_equal(got, want)
        assert len(got[(0, 1)]) == len(matches[(0, 1)]) > 0
        assert got_db.select_blob_matches(1) == ref_db.select_blob_matches(1)
        np.testing.assert_array_equal(got_db.select_blobs_by_roi(1),
                                      ref_db.select_blobs_by_roi(1))
        got_db.delete_blobs(1)
        assert len(ref_db.select_blobs_by_roi(1)) == 0
    finally:
        got_db.close()
        ref_db.close()


def _write_pair(tmp_path, vol):
    """The same 5D (1, z, y, x, c) image for each package (a 4D array
    would read as (t, z, y, x))."""
    paths = []
    for name in ("port", "ref"):
        d = tmp_path / name
        d.mkdir()
        np_io.write_npy(str(d / "vol.npy"), vol[None])
        paths.append(str(d / "vol.npy"))
    return paths


def test_cli_detect_coloc_and_coloc_match_match_reference(tmp_path,
                                                          coloc_vol):
    vol, centres, co, own = coloc_vol
    port, ref = _write_pair(tmp_path, vol)
    argv = ["--proc", "detect_coloc", "--channel", "0", "1",
            "--roi_profile", "lightsheet"]
    got = cli.main(["--img", port] + argv + ["--device", "cpu"])
    want = ref_cli.main(["--img", ref] + argv)
    np.testing.assert_array_equal(got.blobs, want.blobs)
    np.testing.assert_array_equal(got.colocalizations, want.colocalizations)
    with np.load(port.replace(".npy", "_blobs.npz")) as arc:
        np.testing.assert_array_equal(arc["colocs"], got.colocalizations)
    # the planted co-expression, where a blob lies near a planted nucleus
    truth = testing.coloc_truth(got.blobs, centres, co, own)
    known = truth >= 0
    assert np.mean(got.colocalizations[known] == truth[known]) > 0.9

    got_m = cli.main(["--img", port, "--proc", "coloc_match", "--device",
                      "cpu"])
    want_m = ref_cli.main(["--img", ref, "--proc", "coloc_match"])
    _assert_matches_equal(got_m, want_m)
    assert len(got_m[(0, 1)]) > 0


def test_cli_detect_truth_db_and_save_subimg_match_reference(tmp_path,
                                                             coloc_vol):
    """``verify.csv`` and the saved sub-image are the reference's."""
    vol, centres = coloc_vol[0][..., 0], coloc_vol[1]
    port, ref = _write_pair(tmp_path, vol)
    # the sub-image's blobs are relative to its offset (x 10, y 5, z 2)
    truth = testing.write_truth_db(str(tmp_path / "truth.db"),
                                   centres - (2, 5, 10), SHAPE)
    argv = ["--proc", "detect", "--roi_profile", "lightsheet", "--truth_db",
            truth, "--subimg_offset", "10,5,2", "--subimg_size", "80,90,36",
            "--save_subimg"]
    got = cli.main(["--img", port] + argv + ["--device", "cpu"])
    want = ref_cli.main(["--img", ref] + argv)
    np.testing.assert_array_equal(got.blobs, want.blobs)
    csv_port = pd.read_csv(port.replace(".npy", "_verify.csv"))
    csv_ref = pd.read_csv(ref.replace(".npy", "_verify.csv"))
    pd.testing.assert_frame_equal(csv_port, csv_ref)
    assert 0.0 < csv_port["sens"][0] <= 1.0
    name = "vol_(10,5,2)x(80,90,36)_subimg.npy"
    np.testing.assert_array_equal(
        np.load(os.path.join(os.path.dirname(port), name)),
        np.load(os.path.join(os.path.dirname(ref), name)))
