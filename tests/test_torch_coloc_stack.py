"""Whole-image match colocalization of the port
(``colocalizer.match_stack``, which ``--proc coloc_match`` calls) and
``--proc detect_coloc`` against the benchmark's plain reference, on the
CPU.

On an image of one matching block the entry is the one assignment of
``colocalize_blobs_match``, the JAX package's bit for bit; beyond one
block it is ``StackColocalizer.colocalize_stack``, the port's and the JAX
package's. The CLI's task takes the blocked route beyond one block, a
recorded deviation from the JAX package's CLI, which matches the whole
image in one assignment (ROADMAP section 3): pinned here. On seeded
(64, 256, 256, 2) volumes the task's flags and matches equal
``portbench/reference/coloc.py``'s of the same rows, and the spans of
colocalization open, and count, only while a profiler records.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from magellanmapper_tpu.cv import colocalizer as ref_coloc
from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_torch import testing
from magellanmapper_torch.cv import colocalizer, detector
from magellanmapper_torch.io import cli, np_io
from magellanmapper_torch.utils import profiler
from portbench.drivers.coloc import match_diff, match_rows
from portbench.reference import coloc as plain

torch.set_num_threads(1)

#: one matching block; and 1 x 2 x 2 blocks of 128
ONE_BLOCK = (40, 100, 100)
SHAPE = (64, 256, 256)
RES = (1.0, 1.0, 1.0)


def _blobs(seed, shape, n):
    """Seeded blob rows (N x 10) in two channels, each channel-0 row with
    a channel-1 row near it, and rows outside the image."""
    rng = np.random.default_rng(seed)
    b = np.zeros((n, 10))
    b[:, :3] = np.round(rng.uniform(-2, np.add(shape, 2), (n, 3)))
    b[:, 3] = rng.uniform(2, 4, n)
    b[:, 4:6] = -1
    b[:, 6] = 0
    near = b.copy()
    near[:, :3] += np.round(rng.uniform(-3, 3, (n, 3)))
    near[:, 6] = 1
    out = np.concatenate([b, near])
    out[:, 7:10] = out[:, :3]
    return out


def _rows(matches):
    """A channel pair's matches as rows: blob 1, blob 2, the distance."""
    return {pair: np.asarray([np.concatenate([
        np.asarray(r["Blob1"]), np.asarray(r["Blob2"]), [r["Distance"]]])
        for _, r in bm.df.iterrows()]) for pair, bm in matches.items()}


def _assert_equal(got, want):
    got, want = _rows(got), _rows(want)
    assert sorted(got) == sorted(want)
    for pair in want:
        np.testing.assert_array_equal(got[pair], want[pair])


def test_one_block_is_the_one_assignment_of_the_reference():
    blobs = _blobs(1, ONE_BLOCK, 300)
    tol = detector.calc_overlap(RES)
    got = colocalizer.match_stack(blobs, ONE_BLOCK, tol)
    _assert_equal(got, colocalizer.colocalize_blobs_match(
        blobs, (0, 0, 0), ONE_BLOCK[::-1], tol))
    _assert_equal(got, ref_coloc.colocalize_blobs_match(
        blobs, (0, 0, 0), ONE_BLOCK[::-1], tol))
    assert len(got[(0, 1)]) > 100


def test_beyond_one_block_is_the_stack_colocalizer():
    blobs = _blobs(2, SHAPE, 1500)
    tol = detector.calc_overlap(RES)
    got = colocalizer.match_stack(blobs, SHAPE, tol)
    _assert_equal(got, colocalizer.StackColocalizer.colocalize_stack(
        SHAPE, blobs, tol))
    _assert_equal(got, ref_coloc.StackColocalizer.colocalize_stack(
        SHAPE, blobs, tol))
    assert len(got[(0, 1)]) > 500


def test_no_blobs_match_nothing():
    assert colocalizer.match_stack(None, SHAPE, (5, 5, 5)) == {}


@pytest.fixture(scope="module", params=[0, 1])
def task(request, tmp_path_factory):
    """``--proc detect_coloc --channel 0 1`` and then ``--proc
    coloc_match`` through the port's CLI on a seeded (64, 256, 256, 2)
    volume, the matching under a profiler: the volume, the detected
    blobs and flags, the matches, and the matching's kept spans."""
    vol = testing.make_coloc_volume(SHAPE, request.param)[0]
    path = str(tmp_path_factory.mktemp("coloc") / "vol.npy")
    np_io.write_npy(path, vol[None])
    found = cli.main(["--img", path, "--proc", "detect_coloc", "--channel",
                      "0", "1", "--roi_profile", "lightsheet", "--device",
                      "cpu"])
    profiler.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        matches = cli.main(["--img", path, "--proc", "coloc_match",
                            "--device", "cpu"])
    recs = profiler.spans()
    profiler.clear_spans()
    return {"vol": vol, "path": path, "blobs": found.blobs,
            "colocs": found.colocalizations, "matches": matches,
            "recs": recs}


def test_detect_coloc_flags_are_the_plain_references(task):
    want = plain.flags(task["vol"], task["blobs"], 2)
    assert len(task["blobs"]) > 500
    np.testing.assert_array_equal(task["colocs"], want)
    # each channel's own blobs express it; some of the other's do not
    chl = task["blobs"][:, 6].astype(int)
    assert np.all(want[np.arange(len(chl)), chl] == 1)
    assert 0 < want[chl == 0, 1].sum() < np.sum(chl == 0)


def test_coloc_match_is_the_plain_references_blocked_matching(task):
    want = plain.match(task["blobs"], SHAPE, (5, 5, 5), 128)
    assert match_diff(match_rows(task["matches"]), want) == 0.0
    assert len(want[(0, 1)]) > 150


def test_coloc_match_beyond_one_block_matches_in_blocks_pin(task):
    """The port's task is ``StackColocalizer``'s blocks, four here; the
    JAX package's CLI matches the whole image in one assignment, which
    keeps some pairs that the blocks' inner regions and border rescue do
    not. ROADMAP section 3."""
    blobs, tol = task["blobs"], detector.calc_overlap(RES)
    _assert_equal(task["matches"],
                  colocalizer.StackColocalizer.colocalize_stack(
                      SHAPE, blobs, tol))
    spans = [r for r in task["recs"] if r.name == "mm.coloc.match"]
    assert len(spans) == 1 and spans[0].counts == {"blocks": 4}
    ref_dir = os.path.join(os.path.dirname(task["path"]), "ref")
    os.makedirs(ref_dir, exist_ok=True)
    ref_path = os.path.join(ref_dir, "vol.npy")
    np_io.write_npy(ref_path, task["vol"][None])
    shutil.copy(task["path"].replace(".npy", "_blobs.npz"),
                ref_path.replace(".npy", "_blobs.npz"))
    whole = ref_cli.main(["--img", ref_path, "--proc", "coloc_match"])
    _assert_equal(whole, ref_coloc.colocalize_blobs_match(
        blobs, (0, 0, 0), SHAPE[::-1], tol))
    blocked = match_rows(task["matches"])[(0, 1)]
    one = match_rows(whole)[(0, 1)]
    assert 0 < match_diff({(0, 1): blocked}, {(0, 1): one}) < 0.1


def test_colocalization_spans_count_only_while_a_profiler_records(task):
    vol, blobs = task["vol"], task["blobs"]
    profiler.clear_spans()
    colocalizer.colocalize_blobs(vol, blobs, device="cpu")
    colocalizer.match_stack(blobs, SHAPE, (5, 5, 5))
    assert profiler.spans() == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        colocs = colocalizer.colocalize_blobs(vol, blobs, device="cpu")
    recs = profiler.spans()
    profiler.clear_spans()
    np.testing.assert_array_equal(colocs, task["colocs"])
    assert [r.name for r in recs if r.parent is None] == ["mm.coloc"]
    balls = [r for r in recs if r.name == "mm.coloc.ball"]
    assert {recs[r.parent].name for r in balls} == {"mm.coloc"}
    # a slab of 32 planes a channel, each serving the blobs in its planes
    slabs = SHAPE[0] // colocalizer.SLAB_PLANES
    assert len(balls) == 2 * slabs
    assert all(r.counts["voxels"] == 32 * SHAPE[1] * SHAPE[2]
               for r in balls)
    assert sum(r.counts["blobs"] for r in balls) == 2 * len(blobs)


def test_match_cells_are_counted_inside_the_match_span(task):
    recs = task["recs"]
    root = [i for i, r in enumerate(recs) if r.name == "mm.coloc.match"]
    assigns = [r for r in recs if r.name == "mm.verify.assign"]
    assert len(root) == 1 and assigns
    assert all(r.root == root[0] for r in assigns)
    assert sum(r.counts["cells"] for r in assigns) > 0
