"""The port's whole-stack block detection against the JAX reference, both
on the CPU (the port through its kernels' plain versions).

Blob rows must be equal after sorting: coordinates exact, radii within
1e-6 relative (the port and the reference round the LoG sums in another
order, which moves no peak on these fixtures).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magellanmapper_tpu.cv import blobs as blobs_mod
from magellanmapper_tpu.cv import stack_detect as ref_sd
from magellanmapper_tpu.io import np_io
from magellanmapper_tpu.settings.roi_prof import ROIProfile
from magellanmapper_torch.cv import stack_detect as sd
from magellanmapper_torch.io import cli
from magellanmapper_torch.testing import make_nuclei_volume, rows_equal

torch.set_num_threads(1)

RES = (1.0, 1.0, 1.0)
SHAPE = (48, 192, 192)


def _lightsheet(**overrides):
    prof = ROIProfile()
    prof.add_profiles("lightsheet")
    prof.update(overrides)
    return prof


@pytest.fixture(scope="module")
def volume():
    return make_nuclei_volume(SHAPE, seed=0)[0]


@pytest.fixture(scope="module")
def port_resident(volume):
    blobs, timing = sd.detect_blobs_blocks(
        volume, _lightsheet(), RES, device="cpu")
    assert timing["h2d_bytes"] == volume.nbytes
    return blobs


def test_detect_blobs_blocks_matches_reference(volume, port_resident):
    want, _ = ref_sd.detect_blobs_blocks(
        volume, _lightsheet(), RES, preprocess=True)
    assert want is not None and len(want) > 100
    assert rows_equal(port_resident, want)


def test_detect_step_matches_reference_step(volume):
    """The same static arguments handed to the reference's batched step
    and to the port's step give the same blobs and pre-prune counts."""
    prof = _lightsheet()
    shape = (30, 64, 64)
    blocks = sd.setup_blocks(prof, shape, RES)
    block_shape = np.minimum(blocks.max_pixels + blocks.overlap, shape)
    params = sd.step_params(prof, blocks, block_shape, RES, near_max=2000.0)
    batch = np.stack([volume[:30, :64, :64], volume[10:40, 100:164, 50:114]])
    raws, valids, counts = ref_sd._detect_batch(
        jnp.asarray(batch), params.sigmas, params.threshold, params.overlap,
        params.capacity, params.denoise_shape, params.preproc_items)
    for b in range(2):
        got_raw, got_valid, got_count = sd.detect_step(
            torch.from_numpy(batch[b]), params)
        assert got_count == int(counts[b])
        want = np.asarray(raws[b])[np.asarray(valids[b])]
        got = got_raw[got_valid].numpy()
        assert len(want) > 0
        np.testing.assert_array_equal(
            got[np.lexsort(got.T[::-1])], want[np.lexsort(want.T[::-1])])


def test_volume_smaller_than_a_block_matches_reference(volume):
    """A volume smaller than one block window: the window is clamped to
    the volume (reference ``stack_detect.py:658``), so the reference's
    padded small-volume gather (``:756-768``) never runs and the volume
    stages resident in both packages."""
    small = np.ascontiguousarray(volume[:20, :100, :90])
    prof = _lightsheet()
    blocks = ref_sd.setup_blocks(prof, small.shape, RES)
    assert np.all(blocks.max_pixels + blocks.overlap > small.shape)
    want, _ = ref_sd.detect_blobs_blocks(small, prof, RES)
    got, timing = sd.detect_blobs_blocks(small, prof, RES, device="cpu")
    assert want is not None
    assert rows_equal(got, want)
    assert timing["h2d_bytes"] == small.nbytes


@pytest.mark.parametrize("budget,expect_bytes", [
    (5 << 19, 2 * 48 * 128 * 192 * 2),   # two y-slabs of one z block row
    (1 << 20, 4 * 48 * 128 * 128 * 2),   # no slab fits: four windows
])
def test_slab_and_gather_staging_match_resident(
        volume, port_resident, monkeypatch, budget, expect_bytes):
    monkeypatch.setattr(sd, "_RESIDENT_BYTES_BUDGET", budget)
    got, timing = sd.detect_blobs_blocks(
        volume, _lightsheet(), RES, device="cpu")
    assert timing["h2d_bytes"] == expect_bytes
    assert rows_equal(got, port_resident)


def test_overflow_retry_matches_full_capacity(volume, port_resident):
    """At a capacity below each block's peak count every block overflows,
    is re-detected at doubled capacities, and ends as at full capacity."""
    got, _ = sd.detect_blobs_blocks(
        volume, _lightsheet(max_blobs_per_block=32), RES, device="cpu")
    assert rows_equal(got, port_resident)


def test_overflow_retry_stores_truncated_rows_at_the_ceiling(volume):
    retry, stored = [(0, 0, 0)], {}
    rows = np.ones((3, 4), np.float32)
    sd._retry_overflow(
        retry, {(0, 0, 0): ((0, 0, 0), rows)},
        lambda coords, cap: [(c, (0, 0, 0), rows, cap) for c in coords],
        lambda coord, wstart, raw: stored.setdefault(coord, raw), 4, 16)
    np.testing.assert_array_equal(stored[(0, 0, 0)], rows)


def test_stack_detector_facade(volume, port_resident):
    got, _ = sd.StackDetector(
        volume, _lightsheet(), RES, device="cpu").detect_stack()
    assert rows_equal(got, port_resident)


def test_cli_writes_the_blobs_of_a_direct_call(tmp_path, volume):
    small = np.ascontiguousarray(volume[:30, :140, :140])
    path = str(tmp_path / "tiny.npy")
    np_io.write_npy(path, small, resolutions=[[1.0, 1.0, 1.0]])
    out = cli.main(["--img", path, "--proc", "detect",
                    "--roi_profile", "lightsheet", "--device", "cpu"])
    direct, _ = sd.detect_blobs_stack(small, _lightsheet(), RES, device="cpu")
    saved = blobs_mod.Blobs().load_blobs(str(tmp_path / "tiny_blobs.npz"))
    assert len(direct) > 0
    np.testing.assert_array_equal(saved.blobs, direct.blobs)
    np.testing.assert_array_equal(out.blobs, direct.blobs)
    assert os.path.exists(tmp_path / "tiny_stack_detection_times.csv")


@pytest.mark.parametrize("argv", [
    ["--proc", "no_such_task"], ["--register", "single"],
    ["--proc", "detect", "--mesh", "1,1"]])
def test_cli_rejects_what_is_not_ported(tmp_path, argv):
    with pytest.raises(SystemExit):
        cli.main(["--img", str(tmp_path / "x.npy")] + argv)


def test_bfloat16_log_is_not_ported(volume, port_resident):
    """``log_dtype="bfloat16"`` (the fast LoG route, once rejected) runs
    and, on the CPU, gives the reference's ``fast=True`` blobs, which
    there are its float32 blobs: the route changes only the card's
    band products."""
    prof = _lightsheet(log_dtype="bfloat16")
    want, _ = ref_sd.detect_blobs_blocks(volume, prof, RES, preprocess=True)
    got, _ = sd.detect_blobs_blocks(volume, prof, RES, device="cpu")
    assert rows_equal(got, want)
    assert rows_equal(got, port_resident)
    assert not torch.backends.cuda.matmul.allow_tf32


def test_cli_runs_on_the_card_unless_told_otherwise(tmp_path, volume):
    """Without ``--device`` the CLI asks for the card, so a machine
    without one fails instead of timing the CPU path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    path = str(tmp_path / "tiny.npy")
    np.save(path, np.ascontiguousarray(volume[:20, :100, :90]))
    with pytest.raises(RuntimeError):
        cli.main(["--img", path, "--proc", "detect",
                  "--roi_profile", "lightsheet"])
    assert not os.path.exists(tmp_path / "tiny_blobs.npz")


def test_cuda_without_a_card_raises(volume):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        sd.detect_blobs_blocks(volume, _lightsheet(), RES, device="cuda")
