"""K2 (per-row top-8 candidate harvest) and the unfused peak route of the
port, through their plain versions on the CPU, against the JAX reference:
``extract_candidates_pallas`` in interpret mode, the reference's unfused
``find_peaks`` and ``blob_log_multi``.

K2's values and lanes must be equal bit for bit, and so must the peaks'
coordinates, values and counts. Blob rows must have equal coordinates and
sigmas within 1e-6 relative (the two LoG pyramids round their sums in
another order). Every fixture meant for the K2 route holds at least
``capacity`` 128-lane groups, and the tests check that K2 ran.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magellanmapper_tpu.cv import detector as ref_detector
from magellanmapper_tpu.ops import pallas_kernels
from magellanmapper_tpu.ops import peaks as ref_peaks
from magellanmapper_torch import testing
from magellanmapper_torch.cv import detector
from magellanmapper_torch.kernels import extract_candidates as k2
from magellanmapper_torch.ops import peaks

torch.set_num_threads(1)


@pytest.fixture
def k2_calls(monkeypatch):
    """Rows handed to K2's wrapper, per call."""
    calls = []
    original = k2.extract_candidates

    def spy(rows):
        calls.append(rows.shape[0])
        return original(rows)

    monkeypatch.setattr(k2, "extract_candidates", spy)
    return calls


def _rows(case, g, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.full((g, 128), -np.inf, np.float32)
    if case == "sparse":
        hit = rng.random(rows.shape) < 0.03
        rows[hit] = rng.uniform(0.05, 1.0, hit.sum()).astype(np.float32)
        rows[: g // 3] = -np.inf          # a third of the rows hold nothing
    elif case == "plateau":
        rows[::2] = 0.5                   # 128 equal values
        rows[1::4, ::3] = 0.25            # 43 equal values
        rows[3::4, 5] = 0.3               # one finite value
    elif case == "duplicates":
        rows[:] = rng.integers(0, 4, rows.shape).astype(np.float32)
        rows[rng.random(rows.shape) < 0.5] = -np.inf
    return rows


@pytest.mark.parametrize("case,g", [
    ("sparse", 1024), ("plateau", 64), ("all_neg_inf", 96),
    ("duplicates", 700), ("sparse", 777)])
def test_extract_candidates_plain_matches_pallas(case, g):
    rows = _rows(case, g)
    want_v, want_l = pallas_kernels.extract_candidates_pallas(
        jnp.asarray(rows), interpret=True)
    got_v, got_l = k2.extract_candidates(torch.from_numpy(rows))
    assert got_v.shape == (g, 8) and got_l.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_extract_candidates_one_finite_value():
    """Once a row holds no finite value every slot is (-inf, lane 0)."""
    rows = np.full((1, 128), -np.inf, np.float32)
    rows[0, 5] = 0.3
    vals, lanes = k2.extract_candidates(torch.from_numpy(rows))
    np.testing.assert_array_equal(lanes.numpy()[0], [5, 0, 0, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(vals.numpy()[0, 1:], [-np.inf] * 7)


def _peak_cube(shape, seed):
    """-0.05 background, positive isolated peaks and a few equal values."""
    rng = np.random.default_rng(seed)
    cube = rng.normal(-0.05, 0.1, shape).astype(np.float32)
    flat = cube.reshape(-1)
    flat[rng.permutation(flat.size)[:40]] = 0.6
    return cube


@pytest.mark.parametrize("shape,capacity,k2_route", [
    ((4, 6, 32, 128), 64, True),      # G = 768 >= capacity
    ((3, 5, 20, 130), 128, True),     # ragged: padded to 128-lane groups
    ((4, 6, 32, 128), 1024, False),   # G < capacity: select over all
])
@pytest.mark.parametrize("threshold", [0.1, 0.0])
def test_find_peaks_unfused_matches_reference(
        k2_calls, shape, capacity, k2_route, threshold):
    cube = _peak_cube(shape, sum(shape))
    rc, rv, rn = ref_peaks.find_peaks(
        jnp.asarray(cube), threshold, capacity, fused=False)
    coords, values, count = peaks.find_peaks(
        torch.from_numpy(cube), threshold, capacity, fused=False)
    assert bool(k2_calls) == k2_route
    assert count == int(rn)
    np.testing.assert_array_equal(coords.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(values.numpy(), np.asarray(rv))
    assert np.isfinite(values.numpy()).sum() > 0


def test_find_peaks_unfused_tie_order_is_round_major(k2_calls):
    """Equal values go to the earlier harvest round, then the lower
    group: group 0's second-round 0.5 loses to group 1's first-round 0.5
    although its flat index is lower. Flat-index order (K1's) would keep
    group 0's."""
    cube = np.full((1, 1, 4, 128), -0.05, np.float32)
    cube[0, 0, 0, 10] = 0.9     # group 0, round 0
    cube[0, 0, 0, 40] = 0.5     # group 0, round 1
    cube[0, 0, 1, 70] = 0.5     # group 1, round 0
    cube[0, 0, 3, 100] = 0.5    # group 3, round 0
    rc, rv, rn = ref_peaks.find_peaks(jnp.asarray(cube), 0.1, 3, fused=False)
    coords, values, count = peaks.find_peaks(
        torch.from_numpy(cube), 0.1, 3, fused=False)
    assert k2_calls == [4]
    want = [[0, 0, 0, 10], [0, 0, 1, 70], [0, 0, 3, 100]]
    np.testing.assert_array_equal(coords.numpy(), want)
    np.testing.assert_array_equal(np.asarray(rc), want)
    np.testing.assert_array_equal(values.numpy(), np.asarray(rv))
    assert count == int(rn) == 3
    by_flat = peaks.find_peaks(torch.from_numpy(cube), 0.1, 3, fused=True)
    np.testing.assert_array_equal(
        by_flat[0].numpy(), [[0, 0, 0, 10], [0, 0, 0, 40], [0, 0, 1, 70]])


def _nuclei_roi(shape, seed=0):
    vol, _ = testing.make_nuclei_volume(shape, seed, spacing=12, jitter=2)
    return (vol / vol.max()).astype(np.float32)


@pytest.mark.parametrize("shape,thresholds,capacity", [
    ((16, 32, 32), (0.05, 0.1, 0.2), 512),      # G = 1280
    ((20, 36, 40), (0.12, -0.01), 1024),        # G = 2250, a threshold < 0
])
def test_blob_log_multi_matches_reference(
        k2_calls, shape, thresholds, capacity):
    roi = _nuclei_roi(shape)
    sigmas = tuple(ref_detector.sigma_list(3, 4, 10))
    want_rows, want_valid = ref_detector.blob_log_multi(
        jnp.asarray(roi), sigmas, jnp.asarray(thresholds), 0.5, capacity)
    got_rows, got_valid = detector.blob_log_multi(
        torch.from_numpy(roi), sigmas, thresholds, 0.5, capacity)
    assert k2_calls == [len(thresholds) * 10 * int(np.prod(shape)) // 128]
    assert got_rows.shape == (len(thresholds), capacity, 4)
    for k in range(len(thresholds)):
        want = np.asarray(want_rows[k])[np.asarray(want_valid[k])]
        got = got_rows[k][got_valid[k]].numpy()
        assert len(want) > 0
        np.testing.assert_array_equal(got[:, :3], want[:, :3])
        np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=1e-6, atol=0)


def test_blob_log_multi_ridge_valid_pin():
    """Fault of the reference, pinned: on a ridge constant along x each
    128-lane group holds 128 peaks and yields 8, and the reference keeps
    the missing ones valid (``valid = arange(capacity) < count``), which
    leaves a spurious blob at the origin at every threshold. The port
    marks only finite peaks valid."""
    z, y = np.ogrid[:16, :32]
    ridge = np.exp(-((z - 8.0) ** 2 + (y - 16.0) ** 2) / (2 * 2.0 ** 2))
    roi = np.repeat(ridge[:, :, None], 128, axis=2).astype(np.float32)
    sigmas = (1.5, 2.0, 2.5, 3.0)
    want_rows, want_valid = ref_detector.blob_log_multi(
        jnp.asarray(roi), sigmas, jnp.asarray([0.05, 0.1]), 0.5, 256)
    got_rows, got_valid = detector.blob_log_multi(
        torch.from_numpy(roi), sigmas, [0.05, 0.1], 0.5, 256)
    for k in range(2):
        want = np.asarray(want_rows[k])[np.asarray(want_valid[k])]
        got = got_rows[k][got_valid[k]].numpy()
        assert [0.0, 0.0, 0.0, 1.5] in want.tolist()
        assert len(got) > 0
        assert np.all(got[:, :2] == [8, 16])     # on the ridge line only
