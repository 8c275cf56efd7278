"""``detector.remove_close_blobs`` finds its pairs in a sorted window and
returns, bit for bit, what the dense all-pairs difference returns: the
checked rows left and the master rows with their absolute coordinates
averaged, a master matched twice keeping its last pair's mean."""

import numpy as np
import pytest

from magellanmapper_torch.cv import blobs as blobs_mod
from magellanmapper_torch.cv import detector

TOL = np.array([3, 4, 4])


def dense_remove_close_blobs(blobs, blobs_master, tol):
    """The all-pairs oracle: the function's body before the window."""
    if len(blobs) < 1 or len(blobs_master) < 1:
        return blobs, blobs_master
    diffs = np.abs(blobs_master[:, None, :3] - blobs[None, :, :3])
    close_master, close = np.nonzero((diffs <= np.asarray(tol)).all(2))
    pruned = np.delete(blobs, close, axis=0)
    if len(close) > 0:
        B = blobs_mod.Blobs
        abs_between = np.around((
            B.get_blob_abs_coords(blobs_master[close_master])
            + B.get_blob_abs_coords(blobs[close])) / 2)
        blobs_master[close_master] = B.set_blob_abs_coords(
            blobs_master[close_master], abs_between)
    return pruned, blobs_master


def _rows(coords, seed=0):
    """Formatted blob rows at ``coords`` (z, y, x), radii drawn."""
    coords = np.asarray(coords, float).reshape(-1, 3)
    radii = np.random.default_rng(seed).uniform(2, 5, len(coords))
    return blobs_mod.Blobs(np.column_stack([coords, radii])).format_blobs(0)


def _with_abs(rows, abs_coords):
    """``rows`` with absolute coordinates unlike their relative ones, so
    the averaged master rows show which pair they took."""
    blobs_mod.Blobs.set_blob_abs_coords(rows, abs_coords)
    return rows


def _empty_master():
    return _rows([[5, 5, 5], [9, 9, 9]]), _rows(np.empty((0, 3))), TOL


def _empty_checked():
    return _rows(np.empty((0, 3))), _rows([[5, 5, 5]]), TOL


def _master_matches_several():
    check = _with_abs(_rows([[10, 10, 9], [10, 11, 10], [11, 10, 12]]),
                      [[100, 0, 0], [0, 100, 0], [0, 0, 100]])
    master = _rows([[10, 10, 10], [40, 40, 40]], seed=1)
    return check, master, TOL


def _checked_matches_several():
    check = _rows([[20, 20, 20], [50, 5, 5]])
    master = _with_abs(
        _rows([[19, 20, 21], [21, 18, 20], [20, 23, 17], [30, 30, 30]],
              seed=1),
        [[7, 7, 7], [70, 70, 70], [700, 700, 700], [1, 1, 1]])
    return check, master, TOL


def _at_tol_on(axis):
    def case():
        base = np.array([30.0, 30, 30])
        masters = [base + np.eye(3)[a] * 100 * (a + 1) for a in range(3)]
        checks = []
        for a, m in enumerate(masters):
            if a == axis:
                for step in (TOL[a], TOL[a] + 1, -TOL[a], -TOL[a] - 1):
                    checks.append(m + np.eye(3)[a] * step)
        return _rows(checks), _rows(masters, seed=1), TOL
    return case


def _non_integer():
    rng = np.random.default_rng(5)
    master = rng.uniform(0, 60, (200, 3))
    check = np.vstack([master[:80] + rng.uniform(-4.5, 4.5, (80, 3)),
                       rng.uniform(0, 60, (120, 3))])
    return _rows(check, seed=2), _rows(master, seed=3), (2.5, 3.25, 3.75)


def _band(widest):
    """A band 12 voxels deep in y, wide in ``widest`` and 300 in the
    third axis."""
    def case():
        rng = np.random.default_rng(11 + widest)
        span = np.array([300.0, 12.0, 300.0])
        span[widest] = 3000.0
        master = rng.integers(0, span, (600, 3)).astype(float)
        check = np.vstack([
            master[rng.permutation(600)[:250]]
            + rng.integers(-5, 6, (250, 3)),
            rng.integers(0, span, (350, 3))]).astype(float)
        return _rows(check, seed=4), _rows(master, seed=5), TOL
    return case


def _large_random():
    rng = np.random.default_rng(2026)
    span = np.array([640.0, 10.0, 1024.0])
    master = rng.integers(0, span, (2000, 3)).astype(float)
    dup = master[rng.permutation(2000)[:700]] + rng.integers(-1, 2, (700, 3))
    check = np.vstack([dup, rng.integers(0, span, (1300, 3))])
    check = check[rng.permutation(2000)].astype(float)
    return _rows(check, seed=6), _rows(master, seed=7), TOL


CASES = {
    "empty_master": _empty_master,
    "empty_checked": _empty_checked,
    "master_matches_several": _master_matches_several,
    "checked_matches_several": _checked_matches_several,
    "at_tol_z": _at_tol_on(0),
    "at_tol_y": _at_tol_on(1),
    "at_tol_x": _at_tol_on(2),
    "non_integer": _non_integer,
    "band_widest_z": _band(0),
    "band_widest_x": _band(2),
    "random_2000_planted": _large_random,
}


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", list(CASES))
def test_the_window_returns_the_dense_pairs_bit_for_bit(name):
    check, master, tol = CASES[name]()
    want = dense_remove_close_blobs(check.copy(), master.copy(), tol)
    got = detector.remove_close_blobs(check.copy(), master.copy(), tol)
    for g, w in zip(got, want):
        _same_bits(g, w)


@pytest.mark.parametrize("name, pruned, averaged", [
    ("master_matches_several", 3, 1), ("checked_matches_several", 1, 3),
    ("random_2000_planted", 700, None)])
def test_the_cases_match_as_planted(name, pruned, averaged):
    check, master, tol = CASES[name]()
    left, master_out = detector.remove_close_blobs(
        check.copy(), master.copy(), tol)
    assert len(check) - len(left) >= pruned
    if averaged is not None:
        abs_cols = blobs_mod.Blobs.get_blob_abs_coords
        moved = np.any(abs_cols(master_out) != abs_cols(master), axis=1)
        assert moved.sum() == averaged


def test_a_master_matched_twice_keeps_its_last_pairs_mean():
    check, master, tol = _master_matches_several()
    _, master_out = detector.remove_close_blobs(check, master.copy(), tol)
    abs_cols = blobs_mod.Blobs.get_blob_abs_coords
    np.testing.assert_array_equal(
        abs_cols(master_out)[0], np.around((abs_cols(master)[0] + [0, 0, 100])
                                           / 2))
