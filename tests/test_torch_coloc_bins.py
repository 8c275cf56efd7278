"""``StackColocalizer.colocalize_stack`` bins the blob rows to their
matching blocks once: every block gets, in their order, the rows that a
mask of the block's widened bounds over every row picks, and the whole
function's frames equal the JAX package's row for row."""

import numpy as np
import pytest

from magellanmapper_tpu.cv import colocalizer as ref_coloc
from magellanmapper_torch.cv import chunking, colocalizer

EPS = 1e-6


def mask_rows(coords, lo, hi, pad):
    """The oracle: the rows a block's mask over every row picks."""
    return np.flatnonzero(np.all(
        (coords >= lo - pad) & (coords < hi + pad), axis=1))


def _bounds(shape, block, pad):
    """Each axis' block starts and stops, as ``stack_splitter`` cuts."""
    slices, _ = chunking.stack_splitter(shape, (block,) * 3, pad)
    return [sorted({(sl[ax].start, sl[ax].stop) for sl in slices.flat})
            for ax in range(3)]


def _edges(shape, block, pad):
    """Rows at each block's widened bounds and just inside or outside
    them, on each axis in turn, the other axes at the image's centre."""
    rows = []
    for ax, bounds in enumerate(_bounds(shape, block, pad)):
        for lo, hi in bounds:
            for c in (lo - pad[ax], lo - pad[ax] - EPS, hi + pad[ax],
                      hi + pad[ax] - EPS):
                row = np.asarray(shape, float) / 2
                row[ax] = c
                rows.append(row)
    return np.asarray(rows)


def _outside(shape, pad):
    """Rows beyond the image on each side of each axis, and NaN."""
    rows = []
    for ax in range(3):
        for c in (-pad[ax] - 1, -100.5, shape[ax] + pad[ax],
                  shape[ax] + 100, np.nan):
            row = np.asarray(shape, float) / 2
            row[ax] = c
            rows.append(row)
    return np.asarray(rows)


def _uniform(shape, n, seed, spill=8.0):
    """Float rows over the image and a little beyond it."""
    return np.random.default_rng(seed).uniform(
        -spill, np.add(shape, spill), (n, 3))


CASES = {
    "float": ((256, 384, 384), 128, (5, 5, 5),
              lambda s, p: _uniform(s, 3000, 0)),
    "integer": ((256, 384, 384), 128, (5, 5, 5),
                lambda s, p: np.round(_uniform(s, 3000, 1))),
    "edges": ((256, 384, 384), 128, (5, 5, 5),
              lambda s, p: _edges(s, 128, p)),
    "outside": ((256, 384, 384), 128, (5, 5, 5), _outside),
    "fractional_tol": ((256, 384, 384), 128, (2.5, 3.2, 4.7),
                       lambda s, p: np.concatenate(
                           [_edges(s, 128, p), _uniform(s, 2000, 2)])),
    "clipped_last_block": ((200, 300, 330), 128, (5, 5, 5),
                           lambda s, p: np.concatenate(
                               [_edges(s, 128, p), _uniform(s, 2000, 3)])),
    "one_block_axis": ((100, 300, 300), 128, (5, 5, 5),
                       lambda s, p: np.concatenate(
                           [_edges(s, 128, p), _uniform(s, 2000, 4)])),
    "pad_wider_than_block": ((40, 50, 60), 4, (5, 6, 9),
                             lambda s, p: np.concatenate(
                                 [_edges(s, 4, p), _uniform(s, 500, 5)])),
    "no_rows": ((256, 384, 384), 128, (5, 5, 5),
                lambda s, p: np.empty((0, 3))),
    "one_row": ((256, 384, 384), 128, (5, 5, 5),
                lambda s, p: np.array([[130.0, 125.0, 250.0]])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_binned_rows_are_each_blocks_mask(case):
    shape, block, tol, make = CASES[case]
    pad = np.ceil(np.asarray(tol, float)).astype(int)
    coords = make(shape, pad)
    slices, _ = chunking.stack_splitter(shape, (block,) * 3, pad)
    rows, starts = colocalizer._bin_rows(coords, slices, pad)
    assert len(starts) == slices.size + 1
    total = 0
    for k, coord in enumerate(np.ndindex(*slices.shape)):
        lo = np.asarray([s.start for s in slices[coord]])
        hi = np.asarray([s.stop for s in slices[coord]])
        want = mask_rows(coords, lo, hi, pad)
        np.testing.assert_array_equal(rows[starts[k]:starts[k + 1]], want)
        total += len(want)
    assert len(rows) == total


# (256, 384, 384) in blocks of 128 with a pad of 5: z bounds (0, 133) and
# (128, 256), widened to [-5, 138) and [123, 261); y and x at 192 lie in
# their block 1 alone
HAND = {
    "at_lo_minus_pad": (123.0, [(0, 1, 1), (1, 1, 1)]),
    "below_lo_minus_pad": (123.0 - EPS, [(0, 1, 1)]),
    "at_hi_plus_pad": (138.0, [(1, 1, 1)]),
    "below_hi_plus_pad": (138.0 - EPS, [(0, 1, 1), (1, 1, 1)]),
    "below_the_image": (-5.0 - EPS, []),
    "at_the_first_lo_minus_pad": (-5.0, [(0, 1, 1)]),
    "at_the_last_hi_plus_pad": (261.0, []),
    "below_the_last_hi_plus_pad": (261.0 - EPS, [(1, 1, 1)]),
}


@pytest.mark.parametrize("case", sorted(HAND))
def test_a_row_at_a_bound_joins_the_blocks_the_mask_gives(case):
    z, blocks = HAND[case]
    pad = np.array([5, 5, 5])
    slices, _ = chunking.stack_splitter((256, 384, 384), (128,) * 3, pad)
    rows, starts = colocalizer._bin_rows(
        np.array([[z, 192.0, 192.0]]), slices, pad)
    got = [coord for k, coord in enumerate(np.ndindex(*slices.shape))
           if starts[k + 1] > starts[k]]
    assert got == blocks
    assert list(rows) == [0] * len(blocks)


def _blobs(seed, shape, n):
    """Seeded blob rows (N x 10) in two channels, each channel-0 row with
    a channel-1 row near it, rows at block bounds and outside the image."""
    rng = np.random.default_rng(seed)
    b = np.zeros((n, 10))
    b[:, :3] = np.round(rng.uniform(-2, np.add(shape, 2), (n, 3)))
    b[: n // 10, 1] = 128 + rng.integers(-6, 6, n // 10)
    b[:, 3] = rng.uniform(2, 4, n)
    b[:, 4:6] = -1
    near = b.copy()
    near[:, :3] += np.round(rng.uniform(-3, 3, (n, 3)))
    near[:, 6] = 1
    out = np.concatenate([b, near])
    out[:, 7:10] = out[:, :3]
    return out


def _frames(matches):
    """Each channel pair's columns and rows: blob 1, blob 2, distance."""
    out = {}
    for pair, bm in matches.items():
        df = bm.df
        rows = np.asarray([np.concatenate([
            np.asarray(r["Blob1"]), np.asarray(r["Blob2"]),
            [r["Distance"]]]) for _, r in df.iterrows()])
        out[pair] = (list(df.columns), rows)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_colocalize_stack_frames_are_the_jax_packages(seed):
    shape = (200, 300, 330)  # 2 x 3 x 3 blocks of 128, the last clipped
    blobs = _blobs(seed, shape, 2500)
    tol = (5, 5, 5)
    got = _frames(colocalizer.StackColocalizer.colocalize_stack(
        shape, blobs, tol))
    want = _frames(ref_coloc.StackColocalizer.colocalize_stack(
        shape, blobs, tol))
    assert sorted(got) == sorted(want) == [(0, 1)]
    for pair in want:
        assert got[pair][0] == want[pair][0]
        np.testing.assert_array_equal(got[pair][1], want[pair][1])
    assert len(want[(0, 1)][1]) > 1000
