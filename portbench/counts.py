"""Operations and bytes that each measured kernel's inputs need.

Each function counts the work of one call from its shapes (and, where
the work depends on the data, from the counts the run itself produced),
whatever implements it: every input byte read once, every output byte
written once, and the operations of the plainest algorithm that computes
the result. ``roofline.py`` turns a count into the least time the card
could take.
"""

from __future__ import annotations

from math import prod
from typing import Sequence, Tuple

F32 = 4

Count = Tuple[float, float]   # (bytes, operations)


def taps(sigma: float, truncate: float = 4.0) -> int:
    """Length of the sampled Gaussian kernel of ``sigma``."""
    return 2 * int(truncate * float(sigma) + 0.5) + 1


def log_pyramid(shape: Sequence[int], sigmas: Sequence[float],
                truncate: float = 4.0) -> Count:
    """The normalised LoG stack of a float32 ``(Z, Y, X)`` volume at
    ``sigmas``: the volume read, the ``(S, Z, Y, X)`` stack written; per
    sigma and voxel the 7 separable passes that the three second
    derivatives need when they share their order-0 passes (x: G0 and
    K2; y: G0 of both and K2 of the first; z: K2 of one sum, G0 of the
    other), each ``taps`` multiplies and adds, then 2 adds and the
    scaling."""
    vox = prod(int(s) for s in shape)
    ops = vox * sum(7 * 2 * taps(s, truncate) + 3 for s in sigmas)
    return float(vox * F32 * (1 + len(sigmas))), float(ops)


def peak_candidates(cube_shape: Sequence[int], candidates: int) -> Count:
    """K1 on a float32 ``(S, Z, Y, X)`` cube: the cube read; each peak's
    value (4 bytes) and flat index (8) and the count written; per voxel a
    separable 3^4 maximum (2 comparisons an axis), the equality and the
    threshold test."""
    vox = prod(int(s) for s in cube_shape)
    return float(vox * F32 + 12 * candidates + 4), float(10 * vox)


def extract_candidates(rows: int) -> Count:
    """K2 on ``(rows, 128)`` float32: the rows read, 8 values (4 bytes)
    and lanes (4) a row written; per value 3 comparisons into a heap of
    8."""
    return float(rows * 128 * F32 + rows * 8 * 8), float(rows * 128 * 3)


def prune_overlap(capacity: int, valid: int) -> Count:
    """K3 on a buffer of ``capacity`` rows of which ``valid`` are valid:
    coordinates (12 bytes), sigma (4) and the flag (1) read, the flag
    written; 40 operations for each pair of valid rows."""
    pairs = valid * (valid - 1) // 2
    return float(capacity * 18), float(40 * pairs)


def tile_percentiles(tiles: int, values: int, itemsize: int) -> Count:
    """K4 on a ``(tiles, values)`` matrix: the matrix read, two float32
    percentiles a row written; one comparison a value."""
    return float(tiles * values * itemsize + tiles * 2 * F32), float(
        tiles * values)
