"""The comparisons that decide ``correct``.

Blob rows are compared whole, all 10 columns as the values they are:
a row counts as matched when the other side holds an equal row, as
often as it holds it. ``row_diff`` is the share of unmatched rows, the
program's and the reference's together, over the reference's rows.
"""

from __future__ import annotations

import bisect
from collections import Counter
from typing import Optional, Tuple

import numpy as np


def _rows(rows: Optional[np.ndarray]) -> Counter:
    if rows is None:
        return Counter()
    return Counter(map(tuple, np.asarray(rows, np.float64).tolist()))


def unmatched(prog: Optional[np.ndarray], ref: Optional[np.ndarray]
              ) -> Tuple[int, int]:
    """``(rows without an equal row on the other side, reference
    rows)``."""
    a, b = _rows(prog), _rows(ref)
    return sum(((a - b) + (b - a)).values()), sum(b.values())


def share(missing: int, total: int) -> float:
    """``missing / total``; 1.0 where the reference has no rows and the
    program has some."""
    if total:
        return missing / total
    return 1.0 if missing else 0.0


def out_of_order(prog: Optional[np.ndarray], ref: Optional[np.ndarray]
                 ) -> int:
    """Rows that both sides hold but in another order: the matched rows
    less the longest run of them that is in the reference's order on the
    program's side too (rows are distinct on each side)."""
    if prog is None or ref is None:
        return 0
    where = {row: k for k, row in enumerate(
        map(tuple, np.asarray(ref, np.float64).tolist()))}
    seq = [where[row] for row in map(
        tuple, np.asarray(prog, np.float64).tolist()) if row in where]
    tails: list = []
    for v in seq:
        i = bisect.bisect_left(tails, v)
        if i == len(tails):
            tails.append(v)
        else:
            tails[i] = v
    return len(seq) - len(tails)
