"""Detection verification against ground truth (optimal matching).

Copy of ``verify_stack`` and what it calls from
``magellanmapper_tpu/cv/verifier.py``: a one-to-one assignment of
detected to truth blobs on tolerance-scaled distance, then sensitivity
and PPV. Matching runs on the host (scipy ``linear_sum_assignment``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import optimize
from scipy.spatial import distance

from magellanmapper_torch.cv import blobs as blobs_mod


def find_closest_blobs_cdist(
        blobs: np.ndarray, blobs_master: np.ndarray,
        thresh: Optional[float] = None,
        scaling: Optional[Sequence[float]] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Optimal closest-blob assignment.

    Returns row indices into ``blobs``, column indices into
    ``blobs_master``, and their distances, filtered to ``< thresh``.
    """
    if len(blobs) == 0 or len(blobs_master) == 0:
        empty = np.zeros(0, dtype=int)
        return empty, empty, np.zeros(0)
    a = blobs[:, :3].astype(float)
    b = blobs_master[:, :3].astype(float)
    if scaling is not None:
        n = len(scaling)
        a = blobs[:, :n] * scaling
        b = blobs_master[:, :n] * scaling
    dists = distance.cdist(a, b)
    rowis, colis = optimize.linear_sum_assignment(dists)
    dists_closest = dists[rowis, colis]
    if thresh is not None:
        keep = dists_closest < thresh
        rowis, colis = rowis[keep], colis[keep]
        dists_closest = dists_closest[keep]
    return rowis, colis, dists_closest


def setup_match_blobs_roi(
        tol: Sequence[float], blobs: Optional[np.ndarray] = None,
        resize: Optional[Sequence[float]] = None):
    """Tolerance setup: the match threshold, the isotropizing scaling
    from per-axis tolerances, the inner padding, ``resize``, and
    ``blobs`` with relative coordinates multiplied by ``resize``."""
    tol = np.asarray(tol, dtype=float)
    thresh = float(np.amax(tol))
    scaling = thresh / tol
    inner_padding = np.floor(tol[::-1])
    blobs_roi = blobs
    if resize is not None and blobs_roi is not None:
        blobs_roi = blobs_mod.Blobs.multiply_blob_rel_coords(
            blobs_roi, resize)
    return thresh, scaling, inner_padding, resize, blobs_roi


def calc_sens_ppv(
        pos: int, true_pos: int, false_pos: int, false_neg: int
) -> Tuple[float, float, str]:
    """Sensitivity and PPV, and a summary message."""
    sens = true_pos / (true_pos + false_neg) if true_pos + false_neg else 0.0
    ppv = true_pos / (true_pos + false_pos) if true_pos + false_pos else 0.0
    msg = (f"pos: {pos}, true pos: {true_pos}, false pos: {false_pos}, "
           f"false neg: {false_neg}\nsensitivity: {sens}\nPPV: {ppv}")
    return sens, ppv, msg


def verify_stack(
        blobs: np.ndarray, blobs_truth: np.ndarray, tol: Sequence[float]
) -> Tuple[float, float, str]:
    """Whole-set verification: match detections to truth and report
    sensitivity, PPV and a summary message."""
    thresh, scaling, *_ = setup_match_blobs_roi(tol)
    found, _, _ = find_closest_blobs_cdist(
        blobs, blobs_truth, thresh, scaling)
    true_pos = len(found)
    false_pos = len(blobs) - true_pos
    false_neg = len(blobs_truth) - true_pos
    return calc_sens_ppv(
        len(blobs_truth), true_pos, false_pos, false_neg)
