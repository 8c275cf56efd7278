"""Detection verification against ground truth (optimal matching).

Copy of ``verify_stack``, ``verify_rois``, ``match_blobs_roi`` and
``meas_detection_accuracy`` and what they call from
``magellanmapper_tpu/cv/verifier.py``: a one-to-one assignment of
detected to truth blobs on tolerance-scaled distance (whole sets, or an
ROI's inner region with a rescue from its border), then sensitivity and
PPV. Matching runs on the host (scipy ``linear_sum_assignment``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import optimize
from scipy.spatial import distance

from magellanmapper_torch.cv import blobs as blobs_mod
from magellanmapper_torch.utils import profiler

#: radius at or above which a truth blob counts as detected
POS_THRESH = 0


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
    with profiler.annotate("mm.verify.assign"):
        profiler.count("cells", dists.size)
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


def _collect_matches(blobs, blobs_base, found, found_base, dists):
    return [
        (blobs_base[fb], blobs[f], d)
        for f, fb, d in zip(found, found_base, dists)]


def match_blobs_roi(
        blobs: np.ndarray, blobs_base: np.ndarray, offset: Sequence[int],
        size: Sequence[int], thresh: float, scaling: Sequence[float],
        inner_padding: Sequence[float],
        resize: Optional[Sequence[float]] = None):
    """Match ``blobs`` to ``blobs_base`` in an ROI (``offset``/``size``
    x,y,z): blobs of the inner region (the ROI less ``inner_padding``)
    first, then base blobs missed there rescued by blobs of the border.

    Sets ``confirmed`` (column 4) on the matched detections and ``truth``
    (column 5) on the matched base blobs; returns ``(blobs_inner_plus,
    blobs_truth_inner_plus, offset_inner, size_inner, matches)``, each
    match a ``(base blob, blob, distance)`` tuple.
    """
    inner_padding = np.clip(
        inner_padding, 0, np.clip(np.ceil(np.divide(size, 2) - 1), 0, None))
    size_inner = np.subtract(size, inner_padding * 2)
    offset_inner = np.add(offset, inner_padding)

    blobs_roi, _ = blobs_mod.get_blobs_in_roi(blobs, offset, size)
    blobs_inner, blobs_inner_mask = blobs_mod.get_blobs_in_roi(
        blobs_roi, offset_inner, size_inner)
    blobs_base_roi, _ = blobs_mod.get_blobs_in_roi(blobs_base, offset, size)
    _, blobs_base_inner_mask = blobs_mod.get_blobs_in_roi(
        blobs_base_roi, offset_inner, size_inner)

    found, found_base, dists = find_closest_blobs_cdist(
        blobs_inner, blobs_base_roi, thresh, scaling)
    blobs_inner[:, 4] = 0
    blobs_inner[found, 4] = 1
    blobs_base_roi[blobs_base_inner_mask, 5] = 0
    blobs_base_roi[found_base, 5] = 1

    # rescue base blobs missed in the inner ROI with the border's blobs
    blobs_base_inner_missed = blobs_base_roi[blobs_base_roi[:, 5] == 0]
    blobs_outer = blobs_roi[~blobs_inner_mask]
    found_out, found_base_out, dists_out = find_closest_blobs_cdist(
        blobs_outer, blobs_base_inner_missed, thresh, scaling)
    blobs_base_inner_missed[found_base_out, 5] = 1

    blobs_truth_inner_plus = np.concatenate(
        (blobs_base_roi[blobs_base_roi[:, 5] == 1],
         blobs_base_inner_missed))
    blobs_outer[found_out, 4] = 1
    blobs_inner_plus = np.concatenate((blobs_inner, blobs_outer[found_out]))

    matches = (_collect_matches(
        blobs_inner, blobs_base_roi, found, found_base, dists)
        + _collect_matches(
            blobs_outer, blobs_base_inner_missed, found_out, found_base_out,
            dists_out))
    return (blobs_inner_plus, blobs_truth_inner_plus, offset_inner,
            size_inner, matches)


def calc_sens_ppv(
        pos: int, true_pos: int, false_pos: int, false_neg: int
) -> Tuple[float, float, str]:
    """Sensitivity and PPV, and a summary message."""
    sens = true_pos / (true_pos + false_neg) if true_pos + false_neg else 0.0
    ppv = true_pos / (true_pos + false_pos) if true_pos + false_pos else 0.0
    msg = (f"pos: {pos}, true pos: {true_pos}, false pos: {false_pos}, "
           f"false neg: {false_neg}\nsensitivity: {sens}\nPPV: {ppv}")
    return sens, ppv, msg


def meas_detection_accuracy(
        blobs: np.ndarray, verified: bool = False, treat_maybes: int = 0
) -> Tuple[Optional[float], Optional[float], Optional[str]]:
    """Sensitivity, PPV and a message from the blobs' confirmation flags
    (``verified``: truth rows carry ``truth >= 0``; ``treat_maybes`` 1
    counts confirmed = 2 as true, 2 as false)."""
    if blobs is None or len(blobs) < 1:
        return None, None, None
    if verified:
        blobs_pos = blobs[blobs[:, 5] >= 0]
        blobs_detected = blobs[blobs[:, 5] == -1]
        blobs_true_detected = blobs_detected[blobs_detected[:, 4] == 1]
        blobs_false = blobs[blobs[:, 4] == 0]
    else:
        blobs_pos = blobs[blobs[:, 4] == 1]
        blobs_true_detected = blobs_pos[blobs_pos[:, 3] >= POS_THRESH]
        blobs_false = blobs[blobs[:, 4] == 0]
    all_pos = len(blobs_pos)
    true_pos = len(blobs_true_detected)
    false_pos = len(blobs_false)
    if not verified and treat_maybes:
        blobs_maybe = blobs[blobs[:, 4] == 2]
        maybe_det = blobs_maybe[blobs_maybe[:, 3] >= POS_THRESH]
        if treat_maybes == 1:
            all_pos += len(maybe_det)
            true_pos += len(maybe_det)
        else:
            all_pos += len(blobs_maybe) - len(maybe_det)
            false_pos += len(maybe_det)
    false_neg = all_pos - true_pos
    return calc_sens_ppv(all_pos, true_pos, false_pos, false_neg)


@profiler.annotated("mm.verify")
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


def verify_rois(
        rois, blobs: np.ndarray, blobs_truth: np.ndarray,
        tol, output_db, exp_name: str,
        channel: Optional[Sequence[int]] = None):
    """Verify detections against the truth of each ROI, channel by
    channel, inserting each ROI's matched blobs (column 4 marking true
    and false positives) into ``output_db`` (an ``io.sqlite.ClrDB``).

    ``rois`` are sqlite ROI rows (``offset_x/y/z``, ``size_x/y/z``);
    blobs hold absolute z,y,x coordinates; ``tol`` is z,y,x. Returns the
    ``[positives, true positives, false positives]`` totals and the
    summary message of :func:`calc_sens_ppv`.
    """
    thresh, scaling, inner_padding, *_ = setup_match_blobs_roi(tol)
    exp_id = output_db.select_or_insert_experiment(exp_name)
    channels = (np.unique(blobs_mod.Blobs.get_blobs_channel(
        blobs)).astype(int) if channel is None
        else np.atleast_1d(channel))
    total = np.zeros(3, dtype=int)
    for roi in rois:
        offset = (roi["offset_x"], roi["offset_y"], roi["offset_z"])
        size = (roi["size_x"], roi["size_y"], roi["size_z"])
        roi_id, _ = output_db.select_or_insert_roi(
            exp_id, 0, offset, size)
        for chl in channels:
            b_chl = blobs_mod.Blobs.blobs_in_channel(blobs, chl)
            t_chl = blobs_mod.Blobs.blobs_in_channel(blobs_truth, chl)
            inner_plus, truth_plus, off_in, size_in, matches = \
                match_blobs_roi(
                    np.array(b_chl), np.array(t_chl), offset, size,
                    thresh, scaling, inner_padding)
            pos = len(truth_plus)
            true_pos = int(np.sum(inner_plus[:, 4] == 1))
            false_pos = int(np.sum(inner_plus[:, 4] == 0))
            total += (pos, true_pos, false_pos)
            if len(inner_plus):
                output_db.insert_blobs(roi_id, inner_plus)
    sens, ppv, msg = calc_sens_ppv(
        total[0], total[1], total[2], total[0] - total[1])
    return total, msg
