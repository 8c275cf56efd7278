"""Hyperparameter grid search over detection profiles on PyTorch.

Port of ``magellanmapper_tpu/stats/mlearn.py``: :func:`grid_search`
sweeps profile value grids, detecting and verifying against truth blobs
per combination, and
:func:`grid_search_from_cli` is the ``--grid_search`` task. A sweep whose
only detection key is the threshold, over a single-channel ROI, runs every
threshold of a combination on one LoG pyramid
(:func:`make_fn_detect_multi` → ``cv.detector.blob_log_multi``, kernels K2
and K3); any other sweep re-runs block detection per combination.
"""

from __future__ import annotations

import itertools
import logging
import math
from collections import OrderedDict
from enum import Enum
from typing import Callable, Sequence, Union

import numpy as np
import pandas as pd
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.cv import blobs as blobs_mod
from magellanmapper_torch.cv import detector, stack_detect, verifier
from magellanmapper_torch.io import np_io, sqlite
from magellanmapper_torch.parallel import mesh as mesh_mod
from magellanmapper_torch.settings.grid_search_prof import GridSearchProfile
from magellanmapper_torch.settings.roi_prof import ROIProfile
from magellanmapper_torch.utils import profiler

_logger = logging.getLogger(__name__)

#: the score columns of each grid-search row
GRID_SEARCH_STATS = ("POS", "TP", "FP", "FN", "FDR", "SENS", "PPV")

#: hyperparameter key the batched detection path can sweep on one pyramid
MULTI_SWEEP_KEY = "detection_threshold"

#: profile keys the batched-threshold path honors; a grid or base
#: profile touching detection keys OUTSIDE this set must use the plain
#: per-combination path (the multi path would silently ignore them)
MULTI_SUPPORTED_KEYS = frozenset((
    "detection_threshold", "min_sigma_factor", "max_sigma_factor",
    "num_sigma", "overlap", "max_blobs_per_block", "log_dtype"))


@profiler.annotated("mm.grid_search")
def grid_search(
        hyperparams: "OrderedDict[str, Sequence]",
        fn_detect: Callable[[dict], np.ndarray],
        blobs_truth: np.ndarray,
        tol: Sequence[float],
        fn_detect_multi: Callable[
            [dict, Sequence[float]], Sequence[np.ndarray]] = None
) -> pd.DataFrame:
    """Sweep hyperparameter combinations, verifying each against truth
    (copy of the reference's).

    Args:
        hyperparams: ordered mapping of profile key -> values to sweep.
        fn_detect: callback taking the parameter-override dict and
            returning detected blobs (N x >=3).
        blobs_truth: ground-truth blobs.
        tol: per-axis match tolerance.
        fn_detect_multi: optional batched callback
            ``(other_overrides, thresholds) -> [blobs per threshold]``;
            when the grid includes :data:`MULTI_SWEEP_KEY`, all its values
            for a given combination of the OTHER keys run as one call.

    Returns:
        DataFrame with one row per combination: the swept values plus
        POS/TP/FP/FN/FDR/SENS/PPV.
    """
    keys = list(hyperparams)

    def score(overrides, blobs):
        n_det = 0 if blobs is None else len(blobs)
        pos = len(blobs_truth)
        if n_det:
            sens, ppv, _ = verifier.verify_stack(blobs, blobs_truth, tol)
            tp = int(round(sens * pos))
            fp = n_det - tp
        else:
            sens = ppv = 0.0
            tp = 0
            fp = 0
        fn = pos - tp
        fdr = fp / n_det if n_det else 0.0
        row = dict(overrides)
        row.update(zip(GRID_SEARCH_STATS, (pos, tp, fp, fn, fdr, sens, ppv)))
        _logger.info("grid combo %s: sens %.3f ppv %.3f", overrides,
                     sens, ppv)
        return row

    rows = []
    if fn_detect_multi is not None and MULTI_SWEEP_KEY in keys:
        thresholds = list(hyperparams[MULTI_SWEEP_KEY])
        other_keys = [k for k in keys if k != MULTI_SWEEP_KEY]
        for combo in itertools.product(
                *(hyperparams[k] for k in other_keys)):
            other = dict(zip(other_keys, combo))
            with profiler.annotate("mm.detect_multi"):
                blobs_per_thr = fn_detect_multi(other, thresholds)
            for thr, blobs in zip(thresholds, blobs_per_thr):
                # preserve the grid's original key order in the rows
                overrides = {
                    k: (thr if k == MULTI_SWEEP_KEY else other[k])
                    for k in keys}
                rows.append(score(overrides, blobs))
        return pd.DataFrame(rows)

    for combo in itertools.product(*hyperparams.values()):
        overrides = dict(zip(keys, combo))
        rows.append(score(overrides, fn_detect(overrides)))
    return pd.DataFrame(rows)


def make_fn_detect_multi(
        vol: np.ndarray, res: Sequence[float], base_profile=None,
        device: Union[str, torch.device] = "cuda", mesh=None):
    """A :func:`grid_search` ``fn_detect_multi`` for a single-channel 3D
    ROI on ``device`` (the card unless ``"cpu"`` is asked for; a CUDA
    device without a card raises): all threshold values of one
    combination run through :func:`cv.detector.blob_log_multi` (one LoG
    pyramid), with blob rows formatted as block detection formats them.

    The volume goes to the device once. Capacity and threshold chunks
    follow the reference (``mlearn.py:139-157``): the capacity scales with
    the volume (the block path allots its capacity per block), and a chunk
    holds as many thresholds as keep ``~num_sigma * vol.size * 5`` bytes
    each within 2 GiB, at most 8. The reference pads the last chunk to one
    compiled shape; eager PyTorch has no compile to reuse, so it is not
    padded. With ``mesh``, each chunk's thresholds are dealt over the
    mesh's first axis (:func:`cv.detector.blob_log_multi_sharded`), and a
    chunk holds that many times as many thresholds (the per-rank budget,
    ``mlearn.py:145-161``).
    """
    dev = device_mod.resolve(device)
    vol_t = torch.from_numpy(np.array(vol, np.float32)).to(dev)
    sf = detector.calc_scaling_factor(res)[2]

    def fn(other_overrides, thresholds):
        prof = type(base_profile)() if base_profile is not None \
            else ROIProfile()
        if base_profile is not None:
            prof.update(dict(base_profile))
        prof.update(other_overrides)
        sigmas = tuple(detector.sigma_list(
            prof["min_sigma_factor"] * sf,
            prof["max_sigma_factor"] * sf, prof["num_sigma"]))
        # whole-volume capacity: the blocked path's per-block heuristic
        # (block_voxels // 1024) applied to the full volume
        cap = int(prof["max_blobs_per_block"] or 0)
        cap = max(cap, min(1 << 17, max(4096, vol_t.numel() // 1024)))
        per_thr = len(sigmas) * vol_t.numel() * 5
        k_chunk = int(max(1, min(8, (2 << 30) // max(per_thr, 1))))
        if mesh is not None:
            k_chunk *= mesh_mod.axis_size(mesh, mesh_mod.AXES[0])
        out = []
        for c0 in range(0, len(thresholds), k_chunk):
            chunk = list(thresholds[c0:c0 + k_chunk])
            if mesh is not None:
                raws, valids = detector.blob_log_multi_sharded(
                    vol_t, sigmas, chunk, float(prof["overlap"]), cap,
                    mesh, fast=detector.is_fast(prof), device=dev)
            else:
                raws, valids = detector.blob_log_multi(
                    vol_t, sigmas, chunk, float(prof["overlap"]), cap,
                    fast=detector.is_fast(prof))
                with profiler.annotate("mm.pull"):
                    raws = raws.cpu().numpy()
                    valids = valids.cpu().numpy()
            for k in range(len(chunk)):
                raw = raws[k][valids[k]].copy()
                if not raw.shape[0]:
                    out.append(None)
                    continue
                raw[:, 3] *= math.sqrt(3)   # radius = sigma * sqrt(3)
                out.append(blobs_mod.Blobs(raw).format_blobs(0))
        return out

    return fn


def multi_path_applicable(vol, grid_keys, profile) -> bool:
    """True when :func:`make_fn_detect_multi` reproduces the plain
    path's semantics: single-channel ROI-scale volume, every swept key
    supported, and no base-profile feature the single-shot path skips
    (isotropic resampling, spectral unmixing, border exclusion)."""
    if vol.ndim != 3 or vol.size > (16 << 20):
        return False
    if not set(grid_keys) <= MULTI_SUPPORTED_KEYS:
        return False
    for key in ("isotropic", "spectral_unmixing", "exclude_border"):
        if profile.get(key):
            return False
    return True


def parse_grid_stats(df: pd.DataFrame) -> pd.DataFrame:
    """ROC-style summary sorted by distance to (SENS 1, FDR 0)
    (reference ``parse_grid_stats :110``)."""
    out = df.copy()
    out["Distance"] = np.sqrt(
        (1 - out["SENS"]) ** 2 + out["FDR"] ** 2)
    return out.sort_values("Distance").reset_index(drop=True)


def grid_search_from_cli(
        rc, device: Union[str, torch.device] = "cuda") -> pd.DataFrame:
    """The ``--grid_search`` task (reference ``cli._grid_search``): the
    named grid-search profile over the main image, scored against the
    confirmed blobs of ``--truth_db``, on ``device`` (the card unless
    ``"cpu"`` is asked for); writes ``<prefix or image>_gridsearch.csv``."""
    device = device_mod.resolve(device)
    if not rc.truth_db:
        raise SystemExit("grid search requires --truth_db")
    gs_prof = GridSearchProfile()
    gs_prof.add_profiles(rc.grid_search)
    hyperparams = OrderedDict(gs_prof.get_param_grid())

    img5d = np_io.read_file(rc.filenames[0], rc.series)
    img = img5d.img
    # an image5d archive is (t, z, y, x[, c]); a plain .npy volume has no t
    vol = np.asarray(img[0] if img.ndim >= 4 else img)
    res = (img5d.resolutions[0] if img5d.resolutions is not None
           else (1.0, 1.0, 1.0))

    db = sqlite.load_truth_db(rc.truth_db)
    try:
        truth = db.select_blobs_confirmed(1)
    finally:
        db.close()
    tol = detector.calc_overlap(res) * np.asarray(
        rc.roi_profile["verify_tol_factor"])

    def make_prof(overrides):
        prof = type(rc.roi_profile)()
        prof.update(dict(rc.roi_profile))
        prof.update(overrides)
        return prof

    def fn_detect(overrides):
        blobs, _ = stack_detect.detect_blobs_blocks(
            vol, make_prof(overrides), res, channels=rc.channel,
            preprocess=False, device=device)
        return blobs

    fn_multi = None
    if multi_path_applicable(vol, hyperparams.keys(), rc.roi_profile):
        fn_multi = make_fn_detect_multi(vol, res, rc.roi_profile, device)

    df = grid_search(
        hyperparams, fn_detect, truth, tol, fn_detect_multi=fn_multi)
    df = parse_grid_stats(df)
    out_csv = (rc.prefix or rc.filenames[0]) + "_gridsearch.csv"
    df.to_csv(out_csv, index=False)
    return df


class GridSearchStats(Enum):
    """Grid-search stat columns (reference ``mlearn.GridSearchStats
    :18``)."""
    PARAM = "Par"
    PPV = "PPV"
    SENS = "Sens"
    POS = "Pos"
    TP = "TP"
    FP = "FP"
    TN = "TN"
    FN = "FN"
    FDR = "FDR"
