"""3D Laplacian-of-Gaussian blob detection of one block on PyTorch.

Port of ``magellanmapper_tpu/cv/detector.py``: the pure-numpy helpers
(overlap pruning within and between blob arrays, blob surroundings,
pruning ratios) are copied, and :func:`blob_log` runs the LoG
pyramid (fp32 GEMMs), peak finding (kernel K1) and sphere-overlap
pruning (kernel K3) on the device of its input. :func:`blob_log_multi`
runs a threshold sweep on one pyramid through the unfused peak route
(kernel K2), then K3 per threshold; :func:`blob_log_multi_sharded` deals
the sweep's thresholds over the ranks of a mesh. :func:`detect_blobs` is the
reference's single-block entry: isotropic resample, unmixing and
preprocessing around :func:`blob_log`. A profile's ``log_dtype:
bfloat16`` (:func:`is_fast`) runs the LoG's band products as TF32 on the
card (the reference's ``fast`` route, one bf16 pass on the TPU).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.cv import blobs as blobs_mod
from magellanmapper_torch.ops import filters, peaks, preproc, resize
from magellanmapper_torch.parallel import comm, mesh as mesh_mod
from magellanmapper_torch.utils import profiler

#: overlap factor for block halos (reference ``detector.py:41``).
OVERLAP_FACTOR = 5


def calc_scaling_factor(resolutions: Sequence[float]) -> np.ndarray:
    """Pixels-per-um factor, ``1 / resolutions`` in z,y,x."""
    res = np.asarray(resolutions, dtype=float)
    if res.ndim > 1:
        res = res[0]
    return 1.0 / res


def calc_overlap(
        resolutions: Sequence[float], factor: Optional[float] = None
) -> np.ndarray:
    """Block halo width in px per axis."""
    if factor is None:
        factor = OVERLAP_FACTOR
    return np.ceil(calc_scaling_factor(resolutions) * factor).astype(int)


def sigma_list(
        min_sigma: float, max_sigma: float, num_sigma: int) -> np.ndarray:
    """Linearly spaced LoG scales (skimage ``blob_log`` semantics)."""
    if num_sigma <= 1:
        return np.asarray([float(min_sigma)])
    return np.linspace(float(min_sigma), float(max_sigma), int(num_sigma))


def profile_sigmas(settings, resolutions: Sequence[float]
                   ) -> Tuple[float, ...]:
    """A profile's LoG scales: its sigma factors in pixels at the x
    spacing of ``resolutions``."""
    scaling_factor = calc_scaling_factor(resolutions)[2]
    return tuple(float(s) for s in sigma_list(
        settings["min_sigma_factor"] * scaling_factor,
        settings["max_sigma_factor"] * scaling_factor,
        settings["num_sigma"]))


def rows_to_blobs(raw: np.ndarray, channel) -> np.ndarray:
    """Device rows ``z, y, x, sigma`` as the ``N x 10`` blobs of
    ``channel``, radius = sigma * sqrt(3) (reference
    ``detector.py:257-258``); scales ``raw``'s sigmas in place."""
    raw[:, 3] *= math.sqrt(3)
    return blobs_mod.Blobs(raw).format_blobs(channel)


def is_fast(settings) -> bool:
    """True when a profile asks for the fast LoG (``log_dtype``
    ``"bfloat16"``)."""
    return str(settings["log_dtype"]).lower() == "bfloat16"


def blob_log(
        roi: torch.Tensor, sigmas: Sequence[float], threshold: float,
        overlap: float, capacity: int, fast: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """LoG blob detection on a single-channel ``(Z, Y, X)`` block;
    ``fast`` runs the LoG's band products at the fast route's precision
    (``filters.FAST_PRECISION``: TF32 on the card, float32 on the CPU).

    Returns ``blobs`` ``(capacity, 4)`` float32 rows ``z, y, x, sigma``,
    ``valid`` ``(capacity,)`` bool, and the PRE-prune peak count: pruning
    runs after the capacity cut, so a truncated block can show fewer valid
    rows than ``capacity``, and overflow retries gate on this count.
    """
    roi = roi.to(torch.float32)
    with profiler.annotate("mm.log"):
        cube = filters.log_pyramid(
            roi, sigmas, precision=filters.FAST_PRECISION if fast else None)
    with profiler.annotate("mm.peaks"):
        coords4, _, count = peaks.find_peaks(cube, threshold, capacity)
        valid = torch.arange(capacity, device=roi.device) < count
        sig = filters.sigma_tensor(
            tuple(float(s) for s in sigmas), roi.device)[coords4[:, 0].long()]
        coords = coords4[:, 1:].to(torch.float32).contiguous()
    with profiler.annotate("mm.overlap"):
        valid = peaks.prune_overlapping_blobs(
            coords, sig, valid, overlap, ndim=roi.dim())
    return torch.cat([coords, sig[:, None]], dim=1), valid, count


def blob_log_multi(
        roi: torch.Tensor, sigmas: Sequence[float],
        thresholds: Sequence[float], overlap: float, capacity: int,
        fast: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """LoG detection at K thresholds sharing one LoG pyramid
    (``detector.py:96-131``), built at the ``fast`` route's precision
    when asked (:func:`blob_log`).

    The local-maximum mask is computed once; each threshold masks it,
    and the K masked fields go through one launch of K2
    (``peaks.find_peaks_unfused``). Per threshold the peaks' sigmas are
    looked up and K3 prunes overlapping spheres. Thresholds are rounded
    to float32, as the reference's traced threshold vector is.

    Returns ``(K, capacity, 4)`` float32 rows ``z, y, x, sigma`` and
    ``(K, capacity)`` validity. A row is valid when it is within the
    peak count AND its value is finite: a 128-lane group holding more
    than 8 peaks yields only 8, and the reference (``:124``) keeps the
    missing ones as valid rows at the origin.
    """
    roi = roi.to(torch.float32)
    sigmas = tuple(float(s) for s in sigmas)
    with profiler.annotate("mm.log"):
        cube = filters.log_pyramid(
            roi, sigmas, precision=filters.FAST_PRECISION if fast else None)
    sig_lut = filters.sigma_tensor(sigmas, roi.device)
    ths = [float(t) for t in np.asarray(thresholds, np.float32)]
    first = torch.arange(capacity, device=roi.device)
    rows, valids = [], []
    with profiler.annotate("mm.harvest"):
        found = peaks.find_peaks_unfused(cube, ths, capacity)
    for coords4, values, count in found:
        valid = (first < count) & torch.isfinite(values)
        sig = sig_lut[coords4[:, 0].long()]
        coords = coords4[:, 1:].to(torch.float32).contiguous()
        with profiler.annotate("mm.overlap"):
            valid = peaks.prune_overlapping_blobs(
                coords, sig, valid, overlap, ndim=roi.dim())
        rows.append(torch.cat([coords, sig[:, None]], dim=1))
        valids.append(valid)
    return torch.stack(rows), torch.stack(valids)


def blob_log_multi_sharded(
        roi, sigmas: Sequence[float], thresholds, overlap: float,
        capacity: int, mesh, fast: bool = False,
        axis_name: Optional[str] = None, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`blob_log_multi` with the thresholds dealt over a mesh axis
    (``detector.py:134-171``): every rank builds the same LoG pyramid of
    ``roi`` on ``device``, harvests its contiguous share of the threshold
    list (K2, then K3 per threshold) and the shares are gathered, so that
    every rank returns every row. The list is padded to a multiple of the
    axis size (``axis_name``, default the mesh's first) by repeating its
    last value; only the real rows return, as host arrays ``(K, capacity,
    4)`` and ``(K, capacity)``."""
    axis = axis_name or mesh_mod.AXES[0]
    n = mesh_mod.axis_size(mesh, axis)
    thr = [float(t) for t in np.asarray(thresholds, np.float32)]
    k_real = len(thr)
    if not k_real:
        raise ValueError("no thresholds")
    thr += [thr[-1]] * ((-k_real) % n)
    per = len(thr) // n
    i0 = mesh_mod.axis_index(mesh, axis) * per
    if torch.is_tensor(roi):
        roi_t = roi.to(device_mod.resolve(device))
    else:
        roi_t = torch.from_numpy(np.array(roi, np.float32)).to(
            device_mod.resolve(device))
    rows, valids = blob_log_multi(
        roi_t, sigmas, thr[i0:i0 + per], overlap, capacity, fast=fast)
    both = torch.cat([rows, valids[..., None].to(rows.dtype)], dim=-1)
    both = comm.all_gather(both, mesh, axis).cpu().numpy()[:k_real]
    return both[..., :4], both[..., 4] > 0


def detect_blobs(
        roi: np.ndarray, settings, resolutions: Sequence[float],
        channel: Optional[Sequence[int]] = None,
        exclude_border: Optional[Sequence[int]] = None,
        near_max: Optional[Sequence[float]] = None,
        preprocess: bool = False, channel_settings=None,
        device="cuda") -> Optional[np.ndarray]:
    """Detect blobs in one ``(Z, Y, X[, C])`` block on ``device``
    (``detector.py:173-273``): an optional isotropic resample, spectral
    unmixing, per-channel saturate and denoise with ``preprocess``, then
    :func:`blob_log`; rows come back in the block's anisotropic voxels as
    the ``N x 10`` array of :class:`blobs_mod.Blobs`, or None when nothing
    was found. ``exclude_border`` drops blobs within that z,y,x padding of
    the block's edges."""
    dev = device_mod.resolve(device)
    shape = roi.shape
    multichannel = roi.ndim > 3
    channels = (list(range(shape[3])) if multichannel else [0]) \
        if channel is None else list(np.atleast_1d(channel))

    def get_settings(chl):
        if channel_settings is not None:
            try:
                return channel_settings[chl]
            except (IndexError, KeyError, TypeError):
                pass
        return settings

    vol = torch.from_numpy(np.array(roi, np.float32)).to(dev)
    isotropic = get_settings(channels[0])["isotropic"]
    iso_factor = None
    if isotropic is not None:
        iso_factor = resize.calc_isotropic_factor(isotropic, resolutions)
        vol = resize.make_isotropic(vol, isotropic, resolutions)

    blobs_all = []
    for chl in channels:
        roi_detect = vol[..., chl] if multichannel else vol
        chl_set = get_settings(chl)
        unmix = chl_set["spectral_unmixing"]
        if unmix and chl in unmix:
            for subt_chl, subt_fac in unmix[chl].items():
                roi_detect = preproc.spectral_unmix(
                    roi_detect, vol[..., subt_chl], subt_fac)
        if preprocess:
            nm = 1.0 if near_max is None else float(near_max[chl])
            roi_detect = preproc.saturate(
                roi_detect, chl_set["clip_vmin"], chl_set["clip_vmax"],
                nm * chl_set["max_thresh_factor"])
            roi_detect = preproc.denoise(
                roi_detect, chl_set["clip_min"], chl_set["clip_max"],
                chl_set["tot_var_denoise"], chl_set["unsharp_strength"],
                chl_set["erosion_threshold"])
        raw, valid, _ = blob_log(
            roi_detect.contiguous(), profile_sigmas(chl_set, resolutions),
            float(chl_set["detection_threshold"]), float(chl_set["overlap"]),
            int(chl_set["max_blobs_per_block"] or 4096),
            fast=is_fast(chl_set))
        raw = raw[valid].cpu().numpy()
        if raw.shape[0] < 1:
            continue
        blobs_all.append(rows_to_blobs(raw, chl))

    if not blobs_all:
        return None
    out = np.vstack(blobs_all)
    if iso_factor is not None:
        # coordinates back into the block's anisotropic voxels
        out = blobs_mod.Blobs.multiply_blob_rel_coords(out, 1 / iso_factor)
        out = blobs_mod.Blobs.multiply_blob_abs_coords(out, 1 / iso_factor)
    if exclude_border is not None:
        out = blobs_mod.get_blobs_interior(
            out, shape[:3], exclude_border, exclude_border)
    return out


def remove_close_blobs(
        blobs: np.ndarray, blobs_master: np.ndarray, tol: Sequence[float]
) -> Tuple[np.ndarray, np.ndarray]:
    """Prune blobs within ``tol`` of any master blob; averages abs coords
    (the reference's host helper, with its pairs found in a sorted window).

    The master rows are sorted on the coordinate column they spread most
    in; each checked row's candidates are the masters whose key lies
    within that axis' ``tol`` plus 1 (the margin only filters, so float
    rounding at the window's edges drops no pair), and the reference's
    exact test decides among them. The pairs keep ``np.nonzero``'s order,
    by master then checked row, so a master matched twice keeps its last
    pair's mean. Counts the pairs tested as ``candidates``."""
    if len(blobs) < 1 or len(blobs_master) < 1:
        profiler.count("candidates", 0)
        return blobs, blobs_master
    tol = np.asarray(tol)
    master = blobs_master[:, :3]
    check = blobs[:, :3]
    key = int(np.argmax(np.ptp(master, axis=0)))
    tol_key = np.broadcast_to(tol, (3,))[key]
    order = np.argsort(master[:, key], kind="stable")
    keys = master[order, key]
    lo = np.searchsorted(keys, check[:, key] - tol_key - 1, side="left")
    hi = np.searchsorted(keys, check[:, key] + tol_key + 1, side="right")
    sizes = np.maximum(hi - lo, 0)
    n = int(sizes.sum())
    profiler.count("candidates", n)
    # every checked row against each master in its window
    cand = np.repeat(np.arange(len(check)), sizes)
    firsts = np.repeat(lo - (np.cumsum(sizes) - sizes), sizes)
    cand_master = order[firsts + np.arange(n)]
    hit = (np.abs(master[cand_master] - check[cand]) <= tol).all(1)
    close_master, close = cand_master[hit], cand[hit]
    by_master = np.lexsort((close, close_master))
    close_master, close = close_master[by_master], close[by_master]
    pruned = np.delete(blobs, close, axis=0)
    if len(close) > 0:
        B = blobs_mod.Blobs
        abs_between = np.around((
            B.get_blob_abs_coords(blobs_master[close_master])
            + B.get_blob_abs_coords(blobs[close])) / 2)
        blobs_master[close_master] = B.set_blob_abs_coords(
            blobs_master[close_master], abs_between)
    return pruned, blobs_master


def remove_close_blobs_within_sorted_array(
        blobs: Optional[np.ndarray], tol: Sequence[float]
) -> Optional[np.ndarray]:
    """Accept z,y,x-sorted blobs one by one, each only if no accepted
    blob lies within ``tol``; a duplicate moves the last matching kept
    blob's absolute coordinates to the pair's rounded mean (copy of the
    reference's host helper)."""
    if blobs is None or len(blobs) < 1:
        return None if blobs is None else blobs
    sorted_blobs, _ = blobs_mod.sort_blobs(blobs)
    tol = np.asarray(tol, dtype=float)
    kept: list = []
    kept_coords: list = []
    B = blobs_mod.Blobs
    for blob in sorted_blobs:
        if kept_coords:
            diffs = np.abs(np.asarray(kept_coords) - blob[:3])
            matches = np.nonzero((diffs <= tol).all(axis=1))[0]
            if matches.size > 0:
                i = matches[-1]
                mean_abs = np.around((
                    B.get_blob_abs_coords(kept[i][None])
                    + B.get_blob_abs_coords(blob[None])) / 2)
                B.set_blob_abs_coords(kept[i][None], mean_abs)
                continue
        kept.append(blob.copy())
        kept_coords.append(blob[:3])
    return np.asarray(kept)


def blob_surroundings(
        blob: np.ndarray, roi: np.ndarray, padding: int = 1,
        plane: bool = False) -> np.ndarray:
    """The ROI's voxels within a blob's radius plus ``padding``; with
    ``plane``, only the blob's centre z-plane."""
    rad = blob[3]
    start = np.maximum(np.subtract(blob[:3], rad + padding), 0).astype(int)
    end = np.minimum(
        np.add(blob[:3], rad + padding).astype(int),
        np.subtract(roi.shape[:3], 1))
    if plane:
        z = int(np.clip(blob[0], 0, roi.shape[0] - 1))
        return roi[z, start[1]:end[1], start[2]:end[2]]
    return roi[start[0]:end[0], start[1]:end[1], start[2]:end[2]]


def show_blob_surroundings(
        blobs: np.ndarray, roi: np.ndarray, padding: int = 1) -> None:
    """Print each blob's surrounding plane."""
    np.set_printoptions(precision=2, linewidth=200)
    for blob in blobs:
        print(f"{blob} surroundings:")
        print(blob_surroundings(blob, roi, padding, True))
    np.set_printoptions()


def remove_close_blobs_within_array(blobs, region, tol):
    """Greedy self-pruning: keep each blob only if no already-kept blob
    lies within ``tol`` in the columns ``region``."""
    if blobs is None:
        return None
    kept = None
    for blob in blobs:
        if kept is None:
            kept = np.array([blob])
        else:
            diff = np.abs(kept[:, region] - blob[region])
            if not np.any(np.all(diff <= tol, axis=1)):
                kept = np.concatenate([kept, [blob]])
    return kept


def meas_pruning_ratio(
        num_blobs_orig: int, num_blobs_after_pruning: int,
        num_blobs_next: int):
    """Pruning ratios ``(original count, pruned / original, pruned /
    next)``, None without blobs."""
    if num_blobs_next <= 0 or num_blobs_orig <= 0:
        return None
    return (num_blobs_orig,
            num_blobs_after_pruning / num_blobs_orig,
            num_blobs_after_pruning / num_blobs_next)
