"""Realistic registration validation gauntlet (synthetic,
ground-truthed), on PyTorch.

Port of ``magellanmapper_tpu/atlas/gauntlet.py:39-511``. The pair it
builds registers an averaged atlas onto a *different specimen*: a smooth
free-form (cubic B-spline FFD) deformation composed on top of an affine,
a nonlinear monotone intensity remap with a multiplicative bias field and
noise on the fixed ("specimen") image, and a 24-region annotation carried
through the known warp at order 0, so overlap, label transfer and warp
error can be scored against the truth. The anatomy and the modality gap
are host numpy (copies of the reference); the two ground-truth warps run
through the port's :mod:`.transform` on the device asked for.
:func:`run_gauntlet_suite` scores several such pairs and a truncated one.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.atlas import metrics, reg_engine, transform
from magellanmapper_torch.io import np_io, sitk_io
from magellanmapper_torch.settings.atlas_prof import (
    AtlasProfile, make_reg_param_map)


def _on(d: Dict, dev) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32).to(dev)
            for k, v in d.items()}


def make_anatomy(
        shape: Sequence[int], n_labels: int = 24, n_blobs: int = 240,
        seed: int = 0, region_contrast: float = 0.6
) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic "atlas": ellipsoid brain w/ blobby texture + label map.

    Returns ``(intensity, labels)``; labels are ``0`` outside the
    anatomy and ``1..n_labels`` inside (a nearest-seed partition, so
    regions are contiguous, irregular, and tile the whole foreground the
    way an ontology annotation does).

    Each region carries its own base intensity (``region_contrast``
    scales the per-region spread) the way real autofluorescence atlases
    do — cortex/white-matter/ventricle brightness differ, and those
    internal edges are exactly what intensity registration locks onto.
    Without them the interior is homogeneous and ANY diffeomorphism of
    the interior matches intensities equally well, so the recovered
    field is unconstrained where label transfer is judged (measured:
    warp error ~= GT displacement with flat interiors, even at dyadic
    grid spacings where representation is exact).
    """
    rng = np.random.default_rng(seed)
    shape = tuple(int(s) for s in shape)
    zz, yy, xx = np.indices(shape).astype(np.float32)
    center = [(s - 1) / 2 for s in shape]
    # ellipsoid with a lumpy radius so the boundary is not analytic
    nz = (zz - center[0]) / (shape[0] * 0.38)
    ny = (yy - center[1]) / (shape[1] * 0.40)
    nx = (xx - center[2]) / (shape[2] * 0.36)
    r2 = nz ** 2 + ny ** 2 + nx ** 2
    lump = (0.12 * np.sin(zz / 17.0) * np.cos(yy / 23.0)
            + 0.10 * np.sin(xx / 19.0 + 1.1))
    mask = r2 < (1.0 + lump)

    # nearest-seed partition of the foreground -> contiguous regions
    seeds = np.column_stack([
        rng.uniform(0.15 * s, 0.85 * s, n_labels) for s in shape])
    fg = np.argwhere(mask)
    from scipy.spatial import cKDTree
    _, idx = cKDTree(seeds).query(fg, k=1)
    labels = np.zeros(shape, np.int32)
    labels[tuple(fg.T)] = idx.astype(np.int32) + 1

    # per-region base level (region_contrast=0 reproduces the flat 0.35)
    levels = 0.35 + region_contrast * (
        rng.uniform(0.0, 1.0, n_labels + 1) - 0.35)
    levels[0] = 0.0
    intensity = levels[labels].astype(np.float32)
    # internal blobby texture (cell-dense nuclei the detector would see)
    coords = np.column_stack(
        [rng.integers(8, s - 8, n_blobs) for s in shape])
    bz, by, bx = np.indices((15, 15, 15)).astype(np.float32) - 7
    for (cz, cy, cx), r in zip(coords, rng.uniform(2.5, 5.0, n_blobs)):
        sig = r / np.sqrt(2)
        stamp = np.exp(-(bz**2 + by**2 + bx**2) / (2 * sig**2))
        intensity[cz-7:cz+8, cy-7:cy+8, cx-7:cx+8] += 0.6 * stamp
    # smooth regional gradient so large-scale structure exists too
    intensity += mask * (0.15 * np.sin(zz / 40.0) * np.cos(xx / 55.0))
    intensity *= mask
    intensity = np.clip(intensity, 0, None)
    intensity /= max(intensity.max(), 1e-6)
    return intensity, labels


def make_ground_truth(
        shape: Sequence[int], seed: int = 1,
        ffd_spacing: float = 100.0, ffd_ctrl_sigma: float = 26.0,
        rot_deg: float = 4.0, scale_jitter: float = 0.06,
        shift: Sequence[float] = (4.0, -6.0, 5.0),
        remove_affine_component: bool = True, device="cuda") -> Dict:
    """Known smooth transform: FFD (cubic B-spline lattice) then affine,
    in the engine's composition order, so ``resample(base, {"grid":
    grid}, "bspline", shape, spacing, pre_affine=affine)`` both makes the
    fixed image and defines the mapping registration must recover.
    ``ffd_ctrl_sigma`` is the per-control-point draw in voxels; with
    ``remove_affine_component`` the best-fit affine of the lattice is
    subtracted at the control points, so the FFD is purely non-affine.
    ``grid`` and ``affine`` are numpy arrays; ``disp_stats`` measures the
    realised displacement (on ``device``)."""
    dev = device_mod.resolve(device)
    rng = np.random.default_rng(seed)
    shape = tuple(int(s) for s in shape)
    spacing = (float(ffd_spacing),) * 3
    gshape = transform.bspline_grid_shape(shape, spacing)
    grid = rng.normal(0.0, ffd_ctrl_sigma, (3,) + gshape).astype(np.float32)

    if remove_affine_component:
        # control j anchors at (j - 1) * spacing; fit disp ~ A @ x + b over
        # the in-volume controls and subtract that affine field's exact
        # control values (cubic B-splines reproduce linear fields)
        axes = [np.arange(g, dtype=np.float64) - 1.0 for g in gshape]
        zz_c, yy_c, xx_c = np.meshgrid(
            axes[0] * spacing[0], axes[1] * spacing[1],
            axes[2] * spacing[2], indexing="ij")
        pts = np.stack([zz_c, yy_c, xx_c], axis=-1).reshape(-1, 3)
        inside = np.all((pts >= 0) & (pts <= np.asarray(shape) - 1), axis=1)
        X = np.column_stack([pts, np.ones(len(pts))])
        disp_c = grid.reshape(3, -1).T.astype(np.float64)
        coef, *_ = np.linalg.lstsq(X[inside], disp_c[inside], rcond=None)
        grid = (disp_c - X @ coef).T.reshape(grid.shape).astype(np.float32)

    th = np.deg2rad(rot_deg)
    rot = np.array([[1, 0, 0],
                    [0, np.cos(th), -np.sin(th)],
                    [0, np.sin(th), np.cos(th)]], np.float32)
    scale = np.diag(1.0 + rng.uniform(
        -scale_jitter, scale_jitter, 3)).astype(np.float32)
    a = rot @ scale
    affine = {"W": a - np.eye(3, dtype=np.float32),
              "t": np.asarray(shift, np.float32)}

    disp = transform.bspline_displacement(
        torch.from_numpy(grid).to(dev), shape, spacing, stride=(4, 4, 4))
    mag = torch.sqrt((disp ** 2).sum(dim=0)).cpu().numpy()
    return {
        "grid": grid, "spacing": spacing, "affine": affine,
        "disp_stats": {"mean_vox": float(mag.mean()),
                       "p95_vox": float(np.percentile(mag, 95)),
                       "max_vox": float(mag.max())}}


def apply_modality_gap(
        img: np.ndarray, seed: int = 2, gamma: float = 2.0,
        bias_strength: float = 0.3, noise_sigma: float = 0.03
) -> np.ndarray:
    """Make the fixed image look like a different modality/specimen.

    Nonlinear monotone remap (gamma + soft knee), multiplicative smooth
    bias field (coarse random field upsampled, the MRI/light-sheet
    illumination artifact Mattes-MI tolerates and SSD does not), and
    additive Gaussian noise.
    """
    from scipy.ndimage import zoom
    rng = np.random.default_rng(seed)
    x = np.clip(np.asarray(img, np.float32), 0, 1)
    remapped = x ** gamma / (x ** gamma + 0.25 ** gamma)
    coarse = rng.normal(0.0, 1.0, (4, 4, 4))
    bias = zoom(coarse, [s / 4 for s in img.shape], order=3)
    bias = 1.0 + bias_strength * bias / max(np.abs(bias).max(), 1e-6)
    noisy = remapped * bias + rng.normal(0, noise_sigma, img.shape)
    return np.clip(noisy, 0, None).astype(np.float32)


def build_pair(shape: Sequence[int] = (160, 240, 200), seed: int = 0,
               region_contrast: float = 0.6,
               cache_dir: Optional[str] = None, device="cuda",
               **gt_kwargs) -> Dict:
    """Full gauntlet pair: ``moving`` (clean atlas intensity), ``labels``
    (its annotation), ``fixed`` (the ground-truth warp of the atlas with
    the modality gap), ``labels_fixed_gt`` (the annotation through the
    same warp at order 0, the label-transfer oracle) and ``gt`` (the
    transform, numpy). The two warps run on ``device``.

    ``cache_dir`` keeps the built arrays in an uncompressed ``.npz``
    there, in the reference's format, keyed by every argument and the
    device's type, and reads them back instead of building them again."""
    dev = device_mod.resolve(device)
    cache_path = None
    if cache_dir is not None:
        key = "_".join(
            [str(int(s)) for s in shape]
            + [f"s{seed}", f"rc{region_contrast}"]
            + [f"{k}={v}" for k, v in sorted(gt_kwargs.items())]
            + [dev.type])
        cache_path = os.path.join(cache_dir, f"gauntlet_{key}.npz")
        if os.path.exists(cache_path):
            return _read_pair(cache_path)
    moving, labels = make_anatomy(
        shape, seed=seed, region_contrast=region_contrast)
    gt = make_ground_truth(shape, seed=seed + 1, device=dev, **gt_kwargs)
    warp = reg_engine.RegResult.from_numpy(
        [("affine", gt["affine"]), ("bspline", {"grid": gt["grid"]})],
        shape, gt["spacing"], dev)
    warped = warp.transform_img(moving, order=1)
    labels_fixed_gt = warp.transform_img(labels, order=0).astype(np.int32)
    fixed = apply_modality_gap(warped, seed=seed + 2)
    if cache_path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(
            cache_path, moving=moving, labels=labels.astype(np.int16),
            fixed=fixed, labels_fixed_gt=labels_fixed_gt.astype(np.int16),
            grid=gt["grid"], spacing=np.asarray(gt["spacing"], np.float64),
            aff_W=gt["affine"]["W"], aff_t=gt["affine"]["t"],
            disp_stats=np.asarray([gt["disp_stats"][k] for k in (
                "mean_vox", "p95_vox", "max_vox")], np.float64))
    return {"moving": moving, "labels": labels, "fixed": fixed,
            "labels_fixed_gt": labels_fixed_gt, "gt": gt}


def _read_pair(cache_path: str) -> Dict:
    """A pair that :func:`build_pair` cached at ``cache_path``."""
    with np.load(cache_path) as z:
        gt = {"grid": z["grid"],
              "spacing": tuple(float(v) for v in z["spacing"]),
              "affine": {"W": z["aff_W"], "t": z["aff_t"]},
              "disp_stats": {k: float(v) for k, v in zip(
                  ("mean_vox", "p95_vox", "max_vox"), z["disp_stats"])}}
        return {"moving": z["moving"],
                "labels": z["labels"].astype(np.int32),
                "fixed": z["fixed"],
                "labels_fixed_gt": z["labels_fixed_gt"].astype(np.int32),
                "gt": gt}


def build_truncated_pair(
        shape: Sequence[int] = (160, 240, 200), seed: int = 0,
        keep_frac: float = 0.7, cache_dir: Optional[str] = None,
        device="cuda", **gt_kwargs) -> Dict:
    """Partial-overlap case: the specimen's posterior ``1 - keep_frac`` of
    z zeroed (and its annotation), a ``fixed_mask`` over the kept part,
    and ``gated_labels``, the regions the truncation kept at least half
    of. ``cache_dir`` caches the full pair (:func:`build_pair`)."""
    pair = build_pair(shape, seed=seed, cache_dir=cache_dir, device=device,
                      **gt_kwargs)
    shape = pair["fixed"].shape
    z_cut = int(shape[0] * keep_frac)
    fixed = np.array(pair["fixed"])
    fixed[z_cut:] = 0.0
    labels_gt = np.array(pair["labels_fixed_gt"])
    labels_gt[z_cut:] = 0
    mask = np.zeros(shape, bool)
    mask[:z_cut] = True
    full_counts = np.bincount(pair["labels_fixed_gt"].reshape(-1))
    kept_counts = np.bincount(
        labels_gt.reshape(-1), minlength=len(full_counts))
    gated = [int(lid) for lid in range(1, len(full_counts))
             if full_counts[lid] > 0
             and kept_counts[lid] >= 0.5 * full_counts[lid]]
    out = dict(pair)
    out.update(fixed=fixed, labels_fixed_gt=labels_gt, fixed_mask=mask,
               gated_labels=gated, keep_frac=float(keep_frac))
    return out


def write_register_inputs(pair: Dict, where: str) -> Tuple[str, str]:
    """The pair as the ``--register single`` task reads it, under
    ``where``: the fixed image as ``sample.npy`` (an image5d with its
    metadata) and the atlas as an ``atlasVolume.mhd``/``annotation.mhd``
    directory. Returns ``(sample_path, atlas_dir)``."""
    sample = os.path.join(where, "sample.npy")
    np_io.write_npy(sample, pair["fixed"])
    atlas = os.path.join(where, "atlas")
    os.makedirs(atlas)
    sitk_io.write_med_img(os.path.join(atlas, "atlasVolume.mhd"),
                          sitk_io.MedImage(pair["moving"]))
    sitk_io.write_med_img(os.path.join(atlas, "annotation.mhd"),
                          sitk_io.MedImage(pair["labels"]))
    return sample, atlas


def run_gauntlet(pair: Dict, iters_scale: float = 1.0,
                 device="cuda") -> Dict:
    """Register the pair on ``device`` with the reference's Elastix-default
    schedule (translation 2048, affine 1024 and B-spline 512 iterations at
    each of 4 smoothing-pyramid resolutions, grid 50 voxels), recording
    each stage's DSC, and score it against the ground truth
    (``gauntlet.py:313-422``): ``dsc`` (Otsu-overlap DSC, gate >= 0.95),
    per-region label transfer ``label_dsc_median``/``_min``/``_p10``
    (gates: median >= 0.90 and (min >= 0.80 or p10 >= 0.85)), the
    B-spline stage's ``bspline_dsc_gain`` and ``bspline_gap_closure``
    (gate: gain >= 0.05 or closure >= 0.5), ``warp_err_vox`` (mean
    ``|T_rec(x) - T_gt(x)|`` over foreground voxels on a stride-4 grid)
    beside ``gt_disp_vox``, ``wall_s`` and ``passes``."""
    dev = device_mod.resolve(device)
    shape = pair["moving"].shape
    gt = pair["gt"]
    fixed_mask = pair.get("fixed_mask")
    prof = AtlasProfile()
    prof["reg_translation"] = make_reg_param_map(
        "translation", 2048, num_resolutions=4, pyramid_mode="smoothing")
    prof["reg_affine"] = make_reg_param_map(
        "affine", 1024, num_resolutions=4, pyramid_mode="smoothing")
    prof["reg_bspline"] = make_reg_param_map(
        "bspline", 512, grid_space_voxels=50, num_resolutions=4,
        pyramid_mode="smoothing")
    t0 = time.perf_counter()
    moved, result = reg_engine.register_duo(
        pair["fixed"], pair["moving"], prof,
        iters_scale=iters_scale, record_stage_dsc=True,
        fixed_mask=(fixed_mask.astype(np.float32)
                    if fixed_mask is not None else None), device=dev)
    wall = time.perf_counter() - t0

    labels_pred = result.transform_img(
        pair["labels"].astype(np.int32), order=0)
    if fixed_mask is not None:
        labels_pred = np.where(fixed_mask, labels_pred, 0)
    lt = label_transfer_dsc(
        labels_pred, pair["labels_fixed_gt"],
        only_labels=pair.get("gated_labels"))

    # warp error on a stride-4 grid, restricted to the foreground
    kind, params, pre = result._final()
    stride = (4, 4, 4)
    c_rec = transform.transform_coords(
        params, kind, shape, result.bspline_spacing, pre, stride)
    c_gt = transform.transform_coords(
        _on({"grid": gt["grid"]}, dev), "bspline", shape, gt["spacing"],
        _on(gt["affine"], dev), stride)
    err = torch.sqrt(torch.sum((c_rec - c_gt) ** 2, dim=0)).cpu().numpy()
    fg = pair["labels_fixed_gt"][::4, ::4, ::4][
        :err.shape[0], :err.shape[1], :err.shape[2]] > 0
    err_fg = err[fg] if fg.any() else err.reshape(-1)

    st = {k.replace("dsc_stage_", ""): float(v)
          for k, v in result.metrics.items() if k.startswith("dsc_stage_")}
    dsc = float(result.metrics["dsc_fixed_moved"])
    if fixed_mask is not None:
        dsc = float(metrics.measure_overlap(
            pair["fixed"], np.where(fixed_mask, moved, 0.0), device=dev))
    gain = st.get("bspline", 0.0) - st.get("affine", 0.0)
    closure = bspline_gap_closure(st.get("affine"), gain)
    return {
        "wall_s": wall, "dsc": dsc, "stage_dsc": st,
        "bspline_dsc_gain": gain,
        "bspline_gap_closure": closure,
        "label_dsc_median": lt["median"], "label_dsc_min": lt["min"],
        "label_dsc_p10": lt["p10"],
        "warp_err_vox": float(err_fg.mean()),
        "warp_err_p95_vox": float(np.percentile(err_fg, 95)),
        "gt_disp_vox": float(gt["disp_stats"]["mean_vox"]),
        "passes": gates_pass(
            dsc=dsc, label_median=lt["median"], label_min=lt["min"],
            label_p10=lt["p10"], gain=gain, closure=closure),
    }


def bspline_gap_closure(dsc_affine: Optional[float],
                        gain: float) -> float:
    """Fraction of the post-affine DSC residual the B-spline stage
    closed: ``gain / (1 - dsc_affine)``. Scale-free complement to the
    absolute gain — 0.76 closure on a 0.944-affine pair is stronger
    deformable-stage evidence than 0.051 absolute on a 0.938 one."""
    if dsc_affine is None:
        return 0.0
    return float(gain / max(1.0 - float(dsc_affine), 1e-9))


def gates_pass(dsc: float, label_median: float, label_min: float,
               label_p10: float, gain: float, closure: float) -> bool:
    """The per-pair gauntlet gate (round-4 VERDICT item 4, hardened):

    ``dsc >= 0.95`` AND ``label_median >= 0.90`` AND the worst region
    holds up (``label_min >= 0.80`` OR ``label_p10 >= 0.85``) AND the
    deformable stage does real work (``gain >= 0.05`` absolute OR
    ``closure >= 0.5`` of the post-affine residual — see
    :func:`bspline_gap_closure` for why absolute gain alone
    mis-gates pairs whose GT warp has a strong affine component).
    """
    return bool(
        dsc >= 0.95 and label_median >= 0.90
        and (label_min >= 0.80 or label_p10 >= 0.85)
        and (gain >= 0.05 or closure >= 0.5))


def run_gauntlet_suite(
        shape: Sequence[int] = (160, 240, 200),
        seeds: Sequence[int] = (0, 10),
        truncated_seed: Optional[int] = 0,
        cache_dir: Optional[str] = None,
        iters_scale: float = 1.0, device="cuda", **gt_kwargs) -> Dict:
    """Multi-pair gauntlet (``gauntlet.py:453-478``): one pair
    ``seed{s}`` for each seed plus the truncated-specimen partial-overlap
    pair ``trunc{truncated_seed}``, each built and registered on ``device``
    and scored by :func:`run_gauntlet`, so the gates are not tuned to one
    fixture. The suite passes only when every pair passes every gate.
    Returns ``pairs`` (each pair's scores by name), ``passes`` and
    ``wall_s`` (the registrations' walls summed). ``cache_dir`` caches
    the pairs (:func:`build_pair`)."""
    builds = [(f"seed{s}", build_pair, s) for s in seeds]
    if truncated_seed is not None:
        builds.append((f"trunc{truncated_seed}", build_truncated_pair,
                       truncated_seed))
    results = {}
    for name, build, seed in builds:
        pair = build(shape, seed=seed, cache_dir=cache_dir, device=device,
                     **gt_kwargs)
        results[name] = run_gauntlet(pair, iters_scale=iters_scale,
                                     device=device)
    return {
        "pairs": results,
        "passes": bool(all(r["passes"] for r in results.values())),
        "wall_s": float(sum(r["wall_s"] for r in results.values()))}


def label_transfer_dsc(
        labels_pred: np.ndarray, labels_gt: np.ndarray,
        ignore_background: bool = True,
        only_labels: Optional[Sequence[int]] = None) -> Dict:
    """Per-label Dice of a transferred annotation vs the GT-warped one.

    The per-region quality metric atlas users actually consume
    (regional volumes/stats are per-label sums); reports the median,
    min, 10th percentile, and the per-label vector. Labels absent from
    both volumes are skipped; ``only_labels`` restricts scoring (the
    truncated-specimen case gates only regions the truncation kept).
    """
    ids = np.union1d(np.unique(labels_gt), np.unique(labels_pred))
    if ignore_background:
        ids = ids[ids != 0]
    if only_labels is not None:
        ids = np.intersect1d(ids, np.asarray(only_labels))
    dscs = {}
    for lid in ids:
        a = labels_pred == lid
        b = labels_gt == lid
        denom = a.sum() + b.sum()
        if denom == 0:
            continue
        dscs[int(lid)] = float(2.0 * np.logical_and(a, b).sum() / denom)
    vals = np.asarray(list(dscs.values()))
    return {"median": float(np.median(vals)) if len(vals) else 0.0,
            "mean": float(vals.mean()) if len(vals) else 0.0,
            "min": float(vals.min()) if len(vals) else 0.0,
            "p10": float(np.percentile(vals, 10)) if len(vals) else 0.0,
            "per_label": dscs}
