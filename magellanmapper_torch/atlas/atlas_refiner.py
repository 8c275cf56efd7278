"""Atlas curation on PyTorch: truncation, mirroring across the midline,
lateral edge extension, label smoothing, import of an atlas directory,
and the overlap and refinement measures.

Port of ``magellanmapper_tpu/atlas/atlas_refiner.py:33-559``. Plane
bookkeeping (truncation, mirroring, the symmetry checks, the per-plane
``scipy.ndimage.label`` of edge extension) stays on the host, as in the
reference. :func:`smooth_labels` keeps the labels on the host and a copy
on the device: each label's bounding box is found on the device, and its
binary opening or closing (``scipy.ndimage`` semantics, a zero border)
and its in-painting run there on the box, in the reference's order
(largest label first, each seeing the labels the earlier ones left).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch
from scipy import ndimage as scipy_ndi

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.atlas import metrics as reg_metrics
from magellanmapper_torch.cv import cv_nd
from magellanmapper_torch.io import sitk_io
from magellanmapper_torch.ops import filters, preproc
from magellanmapper_torch.ops import resize as resize_ops

_logger = logging.getLogger(__name__)

#: the intensity images' DSC (``atlas.metrics``), under the reference's name
measure_overlap = reg_metrics.measure_overlap

#: smoothing metric columns (the reference's ``config.SmoothingMetrics``)
_SMOOTHING_COLS = ("Filter_size", "Compaction", "Displacement",
                   "Smoothing_quality", "Compactness")


def truncate_labels(img_np, x_frac=None, y_frac=None, z_frac=None):
    """Zero the voxels outside fractional bounds per axis, in place."""
    shape = img_np.shape
    for axis, bound in enumerate((z_frac, y_frac, x_frac)):
        if bound is None:
            continue
        bound_abs = np.multiply(bound, shape[axis]).astype(int)
        sl = [slice(None)] * 3
        sl[axis] = slice(0, bound_abs[0])
        img_np[tuple(sl)] = 0
        sl[axis] = slice(bound_abs[1], None)
        img_np[tuple(sl)] = 0
    return img_np


def mirror_planes(
        img_np: np.ndarray, start: int, mirror_mult: int = 1,
        resize: bool = True, start_dup: Optional[float] = None,
        rand_dup: Optional[int] = None,
        check_equality: bool = False) -> np.ndarray:
    """Mirror the planes before ``start`` onto those from ``start`` on,
    times ``mirror_mult`` (-1 for a mirrored annotation's negative IDs);
    ``resize`` first cuts or pads the image to ``2 * start`` planes."""
    if resize:
        shape = img_np.shape
        new_z = start * 2
        if new_z > shape[0]:
            resized = np.zeros((new_z,) + shape[1:], dtype=img_np.dtype)
            resized[:shape[0]] = img_np
            img_np = resized
        else:
            img_np = img_np[:new_z]
    tot_planes = len(img_np)
    if start_dup is not None:
        n = int(start_dup * tot_planes)
        num_planes = start - n
        if rand_dup is not None:
            rng = np.random.RandomState(num_planes)
            dup = (n - np.ceil(rng.rand(num_planes) * rand_dup)).astype(int)
            dup[dup < 0] = 0
        else:
            dup = np.repeat(n - 1, num_planes)
        for i in range(num_planes):
            plane_i = n + i
            if 0 < plane_i < tot_planes:
                img_np[plane_i] = img_np[dup[i]]
    if 0 <= start <= tot_planes:
        remaining = tot_planes - start
        end = start - remaining - 1
        if end < 0:
            end = None
            remaining = start
        img_np[start:start + remaining] = np.multiply(
            img_np[start - 1:end:-1], mirror_mult)
    if check_equality:
        check_mirrorred(img_np, mirror_mult=mirror_mult)
    return img_np


def check_mirrorred(
        img_np: np.ndarray, mirror_mult: int = 1, axis: int = 0
) -> Tuple[bool, bool]:
    """Whether the two halves along ``axis`` mirror each other (times
    ``mirror_mult``): equal values, and equal label sets."""
    half_len = img_np.shape[axis] // 2
    sl = [slice(None)] * img_np.ndim
    sl[axis] = slice(0, half_len)
    before = img_np[tuple(sl)]
    sl[axis] = slice(img_np.shape[axis], half_len - 1, -1)
    after = img_np[tuple(sl)] / mirror_mult
    eq_vals = np.array_equal(before, after)
    eq_lbls = np.array_equal(np.unique(before), np.unique(after))
    return eq_vals, eq_lbls


def find_symmetric_axis(img_np: np.ndarray, mirror_mult: int = 1) -> int:
    """The first axis along which the image mirrors itself, or -1."""
    for i in range(img_np.ndim):
        if check_mirrorred(img_np, mirror_mult, i)[0]:
            return i
    return -1


def _resize_nearest2d(arr: np.ndarray, shape) -> np.ndarray:
    """Nearest-neighbour 2D resize at voxel centres (skimage ``resize``
    at order 0)."""
    i0 = np.minimum(
        ((np.arange(shape[0]) + 0.5) * arr.shape[0] / shape[0]).astype(int),
        arr.shape[0] - 1)
    i1 = np.minimum(
        ((np.arange(shape[1]) + 0.5) * arr.shape[1] / shape[1]).astype(int),
        arr.shape[1] - 1)
    return arr[i0[:, None], i1[None, :]]


def _extend_region(vol_lab, vol_ref, threshold, template, planei, slices,
                   in_paint, device):
    """Walk one sub-region laterally (decreasing planes), resizing the
    prior plane's label template onto each plane's largest thresholded
    object (the reference's ``extend_edge`` recursion)."""
    while planei >= 0:
        sub_ref = vol_ref[planei][slices] > threshold
        if not np.any(sub_ref):
            break
        comps, n = scipy_ndi.label(sub_ref)
        sizes = scipy_ndi.sum_labels(
            np.ones_like(comps), comps, index=np.arange(1, n + 1))
        rel = scipy_ndi.find_objects(comps)[int(np.argmax(sizes))]
        slices = tuple(
            slice(s.start + r.start, s.start + r.stop)
            for s, r in zip(slices, rel))
        shape = tuple(s.stop - s.start for s in slices)
        resized = _resize_nearest2d(template, shape)
        plane_add = resized
        if in_paint and np.any(resized != 0):
            # fill thresholded foreground the template missed, add-only
            fg_thresh = vol_ref[planei][slices] > threshold
            to_fill = fg_thresh & (plane_add == 0)
            if np.any(to_fill):
                plane_add = cv_nd.in_paint(plane_add, to_fill,
                                           device=device)
                plane_add[~(fg_thresh | (resized != 0))] = 0
        vol_lab[planei][slices] = plane_add
        template = resized
        planei -= 1


def extend_edge(
        labels_img: np.ndarray, atlas_img: np.ndarray,
        threshold: float, plane_start: int, axis: int = 0,
        surr_size: int = 2, in_paint: bool = True,
        device="cuda") -> np.ndarray:
    """Extend incomplete lateral labels along ``axis`` using the atlas's
    histology: at the last labelled lateral plane, each thresholded
    sub-region of the atlas (within the labels dilated by ``surr_size``)
    crops a 2D label template, which every more lateral plane resizes onto
    its largest thresholded object, optionally in-painting (on
    ``device``) the foreground it missed; smallest regions first. Interior
    unlabelled planes refill from the nearest labelled plane within the
    atlas's foreground."""
    dev = device_mod.resolve(device)
    out = np.array(labels_img)
    vol_lab = np.moveaxis(out, axis, 0)
    vol_ref = np.moveaxis(np.asarray(atlas_img), axis, 0)
    n = vol_lab.shape[0]

    labeled = [i for i in range(n) if np.any(vol_lab[i])]
    if not labeled:
        return out

    # the lateral tail: planes below the lowest labelled plane (or below
    # the caller's start plane when it is labelled)
    tail_top = labeled[0]
    if 0 < plane_start < n and np.any(vol_lab[plane_start]):
        tail_top = max(tail_top, int(plane_start))
    if tail_top > 0:
        ref_plane = vol_ref[tail_top] > threshold
        if surr_size > 0:
            lab_fg = scipy_ndi.binary_dilation(
                vol_lab[tail_top] != 0, iterations=int(surr_size))
            ref_plane &= lab_fg
        comps, n_comp = scipy_ndi.label(ref_plane)
        if n_comp:
            sizes = scipy_ndi.sum_labels(
                np.ones_like(comps), comps, index=np.arange(1, n_comp + 1))
            objs = scipy_ndi.find_objects(comps)
            for ci in np.argsort(sizes):        # smallest first
                slices = objs[ci]
                template = np.array(vol_lab[tail_top][slices])
                if not np.any(template):
                    continue
                _extend_region(vol_lab, vol_ref, threshold, template,
                               tail_top - 1, slices, in_paint, dev)

    # interior gaps: the nearest labelled plane within the foreground
    labeled = [i for i in range(n) if np.any(vol_lab[i])]
    for i in range(n):
        if np.any(vol_lab[i]):
            continue
        fg = vol_ref[i] > threshold
        if not np.any(fg) or not labeled:
            continue
        nearest = min(labeled, key=lambda j: abs(j - i))
        dst = vol_lab[i]
        dst[fg] = vol_lab[nearest][fg]
        missing = fg & (dst == 0)
        if np.any(missing) and np.any(dst != 0):
            filled = cv_nd.in_paint(dst, dst == 0, device=dev)
            dst[missing] = filled[missing]
    return out


def smooth_labels(
        labels_img_np: np.ndarray, filter_size: int = 3,
        mode: str = "opening", metrics: bool = False,
        spacing: Optional[Sequence[float]] = None, device="cuda"
) -> Tuple[Optional[pd.DataFrame], Optional[pd.DataFrame]]:
    """Smooth each label in place, largest first, on ``device``: within
    its bounding box padded by ``2 * filter_size``, the label is removed
    (its voxels in-painted from the neighbours) and its binary opening by
    a ball (half the size under 5,000 voxels; the closing when the opening
    keeps under 1%), Gaussian (``mode="gaussian"``) or closing put back.
    With ``metrics``, returns :func:`label_smoothing_metric`'s tables."""
    if not filter_size:
        return None, None
    dev = device_mod.resolve(device)
    orig = np.copy(labels_img_np)
    fn_selem = cv_nd.get_selem(labels_img_np.ndim)
    lab = torch.from_numpy(labels_img_np).to(dev)
    ids, counts = torch.unique(lab, return_counts=True)
    sizes = {int(lid): int(c) for lid, c in zip(ids.cpu().numpy(),
                                                counts.cpu().numpy())
             if lid != 0}
    ordered = sorted(sizes, key=sizes.get, reverse=True)
    pad = int(np.ceil(2 * filter_size))

    for lid in ordered:
        bbox = cv_nd.mask_bbox(lab == lid)
        if bbox is None:
            continue
        slices = tuple(cv_nd.get_bbox_region(bbox, pad, lab.shape))
        region = labels_img_np[slices]
        mask_t = lab[slices] == lid
        mask = mask_t.cpu().numpy()
        size = int(mask.sum())
        if size == 0:
            continue
        if mode in ("opening", "adaptive_opening"):
            selem = fn_selem(filter_size if size >= 5000
                             else max(1, filter_size // 2))
            smoothed = filters.binary_opening(mask_t, selem)
            if int(smoothed.sum()) / size < 0.01:
                smoothed = filters.binary_closing(mask_t, selem)
        elif mode == "gaussian":
            smoothed = filters.gaussian_filter(
                mask_t.to(torch.float32), filter_size, mode="nearest") > 0.5
        elif mode == "closing":
            smoothed = filters.binary_closing(mask_t, fn_selem(filter_size))
        else:
            raise ValueError(f"unknown smoothing mode: {mode}")
        region = cv_nd.in_paint(region, mask, device=dev)
        region[smoothed.cpu().numpy()] = lid
        labels_img_np[slices] = region
        lab[slices] = torch.from_numpy(region).to(dev)

    df_aggr = df_raw = None
    if metrics:
        df_aggr, df_raw = label_smoothing_metric(
            orig, labels_img_np, filter_size, spacing, device=dev)
    return df_aggr, df_raw


def label_smoothing_metric(
        orig_img_np: np.ndarray, smoothed_img_np: np.ndarray,
        filter_size=None, spacing=None, device="cuda"
) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """Smoothing quality per label (compaction, displacement, surface to
    volume) and volume-weighted over the labels. Each label is measured
    on the bounding box of its voxels before and after (found on
    ``device``), which holds every face and voxel the whole image
    would."""
    dev = device_mod.resolve(device)
    if spacing is None:
        spacing = (1.0,) * orig_img_np.ndim
    label_ids = np.unique(orig_img_np)
    label_ids = label_ids[label_ids != 0]
    ids_t = torch.from_numpy(label_ids).to(dev)
    ndim = orig_img_np.ndim
    boxes = [cv_nd.label_bboxes(torch.from_numpy(img).to(dev), ids_t)
             for img in (orig_img_np, smoothed_img_np)]
    rows = []
    for lid, box_o, box_s in zip(label_ids, *boxes):
        if not box_s[ndim:].any():
            box_s = box_o
        sl = tuple(slice(min(a, b), max(c, d)) for a, b, c, d in zip(
            box_o[:ndim], box_s[:ndim], box_o[ndim:], box_s[ndim:]))
        m_orig = orig_img_np[sl] == lid
        m_smooth = smoothed_img_np[sl] == lid
        vol_orig = m_orig.sum()
        vol_smooth = m_smooth.sum()
        if vol_orig == 0:
            continue
        comp_orig, _, _ = cv_nd.compactness_3d(m_orig, spacing)
        if vol_smooth > 0:
            comp_sm, sa_sm, _ = cv_nd.compactness_3d(m_smooth, spacing)
            compaction = (comp_orig - comp_sm) / comp_orig
            displ = np.sum(m_smooth & ~m_orig) / vol_smooth
            sa_vol = sa_sm / vol_smooth
        else:
            compaction = displ = sa_vol = np.nan
        rows.append({
            "Region": lid, "Volume": int(vol_orig),
            "VolumeSmoothed": int(vol_smooth),
            "Compaction": compaction, "Displacement": displ,
            "SmoothingQuality": compaction - displ,
            "SA_to_vol": sa_vol, "Filter": filter_size})
    df_raw = pd.DataFrame(rows)
    if len(df_raw):
        wts = df_raw["Volume"].to_numpy(dtype=float)
        aggr = {
            c: float(np.nansum(df_raw[c] * wts) / wts.sum())
            for c in ("Compaction", "Displacement", "SmoothingQuality")}
        aggr["Filter"] = filter_size
        df_aggr = pd.DataFrame([aggr])
    else:
        df_aggr = pd.DataFrame()
    return df_aggr, df_raw


def measure_overlap_labels(labels_a: np.ndarray, labels_b: np.ndarray,
                           device="cuda") -> float:
    """DSC of two labels images' foregrounds, on ``device``."""
    dev = device_mod.resolve(device)
    return float(reg_metrics.dice(
        torch.from_numpy(np.asarray(labels_a) != 0).to(dev),
        torch.from_numpy(np.asarray(labels_b) != 0).to(dev)))


def measure_overlap_combined_labels(
        atlas_img: np.ndarray, labels_img: np.ndarray,
        thresh: Optional[float] = None, device="cuda") -> float:
    """DSC between the atlas foreground (above ``thresh``, Otsu's when
    None) and the combined labels foreground (labels != 0), on
    ``device``."""
    dev = device_mod.resolve(device)
    atlas = torch.from_numpy(np.array(atlas_img, np.float32)).to(dev)
    if thresh is None:
        thresh = float(preproc.otsu_threshold(atlas))
    labels = torch.from_numpy(np.asarray(labels_img) != 0).to(dev)
    return float(reg_metrics.dice(atlas > thresh, labels))


def transpose_img(
        med: sitk_io.MedImage, plane: Optional[str] = None,
        rotate_deg: Optional[float] = None,
        rescale: Optional[float] = None,
        target_size: Optional[Sequence[int]] = None,
        order: int = 1, device="cuda") -> sitk_io.MedImage:
    """Reorient (``xz``/``yz``), rotate (on the host, scipy), and rescale
    or resize (on ``device``) a medical image, its spacing following."""
    dev = device_mod.resolve(device)
    img = np.asarray(med.img)
    spacing = list(med.spacing)
    if plane in ("xz", "yz"):
        if plane == "xz":
            img = np.swapaxes(img, 0, 1)
            spacing = [spacing[1], spacing[0], spacing[2]]
        else:
            img = np.swapaxes(img, 0, 2)
            spacing = [spacing[2], spacing[1], spacing[0]]
    if rotate_deg:
        img = scipy_ndi.rotate(
            img, rotate_deg, axes=(1, 2), reshape=False, order=order)
    vol = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(dev)
    if rescale:
        img = resize_ops.rescale(vol, rescale, order=order).cpu().numpy()
        spacing = [s / rescale for s in spacing]
    elif target_size is not None:
        factors = np.divide(target_size, img.shape[:3])
        img = resize_ops.resize(vol, target_size,
                                order=order).cpu().numpy()
        spacing = list(np.divide(spacing, factors))
    return sitk_io.MedImage(
        img.astype(med.img.dtype) if order == 0 else img,
        tuple(spacing), med.origin, dict(med.meta))


def match_atlas_labels(
        atlas: sitk_io.MedImage, labels: sitk_io.MedImage, profile,
        device="cuda"
) -> Tuple[sitk_io.MedImage, sitk_io.MedImage, Dict]:
    """Curate an atlas and its labels by the profile (edge extension,
    mirroring, smoothing) and measure the labels' fit to the atlas."""
    dev = device_mod.resolve(device)
    atlas_np = np.asarray(atlas.img)
    labels_np = np.array(labels.img)
    mirror = profile["labels_mirror"] or {}
    edge = profile["labels_edge"] or {}
    metrics_out: Dict[str, float] = {}

    thresh = profile["atlas_threshold"]
    if edge.get("active"):
        start = edge.get("start")
        start_i = int(start * labels_np.shape[0]) if start else 0
        labels_np = extend_edge(labels_np, atlas_np, thresh, start_i,
                                device=dev)
    if mirror.get("active"):
        start = mirror.get("start")
        start_i = (int(start * labels_np.shape[0]) if start is not None
                   else labels_np.shape[0] // 2)
        mult = -1 if mirror.get("neg_labels", True) else 1
        labels_np = mirror_planes(labels_np, start_i, mirror_mult=mult)
        if mirror.get("atlas_mirror", True):
            atlas_np = mirror_planes(
                np.array(atlas_np), start_i, mirror_mult=1)
    smooth = profile["smooth"]
    if smooth:
        smooth_labels(labels_np, smooth, profile["smoothing_mode"],
                      device=dev)

    metrics_out["DSC_atlas_labels"] = measure_overlap_combined_labels(
        atlas_np, labels_np, device=dev)
    fg = atlas_np > (thresh if thresh else 0)
    lbl = labels_np != 0
    metrics_out["Vol_atlas"] = int(fg.sum())
    metrics_out["Vol_labels"] = int(lbl.sum())
    metrics_out["Frac_unlabeled_fg"] = (
        float(np.sum(fg & ~lbl) / fg.sum()) if fg.sum() else np.nan)

    atlas_out = sitk_io.MedImage(
        atlas_np, atlas.spacing, atlas.origin, dict(atlas.meta))
    labels_out = sitk_io.MedImage(
        labels_np, labels.spacing, labels.origin, dict(labels.meta))
    return atlas_out, labels_out, metrics_out


def import_atlas(atlas_dir: str, profile, show: bool = False,
                 prefix: Optional[str] = None,
                 device="cuda") -> Dict[str, str]:
    """Import an atlas directory (``atlasVolume`` and ``annotation``),
    curate it by the profile (:func:`match_atlas_labels`, on ``device``)
    and write the curated pair and a metrics CSV, named after ``prefix``
    or ``<atlas_dir>_imported``. Returns the written paths."""
    device = device_mod.resolve(device)
    atlas = sitk_io.read_med_img(sitk_io.find_sitk_file(
        os.path.join(atlas_dir, "atlasVolume")))
    labels = sitk_io.read_med_img(sitk_io.find_sitk_file(
        os.path.join(atlas_dir, "annotation")))
    atlas_out, labels_out, metr = match_atlas_labels(
        atlas, labels, profile, device=device)
    name = prefix or (os.path.basename(
        atlas_dir.rstrip(os.sep)) + "_imported")
    out_dir = prefix and os.path.dirname(prefix) or atlas_dir
    base = os.path.join(out_dir, os.path.basename(name))
    paths = sitk_io.write_reg_images(
        {"atlasVolume.mhd": atlas_out, "annotation.mhd": labels_out},
        base + ".mhd")
    csv_path = base + "_metrics.csv"
    pd.DataFrame([metr]).to_csv(csv_path, index=False)
    paths["metrics"] = csv_path
    return paths


def crop_to_orig(labels_img_np_orig: np.ndarray,
                 labels_img_np: np.ndarray, crop, device="cuda") -> None:
    """Zero new labels outside the original labels' extent, in place;
    ``crop > 0`` first opens the background by a ball of that radius
    (grayscale erosion then dilation, symmetric border, on ``device``)."""
    if crop is False:
        return
    mask = labels_img_np_orig == 0
    if crop and crop > 0:
        dev = device_mod.resolve(device)
        fp = filters.ball_footprint(int(crop))
        er = filters.erosion(torch.from_numpy(
            mask.astype(np.float32)).to(dev), fp) > 0.5
        mask = (filters.dilation(er.to(torch.float32), fp)
                > 0.5).cpu().numpy()
    labels_img_np[mask] = 0


def find_labels_lost(label_ids_orig: np.ndarray, label_ids: np.ndarray,
                     label_img_np_orig: Optional[np.ndarray] = None
                     ) -> np.ndarray:
    """The IDs present originally but missing after refinement; their
    sizes are logged when the original image is given."""
    label_ids_orig = np.asarray(label_ids_orig)
    lost = label_ids_orig[np.isin(
        label_ids_orig, np.asarray(label_ids), invert=True)]
    if label_img_np_orig is not None:
        for lid in lost:
            _logger.info(
                "lost label %s covered %d voxels", lid,
                int(np.sum(label_img_np_orig == lid)))
    return lost


def make_labels_fg(labels_img: np.ndarray) -> np.ndarray:
    """Binary foreground of a labels image (nonzero -> 1)."""
    fg = np.asarray(labels_img).copy()
    fg[fg != 0] = 1
    return fg


def _weight_mean(vals, weights) -> float:
    """Weighted mean; weights of NaN values leave the total (the
    reference's ``df_io.weight_mean``)."""
    vals = np.asarray(vals, float)
    weights = np.asarray(weights, float)
    tot = np.sum(weights[~np.isnan(vals)])
    return float(np.nansum(vals * weights) / tot) if tot else float("nan")


def aggr_smoothing_metrics(df_pxs: pd.DataFrame) -> pd.DataFrame:
    """Per-label smoothing stats aggregated over the labels, weighted by
    ``Vol_orig`` when present."""
    wt_col = "Vol_orig" if "Vol_orig" in df_pxs.columns else None
    row = {}
    for col in _SMOOTHING_COLS:
        if col not in df_pxs.columns:
            continue
        vals = df_pxs[col].to_numpy(dtype=float)
        if wt_col:
            row[col] = [_weight_mean(
                vals, df_pxs[wt_col].to_numpy(dtype=float))]
        else:
            row[col] = [np.nanmean(vals)]
    return pd.DataFrame(row)


def measure_atlas_refinement(
        metrics_dict, img_atlas: np.ndarray, img_labels: np.ndarray,
        atlas_profile=None, path: Optional[str] = None,
        device="cuda") -> pd.DataFrame:
    """Overall refinement metrics: the DSC of the atlas's foreground (above
    the profile's ``atlas_threshold_all``, or its mean) and the labels',
    on ``device``, and both volumes, beside the steps' metrics."""
    dev = device_mod.resolve(device)
    thresh = None
    if atlas_profile is not None:
        thresh = atlas_profile["atlas_threshold_all"]
    fg_atlas = img_atlas > (
        thresh if thresh is not None else np.mean(img_atlas))
    fg_labels = img_labels != 0
    metrics_dict = dict(metrics_dict or {})
    metrics_dict.setdefault("DSC_atlas_labels", [float(reg_metrics.dice(
        torch.from_numpy(fg_atlas).to(dev),
        torch.from_numpy(fg_labels).to(dev)))])
    metrics_dict.setdefault("Vol_atlas", [int(fg_atlas.sum())])
    metrics_dict.setdefault("Vol_labels", [int(fg_labels.sum())])
    df = pd.DataFrame(metrics_dict)
    if path:
        df.to_csv(path, index=False)
    return df
