"""Edge-aware reannotation of an atlas on PyTorch.

Port of ``magellanmapper_tpu/atlas/edge_seg.py:23-175``: the atlas's
Laplacian of Gaussian and its zero crossings become anatomical edges
(with the distance to them), the labels are eroded into markers, and a
watershed of the markers onto the edges redraws the labels' borders
along the atlas's own; a symmetric atlas is segmented on one half and
mirrored. Labels are then split along the edges into sub-labels. The
LoG, zero crossings, distance transform, erosion and watershed run on
the device; each label's connected components stay on the host
(``scipy.ndimage.label``, on the label's bounding box).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import ndimage as scipy_ndi

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.atlas import atlas_refiner
from magellanmapper_torch.cv import cv_nd, segmenter
from magellanmapper_torch.ops import filters


def _atlas_edges(atlas_img: np.ndarray, labels_img: Optional[np.ndarray],
                 log_sigma: float, dev) -> Tuple[torch.Tensor, np.ndarray]:
    """The atlas's raw LoG (a tensor on ``dev``) and its zero crossings
    (uint8), limited to the labels' foreground when labels are given."""
    log = filters.gaussian_laplace(torch.from_numpy(
        np.array(atlas_img, np.float32)).to(dev), log_sigma)
    edges = cv_nd.zero_crossing_t(log, 1)
    if labels_img is not None:
        edges &= torch.from_numpy(np.asarray(labels_img) != 0).to(dev)
    return log, edges.to(torch.uint8).cpu().numpy()


def make_edge_images(
        atlas_img: np.ndarray, labels_img: Optional[np.ndarray] = None,
        log_sigma: float = 5.0, atlas_threshold: Optional[float] = None,
        device="cuda") -> Dict[str, np.ndarray]:
    """Edge and distance images of an atlas, on ``device``:
    ``atlas_log`` (the LoG clipped and inverted,
    :func:`cv_nd.log_clip`), ``atlas_edge`` (the raw LoG's zero crossings
    within the labels), ``dist_to_edge`` (the distance to them) and, with
    labels, ``labels_edge`` (the labels' perimeter)."""
    dev = device_mod.resolve(device)
    log, edges = _atlas_edges(atlas_img, labels_img, log_sigma, dev)
    out = {
        "atlas_log": cv_nd.log_clip(log, atlas_img, labels_img,
                                    atlas_threshold),
        "atlas_edge": edges,
        "dist_to_edge": cv_nd.distance_transform_edt(edges == 0,
                                                     device=dev),
    }
    if labels_img is not None:
        out["labels_edge"] = cv_nd.perimeter_nd(
            labels_img != 0, device=dev).astype(np.uint8)
    return out


def erode_labels(
        labels_img: np.ndarray, filter_size: int = 8,
        min_filter_size: Optional[int] = None,
        use_min_filter: bool = False, device="cuda"
) -> Tuple[np.ndarray, np.ndarray, list]:
    """Watershed markers (:func:`segmenter.labels_to_markers_erosion`),
    the labels where a marker is (interiors), and the erosion stats."""
    markers, stats = segmenter.labels_to_markers_erosion(
        labels_img, filter_size, min_filter_size, use_min_filter,
        device=device)
    interior = np.where(markers != 0, labels_img, 0)
    return markers, interior, stats


def edge_aware_segmentation(
        atlas_img: np.ndarray, labels_img: np.ndarray,
        markers: Optional[np.ndarray] = None, erosion_size: int = 8,
        mirror_axis: Optional[int] = None, mirror_mult: int = -1,
        log_sigma: float = 5.0, device="cuda"
) -> Tuple[np.ndarray, Dict[str, float]]:
    """Reannotate the labels by a watershed of their eroded markers onto
    the atlas's edges, on ``device``. When the labels mirror themselves
    along axis 0 (``mirror_axis``, found when None) and that axis is even,
    the first half is segmented and mirrored times ``mirror_mult``.
    ``markers`` replace the labels' eroded markers. Returns the labels and ``DSC_orig_new`` (foreground DSC) and
    ``VoxAgreement`` (the labelled voxels keeping their label)."""
    dev = device_mod.resolve(device)
    if mirror_axis is None:
        mirror_axis = atlas_refiner.find_symmetric_axis(
            labels_img, mirror_mult)
    _, edges = _atlas_edges(atlas_img, labels_img, log_sigma, dev)

    def segment_block(lbl):
        block = tuple(slice(0, s) for s in lbl.shape)
        if markers is None:
            mk, _, _ = erode_labels(lbl, erosion_size, device=dev)
        else:
            # the block's own markers (the reference passes the whole
            # image's, which fails on the half of a mirrored atlas)
            mk = np.where(lbl != 0, markers[block], 0)
        return segmenter.segment_from_labels(edges[block], mk, lbl,
                                             device=dev)

    if mirror_axis == 0 and labels_img.shape[0] % 2 == 0:
        half = labels_img.shape[0] // 2
        seg_half = segment_block(labels_img[:half])
        seg = np.concatenate(
            [seg_half, (seg_half[::-1] * mirror_mult)], axis=0)
    else:
        seg = segment_block(labels_img)

    dsc = atlas_refiner.measure_overlap_labels(labels_img, seg, device=dev)
    nonzero = labels_img != 0
    agree = float(np.mean(seg[nonzero] == labels_img[nonzero])) \
        if nonzero.any() else np.nan
    return seg, {"DSC_orig_new": dsc, "VoxAgreement": agree}


def edge_distances(
        labels_edge: np.ndarray, atlas_edge: np.ndarray,
        spacing: Optional[Sequence[float]] = None, device="cuda"
) -> Tuple[np.ndarray, float]:
    """Distance from each label-edge voxel to the nearest atlas edge (on
    ``device``), and its mean."""
    dist = cv_nd.distance_transform_edt(
        np.asarray(atlas_edge) == 0, sampling=spacing, device=device)
    dist_at_edges = np.where(labels_edge != 0, dist, 0)
    n = np.count_nonzero(labels_edge)
    mean_dist = float(dist_at_edges.sum() / n) if n else np.nan
    return dist_at_edges, mean_dist


def make_sub_segmented_labels(
        labels_img: np.ndarray, atlas_edge: np.ndarray,
        sub_seg_mult: int = 100, device="cuda") -> np.ndarray:
    """Split each label along the atlas's edges into its connected
    interiors: sub-labels ``sign(id) * (|id| * sub_seg_mult + k)``, ``k``
    the component (0 on the edges). Each label's bounding box is found on
    ``device`` in one pass; its components are labelled on the host within
    the box, which numbers them as the whole image would."""
    dev = device_mod.resolve(device)
    labels_img = np.asarray(labels_img)
    lab = torch.from_numpy(np.array(labels_img)).to(dev)
    ids = torch.unique(lab)
    boxes = cv_nd.label_bboxes(lab, ids)
    ndim = labels_img.ndim
    out = np.zeros_like(labels_img)
    for lid, box in zip(ids.cpu().numpy(), boxes):
        if lid == 0:
            continue
        sl = tuple(slice(a, b) for a, b in zip(box[:ndim], box[ndim:]))
        mask = labels_img[sl] == lid
        comp, _ = scipy_ndi.label(mask & (atlas_edge[sl] == 0))
        sub = np.where(mask, np.abs(lid) * sub_seg_mult, 0)
        sub = sub + np.where(mask, comp, 0)
        out[sl][mask] = np.sign(lid) * sub[mask]
    return out


def merge_atlas_segmentations(
        samples: Sequence[Tuple[np.ndarray, np.ndarray]],
        erosion_size: int = 8, log_sigma: float = 5.0, device="cuda"
) -> Tuple[list, list]:
    """:func:`edge_aware_segmentation` of each ``(atlas, labels)`` pair;
    returns the labels and the metrics, in order."""
    segs, metrics = [], []
    for atlas_img, labels_img in samples:
        seg, metr = edge_aware_segmentation(
            atlas_img, labels_img, erosion_size=erosion_size,
            log_sigma=log_sigma, device=device)
        segs.append(seg)
        metrics.append(metr)
    return segs, metrics
