"""Region exports: ontology CSVs, blob density (heat) images, metric
painting, on PyTorch.

Port of ``magellanmapper_tpu/io/export_regions.py``:
:func:`export_region_ids`, :func:`export_region_network`,
:func:`make_density_image` and :func:`make_density_images_mp`,
:func:`map_metric_to_labels_img`, :func:`make_labels_level_img` and
:func:`export_common_labels`, with the reference's file names and
formats. The density image scales the blobs' coordinates into the
registered atlas's shape (float64 products truncated, as in the
reference's ``ontology.scale_coords``) and counts them per voxel on the
device (``cv_nd.build_heat_map``); the rest is host code, copied.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.atlas import ontology
from magellanmapper_torch.cv import blobs as blobs_mod
from magellanmapper_torch.cv import cv_nd
from magellanmapper_torch.io import np_io, sitk_io
from magellanmapper_torch.utils import libmag

_logger = logging.getLogger(__name__)


def export_region_ids(
        labels_ref: ontology.LabelsRef, path: str,
        level: Optional[int] = None) -> pd.DataFrame:
    """Export the ontology hierarchy to CSV
    (reference ``export_regions.export_region_ids``)."""
    df = labels_ref.get_ref_lookup_as_df()
    if level is not None:
        df = df[[lvl is None or lvl <= level for lvl in df["Level"]]]
    df = df.drop(columns=["ParentIDs"], errors="ignore")
    df.to_csv(path, index=False)
    return df


def export_region_network(
        labels_ref: ontology.LabelsRef, path: str) -> pd.DataFrame:
    """Export parent-child edges as a SIF-style graph
    (reference ``export_regions.export_region_network``)."""
    rows = []
    for lid, entry in labels_ref.ref_lookup.items():
        parents = entry[ontology.PARENT_IDS]
        if parents:
            rows.append({
                "source": parents[-1], "interaction": "pp",
                "target": lid})
    df = pd.DataFrame(rows)
    df.to_csv(path, sep="\t", index=False, header=False)
    return df


def make_density_image(
        img_path: str,
        scale: Optional[float] = None,
        shape: Optional[Sequence[int]] = None,
        suffix: Optional[str] = None,
        blobs: Optional[blobs_mod.Blobs] = None,
        channel: Optional[Sequence[int]] = None,
        device="cuda") -> Tuple[np.ndarray, str]:
    """Build a blob heat map in registered (atlas) space on ``device``
    (reference ``export_regions.make_density_image``).

    The target shape and spacing come from ``<base>_atlasVolume.mhd``
    when present, else from the main image scaled by ``scale``; the
    blobs (``<base>_blobs.npz`` unless given) are scaled from the main
    image's shape into it and counted per voxel. Writes
    ``<base>_heat.mhd`` (int32). Returns ``(heat, path)``.
    """
    device_mod.resolve(device)
    if blobs is None:
        blobs = blobs_mod.Blobs().load_blobs(
            libmag.combine_paths(img_path, "blobs.npz"))
    arr = blobs.blobs
    if channel is not None:
        arr = blobs_mod.Blobs.blobs_in_channel(arr, channel)

    # target shape: registered atlas if present, else scaled main image
    target_shape = shape
    spacing = (1.0, 1.0, 1.0)
    if target_shape is None:
        try:
            med = sitk_io.read_med_img(sitk_io.find_sitk_file(
                sitk_io.reg_out_path(img_path, "atlasVolume.mhd")))
            target_shape = med.img.shape
            spacing = med.spacing
        except (FileNotFoundError, ValueError):
            pass
    img5d = np_io.read_file(img_path)
    if target_shape is None:
        factor = scale or 1.0
        target_shape = tuple(
            int(s * factor) for s in img5d.img.shape[1:4])

    scaling = np_io.find_scaling(img5d.img.shape[1:4], target_shape)
    coords = ontology.scale_coords(arr[:, :3], scaling, target_shape)
    heat = cv_nd.build_heat_map(target_shape, coords, device=device)
    out_path = sitk_io.reg_out_path(img_path, "heat.mhd")
    sitk_io.write_med_img(out_path, sitk_io.MedImage(
        heat.astype(np.int32), spacing))
    _logger.info("wrote density image %s (%d blobs)", out_path, len(arr))
    return heat, out_path


def map_metric_to_labels_img(
        labels_img: np.ndarray, df: pd.DataFrame, metric: str,
        out_path: Optional[str] = None) -> np.ndarray:
    """Paint a metric into the labels image and optionally save
    (reference ``export_regions.map_metric_to_labels_img``)."""
    from magellanmapper_torch.stats import vols
    out = vols.map_meas_to_labels(labels_img, df, metric)
    if out_path:
        sitk_io.write_med_img(out_path, sitk_io.MedImage(
            out.astype(np.float32)))
    return out


def make_labels_level_img(
        labels_img: np.ndarray, labels_ref: ontology.LabelsRef,
        level: int, out_path: Optional[str] = None) -> np.ndarray:
    """Remap labels to an ontology level and optionally save
    (reference ``export_regions.make_labels_level_img``)."""
    out = ontology.make_labels_level(
        labels_img, labels_ref.ref_lookup, level)
    if out_path:
        sitk_io.write_med_img(out_path, sitk_io.MedImage(
            out.astype(np.int32)))
    return out


def export_common_labels(
        img_paths, out_path: Optional[str] = None) -> pd.DataFrame:
    """Labels present in every sample's annotation image
    (reference ``export_regions.export_common_labels``)."""
    common = None
    for path in img_paths:
        labels = sitk_io.load_registered_img(path, "annotation.mhd")
        ids = set(int(i) for i in np.unique(labels) if i != 0)
        common = ids if common is None else (common & ids)
    df = pd.DataFrame({"Region": sorted(common or [])})
    if out_path:
        df.to_csv(out_path, index=False)
    _logger.info("%d labels common across %d samples",
                 len(df), len(img_paths))
    return df


def make_density_images_mp(
        img_paths: Sequence[str], scale: Optional[float] = None,
        shape: Optional[Sequence[int]] = None,
        suffix: Optional[str] = None,
        channel: Optional[Sequence[int]] = None,
        device="cuda") -> list:
    """Density images for a batch of samples, one after another
    (reference ``export_regions.make_density_images_mp``); a sample that
    fails is logged and skipped."""
    out = []
    for path in img_paths:
        try:
            out.append(make_density_image(
                path, scale=scale, shape=shape, suffix=suffix,
                channel=channel, device=device))
        except (FileNotFoundError, ValueError) as exc:
            _logger.warning("density image failed for %s: %s", path, exc)
    return out
