"""Single-sample atlas registration, the ``--register single`` task, on
PyTorch.

Port of ``magellanmapper_tpu/atlas/register.py:35-294``: load the fixed
sample and the moving atlas with its labels, register through
:func:`reg_engine.register_duo` (translation -> affine -> B-spline), retry
with the profile's fallback metric when the overlap is poor, carry the
labels over at order 0, curate them (carve to the sample's foreground,
in-paint its unlabeled voxels), and write ``exp``, ``atlasVolume`` and
``annotation`` ``.mhd`` images with a stats CSV beside the sample, as the
reference does. ``register_rev`` swaps the roles. ``register_group``
registers a group of images to each other (``--register group``): jointly
against the group's variance, or by rounds of ``register_duo`` to the
evolving mean. ``volumes_by_id`` and ``volumes_by_id_compare`` measure
registered samples (segment sums and label overlap on the device),
``register_repeat`` applies a finished registration to another image,
``overlay_registered_imgs`` draws a sample over its registered atlas
(matplotlib, imported there) and ``get_scaled_regionprops`` scales a
region's properties back to the experiment's space
(``register.py:343-495``).
"""

from __future__ import annotations

import copy
import logging
import os
import time
from enum import Enum
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.atlas import atlas_refiner, ontology, reg_engine
from magellanmapper_torch.atlas import metrics as reg_metrics
from magellanmapper_torch.cv import cv_nd
from magellanmapper_torch.io import np_io, sitk_io
from magellanmapper_torch.parallel import comm

_logger = logging.getLogger(__name__)

register_duo = reg_engine.register_duo


class RegNames(Enum):
    """Registered-image suffix vocabulary (reference ``config.RegNames``)."""
    IMG_ATLAS = "atlasVolume.mhd"
    IMG_ATLAS_PRECUR = "atlasVolumePrecur.mhd"
    IMG_LABELS = "annotation.mhd"
    IMG_EXP = "exp.mhd"
    IMG_EXP_MASK = "expMask.mhd"
    IMG_GROUPED = "grouped.mhd"
    IMG_BORDERS = "borders.mhd"
    IMG_HEAT_MAP = "heat.mhd"
    IMG_HEAT_COLOC = "heatColoc.mhd"
    IMG_ATLAS_EDGE = "atlasEdge.mhd"
    IMG_ATLAS_LOG = "atlasLoG.mhd"
    IMG_ATLAS_MASK = "atlasMask.mhd"
    IMG_LABELS_PRECUR = "annotationPrecur.mhd"
    IMG_LABELS_TRUNC = "annotationTrunc.mhd"
    IMG_LABELS_EDGE = "annotationEdge.mhd"
    IMG_LABELS_DIST = "annotationDist.mhd"
    IMG_LABELS_MARKERS = "annotationMarkers.mhd"
    IMG_LABELS_INTERIOR = "annotationInterior.mhd"
    IMG_LABELS_SUBSEG = "annotationSubseg.mhd"
    IMG_LABELS_DIFF = "annotationDiff.mhd"
    IMG_LABELS_LEVEL = "annotationLevel{}.mhd"
    IMG_LABELS_TRANS = "annotationTrans.mhd"
    COMBINED = "combined.mhd"


def curate_img(
        fixed_img: np.ndarray, labels_img: np.ndarray,
        imgs: Optional[Sequence[np.ndarray]] = None,
        inpaint: bool = True, carve: bool = True,
        thresh: Optional[float] = None, holes_area: int = 5000,
        device="cuda"):
    """Carve transferred images to the fixed image's foreground and
    in-paint its unlabeled foreground from the nearest label."""
    out_imgs = [labels_img] if imgs is None else [labels_img, *imgs]
    result = []
    mask = None
    if carve:
        _, mask = cv_nd.carve(
            np.asarray(fixed_img, np.float32), thresh=thresh,
            holes_area=holes_area, device=device)
    for img in out_imgs:
        img = np.array(img)
        if mask is not None:
            if inpaint:
                to_fill = mask & (labels_img == 0)
                if np.any(to_fill) and np.any(labels_img != 0):
                    img = cv_nd.in_paint(img, to_fill, device=device)
            img[~mask] = 0
        result.append(img)
    return result if imgs is not None else result[0]


def load_elastix_points(path: str) -> np.ndarray:
    """An Elastix point-set file as an ``(N, 3)`` z,y,x array: a
    ``point``/``index`` header line, the point count, then one ``x y z``
    triple a line."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    start = 0
    if lines and lines[0].lower() in ("point", "index"):
        start = 2 if len(lines) > 1 and lines[1].isdigit() else 1
    pts = np.asarray(
        [[float(v) for v in ln.split()] for ln in lines[start:]],
        np.float32)
    return pts[:, ::-1]  # x,y,z -> z,y,x


def register(
        fixed_path_or_img, moving_dir_or_imgs, profile,
        resolutions: Optional[Sequence[float]] = None,
        write_imgs: bool = True, prefix: Optional[str] = None,
        iters_scale: float = 1.0, channel: int = 0,
        reg_suffixes: Optional[Dict[str, str]] = None,
        fixed_mask: Optional[np.ndarray] = None,
        moving_mask: Optional[np.ndarray] = None,
        checkpoint_dir: Optional[str] = None, mesh=None,
        device="cuda") -> Dict:
    """Register a moving atlas onto a fixed sample image on ``device``.

    Args:
        fixed_path_or_img: path to a ``.npy`` or medical image, or ndarray.
        moving_dir_or_imgs: atlas directory holding ``atlasVolume`` and
            ``annotation`` (names from ``reg_suffixes``), or a dict with
            ``atlas`` and ``labels`` arrays.
        profile: :class:`AtlasProfile` with the ``reg_*`` stages,
            ``metric_sim_fallback`` and ``curate``.
        resolutions: fixed image z,y,x spacing (read from the image when a
            path is given).
        write_imgs: write the registered images and the stats CSV.
        prefix: output path prefix (defaults to the fixed path).
        iters_scale: iteration multiplier.
        channel: channel of the fixed image to register against.
        reg_suffixes: ``atlas``/``annotation`` names in the atlas
            directory, ``fixed_mask``/``moving_mask`` suffixes of masks
            beside the fixed image.
        checkpoint_dir: directory of stage checkpoints, so a stopped
            registration resumes at its last completed stage (the
            fallback metric's retry under ``fallback`` inside it).
        mesh: a rank mesh (``parallel.mesh.make_mesh``) over which every
            registration level runs; only rank 0 writes files.

    Returns:
        dict with ``moved_atlas``, ``moved_labels``, ``transform``
        (:class:`reg_engine.RegResult`), ``metrics`` and, when written,
        ``paths``.
    """
    dev = device_mod.resolve(device)
    start = time.time()
    if isinstance(fixed_path_or_img, np.ndarray):
        fixed = fixed_path_or_img
        fixed_path = prefix or "sample"
    else:
        fixed_path = fixed_path_or_img
        if fixed_path.lower().endswith(sitk_io.EXTS_3D):
            med = sitk_io.read_med_img(fixed_path)
            fixed = med.img
            resolutions = resolutions or med.spacing
        else:
            img5d = np_io.read_file(fixed_path)
            vol = img5d.img[0]
            fixed = np.asarray(vol[..., channel] if vol.ndim > 3 else vol)
            if resolutions is None and img5d.resolutions is not None:
                resolutions = img5d.resolutions[0]
    fixed = np.asarray(fixed, np.float32)

    if isinstance(moving_dir_or_imgs, dict):
        moving_atlas = np.asarray(moving_dir_or_imgs["atlas"], np.float32)
        moving_labels = np.asarray(moving_dir_or_imgs["labels"])
    else:
        atlas_name = (reg_suffixes or {}).get("atlas", "atlasVolume")
        labels_name = (reg_suffixes or {}).get("annotation", "annotation")
        atlas_name = os.path.splitext(atlas_name)[0]
        labels_name = os.path.splitext(labels_name)[0]
        moving_atlas = sitk_io.read_med_img(sitk_io.find_sitk_file(
            os.path.join(moving_dir_or_imgs, atlas_name))).img.astype(
            np.float32)
        moving_labels = sitk_io.read_med_img(sitk_io.find_sitk_file(
            os.path.join(moving_dir_or_imgs, labels_name))).img

    if isinstance(fixed_path_or_img, str):
        sfx = reg_suffixes or {}
        if fixed_mask is None and sfx.get("fixed_mask"):
            fixed_mask = sitk_io.load_registered_img(
                prefix or fixed_path, sfx["fixed_mask"])
        if moving_mask is None and sfx.get("moving_mask"):
            moving_mask = sitk_io.load_registered_img(
                prefix or fixed_path, sfx["moving_mask"])

    # corresponding landmarks beside the fixed image when a stage is
    # point-based (fix_pts.txt / mov_pts.txt)
    fix_pts = mov_pts = None
    point_based = any(
        (profile[k] or {}).get("point_based")
        for k in ("reg_translation", "reg_affine", "reg_bspline"))
    if point_based and isinstance(fixed_path_or_img, str):
        pts_dir = os.path.dirname(os.path.abspath(fixed_path))
        fp = os.path.join(pts_dir, "fix_pts.txt")
        mp = os.path.join(pts_dir, "mov_pts.txt")
        if os.path.isfile(fp) and os.path.isfile(mp):
            fix_pts = load_elastix_points(fp)
            mov_pts = load_elastix_points(mp)
            _logger.info(
                "loaded %d corresponding points from %s / %s",
                len(fix_pts), fp, mp)

    duo = dict(iters_scale=iters_scale, fixed_mask=fixed_mask,
               moving_mask=moving_mask, fix_pts=fix_pts, mov_pts=mov_pts,
               checkpoint_dir=checkpoint_dir, mesh=mesh, device=dev)
    moved, result = reg_engine.register_duo(
        fixed, moving_atlas, profile, **duo)
    dsc = reg_metrics.measure_overlap(fixed, moved, device=dev)

    fallback = profile["metric_sim_fallback"]
    if fallback and dsc < fallback[0]:
        _logger.info(
            "DSC %.3f below threshold %.3f; retrying with metric %s",
            dsc, fallback[0], fallback[1])
        prof2 = copy.deepcopy(dict(profile))
        for stage_key in ("reg_translation", "reg_affine", "reg_bspline"):
            if prof2.get(stage_key):
                prof2[stage_key] = dict(prof2[stage_key])
                prof2[stage_key]["metric_similarity"] = fallback[1]
        if checkpoint_dir:
            duo["checkpoint_dir"] = os.path.join(checkpoint_dir, "fallback")
        moved2, result2 = reg_engine.register_duo(
            fixed, moving_atlas, prof2, **duo)
        dsc2 = reg_metrics.measure_overlap(fixed, moved2, device=dev)
        if dsc2 > dsc:
            moved, result, dsc = moved2, result2, dsc2

    # label transfer at order 0 (Transformix), then curation
    moved_labels = result.transform_img(moving_labels, order=0)
    if profile["curate"]:
        moved_labels = curate_img(fixed, moved_labels, device=dev)
    dsc_sample_labels = atlas_refiner.measure_overlap_combined_labels(
        fixed, moved_labels, device=dev)

    elapsed = time.time() - start
    metrics = {
        "DSC_atlas_sample": dsc,
        "DSC_sample_labels": dsc_sample_labels,
        "Time_s": elapsed,
    }
    out = {
        "moved_atlas": moved,
        "moved_labels": moved_labels,
        "transform": result,
        "metrics": metrics,
    }
    def write():
        base = prefix or fixed_path
        spacing = tuple(resolutions) if resolutions is not None else (
            1.0, 1.0, 1.0)
        paths = sitk_io.write_reg_images({
            RegNames.IMG_EXP.value: sitk_io.MedImage(fixed, spacing),
            RegNames.IMG_ATLAS.value: sitk_io.MedImage(
                moved.astype(np.float32), spacing),
            RegNames.IMG_LABELS.value: sitk_io.MedImage(
                moved_labels.astype(np.int32), spacing),
        }, base)
        csv_path = sitk_io.reg_out_path(base, "stats") + ".csv"
        pd.DataFrame([metrics]).to_csv(csv_path, index=False)
        paths["stats"] = csv_path
        return paths

    if write_imgs:
        out["paths"] = comm.on_writer(mesh, write)
    _logger.info("Single registration done in %.1fs, DSC %.3f", elapsed, dsc)
    return out


def register_rev(
        fixed_path_or_img, moving_dir_or_imgs, profile, **kwargs) -> Dict:
    """Reverse registration: the sample onto the atlas, with the same
    engine and the roles swapped."""
    if isinstance(moving_dir_or_imgs, dict):
        atlas = moving_dir_or_imgs["atlas"]
    else:
        atlas = sitk_io.read_med_img(sitk_io.find_sitk_file(
            os.path.join(moving_dir_or_imgs, "atlasVolume"))).img
    return register(
        np.asarray(atlas, np.float32),
        {"atlas": np.asarray(fixed_path_or_img, np.float32)
         if isinstance(fixed_path_or_img, np.ndarray)
         else np_io.read_file(fixed_path_or_img).img[0],
         "labels": np.zeros_like(np.asarray(atlas))},
        profile, **kwargs)


def register_group(
        imgs: Sequence[np.ndarray], profile, n_iters: int = 2,
        iters_scale: float = 1.0, joint: bool = True, mesh=None,
        device="cuda") -> Tuple[np.ndarray, list]:
    """Groupwise registration on ``device`` (``register.py:297-340``).

    ``joint=True`` optimises every image's transform together against the
    group's variance (:func:`reg_engine.register_groupwise`): an affine
    pass of ``groupwise_iter_max`` steps, then, when the profile has a
    B-spline stage, its ``max_iter`` steps of joint B-spline refinement
    on its grid and spacing schedule. ``joint=False`` runs ``n_iters``
    rounds of :func:`reg_engine.register_duo` of every image onto the
    group's mean, the mean taken anew after each round.

    Returns the final mean image and the per-image parameters (joint) or
    :class:`reg_engine.RegResult` objects (rounds).
    """
    dev = device_mod.resolve(device)
    if joint:
        bs = profile["reg_bspline"] or {}
        return reg_engine.register_groupwise(
            imgs, max_iter=int(profile["groupwise_iter_max"] * iters_scale),
            bspline_iter=int((bs.get("max_iter") or 0) * iters_scale),
            grid_space_voxels=float(bs.get("grid_space_voxels") or 130),
            grid_spacing_schedule=bs.get("grid_spacing_schedule"),
            mesh=mesh, device=dev)
    target = np.asarray([im.shape for im in imgs]).min(axis=0)
    vols = [np.asarray(im[:target[0], :target[1], :target[2]], np.float32)
            for im in imgs]
    mean_img = np.mean(vols, axis=0)
    results = []
    for _ in range(n_iters):
        moved_all = []
        results = []
        for vol in vols:
            moved, res = reg_engine.register_duo(
                mean_img, vol, profile, iters_scale=iters_scale, device=dev)
            moved_all.append(moved)
            results.append(res)
        mean_img = np.mean(moved_all, axis=0)
    return mean_img, results


def volumes_by_id(
        img_paths: Sequence[str],
        labels_ref_path: Optional[str] = None,
        suffix: Optional[str] = None,
        unit_factor: Optional[float] = None,
        groups: Optional[Dict] = None,
        max_level: Optional[int] = None,
        combine_sides: bool = True,
        out_path: Optional[str] = None,
        mesh=None, device="cuda") -> pd.DataFrame:
    """Regional metrics of each sample's registered images on ``device``
    (``register.py:343-398``): the registered annotation, with the atlas
    and heat map when present, through :func:`vols.measure_labels_metrics`
    (optionally at an ontology level), a ``Sample`` column first, volumes
    divided by ``unit_factor``, ``groups`` columns per sample;
    concatenated and written to ``out_path`` when given."""
    from magellanmapper_torch.stats import vols

    dev = device_mod.resolve(device)
    ref = None
    if labels_ref_path:
        ref = ontology.LabelsRef(labels_ref_path).load()
    dfs = []
    for i, path in enumerate(img_paths):
        base = path if suffix is None else path + suffix
        atlas = None
        try:
            atlas = sitk_io.load_registered_img(
                base, RegNames.IMG_ATLAS.value)
        except (FileNotFoundError, ValueError):
            pass
        labels = sitk_io.load_registered_img(
            base, RegNames.IMG_LABELS.value)
        heat = None
        try:
            heat = sitk_io.load_registered_img(
                base, RegNames.IMG_HEAT_MAP.value)
        except (FileNotFoundError, ValueError):
            pass
        df = vols.measure_labels_metrics(
            atlas, labels, heat_map=heat, combine_sides=combine_sides,
            labels_ref=ref, level=max_level, mesh=mesh, device=dev)
        if unit_factor:
            df["Volume"] = df["Volume"] / unit_factor
        df.insert(0, "Sample", os.path.basename(path))
        if groups:
            for key, vals in groups.items():
                df[key] = vals[i]
        dfs.append(df)
    out = pd.concat(dfs, ignore_index=True) if dfs else pd.DataFrame()
    if out_path:
        out.to_csv(out_path, index=False)
    return out


def volumes_by_id_compare(
        img_paths: Sequence[str],
        labels_ref_path: Optional[str] = None,
        device="cuda", **kwargs) -> pd.DataFrame:
    """Per-label DSC between the first two samples' registered
    annotations, on ``device`` (:func:`vols.measure_label_overlap`); the
    ontology path is not read, as in the reference."""
    from magellanmapper_torch.stats import vols
    dev = device_mod.resolve(device)
    labels = [sitk_io.load_registered_img(
        p, RegNames.IMG_LABELS.value) for p in img_paths[:2]]
    return vols.measure_label_overlap(labels[0], labels[1], device=dev,
                                      **kwargs)


def make_label_ids_set(
        labels_img: np.ndarray, max_level: Optional[int] = None,
        labels_ref=None, combine_sides: bool = True) -> np.ndarray:
    """The labels' nonzero IDs to measure, sides combined by absolute
    value when asked."""
    ids = np.unique(labels_img)
    ids = ids[ids != 0]
    if combine_sides:
        ids = np.unique(np.abs(ids))
    return ids


class RegImgs:
    """The images of one registration (reference ``register.RegImgs``)."""

    def __init__(self, exp_orig=None, exp=None, atlas=None, labels=None,
                 labels_markers=None, borders=None, exp_mask=None,
                 atlas_mask=None):
        self.exp_orig = exp_orig
        self.exp = exp
        self.atlas = atlas
        self.labels = labels
        self.labels_markers = labels_markers
        self.borders = borders
        self.exp_mask = exp_mask
        self.atlas_mask = atlas_mask


def register_repeat(reg_result, img: np.ndarray,
                    preserve_idents: bool = False) -> np.ndarray:
    """A finished registration's transform applied to another image, at
    order 0 with ``preserve_idents`` so label IDs survive
    (:meth:`reg_engine.RegResult.transform_img`, on its device)."""
    return reg_result.transform_img(
        img, order=0 if preserve_idents else 1)


def overlay_registered_imgs(
        fixed_file: str, moving_file_dir: Optional[str] = None,
        plane: Optional[str] = None, rotate=None,
        name_prefix: Optional[str] = None,
        out_plane: Optional[str] = None,
        out_path: Optional[str] = None, device="cuda"):
    """The fixed sample's middle plane with its registered atlas over it,
    titled with their foregrounds' DSC (Otsu masks on ``device``), saved
    to ``out_path`` when given; returns the DSC."""
    dev = device_mod.resolve(device)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    prefix = name_prefix or fixed_file
    fixed = np_io.read_file(fixed_file).img[0]
    moved = sitk_io.load_registered_img(prefix, RegNames.IMG_ATLAS.value)
    dsc = reg_metrics.measure_overlap(
        np.asarray(fixed, np.float32), np.asarray(moved, np.float32),
        device=dev)
    z = fixed.shape[0] // 2
    fig, ax = plt.subplots()
    ax.imshow(fixed[z], cmap="gray")
    zm = min(z, moved.shape[0] - 1)
    ax.imshow(moved[zm], cmap="viridis", alpha=0.5)
    ax.set_title(f"DSC {dsc:.3f}")
    if out_path:
        fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return dsc


def get_scaled_regionprops(img_region: np.ndarray, scaling):
    """A region's properties (:func:`cv_nd.get_label_props`) with its
    bounding box and centroid divided by ``scaling`` back into the
    experiment's space; ``(None, None, None)`` for an empty region."""
    props = cv_nd.get_label_props(img_region.astype(np.int8), 1)
    if not props:
        return None, None, None
    prop = props[0]
    ndim = img_region.ndim
    scaling = np.asarray(scaling, float)
    lo = np.divide(prop.bbox[:ndim], scaling)
    hi = np.divide(prop.bbox[ndim:], scaling)
    bbox = tuple(int(round(v)) for v in np.concatenate([lo, hi]))
    centroid = tuple(float(c) for c in
                     np.divide(prop.centroid, scaling))
    return props, bbox, centroid
