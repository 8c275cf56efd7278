"""Command-line entry of the port: image import and export, plane, ROI
and plot exports, blob detection and the analysis of its blobs, its grid
search, single-sample atlas registration, and the specimen pipeline
around it.

``python -m magellanmapper_torch.io.cli --img stack.tif --proc
import_only [--set_meta resolutions=z,y,x] [--prefix out]`` imports a
(multi-page, OME-) TIFF into ``<prefix or stack>_image5d.npy`` and its
metadata (:func:`~magellanmapper_torch.io.importer.import_tiff`); the
vendor formats (``.czi``, ``.lif`` (its ``--series``), ``.nd2``,
``.oib``, ``.oif``, ``.ims``) import by extension through the port's
copies of the reference's readers
(:data:`~magellanmapper_torch.io.importer.VENDOR_IMPORTERS`).
``--proc load`` returns the image; ``--proc export_tif`` and
``export_raw`` write its first time point as ``<prefix or image
base>.tif`` and the whole array as ``.raw``;
``--proc export_blobs`` writes ``blobs.npz`` as ``<base>_blobs.csv``.
``--proc extract [--offset x,y,z] [--plane xy|xz|yz]`` saves the plane at
the offset's z (default 0) as ``<base>_plane<plane><z>.npy``; ``--proc
export_rois --truth_db <db>`` writes each of the database's ROIs as
``<base>_rois/roi_<id>.npy`` and its blobs as ``roi_<id>_blobs.csv``;
``--proc export_planes [--savefig ext] [--channel c]`` writes each z-plane
as ``<base>_planes/plane_<z>.<ext>`` (``export_planes_channels``: one file
a channel); ``--proc animated [--slice start,stop[,step]] [--delay ms]``
animates the z-planes into ``<base>.gif``; ``--plot_2d <task> [--labels
x_col=... y_col=...]`` plots a CSV table into ``<prefix or table>.png``
(:mod:`~magellanmapper_torch.plot.plot_2d`). The plane files, animations
and plots are matplotlib's, imported only by these tasks.
These tasks run on the host whatever ``--device`` says.

``python -m magellanmapper_torch.io.cli --img vol.npy --proc detect
--roi_profile lightsheet [--device cuda]`` runs the port's
:func:`~magellanmapper_torch.cv.stack_detect.detect_blobs_stack` and
writes ``blobs.npz`` and ``stack_detection_times.csv`` next to the image
as the reference's ``--proc detect`` task does; ``--truth_db <db>``
also matches the blobs to the database's confirmed blobs and writes
sensitivity and PPV to ``verify.csv``, and ``--save_subimg`` saves the
``--subimg_offset``/``--subimg_size`` sub-image as
``<image>_(x,y,z)x(x,y,z)_subimg.npy``.

Blob analysis: ``--proc detect_coloc --channel 0 1`` detects every
channel and flags each blob's colocalization with the other channels
(``colocs`` in ``blobs.npz``, :func:`cv.colocalizer.colocalize_blobs`);
``--proc coloc_match`` matches the saved blobs between channel pairs
(:func:`cv.colocalizer.colocalize_blobs_match`; returns the matches);
``--proc classify [--classifier model.pkl]`` classifies the saved blobs
with the patch CNN (an untrained one without a model, as in the
reference) into their ``confirmed`` column; ``--register cluster_blobs``
clusters the saved blobs with DBSCAN (eps from their 5-nearest-neighbour
distances) into ``<prefix or image>_clusters.npy``.

``python -m magellanmapper_torch.io.cli --img vol.npy --proc transform
--transform rescale=0.25 [--plane xz]`` shrinks (and reorients) the
whole image, streamed through the device, into
``vol_scale0.25_image5d.npy`` with its metadata
(:func:`~magellanmapper_torch.atlas.transformer.transpose_img`);
``--proc preprocess saturate denoise remap rotate90`` runs those
whole-image tasks and writes the result at ``--prefix`` (default: over
the image).

``python -m magellanmapper_torch.io.cli --img fixed.npy atlas_dir
--register single [--atlas_profile ncc,nobspline]`` registers the atlas
directory's ``atlasVolume``/``annotation`` images onto the fixed sample
(:func:`~magellanmapper_torch.atlas.register.register`) and writes the
``exp``, ``atlasVolume`` and ``annotation`` ``.mhd`` images and a stats
CSV beside it (or at ``--prefix``); ``--register register_rev`` registers
the sample onto the atlas instead. ``--reg_suffixes atlas=...
annotation=...`` names other images of the atlas directory. As in the
reference, ``--register`` takes precedence over every other task.

The specimen's counts: ``--img spec.npy --register make_density_images``
scales ``spec_blobs.npz`` into the registered ``spec_atlasVolume.mhd``'s
shape and writes the per-voxel count as ``spec_heat.mhd`` (one or more
images); ``--img spec.npy --register vol_stats [--labels path_ref=...]``
measures every region of ``spec_annotation.mhd`` (volume, intensity of
``spec_atlasVolume.mhd``, nuclei of ``spec_heat.mhd`` when present) into
``<prefix or base>_vols.csv``; ``--register export_regions --labels
path_ref=ontology.json [level=N]`` writes the ontology's regions to
``--prefix`` (default ``region_ids.csv``). As in the reference,
``vol_stats`` measures the labels as they are: ``level=`` is read only by
``export_regions``.

Atlas construction: ``--img s1.npy s2.npy ... --register group
--atlas_profile groupwise`` registers the images to each other (jointly
against the group's variance; writes nothing, as in the reference);
``--img atlas_dir --register import_atlas --atlas_profile abap56``
curates an atlas directory's ``atlasVolume``/``annotation`` by the
profile (edge extension, mirroring, smoothing) into
``<atlas_dir>_imported_{atlasVolume,annotation}.mhd`` and a metrics CSV
(``new_atlas``: named after ``--prefix``, default ``<atlas_dir>_new``);
``--img base --register make_edge_images`` writes the edge images of
``base_atlasVolume.mhd`` and ``base_annotation.mhd`` (``atlasEdge``,
``atlasLoG``, ``annotationEdge``, ``annotationDist``,
``annotationMarkers``, ``annotationInterior``); ``--register
merge_atlas_segs`` rewrites each image's ``annotation.mhd`` by an
edge-aware watershed; ``--register make_subsegs`` writes
``annotationSubseg.mhd``. The ``_exp`` forms run as the plain ones, as in
the reference.

Comparing and merging registered samples: ``--img a.npy b.npy
--register labels_diff`` writes the per-label DSC of the two samples'
``annotation.mhd`` as ``a_labels_diff.csv`` and the voxels that differ as
``a_annotationDiff.mhd`` (``labels_diff_stats``: the table only);
``labels_dist`` writes their centroid shifts as
``a.npy_labels_dist.csv``; ``vol_compare`` returns the DSC table;
``merge_images[_channels]`` sums (stacks) the samples'
``atlasVolume.mhd`` into ``a_combined.mhd``; ``export_common_labels``,
``convert_itksnap_labels``, ``make_labels_level --labels path_ref=...
level=N``, ``smoothing_metrics_aggr``, ``plot_knns``,
``plot_smoothing_metrics``, ``export_metrics_compactness`` and
``overlays`` write the reference's tables, images and plots
(:func:`register_tables`).

``python -m magellanmapper_torch.io.cli --img roi.npy --grid_search
gridtest --roi_profile 4xnuc --truth_db truth.db`` runs the named
grid-search profile over the image and scores every combination against
the confirmed blobs of the truth database
(:func:`~magellanmapper_torch.stats.mlearn.grid_search_from_cli`),
writing ``<image>_gridsearch.csv`` as the reference's task does. As in the
reference, ``--grid_search`` takes precedence over ``--proc``.

The parser takes the reference's flag names
(``magellanmapper_tpu/io/cli.py:124-194``) for what the port accepts:
``--img``, ``--proc detect|detect_coloc|coloc_match|classify|transform|
preprocess|import_only|load|export_tif|export_raw|export_blobs|extract|
export_rois|export_planes|export_planes_channels|animated``, ``--plot_2d``,
``--register single|register_rev|make_density_images|
vol_stats|export_regions|group|import_atlas|new_atlas|
make_edge_images[_exp]|merge_atlas_segs[_exp]|make_subsegs|
cluster_blobs|export_common_labels|convert_itksnap_labels|
make_labels_level|labels_diff[_stats]|labels_dist|smoothing_metrics_aggr|
plot_knns|plot_smoothing_metrics|export_metrics_compactness|vol_compare|
overlays|merge_images[_channels]``, ``--classifier``,
``--roi_profile`` (one per channel), ``--atlas_profile``,
``--reg_suffixes``, ``--transform``, ``--plane``, ``--labels``,
``--channel``, ``--series``, ``--prefix``,
``--subimg_offset``/``--subimg_size``, ``--set_meta resolutions=z,y,x``,
``--grid_search``, ``--truth_db`` (with ``--grid_search``, the detect
tasks or ``export_rois``), ``--save_subimg`` (with the detect tasks),
``--offset``, ``--slice``, ``--delay``, ``--savefig``, ``--plot_labels``
and ``--device``. Any other flag or task is rejected with a message that
names it.

``--device`` picks where the device step runs: ``cuda`` (the default)
fails without a card, and the CPU, which runs the kernels' plain
versions, is used only when ``--device cpu`` asks for it.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from dataclasses import dataclass, field
from enum import Enum, auto
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import pandas as pd

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.atlas import (
    atlas_refiner, edge_seg, ontology, transformer)
from magellanmapper_torch.atlas import register as register_mod
from magellanmapper_torch.cv import blobs as blobs_mod
from magellanmapper_torch.cv import (
    classifier as classifier_mod, colocalizer, detector, stack_detect,
    verifier)
from magellanmapper_torch.io import (
    export_regions, export_rois, export_stack, importer, naming, np_io,
    sitk_io, sqlite, tiff)
from magellanmapper_torch.plot import plot_support
from magellanmapper_torch.settings.atlas_prof import AtlasProfile
from magellanmapper_torch.settings.roi_prof import ROIProfile
from magellanmapper_torch.stats import clustering, mlearn, vols
from magellanmapper_torch.utils import libmag

_logger = logging.getLogger(__name__)

#: ``--proc`` tasks that run on the host: import, load and export
HOST_TASKS = ("import_only", "load", "export_tif", "export_raw",
              "export_blobs", "extract", "export_rois", "export_planes",
              "export_planes_channels", "animated")
#: ``--proc`` tasks the port runs
TASKS = ("detect", "detect_coloc", "coloc_match", "classify", "transform",
         "preprocess") + HOST_TASKS
#: the tasks that detect, which take ``--truth_db`` and ``--save_subimg``
DETECT_TASKS = ("detect", "detect_coloc")


class RegisterTypes(Enum):
    """The ``--register`` task names (copy of the reference's
    ``settings.config.RegisterTypes``)."""
    SINGLE = auto()
    GROUP = auto()
    REGISTER_REV = auto()
    OVERLAYS = auto()
    EXPORT_REGIONS = auto()
    NEW_ATLAS = auto()
    IMPORT_ATLAS = auto()
    EXPORT_COMMON_LABELS = auto()
    CONVERT_ITKSNAP_LABELS = auto()
    MAKE_EDGE_IMAGES = auto()
    MAKE_EDGE_IMAGES_EXP = auto()
    MERGE_ATLAS_SEGS = auto()
    VOL_STATS = auto()
    VOL_COMPARE = auto()
    MAKE_DENSITY_IMAGES = auto()
    MERGE_ATLAS_SEGS_EXP = auto()
    MAKE_SUBSEGS = auto()
    EXPORT_METRICS_COMPACTNESS = auto()
    PLOT_SMOOTHING_METRICS = auto()
    SMOOTHING_PEAKS = auto()
    SMOOTHING_METRICS_AGGR = auto()
    MERGE_IMAGES = auto()
    MERGE_IMAGES_CHANNELS = auto()
    LABELS_DIFF = auto()
    LABELS_DIFF_STATS = auto()
    MAKE_LABELS_LEVEL = auto()
    COMBINE_COLS = auto()
    ZSCORES = auto()
    COEFVAR = auto()
    MELT_COLS = auto()
    PLOT_REGION_DEV = auto()
    PLOT_LATERAL_UNLABELED = auto()
    PLOT_INTENS_NUC = auto()
    PIVOT_CONDS = auto()
    MEAS_IMPROVEMENT = auto()
    CLUSTER_BLOBS = auto()
    PLOT_KNNS = auto()
    PLOT_CLUSTER_BLOBS = auto()
    LABELS_DIST = auto()


#: the ``--register`` tasks that compare, merge or plot registered
#: images and their tables (:func:`register_tables`)
TABLE_TASKS = (
    RegisterTypes.EXPORT_COMMON_LABELS, RegisterTypes.CONVERT_ITKSNAP_LABELS,
    RegisterTypes.MAKE_LABELS_LEVEL, RegisterTypes.LABELS_DIFF,
    RegisterTypes.LABELS_DIFF_STATS, RegisterTypes.LABELS_DIST,
    RegisterTypes.SMOOTHING_METRICS_AGGR, RegisterTypes.PLOT_KNNS,
    RegisterTypes.PLOT_SMOOTHING_METRICS,
    RegisterTypes.EXPORT_METRICS_COMPACTNESS, RegisterTypes.VOL_COMPARE,
    RegisterTypes.OVERLAYS, RegisterTypes.MERGE_IMAGES,
    RegisterTypes.MERGE_IMAGES_CHANNELS)
#: ``--register`` tasks the port runs
REGISTER_TASKS = (
    RegisterTypes.SINGLE, RegisterTypes.REGISTER_REV,
    RegisterTypes.MAKE_DENSITY_IMAGES, RegisterTypes.VOL_STATS,
    RegisterTypes.EXPORT_REGIONS, RegisterTypes.GROUP,
    RegisterTypes.IMPORT_ATLAS, RegisterTypes.NEW_ATLAS,
    RegisterTypes.MAKE_EDGE_IMAGES, RegisterTypes.MAKE_EDGE_IMAGES_EXP,
    RegisterTypes.MERGE_ATLAS_SEGS, RegisterTypes.MERGE_ATLAS_SEGS_EXP,
    RegisterTypes.MAKE_SUBSEGS, RegisterTypes.CLUSTER_BLOBS) + TABLE_TASKS
#: the tasks that register an atlas directory onto a sample
PAIR_TASKS = (RegisterTypes.SINGLE, RegisterTypes.REGISTER_REV)
#: what the port runs, for the messages that reject the rest
SUPPORTED = ("--proc detect/detect_coloc/coloc_match/classify/transform/"
             "preprocess/import_only/load/export_tif/export_raw/"
             "export_blobs/extract/export_rois/export_planes[_channels]/"
             "animated, --plot_2d, --grid_search and --register single/"
             "register_rev/make_density_images/vol_stats/export_regions/"
             "group/import_atlas/new_atlas/make_edge_images[_exp]/"
             "merge_atlas_segs[_exp]/make_subsegs/cluster_blobs/"
             "export_common_labels/convert_itksnap_labels/"
             "make_labels_level/labels_diff[_stats]/labels_dist/"
             "smoothing_metrics_aggr/plot_knns/plot_smoothing_metrics/"
             "export_metrics_compactness/vol_compare/overlays/"
             "merge_images[_channels]")


@dataclass
class RunConfig:
    """Parsed command line: the fields of the reference's ``RunConfig``
    (``magellanmapper_tpu/io/cli.py:32``) that the port's tasks read, with
    the same values for the same arguments; ``proc`` is the task's name
    (the reference keeps a ``ProcessTypes`` member)."""
    filenames: List[str] = field(default_factory=list)
    channel: Optional[List[int]] = None
    series: int = 0
    subimg_offsets: Optional[List[List[int]]] = None
    subimg_sizes: Optional[List[List[int]]] = None
    proc: Optional[str] = None
    proc_args: Dict[str, str] = field(default_factory=dict)
    resolutions: Optional[List[float]] = None
    roi_profile: ROIProfile = field(default_factory=ROIProfile)
    roi_profiles: List[ROIProfile] = field(default_factory=list)
    truth_db: Optional[str] = None
    prefix: Optional[str] = None
    grid_search: Optional[str] = None
    register_type: Optional[RegisterTypes] = None
    atlas_profile: AtlasProfile = field(default_factory=AtlasProfile)
    reg_suffixes: Dict[str, str] = field(default_factory=dict)
    transform: Dict[str, str] = field(default_factory=dict)
    plane: Optional[str] = None
    labels: Dict[str, str] = field(default_factory=dict)
    classifier: Optional[List[str]] = None
    save_subimg: bool = False
    offset: Optional[List[int]] = None
    slice_vals: Optional[List[int]] = None
    delay: Optional[int] = None
    savefig: Optional[str] = None
    plot_labels: Dict[str, str] = field(default_factory=dict)
    plot_2d_task: Optional[str] = None
    device: str = "cuda"


def args_to_dict(args: Optional[Sequence[str]]) -> Dict[str, str]:
    """Parse ``key=value`` argument lists (a bare key maps to "1")."""
    out: Dict[str, str] = {}
    for arg in args or ():
        if "=" in arg:
            k, v = arg.split("=", 1)
            out[k] = v
        else:
            out[arg] = "1"
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m magellanmapper_torch.io.cli",
        description="MagellanMapper blob detection on PyTorch/CUDA")
    p.add_argument("--img", nargs="*", help="image path(s)")
    p.add_argument("--prefix", help="output path prefix")
    p.add_argument("--channel", nargs="*", type=int, help="channel(s)")
    p.add_argument("--series", type=int, default=0, help="series index")
    p.add_argument("--subimg_offset", nargs="*", help="sub-image offset x,y,z")
    p.add_argument("--subimg_size", nargs="*", help="sub-image size x,y,z")
    p.add_argument("--truth_db", nargs="*", help="truth DB mode and path")
    p.add_argument("--offset", nargs="*", help="ROI offset x,y,z")
    p.add_argument("--proc", nargs="*",
                   help="processing task: detect, detect_coloc, "
                   "coloc_match, classify, transform, preprocess <tasks>, "
                   "import_only, load, export_tif, export_raw, "
                   "export_blobs, extract, export_rois, export_planes, "
                   "export_planes_channels or animated")
    p.add_argument("--plot_2d", help="2D plot task of a CSV table")
    p.add_argument("--plot_labels", nargs="*", help="plot labels")
    p.add_argument("--slice", help="plane range start,stop[,step]")
    p.add_argument("--delay", type=int, help="animation delay (ms)")
    p.add_argument("--savefig", help="figure file format")
    p.add_argument("--register",
                   help="registration task: single, register_rev, "
                   "make_density_images, vol_stats, export_regions, group, "
                   "import_atlas, new_atlas, make_edge_images[_exp], "
                   "merge_atlas_segs[_exp], make_subsegs, cluster_blobs, "
                   "export_common_labels, convert_itksnap_labels, "
                   "make_labels_level, labels_diff[_stats], labels_dist, "
                   "smoothing_metrics_aggr, plot_knns, "
                   "plot_smoothing_metrics, export_metrics_compactness, "
                   "vol_compare, overlays or merge_images[_channels]")
    p.add_argument("--roi_profile", nargs="*", help="ROI profile(s)")
    p.add_argument("--atlas_profile", help="atlas profile")
    p.add_argument("--reg_suffixes", nargs="*",
                   help="registered image suffixes (atlas=..., "
                   "annotation=...)")
    p.add_argument("--labels", nargs="*", help="labels args "
                   "(path_ref=..., level=...)")
    p.add_argument("--transform", nargs="*", help="transform args "
                   "(rescale=...)")
    p.add_argument("--plane", help="plane orientation (xy/xz/yz)")
    p.add_argument("--grid_search", help="grid search profile")
    p.add_argument("--classifier", nargs="*",
                   help="blob classifier model file (--proc classify)")
    p.add_argument("--save_subimg", action="store_true",
                   help="save the sub-image that detection read")
    p.add_argument("--set_meta", nargs="*",
                   help="metadata overrides (resolutions=z,y,x)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def process_cli_args(argv: Optional[Sequence[str]] = None) -> RunConfig:
    """Parse ``argv`` into a :class:`RunConfig`; a flag or task the port
    does not have raises ``SystemExit`` naming it."""
    args, unknown = build_parser().parse_known_args(argv)
    flags = [a for a in unknown if a.startswith("-")]
    if unknown:
        raise SystemExit(
            "magellanmapper_torch does not take "
            f"{' '.join(flags or unknown)}; it supports only {SUPPORTED} "
            "so far (use magellanmapper_tpu.io.cli for other tasks)")
    rc = RunConfig(device=args.device)
    if args.img:
        rc.filenames = list(args.img)
    rc.channel = args.channel
    rc.series = args.series
    rc.prefix = args.prefix

    def parse_coords(vals):
        if not vals:
            return None
        return [[int(v) for v in val.split(",")] for val in vals]

    rc.subimg_offsets = parse_coords(args.subimg_offset)
    rc.subimg_sizes = parse_coords(args.subimg_size)
    offsets = parse_coords(args.offset)
    rc.offset = offsets[0] if offsets else None
    if args.slice:
        rc.slice_vals = [int(v) for v in args.slice.split(",")]
    rc.delay = args.delay
    rc.savefig = args.savefig
    rc.plot_labels = args_to_dict(args.plot_labels)
    rc.plot_2d_task = args.plot_2d
    meta = args_to_dict(args.set_meta)
    if "resolutions" in meta:
        rc.resolutions = [float(v) for v in meta["resolutions"].split(",")]
    # profiles: comma-separated modifier chains, one per channel
    for prof_names in args.roi_profile or ():
        prof = ROIProfile()
        prof.add_profiles(prof_names)
        rc.roi_profiles.append(prof)
    if rc.roi_profiles:
        rc.roi_profile = rc.roi_profiles[0]
    if args.atlas_profile:
        rc.atlas_profile = AtlasProfile()
        rc.atlas_profile.add_profiles(args.atlas_profile)
    rc.reg_suffixes = args_to_dict(args.reg_suffixes)
    rc.transform = args_to_dict(args.transform)
    rc.labels = args_to_dict(args.labels)
    rc.plane = args.plane
    rc.grid_search = args.grid_search
    rc.classifier = args.classifier
    rc.save_subimg = args.save_subimg
    if args.proc:
        rc.proc = args.proc[0].lower()
        rc.proc_args = args_to_dict(args.proc[1:])
    if args.truth_db:
        rc.truth_db = args.truth_db[-1]
    if args.register:
        task = f"--register {args.register}"
        rc.register_type = RegisterTypes.__members__.get(
            args.register.upper())
        if rc.register_type not in REGISTER_TASKS:
            raise SystemExit(
                f"magellanmapper_torch runs only {SUPPORTED} so far (got "
                f"{task}); use magellanmapper_tpu.io.cli for other tasks")
        if rc.register_type in PAIR_TASKS and len(rc.filenames) < 2:
            raise SystemExit(f"{task} needs --img <sample> <atlas_dir>")
    elif rc.plot_2d_task:
        task = f"--plot_2d {rc.plot_2d_task}"
        plot_2d_type(rc.plot_2d_task)
    else:
        task = "--grid_search" if rc.grid_search else (
            f"--proc {rc.proc}" if rc.proc else None)
        if not rc.grid_search and rc.proc not in TASKS:
            raise SystemExit(
                f"magellanmapper_torch supports only {SUPPORTED} so far "
                f"(got {task}); use magellanmapper_tpu.io.cli for other "
                "tasks")
    by_proc = (rc.register_type is None and not rc.plot_2d_task
               and not rc.grid_search)
    detects = by_proc and rc.proc in DETECT_TASKS
    if rc.truth_db and not (rc.grid_search or detects or (
            by_proc and rc.proc == "export_rois")):
        raise SystemExit(
            "magellanmapper_torch takes --truth_db only with --grid_search "
            "or --proc detect/detect_coloc/export_rois")
    if rc.save_subimg and not detects:
        raise SystemExit(
            "magellanmapper_torch takes --save_subimg only with --proc "
            "detect/detect_coloc")
    if not rc.filenames and rc.register_type is not \
            RegisterTypes.EXPORT_REGIONS:
        raise SystemExit(f"{task} needs --img")
    return rc


def plot_2d_type(name: str):
    """The ``Plot2DTypes`` member of a ``--plot_2d`` task name; an unknown
    name raises ``SystemExit`` naming the flag and the known tasks."""
    from magellanmapper_torch.plot import plot_2d
    try:
        return plot_2d.Plot2DTypes[name.upper()]
    except KeyError:
        raise SystemExit(
            f"unknown --plot_2d task: {name}; options: " + ", ".join(
                e.name.lower() for e in plot_2d.Plot2DTypes)) from None


def plot_2d_task(rc: RunConfig):
    """The ``--plot_2d`` task: plot the CSV table ``filenames[0]`` into
    ``--prefix`` (default ``<table>.png``); the columns come from
    ``--labels`` or ``--plot_labels`` ``x_col=``/``y_col=`` (default the
    first two). Returns the figure."""
    from magellanmapper_torch.plot import plot_2d
    task = plot_2d_type(rc.plot_2d_task)
    types = plot_2d.Plot2DTypes
    df = pd.read_csv(rc.filenames[0])
    out_path = rc.prefix or (rc.filenames[0] + ".png")
    if task is types.ROC_CURVE:
        return plot_2d.plot_roc(df, out_path)
    x_col = str(rc.labels.get(
        "x_col", rc.plot_labels.get("x_col", df.columns[0])))
    y_col = str(rc.labels.get(
        "y_col", rc.plot_labels.get("y_col", df.columns[1])))
    if task is types.BAR_PLOT:
        return plot_2d.plot_bars(df, x_col, y_col, out_path)
    if task is types.LINE_PLOT:
        return plot_2d.plot_lines(df, x_col, [y_col], out_path)
    if task is types.SWARM_PLOT:
        return plot_2d.plot_swarm(df, x_col, y_col, out_path)
    if task is types.CAT_PLOT:
        return plot_2d.plot_catplot(df, x_col, y_col, out_path=out_path)
    if task in (types.BAR_PLOT_VOLS_STATS, types.BAR_PLOT_VOLS_STATS_EFFECTS):
        ycol = "Volume" if "Volume" in df.columns else y_col
        return plot_2d.plot_bars(
            df, x_col if x_col in df.columns else "Region", ycol, out_path)
    if task is types.HISTOGRAM:
        return plot_2d.plot_histogram(df, y_col, path=out_path)
    return plot_2d.plot_scatter(df, x_col, y_col, path=out_path)


def load_image(rc: RunConfig) -> np_io.Image5d:
    """The main image, cut to the sub-image when one is given, with
    ``--set_meta`` resolutions applied (reference ``cli._load_image``)."""
    offset = rc.subimg_offsets[0] if rc.subimg_offsets else None
    size = rc.subimg_sizes[0] if rc.subimg_sizes else None
    img5d = np_io.read_file(rc.filenames[0], rc.series, offset=offset,
                            size=size)
    if rc.resolutions is not None:
        img5d.meta["resolutions"] = [rc.resolutions]
    return img5d


def detect(rc: RunConfig, device, coloc: bool = False) -> blobs_mod.Blobs:
    """The ``--proc detect`` and ``detect_coloc`` tasks: detect (with
    ``coloc``, flag each blob's colocalization with every channel), verify
    against ``--truth_db`` into ``verify.csv``, save the sub-image with
    ``--save_subimg``, then save the blob archive and the stage timings
    next to the image."""
    img5d = load_image(rc)
    vol = img5d.img[0] if img5d.img.ndim >= 4 else img5d.img
    res = _resolutions(img5d)
    blobs, timing = stack_detect.detect_blobs_stack(
        vol, rc.roi_profiles or rc.roi_profile, res, channels=rc.channel,
        device=device)
    if coloc and blobs.blobs is not None and vol.ndim > 3:
        blobs.colocalizations = colocalizer.colocalize_blobs(
            vol, blobs.blobs, device=device)
    base = rc.prefix or rc.filenames[0]
    blobs.basename = os.path.basename(base)
    if rc.truth_db:
        verify_truth(rc, blobs.blobs, res, base)
    if rc.save_subimg and img5d.subimg_offset is not None:
        sub_name = naming.make_subimage_name(
            base, img5d.subimg_offset, img5d.subimg_size)
        np.save(libmag.combine_paths(sub_name, "subimg.npy"),
                np.asarray(img5d.img[0]))
    blobs.path = libmag.combine_paths(base, "blobs.npz")
    blobs.save_archive()
    pd.DataFrame([{k: v for k, v in timing.items()
                   if isinstance(v, (int, float))}]).to_csv(
        libmag.combine_paths(base, "stack_detection_times.csv"),
        index=False)
    _logger.info(
        "Detected %d blobs on %s in %.2fs (detection %.2fs, pruning %.2fs)",
        len(blobs), device, timing.get("Total_stack", 0),
        timing.get("Detection", 0), timing.get("Pruning", 0))
    return blobs


def _resolutions(img5d: np_io.Image5d):
    return (img5d.resolutions[0] if img5d.resolutions is not None
            else (1.0, 1.0, 1.0))


def verify_truth(rc: RunConfig, blobs: np.ndarray, res, base: str):
    """Match ``blobs`` to the confirmed blobs of ``--truth_db`` within the
    profile's tolerance and write sensitivity and PPV to ``verify.csv``
    beside ``base`` (nothing when the database has no confirmed blob)."""
    truth_db = sqlite.load_truth_db(rc.truth_db)
    try:
        truth = truth_db.select_blobs_confirmed(1)
        if len(truth):
            tol = detector.calc_overlap(res) * np.asarray(
                rc.roi_profile["verify_tol_factor"])
            sens, ppv, msg = verifier.verify_stack(blobs, truth, tol)
            _logger.info("verification vs truth DB:\n%s", msg)
            pd.DataFrame([{"sens": sens, "ppv": ppv}]).to_csv(
                libmag.combine_paths(base, "verify.csv"), index=False)
    finally:
        truth_db.close()


def load_blobs(rc: RunConfig) -> blobs_mod.Blobs:
    """The blob archive saved beside ``--prefix`` or the image."""
    path = libmag.combine_paths(rc.prefix or rc.filenames[0], "blobs.npz")
    return blobs_mod.Blobs().load_blobs(path)


def coloc_match(rc: RunConfig) -> Dict:
    """The ``--proc coloc_match`` task: match the saved blobs between each
    pair of channels within the detection overlap (host matching)."""
    img5d = load_image(rc)
    blobs = load_blobs(rc)
    tol = detector.calc_overlap(_resolutions(img5d))
    shape = img5d.img.shape[1:4]
    return colocalizer.colocalize_blobs_match(
        blobs.blobs, (0, 0, 0), shape[::-1], tol)


def classify(rc: RunConfig, device) -> Optional[blobs_mod.Blobs]:
    """The ``--proc classify`` task: classify the saved blobs on the
    image's first channel with ``--classifier``'s model (an untrained
    ``BlobClassifier(seed=0)`` without one) and save them back."""
    img5d = load_image(rc)
    blobs = load_blobs(rc)
    if blobs.blobs is None or not len(blobs.blobs):
        _logger.warning("no blobs loaded to classify, skipping")
        return None
    model_path = rc.classifier[0] if rc.classifier else None
    clf = (classifier_mod.BlobClassifier.load(model_path, device=device)
           if model_path else classifier_mod.BlobClassifier(
               seed=0, device=device))
    ci = classifier_mod.ClassifyImage(clf, img5d.img, blobs)
    blobs.blobs = ci.classify_whole_image()
    blobs.save_archive()
    _logger.info(
        "classified %d blobs (%d confirmed)", len(blobs.blobs),
        int((blobs.blobs[:, 4] == 1).sum()))
    return blobs


def process_register(rc: RunConfig, device):
    """The ``--register`` tasks (reference ``cli._process_register``):
    ``single`` registers the atlas directory ``filenames[1]`` onto the
    sample ``filenames[0]``, ``register_rev`` the sample onto the atlas;
    ``make_density_images``, ``vol_stats`` and ``export_regions`` measure
    a registered sample and export its ontology; ``group`` registers the
    images to each other; ``import_atlas``/``new_atlas``,
    ``make_edge_images``, ``merge_atlas_segs`` and ``make_subsegs`` build
    and reannotate an atlas; ``cluster_blobs`` clusters the saved blobs;
    the rest compare, merge and plot (:func:`register_tables`)."""
    task = rc.register_type
    if task in TABLE_TASKS:
        return register_tables(rc, device)
    if task in (RegisterTypes.MAKE_EDGE_IMAGES_EXP,
                RegisterTypes.MERGE_ATLAS_SEGS_EXP):
        # as in the reference: the experiment image's suffix is set, and
        # the plain task runs (it reads the atlas volume all the same)
        plain = (RegisterTypes.MAKE_EDGE_IMAGES
                 if task is RegisterTypes.MAKE_EDGE_IMAGES_EXP
                 else RegisterTypes.MERGE_ATLAS_SEGS)
        return process_register(dataclasses.replace(
            rc, register_type=plain,
            reg_suffixes={"atlas": "exp.mhd", **rc.reg_suffixes}), device)
    if task is RegisterTypes.GROUP:
        imgs = [np.asarray(np_io.read_file(f).img[0]) for f in rc.filenames]
        return register_mod.register_group(imgs, rc.atlas_profile,
                                           device=device)
    if task in (RegisterTypes.IMPORT_ATLAS, RegisterTypes.NEW_ATLAS):
        prefix = rc.prefix
        if task is RegisterTypes.NEW_ATLAS:
            prefix = prefix or rc.filenames[0] + "_new"
        return atlas_refiner.import_atlas(
            rc.filenames[0], rc.atlas_profile, prefix=prefix, device=device)
    if task is RegisterTypes.MAKE_EDGE_IMAGES:
        return make_edge_images(rc, device)
    if task is RegisterTypes.MERGE_ATLAS_SEGS:
        outs = []
        for path in rc.filenames:
            atlas = sitk_io.load_registered_img(path, "atlasVolume.mhd")
            labels = sitk_io.load_registered_img(path, "annotation.mhd")
            seg, metr = edge_seg.edge_aware_segmentation(
                atlas, labels, log_sigma=rc.atlas_profile["log_sigma"],
                device=device)
            sitk_io.write_med_img(
                sitk_io.reg_out_path(path, "annotation.mhd"),
                sitk_io.MedImage(seg.astype(np.int32)))
            _logger.info("reannotated %s: %s", path, metr)
            outs.append(metr)
        return outs
    if task is RegisterTypes.MAKE_SUBSEGS:
        path = rc.filenames[0]
        sub = edge_seg.make_sub_segmented_labels(
            sitk_io.load_registered_img(path, "annotation.mhd"),
            sitk_io.load_registered_img(path, "atlasEdge.mhd"),
            device=device)
        sitk_io.write_med_img(
            sitk_io.reg_out_path(rc.prefix or path, "annotationSubseg.mhd"),
            sitk_io.MedImage(sub.astype(np.int32)))
        return sub
    if task is RegisterTypes.SINGLE:
        return register_mod.register(
            rc.filenames[0], rc.filenames[1], rc.atlas_profile,
            prefix=rc.prefix, reg_suffixes=rc.reg_suffixes or None,
            device=device)
    if task is RegisterTypes.REGISTER_REV:
        return register_mod.register_rev(
            rc.filenames[0], rc.filenames[1], rc.atlas_profile,
            prefix=rc.prefix, device=device)
    if task is RegisterTypes.VOL_STATS:
        return vol_stats(rc, device)
    if task is RegisterTypes.CLUSTER_BLOBS:
        clustered, stats = clustering.cluster_blobs(
            load_blobs(rc).blobs, device=device)
        _logger.info("clustering stats: %s", stats)
        np.save((rc.prefix or rc.filenames[0]) + "_clusters.npy", clustered)
        return clustered
    if task is RegisterTypes.EXPORT_REGIONS:
        ref_path = rc.labels.get("path_ref") or rc.filenames[0]
        ref = ontology.LabelsRef(str(ref_path)).load()
        level = rc.labels.get("level")
        return export_regions.export_region_ids(
            ref, rc.prefix or "region_ids.csv",
            int(level) if level else None)
    if len(rc.filenames) > 1:
        return export_regions.make_density_images_mp(
            rc.filenames, device=device)
    return export_regions.make_density_image(rc.filenames[0],
                                             device=device)


def register_tables(rc: RunConfig, device):
    """The ``--register`` tasks over registered images and their tables
    (reference ``cli._process_register``), each writing the reference's
    files: ``export_common_labels`` (the IDs in every sample's annotation,
    ``--prefix`` or ``regions_common.csv``), ``convert_itksnap_labels``
    (an ITK-SNAP label description as ``<prefix or file>.csv``),
    ``make_labels_level`` (the annotation at ``--labels level=`` of
    ``path_ref=``, ``annotationLevel<N>.mhd``), ``labels_diff[_stats]``
    (per-label DSC of two samples' annotations, ``_labels_diff.csv``, and
    for ``labels_diff`` the voxels that differ, ``annotationDiff.mhd``),
    ``labels_dist`` (centroid shifts, ``_labels_dist.csv``, against the
    sample's ``annotationEdit.mhd`` when given one sample),
    ``smoothing_metrics_aggr`` (``_aggr.csv``), ``plot_knns``
    (``_knn.png``), ``plot_smoothing_metrics`` and
    ``export_metrics_compactness`` (``_metrics.png``), ``vol_compare``
    (per-label DSC, returned only), ``overlays`` (``_overlay.png``) and
    ``merge_images[_channels]`` (``combined.mhd``). The label counts and
    sums run on ``device``; the plots are matplotlib's."""
    task = rc.register_type
    path = rc.filenames[0]
    if task is RegisterTypes.EXPORT_COMMON_LABELS:
        return export_regions.export_common_labels(
            rc.filenames, rc.prefix or "regions_common.csv")
    if task is RegisterTypes.CONVERT_ITKSNAP_LABELS:
        df = ontology.convert_itksnap_to_df(path)
        df.to_csv(rc.prefix or (path + ".csv"), index=False)
        return df
    if task is RegisterTypes.MAKE_LABELS_LEVEL:
        labels = sitk_io.load_registered_img(path, "annotation.mhd")
        ref = ontology.LabelsRef(str(rc.labels.get("path_ref"))).load()
        level = int(rc.labels.get("level") or 0)
        out = sitk_io.reg_out_path(
            rc.prefix or path, f"annotationLevel{level}.mhd")
        return export_regions.make_labels_level_img(labels, ref, level, out)
    if task in (RegisterTypes.LABELS_DIFF, RegisterTypes.LABELS_DIFF_STATS):
        labels_imgs = [sitk_io.load_registered_img(p, "annotation.mhd")
                       for p in rc.filenames[:2]]
        df = vols.measure_labels_overlap(labels_imgs, device=device)
        if task is RegisterTypes.LABELS_DIFF:
            diff = (labels_imgs[0] != labels_imgs[1]).astype(np.int32)
            sitk_io.write_med_img(
                sitk_io.reg_out_path(rc.prefix or path,
                                     "annotationDiff.mhd"),
                sitk_io.MedImage(diff))
        df.to_csv(os.path.splitext(rc.prefix or path)[0]
                  + "_labels_diff.csv", index=False)
        return df
    if task is RegisterTypes.LABELS_DIST:
        two = len(rc.filenames) > 1
        paths = rc.filenames[:2] if two else [path, path]
        suffixes = ("annotation.mhd",
                    "annotation.mhd" if two else "annotationEdit.mhd")
        labels_imgs = [sitk_io.load_registered_img(p, sfx)
                       for p, sfx in zip(paths, suffixes)]
        df = vols.labels_distance(labels_imgs[0], labels_imgs[1],
                                  device=device)
        df.to_csv((rc.prefix or path) + "_labels_dist.csv", index=False)
        return df
    if task is RegisterTypes.SMOOTHING_METRICS_AGGR:
        out = atlas_refiner.aggr_smoothing_metrics(pd.read_csv(path))
        out.to_csv((rc.prefix or path) + "_aggr.csv", index=False)
        return out
    if task is RegisterTypes.PLOT_KNNS:
        blob_sets = []
        for img_path in rc.filenames:
            blobs = blobs_mod.Blobs().load_blobs(
                libmag.combine_paths(img_path, "blobs.npz"))
            if blobs.blobs is not None:
                blob_sets.append(blobs.blobs)
        return clustering.plot_knns(
            blob_sets, out_path=(rc.prefix or path) + "_knn.png",
            device=device)
    if task in (RegisterTypes.PLOT_SMOOTHING_METRICS,
                RegisterTypes.EXPORT_METRICS_COMPACTNESS):
        from magellanmapper_torch.plot import plot_2d
        df = pd.read_csv(path)
        xcol = "Filter_size" if "Filter_size" in df.columns \
            else df.columns[0]
        ycol = "Compactness" if "Compactness" in df.columns \
            else df.columns[-1]
        plot_2d.plot_lines(df, xcol, [ycol],
                           path=(rc.prefix or path) + "_metrics.png")
        return df
    if task is RegisterTypes.VOL_COMPARE:
        return register_mod.volumes_by_id_compare(
            rc.filenames, rc.labels.get("path_ref"), device=device)
    if task is RegisterTypes.OVERLAYS:
        return register_mod.overlay_registered_imgs(
            path, rc.filenames[1] if len(rc.filenames) > 1 else None,
            plane=rc.plane, name_prefix=rc.prefix,
            out_path=(rc.prefix or path) + "_overlay.png", device=device)
    # merge_images[_channels]: the samples' atlas images summed, or
    # stacked along a channel axis
    suffix = rc.reg_suffixes.get("atlas", "atlasVolume.mhd")
    fn = np.sum if task is RegisterTypes.MERGE_IMAGES else None
    med = sitk_io.merge_images(rc.filenames, suffix, fn_combine=fn)
    if med is not None:
        img = med.img
        if img.ndim > 3:
            img = np.moveaxis(img, 0, -1)
        sitk_io.write_med_img(
            sitk_io.reg_out_path(rc.prefix or path, "combined.mhd"),
            sitk_io.MedImage(np.asarray(img, np.float32)))
    return med


def make_edge_images(rc: RunConfig, device) -> Dict[str, np.ndarray]:
    """The ``--register make_edge_images`` task: the edge images of the
    registered atlas and labels at ``filenames[0]``
    (:func:`edge_seg.make_edge_images`) and the labels eroded into markers
    and interiors, written beside it (or at ``--prefix``)."""
    path = rc.filenames[0]
    atlas = sitk_io.load_registered_img(path, "atlasVolume.mhd")
    labels = sitk_io.load_registered_img(path, "annotation.mhd")
    imgs = edge_seg.make_edge_images(
        atlas, labels, log_sigma=rc.atlas_profile["log_sigma"],
        device=device)
    eros = rc.atlas_profile["edge_aware_reannotation"]["marker_erosion"]
    markers, interior, _ = edge_seg.erode_labels(
        labels, filter_size=int(eros), device=device)
    sitk_io.write_reg_images({
        "atlasEdge.mhd": sitk_io.MedImage(
            imgs["atlas_edge"].astype(np.uint8)),
        "atlasLoG.mhd": sitk_io.MedImage(
            imgs["atlas_log"].astype(np.float32)),
        "annotationEdge.mhd": sitk_io.MedImage(
            imgs["labels_edge"].astype(np.uint8)),
        "annotationDist.mhd": sitk_io.MedImage(
            imgs["dist_to_edge"].astype(np.float32)),
        "annotationMarkers.mhd": sitk_io.MedImage(markers.astype(np.int32)),
        "annotationInterior.mhd": sitk_io.MedImage(
            interior.astype(np.int32)),
    }, rc.prefix or path)
    return imgs


def vol_stats(rc: RunConfig, device) -> pd.DataFrame:
    """The ``--register vol_stats`` task (reference ``cli._vol_stats``):
    per-region metrics of the sample's registered annotation, atlas and
    heat map (when present), written to ``<prefix or base>_vols.csv``."""
    path = rc.filenames[0]
    atlas = sitk_io.load_registered_img(path, "atlasVolume.mhd")
    labels = sitk_io.load_registered_img(path, "annotation.mhd")
    heat = None
    try:
        heat = sitk_io.load_registered_img(path, "heat.mhd")
    except FileNotFoundError:
        pass
    ref = None
    ref_path = rc.labels.get("path_ref")
    if ref_path:
        ref = ontology.LabelsRef(str(ref_path)).load()
    df = vols.measure_labels_metrics(
        atlas, labels, heat_map=heat, labels_ref=ref, device=device)
    out_csv = (rc.prefix or os.path.splitext(path)[0]) + "_vols.csv"
    df.to_csv(out_csv, index=False)
    return df


def process_host_task(rc: RunConfig):
    """The ``--proc`` tasks that run on the host (reference
    ``cli.process_file``): ``import_only`` (the imported image),
    ``load`` (the image), ``export_tif`` and ``export_raw`` (the written
    path), ``export_blobs`` (the blobs' table), ``extract`` (the plane),
    ``export_rois`` (the ROIs' table), ``export_planes[_channels]`` (the
    planes' paths) and ``animated`` (the animation's path)."""
    path = rc.filenames[0]
    if rc.proc == "import_only":
        ext = os.path.splitext(path)[1].lower()
        fn = importer.VENDOR_IMPORTERS.get(ext, importer.import_tiff)
        kwargs = {"series": rc.series} if ext == ".lif" else {}
        return fn(path, out_path=rc.prefix or path,
                  resolutions=rc.resolutions, **kwargs)
    if rc.proc == "export_blobs":
        return export_rois.blobs_to_csv(rc)
    img5d = load_image(rc)
    if rc.proc == "load":
        return img5d
    base = os.path.splitext(rc.prefix or path)[0]
    channel = rc.channel[0] if rc.channel else None
    if rc.proc == "extract":
        z = rc.offset[2] if rc.offset else 0
        plane = plot_support.extract_planes(
            np.asarray(img5d.img), z, rc.plane or "xy")[0]
        out = f"{base}_plane{rc.plane or 'xy'}{z}.npy"
        np.save(out, plane)
        _logger.info("extracted plane -> %s %s", out, plane.shape)
        return plane
    if rc.proc == "export_rois":
        db = sqlite.load_db(rc.truth_db or sqlite.DB_NAME)
        try:
            vol = img5d.img[0] if img5d.img.ndim >= 4 else img5d.img
            df = export_rois.export_rois(
                np.asarray(vol), db, rc.channel or [0], f"{base}_rois")
        finally:
            db.close()
        _logger.info("exported %d ROIs to %s_rois", len(df), base)
        return df
    if rc.proc == "animated":
        vol = np.asarray(img5d.img)
        if rc.slice_vals:
            sl = slice(*rc.slice_vals)
            vol = vol[:, sl] if vol.ndim >= 4 else vol[sl]
        fps = max(1, round(1000 / rc.delay)) if rc.delay else 10
        return export_stack.animate_imgs(vol, f"{base}.gif", fps=fps,
                                         channel=channel)
    if rc.proc in ("export_planes", "export_planes_channels"):
        return export_stack.export_planes(
            np.asarray(img5d.img), f"{base}_planes",
            ext=rc.savefig or "png", channel=channel,
            separate_channels=rc.proc == "export_planes_channels")
    out = rc.prefix or os.path.splitext(path)[0]
    if rc.proc == "export_tif":
        out += ".tif"
        tiff.write_tiff(out, np.asarray(img5d.img[0]))
    else:
        out += ".raw"
        np.asarray(img5d.img).tofile(out)
    return out


def process_file(rc: RunConfig, device):
    """The ``--proc`` tasks on ``device`` (reference
    ``cli.process_file``): ``detect`` and ``detect_coloc`` (return the
    blobs), ``coloc_match`` (the matches by channel pair), ``classify``
    (the classified blobs), ``transform`` (the output image's path) and
    ``preprocess`` (the processed image)."""
    path = rc.filenames[0]
    if rc.proc == "transform":
        rescale = rc.transform.get("rescale")
        return transformer.transpose_img(
            path, plane=rc.plane,
            rescale=float(rescale) if rescale else None, device=device)
    if rc.proc == "preprocess":
        img5d = load_image(rc)
        return transformer.preprocess_img(
            np.asarray(img5d.img), list(rc.proc_args),
            out_path=rc.prefix or path, device=device)
    if rc.proc == "coloc_match":
        return coloc_match(rc)
    if rc.proc == "classify":
        return classify(rc, device)
    return detect(rc, device, coloc=rc.proc == "detect_coloc")


def main(argv: Optional[Sequence[str]] = None
         ) -> Union[blobs_mod.Blobs, pd.DataFrame, Dict, str, list,
                    np.ndarray, tuple]:
    """CLI entry. Returns what the task's function returns: the detected
    or classified blobs, the channel pairs' matches, the grid search's
    table, the registration's result, the transformed image's path, the
    preprocessed image, the heat map(s), the regions' table, the
    clustered blobs, the imported or loaded image, an export's path, the
    blobs' or ROIs' table, the extracted plane, the planes' paths or the
    plot's figure."""
    logging.basicConfig(
        level=logging.INFO, format="%(levelname)s:%(name)s: %(message)s")
    rc = process_cli_args(argv)
    if rc.register_type is None and rc.plot_2d_task:
        _logger.info("--plot_2d %s on the host", rc.plot_2d_task)
        return plot_2d_task(rc)
    if rc.register_type is None and not rc.grid_search \
            and rc.proc in HOST_TASKS:
        _logger.info("--proc %s on the host", rc.proc)
        return process_host_task(rc)
    device = device_mod.resolve(rc.device)
    if rc.register_type is not None:
        _logger.info("--register %s on %s", rc.register_type.name.lower(),
                     device)
        return process_register(rc, device)
    if rc.grid_search:
        _logger.info("grid search %s on %s", rc.grid_search, device)
        return mlearn.grid_search_from_cli(rc, device)
    _logger.info("--proc %s on %s", rc.proc, device)
    return process_file(rc, device)


if __name__ == "__main__":
    main()
