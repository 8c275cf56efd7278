"""Command-line entry of the port: image import and export, plane, ROI
and plot exports, blob detection and the analysis of its blobs, its grid
search, atlas registration and construction, the specimen pipeline
around it, and the regions' tables of a study.

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

The study tables, on the host whatever ``--device`` says: ``--df
<task> [tables...]`` runs one of the 13 ``df_io.DFTasks`` (``merge_csvs``,
``merge_csvs_cols``, ``append_csvs_cols`` with ``--groups``,
``exps_by_region``, ``melt_cols``, ``pivot_table``, ``sum_cols``,
``subtract_cols``, ``multiply_cols``, ``divide_cols``, ``normalize``,
``zscore``, ``replace_vals``) on the tables after its name (else
``--img``), its columns named by ``--labels``, and writes the result to
``--prefix`` (:func:`df_task`); ``--img table.csv --register
smoothing_peaks|combine_cols|zscores|coefvar|melt_cols|pivot_conds|
meas_improvement|plot_region_dev|plot_lateral_unlabeled|plot_intens_nuc``
and ``--img image --register plot_cluster_blobs`` summarise and plot the
regions' tables as the reference does (:func:`register_stats`; the plots
are matplotlib's).

The parser takes every flag of the reference's
(``magellanmapper_tpu/io/cli.py:124-194``) with its meaning, and
``--device``; ``--version`` prints the port's name and version,
``--seed`` seeds numpy's global generator, ``-v`` sets the root logger to
DEBUG, and the display and compatibility flags (``--meta``,
``--prefix_out``, ``--suffix``, ``--size``, ``--db``, ``--cpus``,
``--load``, ``--theme``, ``--show``, ``--alphas``, ``--vmin``, ``--vmax``,
``--rgb``) are kept in :class:`RunConfig` as the reference keeps them.
``--truth_db`` goes with ``--grid_search``, the detect tasks or
``export_rois``, ``--save_subimg`` with the detect tasks. ``--notify
URL [message [attachment]]`` posts a webhook message
(:func:`process_notify`) and ``--ec2_start|--ec2_list|--ec2_terminate``
start, list or terminate EC2 instances through boto3
(:func:`process_aws`), in the reference's order of tasks
(:func:`process_tasks`). ``--mesh dp,sp[,spy]`` runs ``--proc detect``
(halo-exchange detection, ``parallel.halo``), ``--proc transform``,
``--register single|register_rev|group|vol_stats`` over the ranks of a
mesh whose size is the world's: a world of one starts itself, a larger
one comes from ``torchrun --standalone --nproc-per-node N -m
magellanmapper_torch.io.cli ... --mesh 1,N`` (or
``parallel.launch.spawn``); only rank 0 writes files. Any other flag or
task is rejected with a message that names it.

``--device`` picks where the device step runs: ``cuda`` (the default)
fails without a card, and the CPU, which runs the kernels' plain
versions, is used only when ``--device cpu`` asks for it.

As a library, as the reference's: build ``rc = RunConfig(filenames=[path],
proc=ProcessTypes.DETECT)`` (``device`` "cuda" unless "cpu" is given),
set ``rc.roi_profiles = setup_roi_profiles(["lightsheet"])`` and
``rc.roi_profile``, then ``setup_image(rc)`` loads the image and
``process_proc_tasks(rc)`` runs the task as :func:`main` does;
``setup_dbs``, ``setup_atlas_profiles``, ``setup_grid_search_profiles``
and ``setup_labels`` open the rest.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import pandas as pd
import torch.distributed as dist

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.atlas import (
    atlas_refiner, edge_seg, ontology, transformer)
from magellanmapper_torch.atlas import register as register_mod
from magellanmapper_torch.cv import blobs as blobs_mod
from magellanmapper_torch.cv import (
    classifier as classifier_mod, colocalizer, detector, stack_detect,
    verifier)
from magellanmapper_torch.io import (
    df_io, export_regions, export_rois, export_stack, importer, naming,
    np_io, sitk_io, sqlite, tiff)
from magellanmapper_torch.parallel import comm, halo
from magellanmapper_torch.parallel import mesh as mesh_mod
from magellanmapper_torch.plot import plot_support
from magellanmapper_torch.settings.atlas_prof import AtlasProfile
from magellanmapper_torch.settings.config import ProcessTypes, RegisterTypes
from magellanmapper_torch.settings.grid_search_prof import GridSearchProfile
from magellanmapper_torch.settings.roi_prof import ROIProfile
from magellanmapper_torch.stats import atlas_stats, clustering, mlearn, vols
from magellanmapper_torch.utils import libmag

_logger = logging.getLogger(__name__)

#: ``--proc`` tasks that run on the host: import, load and export
HOST_TASKS = (
    ProcessTypes.IMPORT_ONLY, ProcessTypes.LOAD, ProcessTypes.EXPORT_TIF,
    ProcessTypes.EXPORT_RAW, ProcessTypes.EXPORT_BLOBS, ProcessTypes.EXTRACT,
    ProcessTypes.EXPORT_ROIS, ProcessTypes.EXPORT_PLANES,
    ProcessTypes.EXPORT_PLANES_CHANNELS, ProcessTypes.ANIMATED)
#: ``--proc`` tasks the port runs: all of the reference's
TASKS = tuple(ProcessTypes)
#: the tasks that detect, which take ``--truth_db`` and ``--save_subimg``
DETECT_TASKS = (ProcessTypes.DETECT, ProcessTypes.DETECT_COLOC)


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
#: the ``--register`` tasks over the regions' tables (pandas, scipy and
#: matplotlib on the host): :func:`register_stats`
STATS_TASKS = (
    RegisterTypes.SMOOTHING_PEAKS, RegisterTypes.COMBINE_COLS,
    RegisterTypes.ZSCORES, RegisterTypes.COEFVAR, RegisterTypes.MELT_COLS,
    RegisterTypes.PIVOT_CONDS, RegisterTypes.MEAS_IMPROVEMENT,
    RegisterTypes.PLOT_REGION_DEV, RegisterTypes.PLOT_LATERAL_UNLABELED,
    RegisterTypes.PLOT_INTENS_NUC, RegisterTypes.PLOT_CLUSTER_BLOBS)
#: ``--register`` tasks the port runs: all of the reference's
REGISTER_TASKS = tuple(RegisterTypes)
#: the tasks that register an atlas directory onto a sample
PAIR_TASKS = (RegisterTypes.SINGLE, RegisterTypes.REGISTER_REV)
#: what the port runs, for the messages that reject the rest
SUPPORTED = ("--proc " + "/".join(t.name.lower() for t in TASKS)
             + ", --plot_2d, --df, "
             "--grid_search and every --register task")
#: flags of the reference that the port rejects by name, with the ROADMAP
#: item that ports them (none is left)
NOT_PORTED: Dict[str, str] = {}


@dataclass
class RunConfig:
    """Parsed command line: the fields of the reference's ``RunConfig``
    (``magellanmapper_tpu/io/cli.py:32``), with the same values for the
    same arguments, and ``device``. ``proc`` is a :class:`ProcessTypes`
    member; a run config built by hand runs through
    :func:`process_proc_tasks` as a parsed one does."""
    filenames: List[str] = field(default_factory=list)
    channel: Optional[List[int]] = None
    series: int = 0
    subimg_offsets: Optional[List[List[int]]] = None
    subimg_sizes: Optional[List[List[int]]] = None
    proc: Optional[ProcessTypes] = None
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
    plot_2d_task_args: Optional[List[str]] = None
    df_task: Optional[List[str]] = None
    groups: Optional[List[str]] = None
    size: Optional[List[int]] = None
    db_path: Optional[str] = None
    prefix_out: Optional[str] = None
    suffix: Optional[str] = None
    verbose: bool = False
    #: the rank mesh (dp, sp[, spy]) of ``--mesh``
    mesh: Optional[List[int]] = None
    meta_paths: Optional[List[str]] = None
    load_data: Dict[str, str] = field(default_factory=dict)
    cpus: Optional[int] = None
    show: bool = False
    theme: Optional[List[str]] = None
    alphas: Optional[List[float]] = None
    vmin: Optional[List[float]] = None
    vmax: Optional[List[float]] = None
    rgb: bool = False
    ec2_start: Optional[List[object]] = None
    ec2_list: Optional[List[object]] = None
    ec2_terminate: Optional[List[str]] = None
    notify_url: Optional[str] = None
    notify_msg: Optional[str] = None
    notify_attach: Optional[str] = None
    device: str = "cuda"

    def get_roi_profile(self, channel: int) -> ROIProfile:
        """The ROI profile of ``channel``: its own from ``roi_profiles``,
        else ``roi_profile``."""
        if self.roi_profiles and channel < len(self.roi_profiles):
            return self.roi_profiles[channel]
        return self.roi_profile


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


def args_with_dict(args: Sequence[str]) -> list:
    """Positional values of a mixed argument list (numbers parsed where
    they parse), then one dict of its ``key=value`` entries
    (comma-separated values become lists)."""
    parsed: list = []
    args_dict: Dict[str, object] = {}
    for arg in args:
        parts = arg.split("=")
        if len(parts) == 1:
            parsed.append(libmag.get_int(arg))
        else:
            vals = [libmag.get_int(v) for v in parts[1].split(",")]
            args_dict[parts[0]] = vals if len(vals) > 1 else vals[0]
    parsed.append(args_dict)
    return parsed


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m magellanmapper_torch.io.cli",
        description="MagellanMapper on PyTorch/CUDA")
    p.add_argument("--version", action="store_true",
                   help="show the version and exit")
    p.add_argument("--img", nargs="*", help="image path(s)")
    p.add_argument("--meta", nargs="*", help="metadata path(s)")
    p.add_argument("--prefix", help="output path prefix")
    p.add_argument("--prefix_out", help="output path prefix when --prefix "
                   "modifies the input path")
    p.add_argument("--suffix", help="output path suffix")
    p.add_argument("--channel", nargs="*", type=int, help="channel(s)")
    p.add_argument("--series", type=int, default=0, help="series index")
    p.add_argument("--subimg_offset", nargs="*", help="sub-image offset x,y,z")
    p.add_argument("--subimg_size", nargs="*", help="sub-image size x,y,z")
    p.add_argument("--offset", nargs="*", help="ROI offset x,y,z")
    p.add_argument("--size", nargs="*", help="ROI size x,y,z")
    p.add_argument("--db", help="database path")
    p.add_argument("--truth_db", nargs="*", help="truth DB mode and path")
    p.add_argument("--cpus", help="worker count")
    p.add_argument("--load", nargs="*", help="data to load")
    p.add_argument("--proc", nargs="*",
                   help="processing task: detect, detect_coloc, "
                   "coloc_match, classify, transform, preprocess <tasks>, "
                   "import_only, load, export_tif, export_raw, "
                   "export_blobs, extract, export_rois, export_planes, "
                   "export_planes_channels or animated")
    p.add_argument("--register", help="registration or table task: "
                   + ", ".join(t.name.lower() for t in RegisterTypes))
    p.add_argument("--df", nargs="*",
                   help="data-frame task and its CSV paths: " + ", ".join(
                       t.name.lower() for t in df_io.DFTasks))
    p.add_argument("--plot_2d", help="2D plot task of a CSV table")
    p.add_argument("--roi_profile", nargs="*", help="ROI profile(s)")
    p.add_argument("--atlas_profile", help="atlas profile")
    p.add_argument("--grid_search", help="grid search profile")
    p.add_argument("--theme", nargs="*", help="GUI theme")
    p.add_argument("--labels", nargs="*", help="labels and table args "
                   "(path_ref=..., level=..., col1=..., ...)")
    p.add_argument("--transform", nargs="*", help="transform args "
                   "(rescale=...)")
    p.add_argument("--reg_suffixes", nargs="*",
                   help="registered image suffixes (atlas=..., "
                   "annotation=...)")
    p.add_argument("--plot_labels", nargs="*", help="plot labels")
    p.add_argument("--set_meta", nargs="*",
                   help="metadata overrides (resolutions=z,y,x)")
    p.add_argument("--classifier", nargs="*",
                   help="blob classifier model file (--proc classify)")
    p.add_argument("--plane", help="plane orientation (xy/xz/yz)")
    p.add_argument("--show", action="store_true", help="show figures")
    p.add_argument("--alphas", nargs="*", help="channel alphas")
    p.add_argument("--vmin", nargs="*", help="display vmin")
    p.add_argument("--vmax", nargs="*", help="display vmax")
    p.add_argument("--rgb", action="store_true", help="RGB display")
    p.add_argument("--seed", type=int, help="seed of numpy's global "
                   "random generator")
    p.add_argument("--save_subimg", action="store_true",
                   help="save the sub-image that detection read")
    p.add_argument("--slice", help="plane range start,stop[,step]")
    p.add_argument("--delay", type=int, help="animation delay (ms)")
    p.add_argument("--savefig", help="figure file format")
    p.add_argument("--groups", nargs="*", help="group names")
    p.add_argument("-v", "--verbose", nargs="*", help="verbose logging")
    p.add_argument(
        "--ec2_start", nargs="*",
        help="AWS EC2 instance start: tag_name, ami_id, instance_type, "
             "subnet_id, sec_group, key_name, [count[, snapshot_ids...]]")
    p.add_argument("--ec2_list", nargs="*", help="AWS EC2 instance list")
    p.add_argument("--ec2_terminate", nargs="*",
                   help="AWS EC2 instance IDs to terminate")
    p.add_argument("--notify", nargs="*",
                   help="notification: URL [message [attachment-file]]")
    p.add_argument(
        "--mesh", help="dp,sp[,spy] rank mesh for sharded whole-volume "
                       "detection, transform, registration and vol_stats")
    for name in NOT_PORTED:
        p.add_argument(f"--{name}", nargs="*",
                       help=f"not ported yet: ROADMAP {NOT_PORTED[name]}")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def df_task_type(name: str) -> "df_io.DFTasks":
    """The ``DFTasks`` member of a ``--df`` task name; an unknown name
    raises ``SystemExit`` naming the flag and the known tasks."""
    try:
        return df_io.DFTasks[name.upper()]
    except KeyError:
        raise SystemExit(
            f"unknown --df task: {name}; options: " + ", ".join(
                e.name.lower() for e in df_io.DFTasks)) from None


def process_cli_args(argv: Optional[Sequence[str]] = None) -> RunConfig:
    """Parse ``argv`` into a :class:`RunConfig`; a flag or task the port
    does not have raises ``SystemExit`` naming it."""
    args, unknown = build_parser().parse_known_args(argv)
    flags = [a for a in unknown if a.startswith("-")]
    if unknown:
        raise SystemExit(
            "magellanmapper_torch does not take "
            f"{' '.join(flags or unknown)}; it supports {SUPPORTED}")
    if args.version:
        import magellanmapper_torch
        print(f"magellanmapper_torch {magellanmapper_torch.__version__}")
        raise SystemExit(0)
    for name, item in NOT_PORTED.items():
        if getattr(args, name) is not None:
            raise SystemExit(
                f"magellanmapper_torch does not take --{name} yet: ROADMAP "
                f"{item} (use magellanmapper_tpu.io.cli)")
    rc = RunConfig(device=args.device)
    if args.mesh:
        dims = str(args.mesh).split(",")
        if not 2 <= len(dims) <= 3 or not all(
                d.isdigit() and int(d) > 0 for d in dims):
            raise SystemExit(
                f"--mesh takes dp,sp[,spy] (positive integers), not "
                f"{args.mesh}")
        rc.mesh = [int(v) for v in dims]
    if args.img:
        rc.filenames = list(args.img)
    rc.channel = args.channel
    rc.series = args.series
    rc.prefix = args.prefix
    rc.prefix_out = args.prefix_out
    rc.suffix = args.suffix
    rc.db_path = args.db
    rc.verbose = args.verbose is not None
    if rc.verbose:
        logging.getLogger().setLevel(logging.DEBUG)
    if args.seed is not None:
        np.random.seed(args.seed)

    def parse_coords(vals):
        if not vals:
            return None
        return [[int(v) for v in val.split(",")] for val in vals]

    rc.subimg_offsets = parse_coords(args.subimg_offset)
    rc.subimg_sizes = parse_coords(args.subimg_size)
    offsets = parse_coords(args.offset)
    sizes = parse_coords(args.size)
    rc.offset = offsets[0] if offsets else None
    rc.size = sizes[0] if sizes else None
    if args.slice:
        rc.slice_vals = [int(v) for v in args.slice.split(",")]
    rc.delay = args.delay
    rc.savefig = args.savefig
    rc.plot_labels = args_to_dict(args.plot_labels)
    rc.plot_2d_task = args.plot_2d
    rc.df_task = args.df
    rc.groups = args.groups
    rc.meta_paths = args.meta
    rc.load_data = args_to_dict(args.load)
    rc.cpus = int(args.cpus) if args.cpus else None
    rc.show = bool(args.show)
    rc.theme = args.theme
    rc.alphas = [float(v) for v in args.alphas] if args.alphas else None
    rc.vmin = [float(v) for v in args.vmin] if args.vmin else None
    rc.vmax = [float(v) for v in args.vmax] if args.vmax else None
    rc.rgb = bool(args.rgb)
    if args.ec2_start is not None:
        rc.ec2_start = args_with_dict(args.ec2_start)
    if args.ec2_list is not None:
        rc.ec2_list = args_with_dict(args.ec2_list)
    if args.ec2_terminate:
        rc.ec2_terminate = args.ec2_terminate
    if args.notify:
        rc.notify_url = args.notify[0]
        if len(args.notify) > 1:
            rc.notify_msg = args.notify[1]
        if len(args.notify) > 2:
            rc.notify_attach = args.notify[2]
    meta = args_to_dict(args.set_meta)
    if "resolutions" in meta:
        rc.resolutions = [float(v) for v in meta["resolutions"].split(",")]
    # profiles: comma-separated modifier chains, one per channel
    if args.roi_profile:
        rc.roi_profiles = setup_roi_profiles(args.roi_profile)
        rc.roi_profile = rc.roi_profiles[0]
    if args.atlas_profile:
        rc.atlas_profile = setup_atlas_profiles(args.atlas_profile)
    rc.reg_suffixes = args_to_dict(args.reg_suffixes)
    rc.transform = args_to_dict(args.transform)
    rc.labels = args_to_dict(args.labels)
    rc.plane = args.plane
    rc.grid_search = args.grid_search
    rc.classifier = args.classifier
    rc.save_subimg = args.save_subimg
    if args.proc:
        rc.proc = ProcessTypes.__members__.get(args.proc[0].upper())
        rc.proc_args = args_to_dict(args.proc[1:])
    if args.truth_db:
        rc.truth_db = args.truth_db[-1]
    if args.register is None and cloud_task(rc):
        # the webhook or EC2 task runs instead of any image task, which
        # therefore needs no checks
        return rc
    if args.register:
        task = f"--register {args.register}"
        rc.register_type = RegisterTypes.__members__.get(
            args.register.upper())
        if rc.register_type is None:
            raise SystemExit(
                f"unknown task {task}; options: " + ", ".join(
                    t.name.lower() for t in RegisterTypes))
        if rc.register_type in PAIR_TASKS and len(rc.filenames) < 2:
            raise SystemExit(f"{task} needs --img <sample> <atlas_dir>")
    elif rc.plot_2d_task:
        task = f"--plot_2d {rc.plot_2d_task}"
        plot_2d_type(rc.plot_2d_task)
    elif rc.df_task is not None:
        if not rc.df_task:
            raise SystemExit("--df needs a task")
        task = f"--df {rc.df_task[0]}"
        df_task_type(rc.df_task[0])
    else:
        task = "--grid_search" if rc.grid_search else (
            f"--proc {args.proc[0].lower()}" if args.proc else None)
        if not rc.grid_search and rc.proc not in TASKS:
            raise SystemExit(
                f"magellanmapper_torch supports {SUPPORTED} (got {task})")
    by_proc = (rc.register_type is None and not rc.plot_2d_task
               and rc.df_task is None and not rc.grid_search)
    detects = by_proc and rc.proc in DETECT_TASKS
    if rc.truth_db and not (rc.grid_search or detects or (
            by_proc and rc.proc is ProcessTypes.EXPORT_ROIS)):
        raise SystemExit(
            "magellanmapper_torch takes --truth_db only with --grid_search "
            "or --proc detect/detect_coloc/export_rois")
    if rc.save_subimg and not detects:
        raise SystemExit(
            "magellanmapper_torch takes --save_subimg only with --proc "
            "detect/detect_coloc")
    has_paths = rc.filenames or (
        rc.register_type is None and not rc.plot_2d_task
        and rc.df_task and len(rc.df_task) > 1)
    if not has_paths and rc.register_type is not \
            RegisterTypes.EXPORT_REGIONS:
        raise SystemExit(f"{task} needs --img")
    return rc


def cloud_task(rc: RunConfig) -> bool:
    """Whether a task other than ``--register`` is ``--notify`` or
    ``--ec2_*``, in the reference's order: ``--notify`` before every
    other task, ``--ec2_*`` after ``--plot_2d``, ``--df`` and
    ``--grid_search``."""
    if rc.notify_url:
        return True
    return bool((rc.ec2_start or rc.ec2_list or rc.ec2_terminate)
                and not rc.plot_2d_task and not rc.df_task
                and not rc.grid_search)


def process_notify(rc: RunConfig):
    """``--notify``: post the message with the attachment's last lines;
    returns the webhook's response."""
    from magellanmapper_torch.cloud import notify
    return notify.post(rc.notify_url, rc.notify_msg or "", rc.notify_attach)


def process_aws(rc: RunConfig):
    """``--ec2_start``, ``--ec2_list`` and ``--ec2_terminate`` through
    boto3: ``--ec2_start`` takes tag_name, ami_id, instance_type,
    subnet_id, sec_group, key_name and count positionally, or ``ami_id=``,
    ``instance_type=`` and ``key_name=``; returns the started IDs, the
    listed instances or the terminated IDs."""
    from magellanmapper_torch.cloud import aws
    out = None
    if rc.ec2_start:
        pos = [a for a in rc.ec2_start if not isinstance(a, dict)]
        kwargs = {}
        for a in rc.ec2_start:
            if isinstance(a, dict):
                kwargs.update(a)
        count = int(pos[6]) if len(pos) > 6 else 1
        out = aws.start_instances(
            image_id=pos[1] if len(pos) > 1 else kwargs.pop("ami_id"),
            instance_type=(pos[2] if len(pos) > 2
                           else kwargs.pop("instance_type")),
            count=count,
            key_name=pos[5] if len(pos) > 5 else kwargs.pop(
                "key_name", None))
    if rc.ec2_list:
        pos = [a for a in rc.ec2_list if not isinstance(a, dict)]
        out = aws.show_instances(pos[0] if pos else "running")
    if rc.ec2_terminate:
        aws.terminate_instances(rc.ec2_terminate)
        out = rc.ec2_terminate
    return out


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
    profiles = rc.roi_profiles or rc.roi_profile
    mesh = rank_mesh(rc)
    if mesh is not None:
        t0 = time.time()
        blobs = blobs_mod.Blobs(halo.detect_blobs_sharded_stack(
            np.asarray(vol), profiles, res, mesh=mesh, channels=rc.channel,
            preprocess=True, device=device))
        blobs.resolutions = np.atleast_2d(np.asarray(res, float))
        elapsed = time.time() - t0
        timing = {"Detection": elapsed, "Pruning": 0.0,
                  "Total_stack": elapsed}
    else:
        blobs, timing = stack_detect.detect_blobs_stack(
            vol, profiles, res, channels=rc.channel, device=device)
    if coloc and blobs.blobs is not None and vol.ndim > 3:
        blobs.colocalizations = colocalizer.colocalize_blobs(
            vol, blobs.blobs, device=device)
    base = rc.prefix or rc.filenames[0]
    blobs.basename = os.path.basename(base)
    blobs.path = libmag.combine_paths(base, "blobs.npz")

    def write():
        if rc.truth_db:
            verify_truth(rc, blobs.blobs, res, base)
        if rc.save_subimg and img5d.subimg_offset is not None:
            sub_name = naming.make_subimage_name(
                base, img5d.subimg_offset, img5d.subimg_size)
            np.save(libmag.combine_paths(sub_name, "subimg.npy"),
                    np.asarray(img5d.img[0]))
        blobs.save_archive()
        pd.DataFrame([{k: v for k, v in timing.items()
                       if isinstance(v, (int, float))}]).to_csv(
            libmag.combine_paths(base, "stack_detection_times.csv"),
            index=False)

    comm.on_writer(mesh, write)
    _logger.info(
        "Detected %d blobs on %s in %.2fs (detection %.2fs, pruning %.2fs)",
        len(blobs), device, timing.get("Total_stack", 0),
        timing.get("Detection", 0), timing.get("Pruning", 0))
    return blobs


def rank_mesh(rc: RunConfig):
    """The rank mesh of ``--mesh dp,sp[,spy]`` (None without the flag).
    A mesh of one rank starts its own world; a larger one needs a world
    of its size (``torchrun`` or ``parallel.launch.spawn``)."""
    if not rc.mesh:
        return None
    dp, sp, spy = (list(rc.mesh) + [1] * (3 - len(rc.mesh)))[:3]
    n = dp * sp * spy
    if n == 1 or "WORLD_SIZE" in os.environ:
        mesh_mod.init_world(device=rc.device)
    if dist.is_initialized() and dist.get_world_size() != n:
        raise SystemExit(
            f"--mesh {','.join(map(str, rc.mesh))} needs {n} ranks, but "
            f"the world has {dist.get_world_size()}")
    return mesh_mod.make_mesh(n, dp=dp, sp=sp, spy=spy, device=rc.device)


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
                                           mesh=rank_mesh(rc),
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
            mesh=rank_mesh(rc), device=device)
    if task is RegisterTypes.REGISTER_REV:
        return register_mod.register_rev(
            rc.filenames[0], rc.filenames[1], rc.atlas_profile,
            prefix=rc.prefix, mesh=rank_mesh(rc), device=device)
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


def register_stats(rc: RunConfig):
    """The ``--register`` tasks over the regions' tables, on the host
    (reference ``cli._process_register``), each reading
    ``filenames[0]``'s table and writing the reference's files:
    ``smoothing_peaks`` (the row of the best smoothing quality, returned
    only), ``combine_cols`` (``_combined.csv``), ``zscores``
    (``<table base>_zscores.csv``), ``coefvar`` (returned only),
    ``melt_cols`` (``_melted.csv``), ``pivot_conds`` (``_pivoted.csv``),
    ``meas_improvement`` (``--proc`` args ``col_effect=``, ``col_p=``,
    ``col_wt=``; returned only) and the matplotlib figures of
    ``plot_region_dev``, ``plot_lateral_unlabeled``, ``plot_intens_nuc``
    (every ``--img`` table) and ``plot_cluster_blobs`` (the blobs beside
    the image, at ``--offset``'s z)."""
    task = rc.register_type
    path = rc.filenames[0]
    out_base = rc.prefix or path
    if task is RegisterTypes.SMOOTHING_PEAKS:
        df = pd.read_csv(path)
        qcol = "SmoothingQuality" if "SmoothingQuality" in df.columns \
            else "Smoothing_quality"
        fcol = "Filter" if "Filter" in df.columns else "Filter_size"
        return atlas_stats.smoothing_peak(df, qcol, fcol)
    if task is RegisterTypes.COMBINE_COLS:
        out = df_io.combine_cols(pd.read_csv(path), list(vols.MetricCombos))
        out.to_csv(out_base + "_combined.csv", index=False)
        return out
    if task is RegisterTypes.ZSCORES:
        return atlas_stats.meas_plot_zscores(
            path, [m.name for m in vols.VAR_METRICS], ["Region"],
            [vols.MetricCombos.HOMOGENEITY])
    if task is RegisterTypes.COEFVAR:
        return atlas_stats.meas_plot_coefvar(
            path, ["Region"], "Condition", None, ["Volume"])
    if task is RegisterTypes.MELT_COLS:
        df = pd.read_csv(path)
        id_cols = [c for c in ("Sample", "Region") if c in df.columns]
        out = df_io.melt_cols(
            df, id_cols, [c for c in df.columns if c not in id_cols])
        out.to_csv(out_base + "_melted.csv", index=False)
        return out
    if task is RegisterTypes.PIVOT_CONDS:
        df = pd.read_csv(path)
        piv, _ = df_io.pivot_with_conditions(
            df, "Sample", "Condition",
            "Volume" if "Volume" in df.columns else df.columns[-1])
        piv.to_csv(out_base + "_pivoted.csv")
        return piv
    if task is RegisterTypes.MEAS_IMPROVEMENT:
        cols = rc.proc_args or {}
        return atlas_stats.meas_improvement(
            path, cols.get("col_effect", "Effect"), cols.get("col_p", "P"),
            col_wt=cols.get("col_wt"))
    if task is RegisterTypes.PLOT_REGION_DEV:
        return atlas_stats.plot_region_development(
            "Volume", pd.read_csv(path))
    if task is RegisterTypes.PLOT_LATERAL_UNLABELED:
        return atlas_stats.plot_unlabeled_hemisphere(path, ["Unlabeled"])
    if task is RegisterTypes.PLOT_INTENS_NUC:
        return atlas_stats.plot_intensity_nuclei(
            rc.filenames, ["DensityIntens", "Density"])
    # plot_cluster_blobs
    return atlas_stats.plot_clusters_by_label(
        libmag.combine_paths(path, "blobs.npz"),
        rc.offset[2] if rc.offset else 0)


def df_task(rc: RunConfig):
    """The ``--df`` tasks over CSV tables (reference ``cli._df_task``), on
    the host: the tables are the paths after the task's name, else
    ``--img``; ``--labels`` names the columns (``id_cols=``,
    ``melt_cols=``, ``group_cols=``, ``metric_cols=``, ``id_col=``,
    ``index=``, ``columns=``, ``values=``, ``col1=``, ``col2=``,
    ``name=``, ``cond_col=``, ``cond_base=``, ``vals_from=``,
    ``vals_to=``, ``cols=``) and ``--groups`` the labels of
    ``append_csvs_cols``; the result is written to ``--prefix`` when
    given (``exps_by_region`` returns its tables only). Returns the
    task's table (``exps_by_region``: a table a measurement)."""
    tasks = df_io.DFTasks
    task = df_task_type(rc.df_task[0])
    paths = rc.df_task[1:] or rc.filenames
    labels = rc.labels
    if task is tasks.MERGE_CSVS:
        return df_io.merge_csvs(paths, rc.prefix)
    if task is tasks.EXPS_BY_REGION:
        return df_io.exps_by_regions(paths[0])
    # the tasks of several tables read them all, the others the first
    if task in (tasks.APPEND_CSVS_COLS, tasks.MERGE_CSVS_COLS):
        dfs = [pd.read_csv(p_) for p_ in paths]
    else:
        df = pd.read_csv(paths[0])
    if task is tasks.APPEND_CSVS_COLS:
        out = df_io.append_cols(
            dfs, rc.groups or [str(i) for i in range(len(dfs))])
    elif task is tasks.MERGE_CSVS_COLS:
        out = df_io.join_dfs(dfs, str(labels.get("id_col", "Sample")))
    elif task is tasks.MELT_COLS:
        out = df_io.melt_cols(
            df, str(labels.get("id_cols", "Region")).split(","),
            str(labels.get("melt_cols", "")).split(","))
    elif task is tasks.ZSCORE:
        out = df_io.zscore_df(
            df, str(labels.get("group_cols", "Region")).split(","),
            str(labels.get("metric_cols", "Volume")).split(","))
    elif task is tasks.PIVOT_TABLE:
        out = df_io.pivot_table(
            df, str(labels.get("index", df.columns[0])),
            str(labels.get("columns", df.columns[1])),
            str(labels.get("values", df.columns[-1])))
    elif task in (tasks.SUM_COLS, tasks.SUBTRACT_COLS,
                  tasks.MULTIPLY_COLS, tasks.DIVIDE_COLS):
        col1 = str(labels.get("col1", df.columns[-2]))
        col2 = str(labels.get("col2", df.columns[-1]))
        fn = {tasks.SUM_COLS: np.add, tasks.SUBTRACT_COLS: np.subtract,
              tasks.MULTIPLY_COLS: np.multiply,
              tasks.DIVIDE_COLS: np.divide}[task]
        name = labels.get("name") or f"{col1}_{task.name.lower()}"
        df_io.func_to_paired_cols(df, col1, col2, fn, str(name))
        out = df
    elif task is tasks.NORMALIZE:
        out = df_io.normalize_df(
            df, str(labels.get("id_cols", "Region")).split(","),
            str(labels.get("cond_col", "Condition")),
            str(labels.get("cond_base", "ctl")),
            str(labels.get("metric_cols", "Volume")).split(","))
    else:  # replace_vals
        out = df_io.replace_vals(
            df, labels.get("vals_from"), labels.get("vals_to"),
            labels.get("cols"))
    if rc.prefix:
        df_io.data_frames_to_csv(out, rc.prefix)
    return out


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
    mesh = rank_mesh(rc)
    df = vols.measure_labels_metrics(
        atlas, labels, heat_map=heat, labels_ref=ref, mesh=mesh,
        device=device)
    out_csv = (rc.prefix or os.path.splitext(path)[0]) + "_vols.csv"
    comm.on_writer(mesh, lambda: df.to_csv(out_csv, index=False))
    return df


def process_host_task(rc: RunConfig):
    """The ``--proc`` tasks that run on the host (reference
    ``cli.process_file``): ``import_only`` (the imported image),
    ``load`` (the image), ``export_tif`` and ``export_raw`` (the written
    path), ``export_blobs`` (the blobs' table), ``extract`` (the plane),
    ``export_rois`` (the ROIs' table), ``export_planes[_channels]`` (the
    planes' paths) and ``animated`` (the animation's path)."""
    path = rc.filenames[0]
    if rc.proc is ProcessTypes.IMPORT_ONLY:
        ext = os.path.splitext(path)[1].lower()
        fn = importer.VENDOR_IMPORTERS.get(ext, importer.import_tiff)
        kwargs = {"series": rc.series} if ext == ".lif" else {}
        return fn(path, out_path=rc.prefix or path,
                  resolutions=rc.resolutions, **kwargs)
    if rc.proc is ProcessTypes.EXPORT_BLOBS:
        return export_rois.blobs_to_csv(rc)
    img5d = load_image(rc)
    if rc.proc is ProcessTypes.LOAD:
        return img5d
    base = os.path.splitext(rc.prefix or path)[0]
    channel = rc.channel[0] if rc.channel else None
    if rc.proc is ProcessTypes.EXTRACT:
        z = rc.offset[2] if rc.offset else 0
        plane = plot_support.extract_planes(
            np.asarray(img5d.img), z, rc.plane or "xy")[0]
        out = f"{base}_plane{rc.plane or 'xy'}{z}.npy"
        np.save(out, plane)
        _logger.info("extracted plane -> %s %s", out, plane.shape)
        return plane
    if rc.proc is ProcessTypes.EXPORT_ROIS:
        db = sqlite.load_db(rc.truth_db or sqlite.DB_NAME)
        try:
            vol = img5d.img[0] if img5d.img.ndim >= 4 else img5d.img
            df = export_rois.export_rois(
                np.asarray(vol), db, rc.channel or [0], f"{base}_rois")
        finally:
            db.close()
        _logger.info("exported %d ROIs to %s_rois", len(df), base)
        return df
    if rc.proc is ProcessTypes.ANIMATED:
        vol = np.asarray(img5d.img)
        if rc.slice_vals:
            sl = slice(*rc.slice_vals)
            vol = vol[:, sl] if vol.ndim >= 4 else vol[sl]
        fps = max(1, round(1000 / rc.delay)) if rc.delay else 10
        return export_stack.animate_imgs(vol, f"{base}.gif", fps=fps,
                                         channel=channel)
    if rc.proc in (ProcessTypes.EXPORT_PLANES,
                   ProcessTypes.EXPORT_PLANES_CHANNELS):
        return export_stack.export_planes(
            np.asarray(img5d.img), f"{base}_planes",
            ext=rc.savefig or "png", channel=channel,
            separate_channels=rc.proc is ProcessTypes.EXPORT_PLANES_CHANNELS)
    out = rc.prefix or os.path.splitext(path)[0]
    if rc.proc is ProcessTypes.EXPORT_TIF:
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
    if rc.proc is ProcessTypes.TRANSFORM:
        rescale = rc.transform.get("rescale")
        return transformer.transpose_img(
            path, plane=rc.plane,
            rescale=float(rescale) if rescale else None,
            mesh=rank_mesh(rc), device=device)
    if rc.proc is ProcessTypes.PREPROCESS:
        img5d = load_image(rc)
        return transformer.preprocess_img(
            np.asarray(img5d.img), list(rc.proc_args),
            out_path=rc.prefix or path, device=device)
    if rc.proc is ProcessTypes.COLOC_MATCH:
        return coloc_match(rc)
    if rc.proc is ProcessTypes.CLASSIFY:
        return classify(rc, device)
    if rc.proc in DETECT_TASKS:
        return detect(rc, device,
                      coloc=rc.proc is ProcessTypes.DETECT_COLOC)
    raise SystemExit(f"--proc takes a ProcessTypes member, not {rc.proc!r}")


def main(argv: Optional[Sequence[str]] = None
         ) -> Union[blobs_mod.Blobs, pd.DataFrame, Dict, str, list,
                    np.ndarray, tuple]:
    """CLI entry. Returns what the task's function returns: the detected
    or classified blobs, the channel pairs' matches, the grid search's
    table, the registration's result, the transformed image's path, the
    preprocessed image, the heat map(s), the regions' table, the
    clustered blobs, the imported or loaded image, an export's path, the
    blobs' or ROIs' table, the extracted plane, the planes' paths, the
    plot's figure, the webhook's response or the EC2 task's result."""
    logging.basicConfig(
        level=logging.INFO, format="%(levelname)s:%(name)s: %(message)s")
    return process_tasks(process_cli_args(argv))


def process_tasks(rc: RunConfig):
    """Run the parsed task, in the reference's order: ``--register``,
    ``--notify``, ``--plot_2d``, ``--df``, ``--grid_search``, ``--ec2_*``,
    then ``--proc``; returns what :func:`main` returns."""
    if rc.register_type is None and rc.notify_url:
        _logger.info("--notify on the host")
        return process_notify(rc)
    if rc.register_type is None and cloud_task(rc):
        _logger.info("--ec2_* on the host")
        return process_aws(rc)
    if rc.register_type in STATS_TASKS:
        _logger.info("--register %s on the host",
                     rc.register_type.name.lower())
        return register_stats(rc)
    if rc.register_type is None and rc.plot_2d_task:
        _logger.info("--plot_2d %s on the host", rc.plot_2d_task)
        return plot_2d_task(rc)
    if rc.register_type is None and rc.df_task:
        _logger.info("--df %s on the host", rc.df_task[0])
        return df_task(rc)
    by_proc = rc.register_type is None and not rc.grid_search
    if by_proc and rc.proc is None:
        _logger.info("no task specified; see --proc / --register")
        return None
    if by_proc and rc.proc in HOST_TASKS:
        _logger.info("%s on the host", rc.proc)
        return process_host_task(rc)
    device = device_mod.resolve(rc.device)
    if rc.register_type is not None:
        _logger.info("--register %s on %s", rc.register_type.name.lower(),
                     device)
        return process_register(rc, device)
    if rc.grid_search:
        _logger.info("grid search %s on %s", rc.grid_search, device)
        return mlearn.grid_search_from_cli(rc, device)
    _logger.info("%s on %s", rc.proc, device)
    return process_file(rc, device)


#: the reference's name of :func:`process_tasks`
process_proc_tasks = process_tasks


def setup_image(rc: RunConfig) -> np_io.Image5d:
    """The main image of a run config (:func:`load_image`)."""
    return load_image(rc)


def setup_dbs(rc: RunConfig):
    """The main database (``rc.db_path``, else ``magmap.db``) and the
    truth database of ``rc.truth_db`` (None without one), opened."""
    db = sqlite.load_db(rc.db_path or sqlite.DB_NAME)
    truth = sqlite.load_truth_db(rc.truth_db) if rc.truth_db else None
    return db, truth


def _with_profiles(prof, names: Optional[str]):
    prof.add_profiles(names)
    return prof


def setup_roi_profiles(names) -> List[ROIProfile]:
    """One ROI profile for each name (a comma-separated modifier chain;
    ``"default"``, or no names, the defaults)."""
    return [_with_profiles(ROIProfile(), name)
            for name in names or ("default",)]


def setup_atlas_profiles(name: Optional[str] = None) -> AtlasProfile:
    """The atlas profile of a modifier chain (the defaults without one)."""
    return _with_profiles(AtlasProfile(), name)


def setup_grid_search_profiles(
        name: Optional[str] = None) -> GridSearchProfile:
    """The grid-search profile of a modifier chain (empty without one)."""
    return _with_profiles(GridSearchProfile(), name)


def update_profiles(rc: RunConfig) -> RunConfig:
    """Rebuild the run config's profiles from their names. ``RunConfig``
    keeps no names, so this resets ``roi_profiles`` to one default
    profile and ``atlas_profile`` to the defaults, as the reference does
    (ROADMAP section 3, reference defects kept for parity)."""
    rc.roi_profiles = setup_roi_profiles(
        getattr(rc, "roi_profile_names", None))
    rc.atlas_profile = setup_atlas_profiles(
        getattr(rc, "atlas_profile_name", None))
    return rc


def setup_labels(labels_path: Optional[str], level=None):
    """The loaded ontology of ``labels_path`` (None without a path);
    ``level`` is taken and not read, as in the reference."""
    if not labels_path:
        return None
    return ontology.LabelsRef(labels_path).load()


def shutdown() -> None:
    """Flush and close the logging handlers."""
    logging.shutdown()


if __name__ == "__main__":
    main()
