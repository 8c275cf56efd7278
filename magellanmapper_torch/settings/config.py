"""Run configuration: task enums and an explicit config object.

Copy of ``magellanmapper_tpu/settings/config.py``: the task vocabularies
(``ProcessTypes``, ``RegisterTypes``, ``DFTasks``, ...), the registered
image names, metadata keys and metric column names, the constants
(``GROUPS_NUMERIC``, the ``PATH_*`` names), :class:`Config` and
:class:`ClassifierData`, with the same member names and values, so
commands and file names carry over between the packages. The command line
(:mod:`magellanmapper_torch.io.cli`) reads ``RegisterTypes`` from here.
"""

from __future__ import annotations

import dataclasses
import logging
from enum import Enum, auto
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger("mmtpu")


class ProcessTypes(Enum):
    """Whole-image processing tasks (``--proc``)."""
    IMPORT_ONLY = auto()
    DETECT = auto()
    DETECT_COLOC = auto()
    COLOC_MATCH = auto()
    CLASSIFY = auto()
    LOAD = auto()
    EXTRACT = auto()
    EXPORT_ROIS = auto()
    TRANSFORM = auto()
    ANIMATED = auto()
    EXPORT_BLOBS = auto()
    EXPORT_PLANES = auto()
    EXPORT_PLANES_CHANNELS = auto()
    EXPORT_RAW = auto()
    EXPORT_TIF = auto()
    PREPROCESS = auto()


class RegisterTypes(Enum):
    """Registration/atlas tasks (``--register``)."""
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


class RegNames(Enum):
    """Registered-image filename suffix vocabulary (reference
    ``config.py:578``). ``.mhd`` files are read/written by our own codec."""
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
    IMG_LABELS_TRUNC_PRECUR = "annotationTruncPrecur.mhd"
    IMG_LABELS_EDGE = "annotationEdge.mhd"
    IMG_LABELS_DIST = "annotationDist.mhd"
    IMG_LABELS_MARKERS = "annotationMarkers.mhd"
    IMG_LABELS_INTERIOR = "annotationInterior.mhd"
    IMG_LABELS_SUBSEG = "annotationSubseg.mhd"
    IMG_LABELS_DIFF = "annotationDiff.mhd"
    IMG_LABELS_LEVEL = "annotationLevel{}.mhd"
    IMG_LABELS_EDGE_LEVEL = "annotationEdgeLevel{}.mhd"
    IMG_LABELS_TRANS = "annotationTrans.mhd"
    COMBINED = "combined.mhd"


class RegSuffixes(Enum):
    """Registered image suffix type keys for CLI parsing."""
    ATLAS = auto()
    ANNOTATION = auto()
    BORDERS = auto()
    FIXED_MASK = auto()
    MOVING_MASK = auto()
    DENSITY = auto()


class SmoothingModes(Enum):
    """Label smoothing modes (reference ``config.py:821``)."""
    opening = auto()
    gaussian = auto()
    closing = auto()
    filled = auto()


class Transforms(Enum):
    """Whole-image transform keys (``--transform``)."""
    ROTATE = auto()
    ROTATE_DEG = auto()
    FLIP_VERT = auto()
    FLIP_HORIZ = auto()
    FLIP = auto()
    RESCALE = auto()
    INTERPOLATION = auto()


class MetaKeys(Enum):
    """Image metadata keys (reference ``config.py:227``)."""
    RESOLUTIONS = "resolutions"
    MAGNIFICATION = "magnification"
    ZOOM = "zoom"
    SHAPE = "shape"
    DTYPE = "dtype"


class PreProcessKeys(Enum):
    """Whole-image preprocessing tasks (reference ``config.py:251``)."""
    SATURATE = auto()
    DENOISE = auto()
    REMAP = auto()
    ROTATE = auto()


class TruthDBModes(Enum):
    """Truth database modes (reference ``config.py:532``)."""
    VIEW = "view"
    VERIFY = "verify"
    VERIFIED = "verified"
    EDIT = "edit"


class DFTasks(Enum):
    """Data-frame tasks (``--df``)."""
    MERGE_CSVS = auto()
    MERGE_CSVS_COLS = auto()
    APPEND_CSVS_COLS = auto()
    EXPS_BY_REGION = auto()
    EXTRACT_FROM_CSV = auto()
    ADD_CSV_COLS = auto()
    NORMALIZE = auto()
    MERGE_EXCELS = auto()
    SUM_COLS = auto()
    SUBTRACT_COLS = auto()
    MULTIPLY_COLS = auto()
    DIVIDE_COLS = auto()
    REPLACE_VALS = auto()


class AtlasMetrics(Enum):
    """Atlas metric column names (reference ``config.py:786``)."""
    SAMPLE = "Sample"
    REGION = "Region"
    REGION_ABBR = "RegionAbbr"
    REGION_NAME = "RegionName"
    LEVEL = "Level"
    SIDE = "Side"
    CONDITION = "Condition"
    DSC_ATLAS_LABELS = "DSC_atlas_labels"
    DSC_ATLAS_SAMPLE = "DSC_atlas_sample"
    DSC_ATLAS_SAMPLE_CUR = "DSC_atlas_sample_curated"
    DSC_SAMPLE_LABELS = "DSC_sample_labels"
    SIMILARITY_METRIC = "Similarity_metric"
    LAT_UNLBL_VOL = "Lateral_unlabeled_volume"
    LAT_UNLBL_PLANES = "Lateral_unlabeled_planes"
    VOL_ATLAS = "Vol_atlas",
    VOL_LABELS = "Vol_labels",
    OFFSET = "Offset"
    SIZE = "Size"
    CHANNEL = "Channel"


class SmoothingMetrics(Enum):
    """Label-smoothing quality metrics (reference ``config.py:837``)."""
    COMPACTION = "Compaction"
    DISPLACEMENT = "Displacement"
    SM_QUALITY = "Smoothing_quality"
    COMPACTNESS = "Compactness"
    DISPLACED = "Displaced"
    FILTER_SIZE = "Filter_size"


class ABAKeys(Enum):
    """Allen Brain Atlas ontology JSON keys."""
    NAME = "name"
    ABA_ID = "id"
    LEVEL = "st_level"
    CHILDREN = "children"
    ACRONYM = "acronym"
    PARENT_ID = "parent_structure_id"


class ItkSnapLabels(Enum):
    """Column names for ITK-SNAP label description files."""
    ID = "id"
    R = "r"
    G = "g"
    B = "b"
    A = "a"
    VIS = "vis"
    MESH = "mesh"
    NAME = "name"


class LoadIO(Enum):
    """I/O sources for image loading."""
    NP = auto()
    TIF = auto()
    SITK = auto()
    BRAIN_GLOBE = auto()


class Verbosity(Enum):
    LEVEL = auto()
    LOG_PATH = auto()


#: labels multiplier for sub-segmentations (reference ``config.py:632``).
SUB_SEG_MULT = 100
#: region value meaning "all regions".
REGION_ALL = "all"

#: stats CSV filenames (reference ``config.py:731-740``).
PATH_SMOOTHING_METRICS = "smoothing.csv"
PATH_SMOOTHING_RAW_METRICS = "smoothing_raw.csv"
PATH_ATLAS_IMPORT_METRICS = "stats.csv"
PATH_COMMON_LABELS = "regions_common.csv"

#: numeric encoding for experiment groups.
GROUPS_NUMERIC = {"WT": 0.0, "het": 0.5, "null": 1.0}


@dataclasses.dataclass
class ClassifierData:
    """Blob classifier settings (reference ``config.py:406``)."""
    model: Optional[str] = None
    #: classification flag written into the blobs "confirmed" column.
    flag: Optional[int] = None
    #: channels of blobs to classify.
    blob_channels: Optional[Sequence[int]] = None
    #: image channels fed to the classifier.
    img_channels: Optional[Sequence[int]] = None


@dataclasses.dataclass
class Config:
    """Explicit run configuration (replaces the reference's global bag).

    Only the CLI mutates this; compute layers receive values as arguments.
    """

    # image selection
    filename: Optional[str] = None
    filenames: Optional[List[str]] = None
    metadata_paths: Optional[List[str]] = None
    prefix: Optional[str] = None
    prefix_out: Optional[str] = None
    suffix: Optional[str] = None
    series: int = 0
    channel: Optional[List[int]] = None
    rgb: bool = False

    # ROI/sub-image geometry (z,y,x per reference semantics)
    subimg_offsets: Optional[List[Sequence[int]]] = None
    subimg_sizes: Optional[List[Sequence[int]]] = None
    roi_offsets: Optional[List[Sequence[int]]] = None
    roi_sizes: Optional[List[Sequence[int]]] = None

    # image metadata
    resolutions: Optional[np.ndarray] = None
    magnification: float = 1.0
    zoom: float = 1.0
    near_min: Optional[np.ndarray] = None
    near_max: Optional[np.ndarray] = None
    vmins: Optional[Sequence[float]] = None
    vmaxs: Optional[Sequence[float]] = None
    norm: Optional[Sequence[float]] = None

    # tasks
    proc_type: Dict[ProcessTypes, Any] = dataclasses.field(
        default_factory=dict)
    register_type: Optional[RegisterTypes] = None
    df_task: Optional[DFTasks] = None
    plot_2d_type: Optional[str] = None
    load_data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # profiles: per-channel ROI profiles; single atlas profile
    roi_profiles: List[Any] = dataclasses.field(default_factory=list)
    atlas_profile: Any = None
    grid_search_profile: Any = None

    # registration
    reg_suffixes: Dict[RegSuffixes, Any] = dataclasses.field(
        default_factory=dict)
    load_labels: Optional[str] = None
    labels_level: Optional[int] = None
    labels_ref: Any = None
    labels_metadata: Any = None
    labels_img: Optional[np.ndarray] = None
    labels_scaling: Optional[Sequence[float]] = None

    # transforms (``--transform`` dict)
    transform: Dict[Transforms, Any] = dataclasses.field(default_factory=dict)

    # databases
    db_path: Optional[str] = None
    db: Any = None
    truth_db_mode: Optional[TruthDBModes] = None
    truth_db_name: Optional[str] = None
    truth_db: Any = None
    verified_db: Any = None

    # runtime
    cpus: Optional[int] = None
    seed: Optional[int] = None
    verbose: bool = False
    show: bool = True
    savefig: Optional[str] = None
    classifier: ClassifierData = dataclasses.field(
        default_factory=ClassifierData)
    groups: Optional[Sequence[str]] = None
    plot_labels: Dict[str, Any] = dataclasses.field(default_factory=dict)
    alphas: Optional[Sequence[float]] = None
    slice_vals: Optional[Sequence[int]] = None
    delay: Optional[int] = None
    save_subimg: bool = False
    plane: Optional[str] = None

    # runtime of the reference's device mesh (kept for the same fields)
    mesh_shape: Optional[Sequence[int]] = None
    device_batch: int = 1

    def get_roi_profile(self, channel: int):
        """Per-channel ROI profile, falling back to the first."""
        from magellanmapper_torch.settings.roi_prof import ROIProfile
        if not self.roi_profiles:
            self.roi_profiles.append(ROIProfile())
        if channel is not None and 0 <= channel < len(self.roi_profiles):
            return self.roi_profiles[channel]
        return self.roi_profiles[0]


#: CLI-populated configuration instance.
config = Config()


def get_roi_profile(i: int):
    """Module-level per-channel ROI profile accessor on the active
    :data:`config` (reference ``config.get_roi_profile :887``)."""
    return config.get_roi_profile(i)


class DocsURLs(Enum):
    """Online documentation URLs (reference ``config.DocsURLs :65``)."""
    DOCS_URL = "https://magellanmapper.readthedocs.io/en/latest"
    DOCS_URL_VIEWER = "viewers.html"
    DOCS_URL_SETTINGS = "settings.html"


class LoadData(Enum):
    """Data sources to (re)load (reference ``config.LoadData :175``)."""
    BLOBS = auto()
    BLOB_MATCHES = auto()


class Cmaps(Enum):
    """Custom colormap names (reference ``config.Cmaps :302``)."""
    CMAP_GRBK_NAME = "Green_black"
    CMAP_RDBK_NAME = "Red_black"
    CMAP_BUBK_NAME = "Blue_black"
    CMAP_CYBK_NAME = "Cyan_black"
    CMAP_MGBK_NAME = "Magenta_black"
    CMAP_YLBK_NAME = "Yellow_black"


class PlotLabels(Enum):
    """Plot label sub-argument keys (reference ``config.PlotLabels
    :330``)."""
    TITLE = auto()
    X_LABEL = auto()
    Y_LABEL = auto()
    X_UNIT = auto()
    Y_UNIT = auto()
    X_LIM = auto()
    Y_LIM = auto()
    X_TICK_LABELS = auto()
    Y_TICK_LABELS = auto()
    X_SCALE = auto()
    Y_SCALE = auto()
    SIZE = auto()
    LAYOUT = auto()
    ALPHAS_CHL = auto()
    VMAX = auto()
    VMIN = auto()
    SCALE_BAR = auto()
    LEGEND_NAMES = auto()
    PADDING = auto()
    MARKER = auto()
    CONDITION = auto()
    DPI = auto()
    NAN_COLOR = auto()
    TEXT_POS = auto()


class Themes(Enum):
    """Matplotlib RC themes (reference ``config.Themes :440``)."""
    DEFAULT = {
        "font.family": "sans-serif",
        "font.sans-serif": ["Arial", "Helvetica", "Tahoma"],
        "axes.titlesize": 12,
        "image.composite_image": False,
    }
    DARK = {
        "text.color": "w",
        "axes.facecolor": "#7a7a7a",
        "axes.edgecolor": "#3b3b3b",
        "axes.labelcolor": "w",
        "xtick.color": "w",
        "ytick.color": "w",
        "grid.color": "w",
        "figure.facecolor": "#3b3b3b",
        "figure.edgecolor": "#3b3b3b",
        "savefig.facecolor": "#3b3b3b",
        "savefig.edgecolor": "#3b3b3b",
    }


class HemSides(Enum):
    """Hemisphere sides (reference ``config.HemSides :813``)."""
    RIGHT = "R"
    LEFT = "L"
    BOTH = "both"


def format_import_err(distro: str, name: Optional[str] = None,
                      task: Optional[str] = None) -> str:
    """Message for a missing optional dependency
    (reference ``config.format_import_err``)."""
    name = name or distro
    task = f" for {task}" if task else ""
    return (f"{name} is required{task}, but it could not be imported; "
            f"please install, e.g. with 'pip install {distro}'")


class DataClassProtocol:
    """Marker base for dataclass-style settings objects parsed by
    ``args_to_dict`` (reference ``config.DataClassProtocol``)."""
    __dataclass_fields__: dict = {}
