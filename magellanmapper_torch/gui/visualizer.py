"""The session controller of the review GUI.

Port of ``magellanmapper_tpu/gui/visualizer.py``: ``Visualization``
loads an image set, picks an ROI (offset and size in x,y,z, as the
reference's sliders), detects its blobs on the card
(``cv.detector.detect_blobs``, which launches the peak and prune
kernels), adjusts the display, confirms blobs into the database and
renders the ROI's planes and 3D scene; the enums, ``VisHandler``,
``TraitsList`` and the table adapters are the reference's. Every device
step runs on the controller's ``device``.
"""

from __future__ import annotations

import logging
from enum import Enum, auto
from typing import Optional, Sequence

import numpy as np

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.cv import detector
from magellanmapper_torch.io import np_io, sqlite
from magellanmapper_torch.settings.prefs_prof import PrefsProfile
from magellanmapper_torch.settings.roi_prof import ROIProfile

_logger = logging.getLogger(__name__)


class Visualization:
    """Scriptable session controller (reference ``Visualization``); its
    detection, 3D scenes and label interpolation run on ``device``."""

    def __init__(self, prefs: Optional[PrefsProfile] = None,
                 device="cuda"):
        self.device = device_mod.resolve(device)
        self.prefs = prefs or PrefsProfile().load_prefs()
        self.img5d: Optional[np_io.Image5d] = None
        self.labels_img: Optional[np.ndarray] = None
        self.blobs: Optional[np.ndarray] = None
        self.db: Optional[sqlite.ClrDB] = None
        #: ROI position/size in x,y,z (reference slider conventions)
        self.roi_offset = (0, 0, 0)
        self.roi_size = (64, 64, 8)
        self.channel: Optional[Sequence[int]] = None
        self.roi_profile = ROIProfile()

    # -- image loading --------------------------------------------------------

    def load_image(self, path: str, **kwargs) -> np_io.Image5d:
        """Load the main image set (reference ``_setup_for_image``)."""
        out = np_io.setup_images(path, **kwargs)
        self.img5d = out["img5d"]
        self.labels_img = out.get("labels_img")
        if out.get("blobs") is not None:
            self.blobs = out["blobs"].blobs
        return self.img5d

    def open_db(self, path: str = sqlite.DB_NAME) -> sqlite.ClrDB:
        self.db = sqlite.load_db(path)
        return self.db

    # -- ROI workflows ---------------------------------------------------------

    def get_roi(self) -> np.ndarray:
        """Current ROI array (z,y,x[,c])."""
        off = self.roi_offset[::-1]
        size = self.roi_size[::-1]
        return np.asarray(self.img5d.roi(off, size))

    def detect_blobs(self) -> np.ndarray:
        """ROI-level detection (reference ``_blob_detection_fired``)."""
        roi = self.get_roi()
        res = (self.img5d.resolutions[0]
               if self.img5d.resolutions is not None else (1.0, 1.0, 1.0))
        blobs = detector.detect_blobs(
            roi, self.roi_profile, res, channel=self.channel,
            device=self.device)
        self.blobs = blobs
        n = 0 if blobs is None else len(blobs)
        _logger.info("detected %d blobs in ROI %s+%s", n,
                     self.roi_offset, self.roi_size)
        return blobs

    def save_blobs(self, experiment: str = "exp", series: int = 0) -> int:
        """Persist current ROI blobs to the database (reference
        verified-blob save)."""
        if self.db is None or self.blobs is None:
            return 0
        exp_id = self.db.select_or_insert_experiment(experiment)
        roi_id, _ = self.db.select_or_insert_roi(
            exp_id, series, self.roi_offset, self.roi_size)
        return self.db.insert_blobs(roi_id, self.blobs)

    def confirm_blob(self, index: int, flag: int = 1) -> None:
        """Flag a blob (1 correct / 0 incorrect / 2 maybe)."""
        self.blobs[index, 4] = flag

    # -- rendering -------------------------------------------------------------

    def show_roi(self, out_path: str, n_cols: int = 5):
        """ROI plane grid with blob overlays (ROI Editor view)."""
        from magellanmapper_torch.gui import roi_review
        return roi_review.plot_roi_planes(
            self.get_roi(), self.blobs, out_path, n_cols=n_cols)

    def show_3d(self, out_path: str, style: str = "points"):
        """3D scene (reference Vis3D style picker).

        ``style``: ``"points"`` (blob point cloud), ``"surface"``
        (surface-nets isosurface mesh, Otsu's level on the device), or
        the shear-warp modes ``"volume"``/``"mip"``/``"isosurface"``
        through the interactive :class:`gui.vis_3d.Vis3DCanvas`.
        """
        from magellanmapper_torch.gui import vis_3d
        iso = self.roi_profile["isotropic_vis"] or (1, 1, 1)
        if style == "points":
            return vis_3d.plot_blobs_3d(
                self.blobs, self.get_roi().shape[:3], out_path,
                isotropic_vis=iso)
        if style == "surface":
            return vis_3d.plot_surface_3d(
                self.get_roi(), out_path=out_path, isotropic_vis=iso,
                device=self.device)
        vis = vis_3d.Vis3D(np.asarray(self.get_roi(), np.float32))
        if self.blobs is not None and len(self.blobs):
            vis.show_blobs(np.asarray(self.blobs))
        canvas = vis_3d.Vis3DCanvas(vis, render_mode=style,
                                    device=self.device)
        return canvas.save(out_path)

    def open_3d_canvas(self, style: str = "isosurface"):
        """Interactive 3D canvas over the current ROI with blob picking
        wired to the ROI editor's confirm/save flow: click a rendered
        blob to select it (nearest-by-depth), ``c`` cycles its
        confirmed flag, and the attached editor's ``save(db)`` persists
        the curated set (reference Mayavi pick -> verified blobs,
        ``gui/vis_3d.py:21``)."""
        from magellanmapper_torch.gui import vis_3d
        return self._scene_3d(vis_3d.Vis3DCanvas, style)

    def open_3d_renderer(self, style: str = "isosurface",
                         render_hw=(384, 384)):
        """:meth:`open_3d_canvas` without matplotlib: the scene's
        :class:`gui.vis_3d.Vis3DRenderer` (frame, depth, camera and
        picks) at ``render_hw``, wired to an ROI editor the same way."""
        from magellanmapper_torch.gui import vis_3d
        return self._scene_3d(vis_3d.Vis3DRenderer, style,
                              render_hw=render_hw)

    def _scene_3d(self, cls, style: str, **kwargs):
        from magellanmapper_torch.gui import roi_editor, vis_3d
        vis = vis_3d.Vis3D(np.asarray(self.get_roi(), np.float32))
        scene = cls(vis, render_mode=style, device=self.device, **kwargs)
        editor = roi_editor.ROIEditor(
            self.get_roi(),
            self.blobs if self.blobs is not None else None,
            offset=getattr(self, "roi_offset", (0, 0, 0)))
        scene.attach_editor(editor)
        return scene

    def save_prefs(self, path: Optional[str] = None) -> str:
        return self.prefs.save_prefs(path or "prefs.yaml")

    # -- remaining app-tab workflows ------------------------------------------

    def set_roi_profile(self, names: str) -> "ROIProfile":
        """Apply a comma-chained ROI profile (the app's profile picker,
        reference profile tab)."""
        prof = ROIProfile()
        prof.add_profiles(names)
        self.roi_profile = prof
        return prof

    def adjust_image(self, vmin=None, vmax=None, alpha=None) -> dict:
        """Image-adjustment state (brightness/contrast/alpha sliders,
        reference image adjustment tab); consumed by the editor
        canvases via ImageSyncMixin."""
        adj = getattr(self, "display_adjust", {})
        if vmin is not None:
            adj["vmin"] = float(vmin)
        if vmax is not None:
            adj["vmax"] = float(vmax)
        if alpha is not None:
            adj["alpha"] = float(alpha)
        self.display_adjust = adj
        return adj

    def import_file(self, path: str, prefix: Optional[str] = None,
                    resolutions=None) -> np_io.Image5d:
        """Import a TIFF/RAW into the image5d format and load it
        (reference import tab -> ImportThread flow)."""
        from magellanmapper_torch.gui import threads
        task = threads.ImportThread(
            "tif", prefix or path, {0: [path]}).start()
        img5d = task.result()
        self.img5d = img5d
        return img5d

    def open_atlas_editor(self):
        """Synced orthogonal atlas editing views over the loaded image +
        labels (reference atlas-label annotation tab)."""
        from magellanmapper_torch.gui.atlas_editor import AtlasEditor
        from magellanmapper_torch.gui.mpl_canvas import AtlasEditorCanvases
        if self.labels_img is None:
            raise ValueError("no labels image loaded")
        vol = self.img5d.img[0]
        vol = vol[..., 0] if vol.ndim > 3 else vol
        return AtlasEditorCanvases(AtlasEditor(
            np.asarray(vol), np.asarray(self.labels_img),
            device=self.device))

    def open_brain_globe(self, name: str, cache_dir: Optional[str] = None):
        """Open a BrainGlobe atlas from its local cache as the current
        image set (reference BrainGlobe tab)."""
        from magellanmapper_torch import brain_globe
        bg = brain_globe.BrainGlobeMM(
            **({"cache_dir": cache_dir} if cache_dir else {}))
        img5d, labels_img, meta = bg.get_atlas(name)
        self.img5d = img5d
        self.labels_img = labels_img
        return img5d, labels_img, meta


class ViewerTabs(Enum):
    """Viewer tab enumerations (reference ``vis_handler.ViewerTabs
    :197``)."""
    ROI_ED = auto()
    ATLAS_ED = auto()
    MAYAVI = auto()


class StaleFlags(Enum):
    """Stale-state flags per viewer (reference ``vis_handler.StaleFlags
    :204``)."""
    IMAGE = auto()
    ROI = auto()
    ZOOM = auto()


class Styles2D(Enum):
    """2D viewer layout styles (reference ``visualizer.Styles2D``)."""
    SQUARE = "Square layout"
    SQUARE_3D = "Square with 3D"
    SINGLE_ROW = "Single row"
    WIDE = "Wide region"
    ZOOM3 = "3 level zoom"
    ZOOM4 = "4 level zoom"
    THIN_ROWS = "Thin rows"


class RegionOptions(Enum):
    """Atlas region selection options (reference
    ``visualizer.RegionOptions``)."""
    BOTH_SIDES = "Both sides"
    INCL_CHILDREN = "Include children"
    APPEND = "Append"


class AtlasEditorOptions(Enum):
    """Atlas editor toggles (reference
    ``visualizer.AtlasEditorOptions``)."""
    SHOW_LABELS = "Labels"
    SYNC_ROI = "Sync ROI"
    CROSSHAIRS = "Crosshairs"
    ZOOM_ROI = "Zoom ROI"

class Vis3dOptions(Enum):
    """3D viewer toggles (reference ``visualizer.Vis3dOptions``)."""
    RAW = "Raw"
    SURFACE = "Surface"
    CLEAR = "Clear"
    PANES = "Panes"
    SHADOWS = "Shadows"


class BlobsVisibilityOptions(Enum):
    """Blob display toggles (reference
    ``visualizer.BlobsVisibilityOptions``)."""
    VISIBLE = "Visible"


class ProfileCats(Enum):
    """Profile categories in the profiles tab (reference
    ``visualizer.ProfileCats``)."""
    ROI = "ROI"
    ATLAS = "Atlas"
    GRID = "Grid Search"


class ImportModes(Enum):
    """Image import modes (reference ``visualizer.ImportModes``)."""
    DIR = auto()
    MULTIPAGE = auto()


class VisHandler:
    """Session event handler (reference ``vis_handler.VisHandler :19``):
    tracks stale states per viewer tab and closing cleanup."""

    def __init__(self, vis: "Visualization"):
        self.vis = vis
        self.stale: dict = {tab: set() for tab in ViewerTabs}

    def mark_stale(self, flag: StaleFlags,
                   tabs=None) -> None:
        for tab in tabs or ViewerTabs:
            self.stale[tab].add(flag)

    def is_stale(self, tab: ViewerTabs, flag: StaleFlags) -> bool:
        return flag in self.stale[tab]

    def refresh(self, tab: ViewerTabs) -> None:
        self.stale[tab].clear()

    def closed(self, info=None, is_ok: bool = True) -> bool:
        db = getattr(self.vis, "db", None)
        if db is not None:
            db.close()
        return is_ok


class ColocalizeOptions(Enum):
    """Co-localization modes (reference
    ``visualizer.ColocalizeOptions``)."""
    DEFAULT = ""
    INTENSITY = "Intensity"
    MATCHES = "Matches"


class BlobColorStyles(Enum):
    """Blob coloring schemes (reference
    ``visualizer.BlobColorStyles``)."""
    ATLAS_LABELS = "Atlas label colors"
    UNIQUE = "Unique colors"
    CHANNEL = "Channel colors"


class ControlsTabs(Enum):
    """Left-panel control tab order (reference
    ``visualizer.ControlsTabs``)."""
    ROI = auto()
    DETECT = auto()
    PROFILES = auto()
    ADJUST = auto()
    IMPORT = auto()


class TraitsList:
    """Mutable selection-list holder (reference
    ``visualizer.TraitsList``): the Traits-observable list reduced to a
    plain container with change callbacks."""

    def __init__(self, selections=None, fn_changed=None):
        self._selections = list(selections or [])
        self.fn_changed = fn_changed

    @property
    def selections(self) -> list:
        return self._selections

    @selections.setter
    def selections(self, vals) -> None:
        self._selections = list(vals or [])
        if self.fn_changed is not None:
            self.fn_changed(self._selections)


class _TableAdapter:
    """Base table adapter: maps row objects to display columns
    (stand-in for TraitsUI TabularAdapter)."""

    columns: list = []

    def row(self, obj) -> list:
        return [getattr(obj, name, obj[i] if hasattr(obj, "__getitem__")
                        else None)
                for i, (label, name) in enumerate(self.columns)]

    def table(self, objs) -> list:
        return [self.row(o) for o in objs]


class SegmentsArrayAdapter(_TableAdapter):
    """Blob table columns (reference
    ``visualizer.SegmentsArrayAdapter``)."""
    columns = [("z", 0), ("y", 1), ("x", 2), ("radius", 3),
               ("confirmed", 4), ("channel", 6), ("abs_z", 7),
               ("abs_y", 8), ("abs_x", 9)]

    def row(self, blob) -> list:
        return [blob[i] for _, i in self.columns if i < len(blob)]


class ProfilesArrayAdapter(_TableAdapter):
    """Applied-profiles table (reference
    ``visualizer.ProfilesArrayAdapter``)."""
    columns = [("Category", 0), ("Profile", 1), ("Channel", 2)]


class ImportFilesArrayAdapter(_TableAdapter):
    """Import-file table (reference
    ``visualizer.ImportFilesArrayAdapter``)."""
    columns = [("File", 0), ("Channel", 1)]


class BrainGlobeArrayAdapter(_TableAdapter):
    """BrainGlobe atlas table (reference
    ``visualizer.BrainGlobeArrayAdapter``)."""
    columns = [("Atlas", 0), ("Ver", 1), ("Downloaded", 2)]


class MPLFigureEditor:
    """Placeholder editor binding a Matplotlib figure into a GUI layout
    (reference ``visualizer.MPLFigureEditor``); headless builds hold the
    figure directly."""

    def __init__(self, figure=None):
        self.figure = figure

    def init(self, parent=None):
        return self.figure
