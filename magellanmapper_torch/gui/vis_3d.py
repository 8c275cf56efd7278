"""The 3D scene: blob clouds, projections, surfaces and an orbit camera.

Port of ``magellanmapper_tpu/gui/vis_3d.py``. The figures
(:func:`plot_blobs_3d`, :func:`plot_max_intensity_projections`,
:func:`plot_surface_3d`) are matplotlib's, imported when one is made.
The interactive scene is split in two:

- :class:`Vis3DRenderer` holds everything that is not drawing: the
  volume on the card, the frame and depth buffer of the shear-warp
  renderers (``ops.render3d.render_volume_sw`` in ``volume`` and ``mip``
  modes, ``render_isosurface_sw`` with its Otsu level taken on the card),
  the camera (orbit, zoom, pan, reset), the blobs' projection through
  ``render3d.render_blobs_overlay`` and picking. It imports no
  matplotlib, so it runs where none is installed;
- :class:`Vis3DCanvas`, the reference's canvas with its events and
  methods, is that renderer with a matplotlib figure over it: it blits
  the renderer's frame and overlays, or draws the scene on a 3D axes in
  ``mpl`` mode.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.ops import preproc, render3d
from magellanmapper_torch.plot import colormaps, plot_support

_logger = logging.getLogger(__name__)

#: the renderer's modes that make a frame on the device; ``mpl`` makes
#: none (the canvas draws the scene on a matplotlib 3D axes)
RENDER_MODES = ("volume", "mip", "isosurface")


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_blobs_3d(
        blobs: np.ndarray, roi_shape: Sequence[int],
        out_path: Optional[str] = None,
        isotropic_vis: Sequence[float] = (1, 1, 1),
        color_by_channel: bool = True):
    """3D scatter of blobs sized by radius (Vis3D points mode)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    scale = np.asarray(isotropic_vis, float)
    coords = blobs[:, :3] * scale
    sizes = np.clip(blobs[:, 3] ** 2 * 4, 4, 200)
    chls = blobs[:, 6].astype(int) if blobs.shape[1] > 6 else \
        np.zeros(len(blobs), int)
    for chl in np.unique(chls):
        sel = chls == chl
        color = colormaps.CHANNEL_COLORS[
            chl % len(colormaps.CHANNEL_COLORS)]
        ax.scatter(coords[sel, 2], coords[sel, 1], coords[sel, 0],
                   s=sizes[sel], color=color, alpha=0.6,
                   label=f"chl {chl}")
    ax.set_xlim(0, roi_shape[2] * scale[2])
    ax.set_ylim(0, roi_shape[1] * scale[1])
    ax.set_zlim(0, roi_shape[0] * scale[0])
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.invert_zaxis()
    ax.legend()
    if out_path:
        plot_support.save_fig(fig, out_path)
    plt.close(fig)
    return fig


def plot_max_intensity_projections(
        roi: np.ndarray, out_path: Optional[str] = None,
        blobs: Optional[np.ndarray] = None):
    """Orthogonal maximum-intensity projections, blob centres circled."""
    plt = _pyplot()
    vol = roi if roi.ndim == 3 else roi.max(axis=-1)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    titles = ("xy (max over z)", "xz (max over y)", "yz (max over x)")
    for ax, axis, title in zip(axes, (0, 1, 2), titles):
        mip = vol.max(axis=axis)
        ax.imshow(mip, cmap="magma")
        ax.set_title(title, fontsize=9)
        ax.axis("off")
        if blobs is not None and len(blobs):
            plane_coords = {
                0: (blobs[:, 2], blobs[:, 1]),
                1: (blobs[:, 2], blobs[:, 0]),
                2: (blobs[:, 1], blobs[:, 0])}[axis]
            ax.scatter(*plane_coords, s=8, facecolors="none",
                       edgecolors="cyan", linewidths=0.6)
    if out_path:
        plot_support.save_fig(fig, out_path)
    plt.close(fig)
    return fig


class Vis3D:
    """3D viewer state (reference ``gui/vis_3d.Vis3D``): the scene's
    volume, blobs and surface meshes, rendered as MIP panes or a blob
    cloud."""

    def __init__(self, roi: Optional[np.ndarray] = None):
        self.roi = roi
        self.blobs: Optional[np.ndarray] = None
        self.surfaces = []

    def update_img_display(self, roi: np.ndarray) -> None:
        self.roi = roi

    def show_blobs(self, blobs: np.ndarray) -> None:
        self.blobs = blobs

    def clear_scene(self) -> None:
        self.blobs = None
        self.surfaces = []

    def render(self, out_path: str):
        """Render the blob cloud (when there are blobs) or the MIPs to
        ``out_path``. The reference passes the volume as the blobs and
        raises (ROADMAP section 3); the port plots the blobs in the
        volume's extent."""
        if self.blobs is not None and len(self.blobs):
            return plot_blobs_3d(self.blobs, np.shape(self.roi)[:3],
                                 out_path)
        return plot_max_intensity_projections(self.roi, out_path)


def plot_surface_3d(
        roi: np.ndarray, level: Optional[float] = None,
        out_path: Optional[str] = None,
        isotropic_vis: Sequence[float] = (1, 1, 1),
        color: str = "tab:orange", alpha: float = 0.8, device="cuda"):
    """The ROI's isosurface as a 3D mesh (Vis3D surface mode): the level
    by Otsu on ``device`` unless given, the mesh by surface nets
    (``cv.cv_nd.surface_net_mesh``), drawn as matplotlib's
    ``Poly3DCollection``. Returns ``(fig, (verts, faces))``."""
    from magellanmapper_torch.cv import cv_nd

    dev = device_mod.resolve(device)
    roi = np.asarray(roi, np.float32)
    if level is None:
        level = float(preproc.otsu_threshold(
            torch.from_numpy(roi).to(dev)))
    verts, faces = cv_nd.surface_net_mesh(roi, level)
    scale = np.asarray(isotropic_vis, float)
    verts = verts * scale

    plt = _pyplot()
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    if len(faces):
        # x,y,z order for mpl
        tris = verts[faces][:, :, ::-1]
        coll = Poly3DCollection(
            tris, alpha=alpha, facecolor=color, edgecolor="none")
        ax.add_collection3d(coll)
    shape = np.asarray(roi.shape) * scale
    ax.set_xlim(0, shape[2])
    ax.set_ylim(0, shape[1])
    ax.set_zlim(0, shape[0])
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.invert_zaxis()
    if out_path:
        plot_support.save_fig(fig, out_path)
    plt.close(fig)
    return fig, (verts, faces)


class Vis3DRenderer:
    """The 3D scene's frame, depth buffer, camera and picking on
    ``device``, without matplotlib.

    ``render_mode``: ``"volume"`` (shear-warp emission-absorption, window
    from a tenth of the volume's maximum to its maximum, opacity 0.08),
    ``"mip"`` (maximum intensity projection at any angle),
    ``"isosurface"`` (shaded first crossing of ``iso_level``, Otsu's
    level of the volume when None, with a depth buffer that hides the
    blobs behind the surface) or ``"mpl"`` (no frame). The volume is
    uploaded once; every orbit or zoom renders a new ``render_hw`` frame
    (``frame``, (H, W, 3) float32 on the host; ``_depth`` the isosurface's
    (H, W) depth, inf where no ray hit). ``offset`` is the viewport's pan
    in frame pixels, (x, y), reset by each render.
    """

    def __init__(self, vis3d: Vis3D, render_mode: str = "volume",
                 render_hw: Tuple[int, int] = (384, 384),
                 iso_level: Optional[float] = None, device="cuda",
                 render: bool = True):
        if render_mode not in RENDER_MODES + ("mpl",):
            raise ValueError(f"unknown render mode {render_mode}; options: "
                             f"{RENDER_MODES + ('mpl',)}")
        self.device = device_mod.resolve(device)
        self.vis3d = vis3d
        self.render_mode = render_mode
        self.render_hw = tuple(render_hw)
        self.iso_level = iso_level
        self._azim, self._elev, self._zoom = -60.0, 30.0, 1.0
        self._depth: Optional[np.ndarray] = None
        self.frame: Optional[np.ndarray] = None
        self.offset = [0.0, 0.0]
        #: index into ``vis3d.blobs`` of the picked blob (None = none)
        self.selected_blob: Optional[int] = None
        #: an ROIEditor sharing the scene's blob array: picks and
        #: :meth:`confirm_selected` edit its confirmed flags, and its
        #: ``save(db)`` stores them
        self.editor = None
        self._home: Optional[dict] = None
        self._vol: Optional[torch.Tensor] = None
        self._vol_src = None
        if render:
            self.render()

    # -- frames -------------------------------------------------------------

    def _volume(self) -> torch.Tensor:
        """The scene's volume as float32 on the device, uploaded once a
        volume."""
        roi = self.vis3d.roi
        if self._vol is None or self._vol_src is not roi:
            self._vol = torch.from_numpy(
                np.ascontiguousarray(roi, np.float32)).to(self.device)
            self._vol_src = roi
        return self._vol

    def render(self) -> Optional[np.ndarray]:
        """Render the scene at the current pose into :attr:`frame` (and
        the depth buffer); returns the frame, None without a volume or in
        ``mpl`` mode."""
        self.offset = [0.0, 0.0]
        if self.render_mode == "mpl" or self.vis3d.roi is None:
            self.frame, self._depth = None, None
            return None
        vol = self._volume()
        if self.render_mode == "isosurface":
            if self.iso_level is None:
                self.iso_level = float(preproc.otsu_threshold(vol))
            rgb, depth = render3d.render_isosurface_sw(
                vol, self.iso_level, self._azim, self._elev,
                out_hw=self.render_hw, zoom=self._zoom, device=self.device)
            self._depth = depth.cpu().numpy()
            self.frame = rgb.cpu().numpy()
        else:
            vmax = float(torch.amax(vol))
            self.frame = render3d.render_volume_sw(
                vol, self._azim, self._elev, vmin=0.1 * vmax, vmax=vmax,
                out_hw=self.render_hw, zoom=self._zoom, opacity=0.08,
                mode="mip" if self.render_mode == "mip" else "composite",
                device=self.device).cpu().numpy()
            self._depth = None
        if self._home is None:
            self._home = self.camera_state()
        return self.frame

    def refresh(self) -> None:
        """Re-render after a change of the camera (the canvas redraws
        too)."""
        self.render()

    def _depth_or_open(self) -> np.ndarray:
        return (self._depth if self._depth is not None
                else np.full(self.render_hw, np.inf, np.float32))

    def project_points(self, points: np.ndarray) -> np.ndarray:
        """(N, 4) ``(row, col, visible, ray_depth)`` of z,y,x points under
        the current camera, hidden behind the last isosurface's depth
        buffer when there is one."""
        return render3d.render_blobs_overlay(
            self._depth_or_open(), np.asarray(points),
            np.asarray(self.vis3d.roi).shape, self._azim, self._elev,
            out_hw=self.render_hw, zoom=self._zoom)

    def project_blobs(self) -> np.ndarray:
        """:meth:`project_points` of the scene's blobs."""
        return self.project_points(self.vis3d.blobs)

    def project_surfaces(self) -> List[np.ndarray]:
        """The visible vertices of each surface mesh (at most ~2,000 a
        mesh), as ``(row, col)`` frame pixels: the mesh actors' splats."""
        out = []
        for verts, _faces in self.vis3d.surfaces:
            verts = np.asarray(verts)
            if not len(verts):
                continue
            step = max(1, len(verts) // 2000)
            pts = self.project_points(verts[::step])
            vis = pts[:, 2] > 0
            if vis.any():
                out.append(pts[vis, :2])
        return out

    # -- picking ------------------------------------------------------------

    def attach_editor(self, editor) -> None:
        """Route picks and confirmations through an ROIEditor whose blob
        array the scene then shows."""
        self.editor = editor
        self.vis3d.show_blobs(editor.blobs)

    def pick_blob(self, row: float, col: float,
                  pick_px: float = 8.0) -> Optional[int]:
        """Select the blob under frame pixel ``(row, col)``: the visible
        blobs whose projected centre lies within their projected radius
        (at least ``pick_px``), the nearest along the view ray winning.
        Returns its index or None, and sets :attr:`selected_blob`."""
        if (self.render_mode == "mpl" or self.vis3d.blobs is None
                or not len(self.vis3d.blobs)):
            return None
        pts = self.project_blobs()
        b = np.asarray(self.vis3d.blobs)
        h = self.render_hw[0]
        extent = np.asarray(np.asarray(self.vis3d.roi).shape, np.float32)
        span = 2.0 * float(np.linalg.norm(extent)) / 2.0 / self._zoom
        px_per_vox = (h - 1) / span
        pick_r = np.maximum(
            pick_px, np.maximum(b[:, 3], 1.0) * px_per_vox)
        d2 = (pts[:, 0] - row) ** 2 + (pts[:, 1] - col) ** 2
        cand = (d2 <= pick_r ** 2) & (pts[:, 2] > 0)
        if not cand.any():
            self.selected_blob = None
            return None
        self.selected_blob = int(np.argmin(np.where(cand, pts[:, 3],
                                                    np.inf)))
        return self.selected_blob

    def confirm_selected(self, flag: Optional[int] = None) -> Optional[int]:
        """Set the picked blob's confirmed flag through the attached
        editor: ``flag=None`` advances the -1 -> 0 -> 1 cycle. Returns the
        new flag, or None when nothing is picked or attached."""
        if self.selected_blob is None or self.editor is None:
            return None
        if flag is None:
            return self.editor.cycle_confirmed(self.selected_blob)
        self.editor.set_confirmed(self.selected_blob, int(flag))
        return int(flag)

    # -- camera -------------------------------------------------------------

    def camera_state(self) -> dict:
        return {"azim": self._azim, "elev": self._elev,
                "zoom": self._zoom, "mode": self.render_mode}

    def orbit(self, d_azim: float, d_elev: float) -> None:
        """Turn the camera (elevation kept off the poles) and re-render."""
        self._azim += d_azim
        self._elev = float(np.clip(self._elev + d_elev, -89.9, 89.9))
        self.refresh()

    def zoom(self, factor: float) -> None:
        """Scale the view box by ``factor`` (below 1 zooms in) and
        re-render."""
        self._zoom /= factor
        self.refresh()

    def pan(self, dx: float = 0, dy: float = 0, dz: float = 0) -> None:
        """Shift the viewport over the frame by ``dx``, ``dy`` pixels
        (``dz`` moves nothing in a frame)."""
        self.offset[0] += dx
        self.offset[1] += dy

    def reset_camera(self) -> None:
        home = self._home or {}
        if "azim" in home:
            self._azim, self._elev = home["azim"], home["elev"]
            self._zoom = home.get("zoom", 1.0)
        self.refresh()


class Vis3DCanvas(Vis3DRenderer):
    """Interactive 3D camera over a :class:`Vis3D` scene on a matplotlib
    canvas (reference ``gui/vis_3d.Vis3DCanvas``): left-drag orbits
    (azimuth and elevation), scroll zooms, arrow keys pan, ``r`` resets,
    a click picks a blob and ``c`` cycles the picked blob's confirmed
    flag. ``render_mode`` ``"mpl"`` draws meshes or a thresholded voxel
    cloud on a 3D axes; the other modes blit :class:`Vis3DRenderer`'s
    frame, rendered on ``device`` at ``render_hw``, with the blobs and
    mesh vertices it projects."""

    #: degrees of orbit per dragged pixel
    ORBIT_RATE = 0.4
    #: zoom factor per scroll step
    ZOOM_STEP = 1.2

    def __init__(self, vis3d: Vis3D, figsize=(7, 7),
                 max_points: int = 20000, render_mode: str = "mpl",
                 render_hw: Tuple[int, int] = (384, 384),
                 iso_level: Optional[float] = None, device="cuda"):
        super().__init__(vis3d, render_mode, render_hw, iso_level, device,
                         render=False)
        from matplotlib.figure import Figure
        from matplotlib.backends.backend_agg import FigureCanvasAgg

        self.max_points = max_points
        self.fig = Figure(figsize=figsize)
        self.canvas = FigureCanvasAgg(self.fig)
        self.ax = self.fig.add_subplot(
            **({} if render_mode != "mpl" else {"projection": "3d"}))
        self._drag_start = None
        self._press_pos = None
        self.cids = [
            self.canvas.mpl_connect("button_press_event", self.on_press),
            self.canvas.mpl_connect(
                "button_release_event", self.on_release),
            self.canvas.mpl_connect(
                "motion_notify_event", self.on_motion),
            self.canvas.mpl_connect("scroll_event", self.on_scroll),
            self.canvas.mpl_connect("key_press_event", self.on_key),
        ]
        self.draw_scene()

    # -- scene --------------------------------------------------------------

    def draw_scene(self) -> None:
        """(Re)build the scene: surface meshes when present, else a
        thresholded voxel point cloud, plus the blob scatter."""
        if self.render_mode != "mpl":
            self._draw_raycast()
            return
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        az, el = self.ax.azim, self.ax.elev
        self.ax.clear()
        roi = self.vis3d.roi
        if self.vis3d.surfaces:
            for verts, faces in self.vis3d.surfaces:
                if len(faces):
                    self.ax.add_collection3d(Poly3DCollection(
                        np.asarray(verts)[np.asarray(faces)][:, :, ::-1],
                        alpha=0.6, facecolor="tab:orange",
                        edgecolor="none"))
        elif roi is not None:
            flat = np.asarray(roi).reshape(-1)
            n = min(self.max_points, max(1, flat.size // 50))
            thresh = np.partition(flat, flat.size - n)[flat.size - n]
            zz, yy, xx = np.nonzero(np.asarray(roi) >= thresh)
            vals = np.asarray(roi)[zz, yy, xx]
            self.ax.scatter(xx, yy, zz, c=vals, s=2, alpha=0.35,
                            cmap="magma")
        if self.vis3d.blobs is not None and len(self.vis3d.blobs):
            b = np.asarray(self.vis3d.blobs)
            self.ax.scatter(b[:, 2], b[:, 1], b[:, 0],
                            s=(np.maximum(b[:, 3], 1.0) * 8) ** 2 / 4,
                            facecolors="none", edgecolors="cyan")
        if roi is not None:
            shape = np.asarray(roi).shape
            self.ax.set_xlim(0, shape[2])
            self.ax.set_ylim(0, shape[1])
            self.ax.set_zlim(shape[0], 0)
        self.ax.view_init(elev=el, azim=az)
        if self._home is None:
            self._home = self.camera_state()
        self.canvas.draw_idle()

    def refresh(self) -> None:
        self._draw_raycast()

    def _draw_raycast(self) -> None:
        """Render the frame at the current pose and blit it with the mesh
        splats, the blobs and the picked blob's highlight onto the 2D
        axes."""
        self.render()
        self.ax.clear()
        if self.frame is None:
            self.canvas.draw_idle()
            return
        self.ax.imshow(self.frame)
        self.ax.set_axis_off()
        for pts in self.project_surfaces():
            self.ax.scatter(pts[:, 1], pts[:, 0], s=2, c="orange",
                            alpha=0.6)
        if self.vis3d.blobs is not None and len(self.vis3d.blobs):
            pts = self.project_blobs()
            vis = pts[:, 2] > 0
            if vis.any():
                self.ax.scatter(pts[vis, 1], pts[vis, 0], s=30,
                                facecolors="none", edgecolors="cyan")
            sel = self.selected_blob
            if sel is not None and sel < len(pts) and pts[sel, 2] > 0:
                self.ax.scatter([pts[sel, 1]], [pts[sel, 0]], s=90,
                                facecolors="none", edgecolors="yellow",
                                linewidths=2)
        self.canvas.draw_idle()

    # -- picking ------------------------------------------------------------

    def pick_blob(self, row: float, col: float,
                  pick_px: float = 8.0) -> Optional[int]:
        """:meth:`Vis3DRenderer.pick_blob`, then the highlight redrawn
        (also when a miss clears an earlier pick)."""
        before = self.selected_blob
        idx = super().pick_blob(row, col, pick_px)
        if idx is not None or before is not None:
            self._draw_raycast()
        return idx

    # -- camera -------------------------------------------------------------

    def camera_state(self) -> dict:
        """The camera: orbit angles and zoom, or in ``mpl`` mode the 3D
        axes' angles and bounds."""
        if self.render_mode != "mpl":
            return super().camera_state()
        return {
            "azim": float(self.ax.azim), "elev": float(self.ax.elev),
            "xlim": tuple(self.ax.get_xlim()),
            "ylim": tuple(self.ax.get_ylim()),
            "zlim": tuple(self.ax.get_zlim()),
        }

    def orbit(self, d_azim: float, d_elev: float) -> None:
        if self.render_mode != "mpl":
            super().orbit(d_azim, d_elev)
            return
        self.ax.view_init(
            elev=float(np.clip(self.ax.elev + d_elev, -90.0, 90.0)),
            azim=self.ax.azim + d_azim)
        self.canvas.draw_idle()

    def zoom(self, factor: float) -> None:
        """Scale the view box about its center (Mayavi dolly)."""
        if self.render_mode != "mpl":
            # the 3D axes' factor below 1 shrinks the box (zooms in); the
            # frame's zoom scales the film the other way
            super().zoom(factor)
            return
        for get, set_ in ((self.ax.get_xlim, self.ax.set_xlim),
                          (self.ax.get_ylim, self.ax.set_ylim),
                          (self.ax.get_zlim, self.ax.set_zlim)):
            lo, hi = get()
            c = (lo + hi) / 2
            half = (hi - lo) / 2 * factor
            set_(c - half, c + half)
        self.canvas.draw_idle()

    def pan(self, dx: float = 0, dy: float = 0, dz: float = 0) -> None:
        """Shift the focal point in data units (the frame's viewport in
        the frame modes)."""
        axes = ((dx, self.ax.get_xlim, self.ax.set_xlim),
                (dy, self.ax.get_ylim, self.ax.set_ylim))
        if self.render_mode == "mpl":
            axes = axes + ((dz, self.ax.get_zlim, self.ax.set_zlim),)
        else:
            super().pan(dx, dy)
        for d, get, set_ in axes:
            if d:
                lo, hi = get()
                set_(lo + d, hi + d)
        self.canvas.draw_idle()

    def reset_camera(self) -> None:
        if self.render_mode != "mpl":
            super().reset_camera()
            return
        home = self._home or {}
        if "azim" in home:
            self.ax.view_init(elev=home["elev"], azim=home["azim"])
            self.ax.set_xlim(*home["xlim"])
            self.ax.set_ylim(*home["ylim"])
            self.ax.set_zlim(*home["zlim"])
        self.canvas.draw_idle()

    # -- event handlers -----------------------------------------------------

    def on_press(self, event) -> None:
        if event.button == 1:
            self._drag_start = (event.x, event.y)
            self._press_pos = (event.x, event.y)

    def on_release(self, event) -> None:
        start = self._press_pos
        self._drag_start = None
        self._press_pos = None
        if (start is None or event.x is None
                or self.render_mode == "mpl"):
            return
        # a press-release with <3 px of motion is a click -> pick
        if (abs(event.x - start[0]) < 3 and abs(event.y - start[1]) < 3
                and event.inaxes is self.ax
                and event.xdata is not None):
            self.pick_blob(event.ydata, event.xdata)

    def on_motion(self, event) -> None:
        if self._drag_start is None or event.x is None:
            return
        x0, y0 = self._drag_start
        self.orbit((x0 - event.x) * self.ORBIT_RATE,
                   (event.y - y0) * self.ORBIT_RATE)
        self._drag_start = (event.x, event.y)

    def on_scroll(self, event) -> None:
        self.zoom(1.0 / self.ZOOM_STEP if event.step > 0
                  else self.ZOOM_STEP)

    def on_key(self, event) -> None:
        span = abs(self.ax.get_xlim()[1] - self.ax.get_xlim()[0]) * 0.05
        if event.key == "left":
            self.pan(dx=-span)
        elif event.key == "right":
            self.pan(dx=span)
        elif event.key == "up":
            self.pan(dy=span)
        elif event.key == "down":
            self.pan(dy=-span)
        elif event.key == "r":
            self.reset_camera()
        elif event.key == "c":
            # confirmed-flag cycle on the picked blob (ROI-editor flow)
            self.confirm_selected()

    def save(self, out_path: str) -> str:
        plot_support.save_fig(self.fig, out_path)
        return out_path
