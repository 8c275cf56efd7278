"""Image import: TIFF, RAW and plane directories to memmapped image5d.

Copy of the TIFF family of ``magellanmapper_tpu/io/importer.py``:
:func:`import_tiff` (OME-TIFF's page stream reshaped by its OME-XML, with
its calibration), :func:`import_raw`, plane directories
(:func:`setup_import_dir`, :func:`import_planes_to_stack`), channel-file
groups (:func:`setup_import_multipage`, :func:`setup_import_metadata`,
:func:`import_multiplane_images`) and the name and metadata helpers. The
same files import to the same ``.npy`` archives and metadata as the
reference's.

The vendor formats import through the port's copies of the reference's
readers: :func:`import_czi` and :func:`import_lif` (``czi_lif``),
:func:`import_nd2` (``nd2`` with ``jp2k``), :func:`import_oib` and
:func:`import_oif` (``oib``) and :func:`import_ims` (``hdf5`` with
``hdf5_native``), with the reference's signatures. Formats that need
Bio-Formats go through the Java gate (:func:`start_jvm`), which raises
``ImportError`` where javabridge is not installed, as the reference's.
"""

from __future__ import annotations

import glob
import logging
import os
import re
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from magellanmapper_torch.io import np_io, tiff
from magellanmapper_torch.utils import libmag

_logger = logging.getLogger(__name__)

#: per-channel file designator
CHANNEL_SEPARATOR = "_ch_"


def deconstruct_img_name(
        img_name: str) -> Tuple[str, Optional[List[int]],
                                Optional[List[int]]]:
    """Parse sub-image offset/size from a filename: names like
    ``base_(x,y,z)x(x,y,z)`` carry offset x size."""
    base = os.path.basename(img_name)
    m = re.search(
        r"_\((\d+),(\d+),(\d+)\)x\((\d+),(\d+),(\d+)\)", base)
    if not m:
        return img_name, None, None
    vals = [int(v) for v in m.groups()]
    stripped = img_name.replace(m.group(0), "")
    return stripped, vals[:3], vals[3:]


def make_subimage_name(
        base: str, offset: Sequence[int], size: Sequence[int]) -> str:
    """Sub-image path for an x,y,z ``offset``/``size``."""
    return np_io.make_subimage_name(base, offset, size)


def parse_ome_description(desc: Optional[str]) -> Optional[Dict]:
    """Parse an OME-TIFF ImageDescription's OME-XML block.

    Returns ``{"size": {X,Y,Z,C,T}, "order": DimensionOrder,
    "resolutions": (z,y,x) | None}`` or None for non-OME descriptions.
    """
    if not desc or "OME" not in desc or "<" not in desc:
        return None
    import xml.etree.ElementTree as ET
    try:
        root = ET.fromstring(desc)
    except ET.ParseError:
        return None

    def local(el):
        return el.tag.rsplit("}", 1)[-1]

    pixels = next((el for el in root.iter() if local(el) == "Pixels"),
                  None)
    if pixels is None:
        return None
    size = {ax: int(pixels.get(f"Size{ax}", 1)) for ax in "XYZCT"}
    phys = {}
    for ax in "XYZ":
        v = pixels.get(f"PhysicalSize{ax}")
        if v is not None:
            phys[ax] = float(v)
    res = None
    if "X" in phys and "Y" in phys:
        res = (phys.get("Z", phys["X"]), phys["Y"], phys["X"])
    return {"size": size,
            "order": pixels.get("DimensionOrder", "XYZCT"),
            "resolutions": res}


def _reshape_ome(pages: np.ndarray, ome: Dict) -> np.ndarray:
    """(pages, H, W) -> (T, Z, Y, X[, C]) per the OME DimensionOrder
    (the first two letters are always XY; the rest order C/Z/T fastest
    first across pages)."""
    size = ome["size"]
    nz, nc, nt = size["Z"], size["C"], size["T"]
    if pages.shape[0] != nz * nc * nt:
        raise ValueError(
            f"OME page count mismatch: {pages.shape[0]} pages vs "
            f"SizeZ*SizeC*SizeT = {nz * nc * nt}")
    fast_to_slow = [ax for ax in ome["order"][2:] if ax in "ZCT"]
    dims = {"Z": nz, "C": nc, "T": nt}
    # page index unravels as (slowest, ..., fastest)
    arr = pages.reshape(
        [dims[ax] for ax in reversed(fast_to_slow)]
        + list(pages.shape[1:]))
    # move axes into (T, Z, Y, X, C)
    axis_of = {ax: i for i, ax in enumerate(reversed(fast_to_slow))}
    arr = np.transpose(arr, (
        axis_of["T"], axis_of["Z"], 3, 4, axis_of["C"]))
    if size["C"] == 1:
        arr = arr[..., 0]
    return arr


def _res_list(res) -> Optional[list]:
    return [list(res)] if res is not None else None


def import_tiff(
        path: str, out_path: Optional[str] = None,
        resolutions: Optional[Sequence[float]] = None,
        channel_dim: Optional[int] = None) -> np_io.Image5d:
    """Import a (multi-page) TIFF stack into a memmapped image5d.

    OME-TIFFs (an OME-XML ImageDescription) reshape their page stream
    into the full ``(T, Z, Y, X[, C])`` geometry with calibration from
    PhysicalSize attributes, unless ``resolutions`` are given.
    ``channel_dim`` is accepted for the reference's signature and read
    nowhere, as there.
    """
    arr, desc = tiff.read_tiff(path, return_description=True)
    if arr.ndim == 2:
        arr = arr[None]
    ome = parse_ome_description(desc)
    if ome is not None and arr.ndim == 3:
        arr5d = _reshape_ome(arr, ome)
        res = resolutions or ome.get("resolutions")
        return np_io.write_npy(out_path or path, arr5d,
                               resolutions=_res_list(res))
    return np_io.write_npy(out_path or path, arr[None],
                           resolutions=_res_list(resolutions))


def _write_vendor(path, out_path, arr, meta, resolutions,
                  channels_first=False) -> np_io.Image5d:
    """Write a vendor reader's array as an image5d, its calibration unless
    ``resolutions`` are given; ``channels_first`` readers return
    ``(C, Z, Y, X)``, moved to ``(Z, Y, X, C)``."""
    if channels_first and arr.ndim == 4:
        arr = np.moveaxis(arr, 0, -1)
    return np_io.write_npy(
        out_path or path, arr[None],
        resolutions=_res_list(resolutions or meta.get("resolutions")))


def import_czi(
        path: str, out_path: Optional[str] = None,
        resolutions: Optional[Sequence[float]] = None) -> np_io.Image5d:
    """Import a Zeiss CZI file into a memmapped image5d through the
    pure-Python ZISRAW reader (:func:`.czi_lif.read_czi`)."""
    from magellanmapper_torch.io import czi_lif
    arr, meta = czi_lif.read_czi(path)
    return _write_vendor(path, out_path, arr, meta, resolutions)


def import_lif(
        path: str, out_path: Optional[str] = None, series: int = 0,
        resolutions: Optional[Sequence[float]] = None) -> np_io.Image5d:
    """Import one series of a Leica LIF file into a memmapped image5d
    (:func:`.czi_lif.read_lif`)."""
    from magellanmapper_torch.io import czi_lif
    arr, meta = czi_lif.read_lif(path, series=series)
    return _write_vendor(path, out_path, arr, meta, resolutions)


def import_nd2(
        path: str, out_path: Optional[str] = None,
        resolutions: Optional[Sequence[float]] = None) -> np_io.Image5d:
    """Import a Nikon ND2 file into a memmapped image5d through the
    chunk-map reader, or the JPEG 2000 route for legacy files
    (:func:`.nd2.read_nd2`); compressed chunk-map planes raise."""
    from magellanmapper_torch.io import nd2
    arr, meta = nd2.read_nd2(path)
    return _write_vendor(path, out_path, arr, meta, resolutions,
                         channels_first=True)


def import_oib(
        path: str, out_path: Optional[str] = None,
        resolutions: Optional[Sequence[float]] = None) -> np_io.Image5d:
    """Import an Olympus OIB archive (OLE2 compound file of per-plane
    TIFFs) through :func:`.oib.read_oib`."""
    from magellanmapper_torch.io import oib
    arr, meta = oib.read_oib(path)
    return _write_vendor(path, out_path, arr, meta, resolutions,
                         channels_first=True)


def import_oif(
        path: str, out_path: Optional[str] = None,
        resolutions: Optional[Sequence[float]] = None) -> np_io.Image5d:
    """Import an Olympus OIF main file and its ``.files`` plane
    directory through :func:`.oib.read_oif`."""
    from magellanmapper_torch.io import oib
    arr, meta = oib.read_oif(path)
    return _write_vendor(path, out_path, arr, meta, resolutions,
                         channels_first=True)


def import_ims(
        path: str, out_path: Optional[str] = None,
        resolution_level: int = 0,
        resolutions: Optional[Sequence[float]] = None) -> np_io.Image5d:
    """Import an Imaris IMS (HDF5) volume through the pure-Python HDF5
    reader, or the system libhdf5 for 'latest'-profile files
    (:func:`.hdf5.read_ims`)."""
    from magellanmapper_torch.io import hdf5
    arr, meta = hdf5.read_ims(path, resolution_level=resolution_level)
    return _write_vendor(path, out_path, arr, meta, resolutions,
                         channels_first=True)


#: the vendor formats' importers by file extension
VENDOR_IMPORTERS = {".czi": import_czi, ".lif": import_lif,
                    ".nd2": import_nd2, ".oib": import_oib,
                    ".oif": import_oif, ".ims": import_ims}


def import_raw(
        path: str, shape: Sequence[int], dtype,
        out_path: Optional[str] = None,
        offset_bytes: int = 0,
        resolutions: Optional[Sequence[float]] = None) -> np_io.Image5d:
    """Import a headerless RAW volume given shape (z,y,x[,c]) + dtype."""
    arr = np.memmap(
        path, dtype=dtype, mode="r", offset=offset_bytes, shape=tuple(shape))
    return np_io.write_npy(out_path or path, np.asarray(arr)[None],
                           resolutions=_res_list(resolutions))


def setup_import_dir(dir_path: str, pattern: str = "*.tif*") -> List[str]:
    """Plane or tile files of a directory, sorted by name as strings (so
    ``tile_10`` comes before ``tile_2``, as in the reference)."""
    files = sorted(glob.glob(os.path.join(dir_path, pattern)))
    if not files:
        raise FileNotFoundError(
            f"no files matching {pattern} in {dir_path}")
    return files


def _first_page(path: str) -> np.ndarray:
    plane = tiff.read_tiff(path)
    return plane[0] if plane.ndim > 2 else plane


def import_planes_to_stack(
        plane_files: Sequence[str], out_path: str,
        resolutions: Optional[Sequence[float]] = None) -> np_io.Image5d:
    """Stream per-plane images (the first page of each file) into a
    memmapped image5d."""
    first = _first_page(plane_files[0])
    shape = (1, len(plane_files)) + first.shape
    path_img, path_meta = np_io.make_filenames(out_path)
    out = np.lib.format.open_memmap(
        path_img, mode="w+", dtype=first.dtype, shape=shape)
    out[0, 0] = first
    for i, fname in enumerate(plane_files[1:], start=1):
        out[0, i] = _first_page(fname)
    out.flush()
    near_min, near_max = np_io.calc_intensity_bounds(out)
    np_io.save_image_info(
        path_meta, [os.path.basename(out_path)], [shape],
        [list(resolutions)] if resolutions is not None else [[1.0, 1.0, 1.0]],
        near_min=near_min, near_max=near_max)
    return np_io.read_file(out_path)


def read_file(filename: str, series: Optional[int] = None,
              **kwargs) -> np_io.Image5d:
    """Load an imported image."""
    return np_io.read_file(filename, series, **kwargs)


def filename_to_base(filename: str, series: Optional[int] = None,
                     modifier: str = "", keep_ext: bool = False) -> str:
    """Image path to its base path (``series`` is accepted for the
    reference's signature and read nowhere, as there)."""
    base = filename if keep_ext else libmag.splitext(filename)[0]
    if modifier:
        base += f"_{modifier}" if not modifier.startswith("_") else modifier
    return base


def parse_deconstructed_name(filename: str, offset, size,
                             reg_suffixes=None, suffix=None):
    """Interpret a deconstructed name: returns
    ``(has_subimg, is_registered)``."""
    has_subimg = offset is not None and size is not None
    is_registered = bool(reg_suffixes) and any(
        v for v in (reg_suffixes or {}).values())
    return has_subimg, is_registered


def find_sizes(filename: str) -> List[Tuple[int, ...]]:
    """Per-series (t, z, y, x, c) dimensions of a TIFF or ``.npy``
    file."""
    ext = os.path.splitext(filename)[1].lower()
    if ext in (".tif", ".tiff"):
        shape = tiff.read_tiff(filename).shape
    else:
        shape = np.load(filename, mmap_mode="r").shape
    # normalize to t,z,y,x,c
    shape = list(shape)
    while len(shape) < 5:
        if len(shape) == 3:
            shape = [1] + shape
        else:
            shape = shape + [1]
    return [tuple(shape[:5])]


def setup_import_multipage(filename) -> Tuple[Dict, str]:
    """Group channel-designated files (``<prefix>_ch_<n>*``) for import:
    returns ``({channel: [paths]}, prefix)``."""
    paths = np.atleast_1d(filename).tolist()
    root, ext = os.path.splitext(paths[0])
    # strip an existing channel designator to glob for siblings
    i = root.find(CHANNEL_SEPARATOR)
    prefix = root[:i] if i != -1 else root
    matches = sorted(glob.glob(f"{prefix}{CHANNEL_SEPARATOR}*{ext}"))
    chl_paths: Dict = OrderedDict()
    if matches:
        for m in matches:
            tail = m[len(prefix) + len(CHANNEL_SEPARATOR):]
            try:
                chl = int(os.path.splitext(tail)[0].split("_")[0])
            except ValueError:
                continue
            chl_paths.setdefault(chl, []).append(m)
    else:
        chl_paths[0] = paths
    return chl_paths, prefix


def setup_import_metadata(chl_paths: Dict, channel=None, series=None,
                          z_max: int = -1) -> Dict:
    """Output shape + dtype metadata for a multipage import, from the
    first selected channel's first file."""
    md: Dict = {"series": series or 0}
    chls = [c for c in chl_paths
            if channel is None or c in np.atleast_1d(channel)]
    if chls:
        arr = tiff.read_tiff(chl_paths[chls[0]][0])
        if arr.ndim == 2:
            arr = arr[None]
        if z_max >= 0:
            arr = arr[:z_max]
        md["shape"] = (1, *arr.shape, len(chls)) if len(chls) > 1 \
            else (1, *arr.shape)
        md["dtype"] = str(arr.dtype)
    return md


def import_multiplane_images(chl_paths: Dict, prefix: str,
                             import_md: Optional[Dict] = None,
                             channel=None) -> np_io.Image5d:
    """Import channel-grouped multipage files into one image5d archive
    (``import_md`` is accepted for the reference's signature and read
    nowhere, as there)."""
    vols = []
    for chl, paths in sorted(chl_paths.items()):
        if channel is not None and chl not in np.atleast_1d(channel):
            continue
        planes = [tiff.read_tiff(p) for p in paths]
        vol = planes[0] if len(planes) == 1 else np.stack(
            [p if p.ndim == 2 else p[0] for p in planes])
        if vol.ndim == 2:
            vol = vol[None]
        vols.append(vol)
    arr = vols[0] if len(vols) == 1 else np.stack(vols, axis=-1)
    return np_io.write_npy(prefix, arr[None])


def calc_near_intensity_bounds(near_mins: list, near_maxs: list,
                               lows: list, highs: list) -> None:
    """Fold per-chunk low/high lists into channel near-min/max lists,
    in place."""
    if not lows:
        return
    num_channels = len(np.atleast_1d(lows[0]))
    if num_channels <= 1:
        near_mins.append(float(np.min(lows)))
        near_maxs.append(float(np.max(highs)))
    else:
        near_mins.extend(np.min(np.asarray(lows), axis=0).tolist())
        near_maxs.extend(np.max(np.asarray(highs), axis=0).tolist())


def save_np_image(image: np.ndarray, filename: str,
                  series: Optional[int] = None) -> str:
    """Save an array as an image5d archive + metadata; returns the
    base path."""
    if image.ndim < 4:
        image = image[None]
    base = filename_to_base(filename, series)
    np_io.write_npy(base, image)
    return base


def calc_scaling(image5d, scaled, image5d_shape=None,
                 scaled_shape=None) -> np.ndarray:
    """Exact z,y,x scaling between an image and its rescaled version."""
    if image5d_shape is None:
        image5d_shape = image5d.shape
    if scaled_shape is None:
        scaled_shape = scaled.shape
    big = image5d_shape[1:4] if len(image5d_shape) >= 4 \
        else image5d_shape[:3]
    small = scaled_shape[1:4] if len(scaled_shape) >= 4 \
        else scaled_shape[:3]
    return np.divide(small, big)


def roi_to_image5d(roi: np.ndarray) -> np.ndarray:
    """Add the time axis."""
    return np.asarray(roi)[None]


def assign_metadata(img5d, md: Dict) -> None:
    """Copy metadata entries onto an image object by attribute (an
    :class:`~magellanmapper_torch.io.np_io.Image5d` takes none of them:
    its ``resolutions``, ``near_min`` and ``near_max`` read its ``meta``
    and cannot be set, as in the reference)."""
    for key in ("resolutions", "magnification", "zoom", "near_min",
                "near_max"):
        if key in md and md[key] is not None:
            setattr(img5d, key, md[key])


def is_javabridge_loaded() -> bool:
    """Whether the Java bridge (javabridge) imports."""
    try:
        import javabridge  # noqa: F401
    except ImportError:
        return False
    return True


def start_jvm(heap_size: str = "8G") -> None:
    """Start the Bio-Formats JVM; raises ``ImportError`` with the
    reference's guidance when the Java stack is absent."""
    if not is_javabridge_loaded():
        raise ImportError(
            "javabridge/python-bioformats are required for this format; "
            "CZI/LIF import natively via io.czi_lif (import_czi/"
            "import_lif), or import TIFF/NPY/raw, or install the Java "
            "stack")
    import javabridge
    import bioformats
    javabridge.start_vm(class_path=bioformats.JARS,
                        max_heap_size=heap_size)


def stop_jvm() -> None:
    """Stop the JVM when the Java bridge is there."""
    if is_javabridge_loaded():
        import javabridge
        javabridge.kill_vm()


def parse_ome(filename: str):
    """OME metadata through Bio-Formats: needs the Java stack
    (:func:`start_jvm` raises without it)."""
    start_jvm()


def parse_ome_raw(filename: str):
    """OME-XML through Bio-Formats: needs the Java stack
    (:func:`start_jvm` raises without it)."""
    start_jvm()
