"""NumPy image I/O: memmapped ``image5d`` arrays and their YAML metadata.

Copy of what the port reads and writes from
``magellanmapper_tpu/io/np_io.py``: the ``Image5d`` model,
``<base>_image5d.npy`` / ``<base>_meta.yml`` naming, versioned metadata,
memmapped loading (:func:`read_file`, which also takes a plain ``.npy``
path, and a sub-image by offset and size), :func:`write_npy`, and the
scaling between a full image and a rescaled one with the blobs' region
assignment (:func:`find_scaling`, :func:`assign_blob_regions`), the
master loader :func:`setup_images`, TIFF reads and writes
(:func:`read_tif`, :func:`write_tif`), raw writes and the archive
helpers.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from magellanmapper_torch.io import yaml_io
from magellanmapper_torch.utils import libmag

#: metadata archive version
IMAGE5D_NP_VER = 15

SUFFIX_IMAGE5D = "image5d.npy"
SUFFIX_META = "meta.yml"
SUFFIX_SUBIMG = "subimg.npy"
SUFFIX_BLOBS = "blobs.npz"


@dataclass
class Image5d:
    """Main image model: ``t, z, y, x, [c]`` array + metadata."""
    img: Optional[np.ndarray] = None
    path_img: Optional[str] = None
    path_meta: Optional[str] = None
    img_io: Optional[str] = None
    meta: Dict = field(default_factory=dict)
    subimg_offset: Optional[Sequence[int]] = None
    subimg_size: Optional[Sequence[int]] = None

    @property
    def resolutions(self) -> Optional[np.ndarray]:
        res = self.meta.get("resolutions")
        return None if res is None else np.atleast_2d(np.asarray(res))

    @property
    def near_min(self):
        return self.meta.get("near_min")

    @property
    def near_max(self):
        return self.meta.get("near_max")

    def roi(self, offset: Sequence[int], size: Sequence[int]) -> np.ndarray:
        """Extract a z,y,x ROI (offset/size in z,y,x) from the t=0 volume."""
        vol = self.img[0] if self.img.ndim >= 4 else self.img
        sl = tuple(slice(o, o + s) for o, s in zip(offset, size))
        return vol[sl]


def make_filenames(
        filename: str, series: Optional[int] = None) -> Tuple[str, str]:
    """Paths of the image5d array and metadata for a base path."""
    base = libmag.splitext(filename)[0]
    if series is not None and series > 0:
        base = f"{base}_series{series:05d}"
    return f"{base}_{SUFFIX_IMAGE5D}", f"{base}_{SUFFIX_META}"


def make_subimage_name(
        base: str, offset: Sequence[int], size: Sequence[int]) -> str:
    """Sub-image path for an x,y,z ``offset``/``size``
    (``importer.make_subimage_name`` and ``naming.make_subimage_name`` of
    the reference): ``<base>_(x,y,z)x(x,y,z)<ext>``."""
    roi_site = "{}x{}".format(
        tuple(offset), tuple(size)).replace(" ", "")
    return libmag.insert_before_ext(base, roi_site, "_")


def save_image_info(
        path_meta: str, names, sizes, resolutions, magnification=1.0,
        zoom=1.0, near_min=None, near_max=None, scaling=None,
        plane=None) -> Dict:
    """Write the metadata YAML."""
    data = {
        "ver": IMAGE5D_NP_VER,
        "names": list(names) if names is not None else None,
        "sizes": [list(np.ravel(s)) for s in sizes] if sizes else None,
        "resolutions": np.asarray(resolutions).tolist(),
        "magnification": magnification,
        "zoom": zoom,
        "near_min": np.asarray(near_min).tolist()
        if near_min is not None else None,
        "near_max": np.asarray(near_max).tolist()
        if near_max is not None else None,
        "scaling": np.asarray(scaling).tolist()
        if scaling is not None else None,
        "plane": plane,
    }
    yaml_io.save_yaml(path_meta, data)
    return data


def load_metadata(path_meta: str) -> Tuple[Dict, int]:
    """Load the metadata YAML; returns ``(meta, version)``."""
    if not os.path.exists(path_meta):
        return {}, -1
    docs = yaml_io.load_yaml(path_meta)
    meta = docs[0] if isinstance(docs, list) else docs
    return meta, int(meta.get("ver", -1))


def calc_intensity_bounds(
        img: np.ndarray, lower: float = 0.5, upper: float = 99.5,
        sample_planes: int = 32) -> Tuple[list, list]:
    """Near-min/max per channel from percentiles over sampled planes."""
    vol = img[0] if img.ndim >= 5 else img
    step = max(1, vol.shape[0] // sample_planes)
    sample = np.asarray(vol[::step])
    multichannel = sample.ndim > 3
    n_chl = sample.shape[-1] if multichannel else 1
    mins, maxs = [], []
    for c in range(n_chl):
        chan = sample[..., c] if multichannel else sample
        lo, hi = np.percentile(chan, (lower, upper))
        mins.append(float(lo))
        maxs.append(float(hi))
    return mins, maxs


def write_npy(
        path: str, arr: np.ndarray, resolutions=None,
        save_meta: bool = True) -> Image5d:
    """Save an array as ``<base>_image5d.npy`` (+ metadata) via an
    out-of-core memmap copy; returns the loaded Image5d."""
    path_img, path_meta = make_filenames(path)
    if arr.ndim == 3:
        arr = arr[None]  # add t axis
    out = np.lib.format.open_memmap(
        path_img, mode="w+", dtype=arr.dtype, shape=arr.shape)
    for t in range(arr.shape[0]):
        out[t] = arr[t]
    out.flush()
    if save_meta:
        near_min, near_max = calc_intensity_bounds(arr)
        save_image_info(
            path_meta, [os.path.basename(path)], [arr.shape],
            resolutions if resolutions is not None else [[1.0, 1.0, 1.0]],
            near_min=near_min, near_max=near_max)
    return read_file(path)


def read_file(
        filename: str, series: Optional[int] = None,
        offset: Optional[Sequence[int]] = None,
        size: Optional[Sequence[int]] = None) -> Image5d:
    """Load a memmapped image5d and its metadata; ``offset``/``size``
    (x,y,z) cut a sub-image, or load one saved under its sub-image
    name."""
    path_img, path_meta = make_filenames(filename, series)
    if not os.path.exists(path_img) and os.path.exists(filename) \
            and filename.endswith(".npy"):
        # direct .npy path given
        path_img = filename
    meta, ver = load_metadata(path_meta)
    if 0 <= ver < IMAGE5D_NP_VER:
        meta = update_image5d_np_ver(meta, ver)

    if offset is not None and size is not None:
        # prefer a previously saved sub-image archive
        sub_path = libmag.combine_paths(
            make_subimage_name(filename, offset, size), SUFFIX_SUBIMG)
        if os.path.exists(sub_path):
            sub = np.load(sub_path, mmap_mode="r")
            img5d = Image5d(
                img=sub[None] if sub.ndim < 4 else sub,
                path_img=sub_path, path_meta=path_meta, img_io="np",
                meta=meta)
            img5d.subimg_offset = offset[::-1]
            img5d.subimg_size = size[::-1]
            return img5d

    img = np.load(path_img, mmap_mode="r")
    img5d = Image5d(
        img=img, path_img=path_img, path_meta=path_meta, img_io="np",
        meta=meta)
    if offset is not None and size is not None:
        # x,y,z convention for offset/size per the CLI
        off_zyx = offset[::-1]
        size_zyx = size[::-1]
        img5d.img = img5d.roi(off_zyx, size_zyx)[None]
        img5d.subimg_offset = off_zyx
        img5d.subimg_size = size_zyx
    return img5d


def find_scaling(
        img5d_shape: Sequence[int], scaled_shape: Sequence[int]
) -> np.ndarray:
    """Per-axis scaling between a full image and a rescaled one
    (reference ``np_io.find_scaling``)."""
    return np.divide(scaled_shape[:3], img5d_shape[:3])


def assign_blob_regions(
        blobs: np.ndarray, labels_img: np.ndarray,
        scaling: Sequence[float]) -> np.ndarray:
    """Append/overwrite the blobs' region column from a labels image
    (reference ``np_io.setup_images`` blob-to-region assignment)."""
    from magellanmapper_torch.atlas import ontology
    coords = ontology.scale_coords(
        blobs[:, :3], scaling, labels_img.shape)
    regions = ontology.get_label_ids_from_position(coords, labels_img)
    if blobs.shape[1] >= 11:
        blobs[:, 10] = regions
        return blobs
    return np.column_stack([blobs, regions])


def update_image5d_np_ver(meta: Dict, ver: int,
                          img: Optional[np.ndarray] = None) -> Dict:
    """Migrate an older metadata archive to the current layout: fills
    keys added in later versions (the near-min/max intensity bounds from
    ``img`` when given) so archives written by old builds keep loading.
    Returns the upgraded dict with ``ver`` bumped."""
    meta = dict(meta)
    if ver >= IMAGE5D_NP_VER:
        return meta
    # <= v9: no separate zoom/magnification
    meta.setdefault("magnification", 1.0)
    meta.setdefault("zoom", 1.0)
    # <= v11: no near-min/max intensity bounds
    if meta.get("near_min") is None or meta.get("near_max") is None:
        if img is not None:
            near_min, near_max = calc_intensity_bounds(img)
            meta["near_min"], meta["near_max"] = near_min, near_max
        else:
            meta.setdefault("near_min", None)
            meta.setdefault("near_max", None)
    # <= v13: no scaling/plane records
    meta.setdefault("scaling", None)
    meta.setdefault("plane", None)
    meta["ver"] = IMAGE5D_NP_VER
    return meta


def setup_images(
        filename: str,
        series: Optional[int] = None,
        offset: Optional[Sequence[int]] = None,
        size: Optional[Sequence[int]] = None,
        load_blobs: bool = True,
        reg_suffixes: Optional[Dict[str, str]] = None,
        labels_ref_path: Optional[str] = None) -> Dict:
    """Master loader (reference ``np_io.setup_images :221``): main image
    (memmap), blobs archive, registered atlas/labels by suffix, labels
    reference, and blob region assignment.

    Returns dict with ``img5d``, ``blobs`` (Blobs or None),
    ``labels_img``, ``atlas_img``, ``labels_ref`` (loaded entries only).
    """
    from magellanmapper_torch.atlas import ontology
    from magellanmapper_torch.cv import blobs as blobs_mod
    from magellanmapper_torch.io import sitk_io

    out: Dict = {}
    img5d = read_file(filename, series, offset=offset, size=size)
    out["img5d"] = img5d

    if load_blobs:
        blobs_path = libmag.combine_paths(filename, SUFFIX_BLOBS)
        if os.path.exists(blobs_path):
            out["blobs"] = blobs_mod.Blobs().load_blobs(blobs_path)

    if reg_suffixes:
        for key, name in reg_suffixes.items():
            try:
                img = sitk_io.load_registered_img(filename, name)
            except (FileNotFoundError, ValueError):
                continue
            if key in ("annotation", "labels"):
                out["labels_img"] = img
            elif key == "atlas":
                out["atlas_img"] = img

    if labels_ref_path:
        out["labels_ref"] = ontology.LabelsRef(labels_ref_path).load()

    blobs = out.get("blobs")
    labels_img = out.get("labels_img")
    if blobs is not None and blobs.blobs is not None \
            and labels_img is not None:
        scaling = find_scaling(img5d.img.shape[1:4], labels_img.shape)
        blobs.blobs = assign_blob_regions(
            blobs.blobs, labels_img, scaling)
    return out


def read_tif(path: str, lazy: bool = True):
    """Open a TIFF lazily when possible (reference ``np_io.read_tif
    :274``): a :class:`~magellanmapper_torch.io.tiff.LazyTiffStack`, or
    an eager read when its pages are inconsistent."""
    from magellanmapper_torch.io import tiff
    if lazy:
        try:
            return tiff.LazyTiffStack(path)
        except ValueError:
            pass
    return tiff.read_tiff(path)


def img_to_blobs_path(path: str) -> str:
    """Default blobs archive path for an image base path."""
    return libmag.combine_paths(path, SUFFIX_BLOBS)


def read_np_archive(archive) -> Dict:
    """NPZ archive to a dict, skipping the entries that need pickle to
    load (numpy raises ``ValueError`` for them)."""
    out = {}
    for key in archive.files if hasattr(archive, "files") else archive:
        try:
            out[key] = archive[key]
        except ValueError:
            continue
    return out


def fix_memmap_shape(shape) -> Tuple[int, ...]:
    """Shape tuple of primitive ints (NumPy-2 ``open_memmap`` rejects
    ``np.int64`` entries)."""
    return tuple(int(s) for s in shape)


def get_num_channels(img: Optional[np.ndarray] = None,
                     is_3d: bool = False) -> int:
    """Channel count for z,y,x[,c] (``is_3d``) or t,z,y,x[,c] arrays."""
    if img is None:
        return 1
    chl_dim = 3 if is_3d else 4
    return int(img.shape[chl_dim]) if img.ndim > chl_dim else 1


def write_raw_file(arr: np.ndarray, path: str) -> str:
    """Stream an array to a raw binary file via memmap
    (reference ``np_io.write_raw_file :322``)."""
    mm = np.memmap(path, dtype=arr.dtype, mode="w+", shape=arr.shape)
    mm[:] = arr[:]
    mm.flush()
    return path


def write_tif(img: np.ndarray, path: str, **kwargs) -> str:
    """Write an array as TIFF planes through
    :func:`magellanmapper_torch.io.tiff.write_tiff` (reference
    ``np_io.write_tif :331``); a path without a TIFF extension gets
    ``.tif``."""
    from magellanmapper_torch.io import tiff
    out = libmag.match_ext("x.tif", path) if not path.endswith(
        (".tif", ".tiff")) else path
    tiff.write_tiff(out, np.asarray(img))
    return out
