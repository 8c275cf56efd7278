"""Medical-format I/O (MHD/MHA, NRRD, NIfTI) in numpy, no ITK.

Copy of ``magellanmapper_tpu/io/sitk_io.py``: ``MedImage``, the
readers and writers (``read_med_img``, ``write_med_img``, ``read_img``,
``write_img``, ``read_sitk[_files]``), registered-image paths and sets
(``reg_out_path``, ``load_registered_img[s]``, ``write_reg_images``,
``write_registered_image``), conversions (``convert_img``,
``load_numpy_to_sitk``, ``replace_sitk_with_numpy``, the identity
bridges), ``match_world_info``, ``find_atlas_labels``, ``merge_images``
and ``write_pts``, with the reference's parsers and writers, so the
files written are byte for byte the reference's. World info
(spacing/origin) travels with a small ``MedImage`` record.
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

#: extensions handled, in priority order for lookups
#: (reference ``sitk_io.EXTS_3D``).
EXTS_3D = (".mhd", ".mha", ".nii.gz", ".nii", ".nrrd")

_MHD_TYPES = {
    "MET_UCHAR": np.uint8, "MET_CHAR": np.int8,
    "MET_USHORT": np.uint16, "MET_SHORT": np.int16,
    "MET_UINT": np.uint32, "MET_INT": np.int32,
    "MET_ULONG": np.uint64, "MET_LONG": np.int64,
    "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
}
_MHD_TYPES_INV = {np.dtype(v): k for k, v in _MHD_TYPES.items()}

_NRRD_TYPES = {
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "short": np.int16, "int16": np.int16,
    "ushort": np.uint16, "uint16": np.uint16,
    "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32,
    "float": np.float32, "double": np.float64,
    "int64": np.int64, "uint64": np.uint64,
}

_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
    1024: np.int64, 1280: np.uint64,
}
_NIFTI_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}


@dataclass
class MedImage:
    """Volume + world info (z,y,x conventions on the array side)."""
    img: np.ndarray
    #: voxel spacing in z,y,x
    spacing: Tuple[float, ...] = (1.0, 1.0, 1.0)
    #: world origin in z,y,x
    origin: Tuple[float, ...] = (0.0, 0.0, 0.0)
    meta: Dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# MetaImage (.mhd/.mha)


def _read_mhd(path: str) -> MedImage:
    header: Dict[str, str] = {}
    data_start = None
    with open(path, "rb") as f:
        while True:
            line = f.readline()
            if not line:
                break
            text = line.decode("ascii", errors="replace").strip()
            if "=" not in text:
                continue
            key, val = [s.strip() for s in text.split("=", 1)]
            header[key] = val
            if key == "ElementDataFile":
                data_start = f.tell()
                break
    dims = [int(v) for v in header["DimSize"].split()]
    dtype = _MHD_TYPES[header["ElementType"]]
    spacing_xyz = [float(v) for v in header.get(
        "ElementSpacing", header.get("ElementSize", "1 1 1")).split()]
    origin_xyz = [float(v) for v in header.get(
        "Offset", header.get("Position", "0 0 0")).split()]
    compressed = header.get("CompressedData", "False").lower() == "true"

    datafile = header["ElementDataFile"]
    if datafile == "LOCAL":
        with open(path, "rb") as f:
            f.seek(data_start)
            raw = f.read()
    else:
        raw_path = os.path.join(os.path.dirname(path), datafile)
        with open(raw_path, "rb") as f:
            raw = f.read()
    if compressed:
        raw = zlib.decompress(raw)
    count = int(np.prod(dims))
    arr = np.frombuffer(raw, dtype=dtype, count=count)
    # file stores x fastest; numpy array is z,y,x (dims reversed)
    arr = arr.reshape(dims[::-1])
    return MedImage(
        arr, tuple(spacing_xyz[::-1]), tuple(origin_xyz[::-1]),
        {"format": "mhd"})


def _write_mhd(path: str, med: MedImage) -> None:
    arr = np.ascontiguousarray(med.img)
    is_mha = path.endswith(".mha")
    datafile = ("LOCAL" if is_mha
                else os.path.basename(path)[:-4] + ".raw")
    dims = list(arr.shape[::-1])
    lines = [
        "ObjectType = Image",
        f"NDims = {arr.ndim}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        "CompressedData = False",
        f"TransformMatrix = {' '.join(str(float(v)) for v in np.eye(arr.ndim).ravel())}",
        f"Offset = {' '.join(str(float(v)) for v in med.origin[::-1])}",
        f"ElementSpacing = {' '.join(str(float(v)) for v in med.spacing[::-1])}",
        f"DimSize = {' '.join(str(d) for d in dims)}",
        f"ElementType = {_MHD_TYPES_INV[arr.dtype]}",
        f"ElementDataFile = {datafile}",
    ]
    header = ("\n".join(lines) + "\n").encode("ascii")
    if is_mha:
        with open(path, "wb") as f:
            f.write(header)
            f.write(arr.tobytes())
    else:
        with open(path, "wb") as f:
            f.write(header)
        with open(os.path.join(os.path.dirname(path), datafile), "wb") as f:
            f.write(arr.tobytes())


# ---------------------------------------------------------------------------
# NRRD


def _read_nrrd(path: str) -> MedImage:
    header: Dict[str, str] = {}
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NRRD"):
            raise ValueError(f"not an NRRD file: {path}")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
            text = line.decode("utf-8", errors="replace").strip()
            if text.startswith("#"):
                continue
            for sep in (": ", ":=", ":"):
                if sep in text:
                    key, val = text.split(sep, 1)
                    header[key.strip().lower()] = val.strip()
                    break
        raw = f.read()
    sizes = [int(v) for v in header["sizes"].split()]
    dtype = _NRRD_TYPES[header["type"]]
    encoding = header.get("encoding", "raw")
    if encoding in ("gzip", "gz"):
        raw = gzip.decompress(raw)
    elif encoding != "raw":
        raise ValueError(f"unsupported NRRD encoding: {encoding}")
    arr = np.frombuffer(raw, dtype=dtype, count=int(np.prod(sizes)))
    arr = arr.reshape(sizes[::-1])
    spacing_xyz = [1.0] * len(sizes)
    if "space directions" in header:
        vecs = [v for v in header["space directions"].split(") ")
                if "(" in v]
        for i, v in enumerate(vecs):
            nums = [float(x) for x in
                    v.replace("(", "").replace(")", "").split(",")]
            spacing_xyz[i] = float(np.linalg.norm(nums))
    elif "spacings" in header:
        spacing_xyz = [float(v) for v in header["spacings"].split()]
    origin_xyz = [0.0] * len(sizes)
    if "space origin" in header:
        origin_xyz = [float(x) for x in header["space origin"]
                      .replace("(", "").replace(")", "").split(",")]
    return MedImage(
        arr, tuple(spacing_xyz[::-1]), tuple(origin_xyz[::-1]),
        {"format": "nrrd"})


def _write_nrrd(path: str, med: MedImage) -> None:
    arr = np.ascontiguousarray(med.img)
    type_name = {v: k for k, v in _NRRD_TYPES.items()}[arr.dtype.type]
    sizes = " ".join(str(s) for s in arr.shape[::-1])
    spac = med.spacing[::-1]
    dirs = " ".join(
        "(" + ",".join(str(float(spac[i])) if j == i else "0"
                       for j in range(arr.ndim)) + ")"
        for i in range(arr.ndim))
    header = (
        "NRRD0004\n"
        f"type: {type_name}\n"
        f"dimension: {arr.ndim}\n"
        f"sizes: {sizes}\n"
        f"space directions: {dirs}\n"
        "space origin: ("
        + ",".join(str(float(v)) for v in med.origin[::-1]) + ")\n"
        "encoding: raw\n"
        "endian: little\n\n")
    with open(path, "wb") as f:
        f.write(header.encode("utf-8"))
        f.write(arr.tobytes())


# ---------------------------------------------------------------------------
# NIfTI-1


def _read_nifti(path: str) -> MedImage:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        hdr = f.read(352)
        sizeof_hdr = struct.unpack("<i", hdr[:4])[0]
        if sizeof_hdr != 348:
            raise ValueError(f"not a NIfTI-1 file: {path}")
        dim = struct.unpack("<8h", hdr[40:56])
        datatype = struct.unpack("<h", hdr[70:72])[0]
        pixdim = struct.unpack("<8f", hdr[76:108])
        vox_offset = int(struct.unpack("<f", hdr[108:112])[0])
        scl_slope = struct.unpack("<f", hdr[112:116])[0]
        scl_inter = struct.unpack("<f", hdr[116:120])[0]
        qoffset = struct.unpack("<3f", hdr[268:280])
        ndim = dim[0]
        shape_xyz = list(dim[1:1 + ndim])
        dtype = _NIFTI_DTYPES[datatype]
        f.seek(vox_offset)
        count = int(np.prod(shape_xyz))
        raw = f.read(count * np.dtype(dtype).itemsize)
    arr = np.frombuffer(raw, dtype=dtype, count=count)
    arr = arr.reshape(shape_xyz[::-1])
    if scl_slope not in (0.0, 1.0):
        arr = arr * scl_slope + scl_inter
    spacing_xyz = list(pixdim[1:1 + ndim])
    return MedImage(
        arr, tuple(spacing_xyz[::-1]),
        tuple(list(qoffset)[::-1][-arr.ndim:]), {"format": "nifti"})


def _write_nifti(path: str, med: MedImage) -> None:
    arr = np.ascontiguousarray(med.img)
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [arr.ndim] + list(arr.shape[::-1]) + [1] * (7 - arr.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, _NIFTI_CODES[arr.dtype])
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)
    pixdims = [1.0] + list(med.spacing[::-1]) + [1.0] * (7 - arr.ndim)
    struct.pack_into("<8f", hdr, 76, *pixdims)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    # qform/sform disabled (codes 0); spacing carries geometry
    hdr[344:348] = b"n+1\x00"
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(arr.tobytes())


# ---------------------------------------------------------------------------
# public API (reference sitk_io surface)


def read_med_img(path: str) -> MedImage:
    """Read any supported medical format into a ``MedImage``."""
    low = path.lower()
    if low.endswith((".mhd", ".mha")):
        return _read_mhd(path)
    if low.endswith(".nrrd"):
        return _read_nrrd(path)
    if low.endswith((".nii", ".nii.gz")):
        return _read_nifti(path)
    raise ValueError(f"unsupported medical image format: {path}")


def write_med_img(path: str, med: MedImage) -> None:
    """Write a ``MedImage`` in the format implied by the extension."""
    low = path.lower()
    if low.endswith((".mhd", ".mha")):
        _write_mhd(path, med)
    elif low.endswith(".nrrd"):
        _write_nrrd(path, med)
    elif low.endswith((".nii", ".nii.gz")):
        _write_nifti(path, med)
    else:
        raise ValueError(f"unsupported medical image format: {path}")


def read_sitk_files(
        path: str, reg_names=None) -> "np_io.Image5d":
    """A medical image (or the first of its registered images named by
    ``reg_names``) as an ``np_io.Image5d`` with its spacing as the
    resolutions."""
    from magellanmapper_torch.io import np_io
    paths = [path]
    if reg_names:
        names = reg_names if isinstance(
            reg_names, (list, tuple)) else [reg_names]
        paths = [reg_out_path(path, name) for name in names]
    med = read_med_img(find_sitk_file(paths[0]))
    return np_io.Image5d(
        img=med.img[None], path_img=paths[0], img_io="sitk",
        meta={"resolutions": [list(med.spacing)],
              "origin": list(med.origin)})


def find_sitk_file(path: str) -> str:
    """Resolve ``path`` against the supported 3D extensions."""
    if os.path.exists(path):
        return path
    base = os.path.splitext(path)[0]
    for ext in EXTS_3D:
        cand = base + ext
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(path)


def reg_out_path(
        file_path: str, reg_name: str, match_ext: bool = False) -> str:
    """Path of a registered image: ``<base>_<reg_name>``
    (reference ``sitk_io.reg_out_path :33``)."""
    base = os.path.splitext(file_path)[0]
    if base.endswith(".nii"):  # handle .nii.gz double extension
        base = base[:-4]
    if match_ext:
        ext = file_path[len(os.path.splitext(file_path)[0]):]
        return f"{base}_{reg_name}{ext}"
    return f"{base}_{reg_name}"


def load_registered_img(
        img_path: str, reg_name: str) -> np.ndarray:
    """Load an image registered to ``img_path`` by suffix
    (reference ``sitk_io.load_registered_img :438``)."""
    path = reg_out_path(img_path, reg_name)
    return read_med_img(find_sitk_file(path)).img


def write_reg_images(
        imgs: Dict[str, MedImage], prefix: str,
        ext: str = ".mhd") -> Dict[str, str]:
    """Write a set of registered images keyed by reg suffix
    (reference ``sitk_io.write_reg_images :615``)."""
    out = {}
    for reg_name, med in imgs.items():
        name = reg_name if reg_name.endswith(
            tuple(EXTS_3D)) else reg_name + ext
        path = reg_out_path(prefix, name)
        write_med_img(path, med)
        out[reg_name] = path
    return out


def match_world_info(
        source: MedImage, target: MedImage) -> MedImage:
    """``target`` with ``source``'s spacing and origin."""
    target.spacing = source.spacing
    target.origin = source.origin
    return target


def read_img(path: str) -> MedImage:
    """Read a medical-format image."""
    return read_med_img(path)


def read_sitk(path: str) -> MedImage:
    """Read a medical-format image, resolving its extension."""
    return read_med_img(find_sitk_file(path))


def write_img(path: str, img, spacing=(1.0, 1.0, 1.0)) -> str:
    """Write an array (with ``spacing``) or a ``MedImage``."""
    med = img if isinstance(img, MedImage) else MedImage(
        np.asarray(img), tuple(spacing))
    write_med_img(path, med)
    return path


def convert_img(img) -> np.ndarray:
    """An image's array (a ``MedImage`` already wraps numpy)."""
    return np.asarray(img.img if isinstance(img, MedImage) else img)


def replace_sitk_with_numpy(img, arr: np.ndarray) -> MedImage:
    """A ``MedImage`` of ``arr`` with ``img``'s spacing and origin."""
    spacing = img.spacing if isinstance(img, MedImage) else (1.0,) * 3
    origin = getattr(img, "origin", None)
    med = MedImage(np.asarray(arr), spacing)
    if origin is not None:
        med.origin = origin
    return med


def load_numpy_to_sitk(path: str, rotate: bool = False) -> MedImage:
    """A ``.npy`` volume (its first time point) as a ``MedImage``,
    turned by 180 degrees in y/x with ``rotate``."""
    arr = np.load(path, mmap_mode="r")
    if arr.ndim >= 4:
        arr = arr[0]
    if rotate:
        arr = np.rot90(arr, 2, (1, 2))
    return MedImage(np.asarray(arr), (1.0, 1.0, 1.0))


def load_registered_imgs(img_path: str, reg_names,
                         **kwargs) -> Dict[str, np.ndarray]:
    """Several registered images keyed by suffix; missing ones are left
    out."""
    out = {}
    for name in reg_names:
        key = name.value if hasattr(name, "value") else name
        try:
            out[key] = load_registered_img(img_path, key, **kwargs)
        except (FileNotFoundError, ValueError):
            continue
    return out


def write_registered_image(
        arr: np.ndarray, img_path: str, reg_name: str,
        spacing=(1.0, 1.0, 1.0), load_reg_names=None,
        overwrite: bool = False) -> str:
    """Write one registered image beside ``img_path``; an existing file
    raises unless ``overwrite``."""
    out_path = reg_out_path(img_path, reg_name)
    if os.path.exists(out_path) and not overwrite:
        raise FileExistsError(f"{out_path} exists; pass overwrite=True")
    write_med_img(out_path, MedImage(np.asarray(arr), tuple(spacing)))
    return out_path


def find_atlas_labels(labels_ref_path: str, drawn_only: bool,
                      labels_ref=None) -> list:
    """The IDs of a labels reference, only those without children when
    ``drawn_only``."""
    from magellanmapper_torch.atlas import ontology
    ref = labels_ref
    if ref is None:
        ref = ontology.LabelsRef(labels_ref_path).load()
    ids = list(ref.ref_lookup.keys())
    if drawn_only:
        df = ref.get_ref_lookup_as_df()
        parents = {p[-1] for p in df["ParentIDs"] if p}
        ids = [i for i in ids if i not in parents]
    return ids


def merge_images(img_paths, reg_name, prefix=None, suffix=None,
                 fn_combine=np.sum) -> Optional[MedImage]:
    """The samples' registered images ``reg_name`` combined voxel by voxel
    by ``fn_combine`` over a stack (the stack itself when None); missing
    samples are skipped, None when none is found."""
    imgs = []
    for path in img_paths:
        try:
            imgs.append(load_registered_img(path, reg_name))
        except (FileNotFoundError, ValueError):
            continue
    if not imgs:
        return None
    stack = np.stack(imgs)
    merged = fn_combine(stack, axis=0) if fn_combine is not None else stack
    return MedImage(merged, (1.0, 1.0, 1.0))


def write_pts(path: str, pts, fmt: str = "point") -> str:
    """Write an Elastix-format points file."""
    with open(path, "w") as f:
        f.write(f"{fmt}\n{len(pts)}\n")
        for pt in pts:
            f.write(" ".join(str(float(v)) for v in pt) + "\n")
    return path


def sitk_to_itk_img(img):
    """Identity: the reference converts between SimpleITK and ITK
    wrappers; a ``MedImage`` is one numpy-backed type."""
    return img


def itk_to_sitk_img(img):
    """Identity (see :func:`sitk_to_itk_img`)."""
    return img
