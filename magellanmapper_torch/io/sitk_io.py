"""Medical-format I/O (MHD/MHA, NRRD, NIfTI) in numpy, no ITK.

Copy of what the registration task reads and writes from
``magellanmapper_tpu/io/sitk_io.py``: ``MedImage``, ``read_med_img``,
``write_med_img``, ``find_sitk_file``, ``reg_out_path``,
``load_registered_img`` and ``write_reg_images``, with the reference's
parsers and writers, so the files written are byte for byte the
reference's. World info (spacing/origin) travels with a small
``MedImage`` record.
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Tuple

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
