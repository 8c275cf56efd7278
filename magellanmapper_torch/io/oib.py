"""Pure-Python Olympus OIB/OIF readers.

Copy of ``magellanmapper_tpu/io/oib.py``: the same arrays, metadata and
errors from the same files. The upstream MagellanMapper imports Olympus
FluoView stacks through Bioformats on a JVM
(``magmap/io/importer.py:97-156``); both containers are directly
readable:

 - **OIB** is a Microsoft Compound File Binary (CFBF/OLE2) archive —
   512-byte header with the ``D0 CF 11 E0 A1 B1 1A E1`` magic, a FAT of
   u32 sector chains, a mini-FAT for streams under the 4096-byte
   cutoff (carried inside the root entry's mini stream), and 128-byte
   directory entries — whose streams are one single-plane TIFF per
   acquired frame (``Storage00001/s_C001Z001.tif``-style names) plus a
   UTF-16 ``OibInfo.txt`` manifest;
 - **OIF** is the unpacked form: a UTF-16 INI main file next to a
   ``<name>.oif.files/`` directory holding the same per-plane TIFFs.

Plane filenames encode the grid position (``s_C%03dZ%03d[T%03d].tif``);
planes assemble into ``(Z, Y, X)`` / ``(C, Z, Y, X)`` with the port's
TIFF decoder (:mod:`.tiff`). Multi-timepoint series map T to the slowest axis of Z
(single-volume semantics, like the ND2 reader); 4 GB+ v4 compound files
(4096-byte sectors) are parsed by the same code via the header's sector
shift.
"""

from __future__ import annotations

import os
import re
import struct
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

OLE_MAGIC = b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1"
_ENDOFCHAIN = 0xFFFFFFFE
_FREESECT = 0xFFFFFFFF
_MAXREG = 0xFFFFFFFA


class CompoundFile:
    """Minimal CFBF (OLE2) reader: directory listing + stream bytes."""

    def __init__(self, path: str):
        import mmap
        # memory-map: multi-GB OIB archives should not cost file-size
        # bytes of RAM on top of the decoded planes
        with open(path, "rb") as f:
            self._data = mmap.mmap(
                f.fileno(), 0, access=mmap.ACCESS_READ)
        d = self._data
        if d[:8] != OLE_MAGIC:
            raise ValueError(f"not an OLE compound file: {path}")
        self.sector_size = 1 << struct.unpack_from("<H", d, 30)[0]
        self.mini_size = 1 << struct.unpack_from("<H", d, 32)[0]
        self.n_fat = struct.unpack_from("<I", d, 44)[0]
        self.first_dir = struct.unpack_from("<I", d, 48)[0]
        self.mini_cutoff = struct.unpack_from("<I", d, 56)[0]
        self.first_minifat = struct.unpack_from("<I", d, 60)[0]
        self.n_minifat = struct.unpack_from("<I", d, 64)[0]
        first_difat = struct.unpack_from("<I", d, 68)[0]
        n_difat = struct.unpack_from("<I", d, 72)[0]

        difat = list(struct.unpack_from("<109I", d, 76))
        sect = first_difat
        for _ in range(n_difat):
            if sect > _MAXREG:
                break
            raw = self._sector(sect)
            vals = struct.unpack("<%dI" % (self.sector_size // 4), raw)
            difat.extend(vals[:-1])
            sect = vals[-1]
        fat_bytes = b"".join(
            self._sector(s) for s in difat[:self.n_fat] if s <= _MAXREG)
        self.fat = struct.unpack("<%dI" % (len(fat_bytes) // 4), fat_bytes)

        dir_bytes = self._read_chain(self.first_dir)
        self.entries: List[Dict] = []
        for off in range(0, len(dir_bytes), 128):
            e = dir_bytes[off:off + 128]
            if len(e) < 128:
                break
            name_len = struct.unpack_from("<H", e, 64)[0]
            obj_type = e[66]
            if obj_type == 0 or name_len == 0:
                continue
            name = e[:max(0, name_len - 2)].decode("utf-16-le")
            self.entries.append({
                "name": name, "type": obj_type,
                "start": struct.unpack_from("<I", e, 116)[0],
                "size": struct.unpack_from("<Q", e, 120)[0]})

        root = next(e for e in self.entries if e["type"] == 5)
        self._mini_container = self._read_chain(
            root["start"])[:root["size"]]
        minifat_bytes = (self._read_chain(self.first_minifat)
                         if self.first_minifat <= _MAXREG else b"")
        self.minifat = struct.unpack(
            "<%dI" % (len(minifat_bytes) // 4), minifat_bytes)

    def _sector(self, idx: int) -> bytes:
        # MS-CFB: sector N begins at (N + 1) * sector_size — the header
        # occupies 512 bytes but v4 files (4096-byte sectors) pad it to
        # a full sector, so "512 + N * size" would land 3584 bytes early
        off = (idx + 1) * self.sector_size
        return self._data[off:off + self.sector_size]

    def _read_chain(self, start: int) -> bytes:
        out, sect, guard = [], start, 0
        while sect <= _MAXREG:
            out.append(self._sector(sect))
            sect = self.fat[sect]
            guard += 1
            if guard > len(self.fat) + 1:
                raise ValueError("cyclic FAT chain")
        return b"".join(out)

    def _read_mini_chain(self, start: int) -> bytes:
        out, sect, guard = [], start, 0
        while sect <= _MAXREG:
            off = sect * self.mini_size
            out.append(self._mini_container[off:off + self.mini_size])
            sect = self.minifat[sect]
            guard += 1
            if guard > max(len(self.minifat), 1) + 1:
                raise ValueError("cyclic mini-FAT chain")
        return b"".join(out)

    def list_streams(self) -> List[str]:
        return [e["name"] for e in self.entries if e["type"] == 2]

    def read_stream(self, name: str) -> bytes:
        e = next((x for x in self.entries
                  if x["type"] == 2 and x["name"] == name), None)
        if e is None:
            raise KeyError(name)
        if e["size"] < self.mini_cutoff:
            return self._read_mini_chain(e["start"])[:e["size"]]
        return self._read_chain(e["start"])[:e["size"]]


#: plane-name grid position: s_C001Z001.tif / ...T001.tif variants
_PLANE_RE = re.compile(
    r"s_?C(?P<c>\d+)(?:Z(?P<z>\d+))?(?:T(?P<t>\d+))?\.tif+$",
    re.IGNORECASE)


def _assemble_planes(
        planes: List[Tuple[int, int, int, np.ndarray]]) -> np.ndarray:
    """(c, t, z, plane) rows -> (C, Z, Y, X) with T folded into Z."""
    cs = sorted({p[0] for p in planes})
    ts = sorted({p[1] for p in planes})
    zs = sorted({p[2] for p in planes})
    h, w = planes[0][3].shape
    out = np.zeros((len(cs), len(ts) * len(zs), h, w),
                   planes[0][3].dtype)
    for c, t, z, img in planes:
        out[cs.index(c), ts.index(t) * len(zs) + zs.index(z)] = img
    return out


def _decode_tiff_bytes(data: bytes) -> np.ndarray:
    from magellanmapper_torch.io import tiff
    with tempfile.NamedTemporaryFile(suffix=".tif", delete=False) as f:
        f.write(data)
        tmp = f.name
    try:
        arr = tiff.read_tiff(tmp)
    finally:
        os.unlink(tmp)
    return arr if arr.ndim == 2 else arr[0]


def read_oib(path: str) -> Tuple[np.ndarray, Dict]:
    """Read an OIB archive into ``(array, meta)``.

    Output axes ``(Z, Y, X)`` single-channel, else ``(C, Z, Y, X)``.
    FluoView names the actual streams ``Stream00001``-style and maps
    them to ``s_C###Z###.tif`` plane filenames in the ``OibInfo.txt``
    manifest ([OibSaveInfo] section); streams that are themselves named
    like planes are also accepted.
    """
    cf = CompoundFile(path)
    info_name = next((n for n in cf.list_streams()
                      if n.lower().endswith("oibinfo.txt")), None)
    info_text = (cf.read_stream(info_name).decode(
        "utf-16", errors="replace") if info_name else "")
    #: stream name -> plane filename from the manifest
    manifest = {}
    for line in info_text.splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            if _PLANE_RE.search(v.strip()):
                manifest[k.strip()] = v.strip()
    planes = []
    for name in cf.list_streams():
        mapped = manifest.get(name, name)
        m = _PLANE_RE.search(mapped)
        if not m:
            continue
        img = _decode_tiff_bytes(cf.read_stream(name))
        planes.append((int(m.group("c")),
                       int(m.group("t") or 1),
                       int(m.group("z") or 1), img))
    if not planes:
        raise ValueError(f"no plane TIFF streams in {path}")
    arr = _assemble_planes(planes)
    meta: Dict = {"components": arr.shape[0],
                  "streams": len(planes)}
    if info_text:
        meta["info"] = info_text
    # the archive embeds its OIF main-settings stream; parse it for
    # voxel calibration like the unpacked form does
    oif_stream = next(
        (n for n in cf.list_streams()
         if n.lower().endswith(".oif")), None)
    if oif_stream is not None:
        ini = _parse_oif_ini(cf.read_stream(oif_stream).decode(
            "utf-16", errors="replace"))
        meta["ini"] = ini
        res = _ini_resolutions(ini)
        if res is not None:
            meta["resolutions"] = res
    if arr.shape[0] == 1:
        arr = arr[0]
    return arr, meta


def _ini_resolutions(
        ini: Dict[str, Dict[str, str]]) -> Optional[Tuple[float, ...]]:
    """(z, y, x) um/px from FluoView settings: [Reference Image
    Parameter] WidthConvertValue gives XY; the Z axis section's
    Interval gives the step."""
    ref = ini.get("Reference Image Parameter", {})
    try:
        xy = float(ref.get("WidthConvertValue"))
    except (TypeError, ValueError):
        return None
    z_step = None
    for sec, kv in ini.items():
        if sec.startswith("Axis") and kv.get("AxisCode") == "Z":
            try:
                z_step = abs(float(kv.get("Interval", 0))) or None
            except (TypeError, ValueError):
                pass
    return (z_step or xy, xy, xy)


def _parse_oif_ini(text: str) -> Dict[str, Dict[str, str]]:
    out: Dict[str, Dict[str, str]] = {}
    section = ""
    for line in text.splitlines():
        line = line.strip().lstrip("﻿")
        if not line or line.startswith(";"):
            continue
        if line.startswith("[") and line.endswith("]"):
            section = line[1:-1]
            out.setdefault(section, {})
        elif "=" in line:
            k, v = line.split("=", 1)
            out.setdefault(section, {})[k.strip()] = \
                v.strip().strip('"')
    return out


def read_oif(path: str) -> Tuple[np.ndarray, Dict]:
    """Read an OIF main file + its ``.files`` directory."""
    raw = open(path, "rb").read()
    text = raw.decode("utf-16" if raw[:2] in (b"\xff\xfe", b"\xfe\xff")
                      else "utf-8", errors="replace")
    ini = _parse_oif_ini(text)
    files_dir = path + ".files"
    if not os.path.isdir(files_dir):
        base = os.path.splitext(path)[0]
        if os.path.isdir(base + ".oif.files"):
            files_dir = base + ".oif.files"
        else:
            raise FileNotFoundError(
                f"OIF plane directory not found: {files_dir}")
    planes = []
    for fn in sorted(os.listdir(files_dir)):
        m = _PLANE_RE.search(fn)
        if not m:
            continue
        img = _decode_tiff_bytes(
            open(os.path.join(files_dir, fn), "rb").read())
        planes.append((int(m.group("c")),
                       int(m.group("t") or 1),
                       int(m.group("z") or 1), img))
    if not planes:
        raise ValueError(f"no plane TIFFs in {files_dir}")
    arr = _assemble_planes(planes)
    meta: Dict = {"components": arr.shape[0], "ini": ini}
    res = _ini_resolutions(ini)
    if res is not None:
        meta["resolutions"] = res
    if arr.shape[0] == 1:
        arr = arr[0]
    return arr, meta
