"""Pure-Python Nikon ND2 reader (modern chunk-map container).

Copy of ``magellanmapper_tpu/io/nd2.py``: the same arrays, metadata and
errors from the same files. The upstream MagellanMapper imports ND2
through Bioformats on a JVM (``magmap/io/importer.py:97-156,1127``);
the modern ND2 container (NIS-Elements 2012+,
the "chunk map" layout also parsed by the open ``nd2`` package's
pure-Python fallback) is directly readable:

 - the file is a sequence of chunks, each headed by
   ``<magic:u32=0x0ABECEDA> <name_len:u32> <data_len:u64>`` followed by
   ``name_len`` name bytes and ``data_len`` data bytes;
 - the last 40 bytes of the file are the 32-byte chunk-map signature
   ``ND2 CHUNK MAP SIGNATURE 0000001!`` plus the u64 offset of the
   chunk-map chunk, whose data lists ``name…! <offset:u64> <size:u64>``
   entries (terminated by the signature's own entry);
 - metadata chunks (``ImageAttributesLV!`` here) hold a "lite variant"
   tree: items of ``<type:u8> <name_len:u8> <utf-16 name>`` where type
   11 is a nested level (``<count:u32> <byte_len:u64>`` + items + a
   trailing u64-per-item offset index) and scalar types are
   bool/i32/u32/i64/u64/f64/utf-16 string/bytearray;
 - pixel chunks ``ImageDataSeq|N!`` carry an 8-byte timestamp then the
   plane's rows at the ``uiWidthBytes`` stride, components interleaved
   per pixel.

Scope (documented in the importer format matrix): uncompressed planes
only in the chunk-map container — ``eCompression`` 0/1
(lossless/lossy) raises with guidance; frame sequences map to Z
(single timepoint), matching the lightsheet stacks this framework
targets. Legacy (pre-chunk-map) files are JP2 containers and are read
by :func:`_read_nd2_legacy` through the system libopenjp2
(``io.jp2k``); Nikon's proprietary metadata boxes are undocumented
and skipped.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np

CHUNK_MAGIC = 0x0ABECEDA
CHUNK_HEADER = struct.Struct("<IIQ")
CHUNKMAP_SIGNATURE = b"ND2 CHUNK MAP SIGNATURE 0000001!"
#: legacy (pre-chunk-map) ND2 files are JP2 containers
JP2_SIGNATURE = (b"\x00\x00\x00\x0cjP  \r\n\x87\n")

#: lite-variant type tags (ELxLiteVariantType)
_T_BOOL, _T_I32, _T_U32, _T_I64, _T_U64, _T_F64 = 1, 2, 3, 4, 5, 6
_T_PTR, _T_STR, _T_BYTES, _T_LEVEL = 7, 8, 9, 11


def _parse_lite_variant_item(data: bytes, pos: int):
    """Parse one lite-variant item; returns ``(name, value, next_pos)``."""
    dtype, name_len = struct.unpack_from("<BB", data, pos)
    pos += 2
    name = data[pos:pos + name_len * 2].decode(
        "utf-16-le").rstrip("\x00")
    pos += name_len * 2
    if dtype == _T_BOOL:
        return name, bool(data[pos]), pos + 1
    if dtype == _T_I32:
        return name, struct.unpack_from("<i", data, pos)[0], pos + 4
    if dtype == _T_U32:
        return name, struct.unpack_from("<I", data, pos)[0], pos + 4
    if dtype == _T_I64:
        return name, struct.unpack_from("<q", data, pos)[0], pos + 8
    if dtype in (_T_U64, _T_PTR):
        return name, struct.unpack_from("<Q", data, pos)[0], pos + 8
    if dtype == _T_F64:
        return name, struct.unpack_from("<d", data, pos)[0], pos + 8
    if dtype == _T_STR:
        end = pos
        while end < len(data) and data[end:end + 2] != b"\x00\x00":
            end += 2
        return (name, data[pos:end].decode("utf-16-le"), end + 2)
    if dtype == _T_BYTES:
        n = struct.unpack_from("<Q", data, pos)[0]
        pos += 8
        return name, data[pos:pos + n], pos + n
    if dtype == _T_LEVEL:
        count, _byte_len = struct.unpack_from("<IQ", data, pos)
        pos += 12
        level = {}
        for _ in range(count):
            k, v, pos = _parse_lite_variant_item(data, pos)
            level[k] = v
        # trailing per-item u64 offset index
        return name, level, pos + count * 8
    raise ValueError(f"unknown lite-variant type {dtype} at {pos}")


def parse_lite_variant(data: bytes) -> Dict:
    """Parse a metadata chunk's lite-variant payload into a dict."""
    out = {}
    pos = 0
    while pos < len(data) - 2:
        name, value, pos = _parse_lite_variant_item(data, pos)
        out[name] = value
    return out


def _find_key(tree, key: str):
    """Depth-first search for ``key`` in nested dicts."""
    if isinstance(tree, dict):
        if key in tree:
            return tree[key]
        for v in tree.values():
            found = _find_key(v, key)
            if found is not None:
                return found
    return None


def read_chunkmap(path: str) -> Dict[bytes, Tuple[int, int]]:
    """Chunk name -> (offset, data size) from the end-of-file map."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if size < 40 + CHUNK_HEADER.size:
            raise ValueError(f"not an ND2 chunk-map file: {path}")
        f.seek(size - 40)
        tail = f.read(40)
        if tail[:32] != CHUNKMAP_SIGNATURE:
            raise NotImplementedError(
                "legacy (pre-chunk-map) ND2 files need the Bioformats/"
                "JVM path; re-export from NIS-Elements >= 4.x or "
                "convert to TIFF")
        map_offset = struct.unpack("<Q", tail[32:])[0]
        f.seek(map_offset)
        magic, name_len, data_len = CHUNK_HEADER.unpack(
            f.read(CHUNK_HEADER.size))
        if magic != CHUNK_MAGIC:
            raise ValueError("corrupt ND2 chunk map header")
        f.seek(name_len, 1)
        data = f.read(data_len)
    entries: Dict[bytes, Tuple[int, int]] = {}
    pos = 0
    while pos < len(data):
        bang = data.find(b"!", pos)
        if bang < 0:
            break
        name = data[pos:bang + 1]
        if name == CHUNKMAP_SIGNATURE:
            break
        offset, csize = struct.unpack_from("<QQ", data, bang + 1)
        entries[name] = (offset, csize)
        pos = bang + 1 + 16
    return entries


def _read_chunk(f, offset: int, expected_name: bytes) -> bytes:
    f.seek(offset)
    magic, name_len, data_len = CHUNK_HEADER.unpack(
        f.read(CHUNK_HEADER.size))
    if magic != CHUNK_MAGIC:
        raise ValueError(
            f"bad chunk magic at {offset} (wanted {expected_name!r})")
    name = f.read(name_len)
    if not name.startswith(expected_name):
        raise ValueError(
            f"chunk at {offset} is {name!r}, wanted {expected_name!r}")
    return f.read(data_len)


def read_nd2(path: str) -> Tuple[np.ndarray, Dict]:
    """Read an ND2 file into ``(array, meta)``.

    Output axes: ``(Z, Y, X)`` single-channel, ``(C, Z, Y, X)`` for
    interleaved multi-component pixels; frame sequences map to Z.
    ``meta`` carries the raw attribute dict plus ``resolutions`` when a
    calibration (um/px) is present.

    Legacy (pre-chunk-map) ND2 files are JP2 containers and dispatch
    to :func:`_read_nd2_legacy` (frames decoded from ``jp2c``
    codestream boxes via the system libopenjp2).
    """
    with open(path, "rb") as f:
        head = f.read(12)
    if head == JP2_SIGNATURE:
        return _read_nd2_legacy(path)
    entries = read_chunkmap(path)
    with open(path, "rb") as f:
        attrs_entry = entries.get(b"ImageAttributesLV!")
        if attrs_entry is None:
            raise ValueError(f"no ImageAttributesLV chunk in {path}")
        tree = parse_lite_variant(_read_chunk(
            f, attrs_entry[0], b"ImageAttributesLV"))

        def attr(key, default=None):
            v = _find_key(tree, key)
            return default if v is None else v

        width = int(attr("uiWidth", 0))
        height = int(attr("uiHeight", 0))
        comp = int(attr("uiComp", 1))
        bpc = int(attr("uiBpcInMemory", 16))
        stride = int(attr("uiWidthBytes", width * comp * (bpc // 8)))
        n_seq = int(attr("uiSequenceCount", 0))
        compression = attr("eCompression")
        if compression is not None and int(compression) in (0, 1):
            raise NotImplementedError(
                "compressed ND2 planes (eCompression="
                f"{int(compression)}) need the Bioformats/JVM path; "
                "re-export uncompressed or convert to TIFF")
        if width <= 0 or height <= 0:
            raise ValueError(f"bad ND2 geometry {width}x{height}")
        if bpc == 8:
            dt = np.uint8
        elif bpc == 16:
            dt = np.uint16
        elif bpc == 32:
            dt = np.float32   # ND2 32-bit components are float
        else:
            raise NotImplementedError(f"unsupported ND2 bpc {bpc}")
        itemsize = np.dtype(dt).itemsize

        seq_names = sorted(
            (int(n.split(b"|")[1].rstrip(b"!")), n)
            for n in entries if n.startswith(b"ImageDataSeq|"))
        if not seq_names:
            raise ValueError(
                f"no ImageDataSeq chunks in {path} (metadata-only or "
                "truncated file)")
        if n_seq and len(seq_names) != n_seq:
            # trust the chunk map; attributes can lag aborted runs
            n_seq = len(seq_names)
        planes = np.empty((len(seq_names), height, width, comp), dt)
        row_bytes = width * comp * itemsize
        for zi, (_idx, name) in enumerate(seq_names):
            data = _read_chunk(f, entries[name][0], name[:-1])
            pix = data[8:]   # skip the 8-byte acquisition timestamp
            if stride == row_bytes:
                rows = np.frombuffer(
                    pix[:height * row_bytes], dt)
            else:
                rows = np.concatenate([
                    np.frombuffer(
                        pix[r * stride:r * stride + row_bytes], dt)
                    for r in range(height)])
            planes[zi] = rows.reshape(height, width, comp)

    arr = np.moveaxis(planes, -1, 0)   # (C, Z, Y, X)
    if comp == 1:
        arr = arr[0]
    meta: Dict = {"attributes": tree, "sequence_count": len(seq_names),
                  "components": comp}
    # calibration chunk -> isotropic XY um/px (z spacing lives in the
    # experiment loop metadata; callers override via --res)
    cal_entry = next(
        (entries[n] for n in entries
         if n.startswith(b"ImageCalibration")), None)
    if cal_entry is not None:
        with open(path, "rb") as f:
            cal = parse_lite_variant(_read_chunk(
                f, cal_entry[0], b"ImageCalibration"))
        um = _find_key(cal, "dCalibration")
        if um:
            meta["resolutions"] = (float(um), float(um), float(um))
    return arr, meta


# -- legacy (pre-chunk-map) ND2: a JP2 container ----------------------------

def _jp2_boxes(data: bytes, start: int, end: int):
    """Yield ``(type, payload_start, payload_end)`` for each ISO
    box in ``data[start:end]`` (ISO 15444-1 I.4: u32-BE length +
    4CC type, length 1 -> u64 XLBox, length 0 -> to end)."""
    pos = start
    while pos + 8 <= end:
        ln, = struct.unpack_from(">I", data, pos)
        btype = data[pos + 4:pos + 8]
        hdr = 8
        if ln == 1:
            if pos + 16 > end:
                raise ValueError("truncated JP2 XLBox header")
            ln, = struct.unpack_from(">Q", data, pos + 8)
            hdr = 16
        elif ln == 0:
            ln = end - pos
        if ln < hdr or pos + ln > end:
            raise ValueError("corrupt JP2 box structure")
        yield btype, pos + hdr, pos + ln
        pos += ln


def _jp2_capture_res_um(data: bytes, lo: int, hi: int):
    """``resc`` capture-resolution box -> (y_um, x_um) per pixel.
    Fields (ISO 15444-1 I.5.3.7.1): VRcN VRcD HRcN HRcD u16-BE then
    VRcE HRcE i8 exponents; values are grid points per meter."""
    if hi - lo < 10:
        return None
    vn, vd, hn, hd = struct.unpack_from(">HHHH", data, lo)
    ve, he = struct.unpack_from(">bb", data, lo + 8)
    if not (vn and vd and hn and hd):
        return None
    v_ppm = vn / vd * 10.0 ** ve
    h_ppm = hn / hd * 10.0 ** he
    return 1e6 / v_ppm, 1e6 / h_ppm


def _read_nd2_legacy(path: str) -> Tuple[np.ndarray, Dict]:
    """Read a legacy ND2 (JP2 container; NIS-Elements pre-2012).

    Frames live in ``jp2c`` codestream boxes in acquisition order and
    decode through the system libopenjp2 (``io.jp2k``); geometry comes
    from the codestreams, calibration from the standard JP2 capture-
    resolution box when present. Nikon's proprietary metadata boxes
    are undocumented and skipped. Reference path: Bioformats
    LegacyND2Reader on a JVM (``magmap/io/importer.py:97-156``)."""
    from magellanmapper_torch.io import jp2k
    if not jp2k.available():
        raise NotImplementedError(
            "legacy ND2 frames are JPEG 2000 codestreams; no "
            "libopenjp2 available to decode them (or use the "
            "Bioformats/JVM path)")
    with open(path, "rb") as f:
        data = f.read()
    frames = []
    res_um = None
    for btype, lo, hi in _jp2_boxes(data, 0, len(data)):
        if btype == b"jp2c":
            frames.append((lo, hi))
        elif btype == b"jp2h":
            for sub, slo, shi in _jp2_boxes(data, lo, hi):
                if sub == b"res ":
                    for rsub, rlo, rhi in _jp2_boxes(data, slo, shi):
                        if rsub == b"resc" and res_um is None:
                            res_um = _jp2_capture_res_um(
                                data, rlo, rhi)
    if not frames:
        raise ValueError(f"no jp2c codestream boxes in {path}")
    planes = [jp2k.decode(data[lo:hi]) for lo, hi in frames]
    shapes = {p.shape for p in planes}
    if len(shapes) != 1:
        raise ValueError(
            f"inconsistent legacy ND2 frame shapes: {sorted(shapes)}")
    arr = np.stack(planes)                       # (Z, Y, X[, C])
    comp = 1 if arr.ndim == 3 else arr.shape[-1]
    if arr.ndim == 4:
        arr = np.moveaxis(arr, -1, 0)            # (C, Z, Y, X)
        if comp == 1:
            arr = arr[0]
    meta: Dict = {"attributes": {}, "sequence_count": len(frames),
                  "components": comp, "legacy": True}
    if res_um is not None:
        y_um, x_um = res_um
        meta["resolutions"] = (float(y_um), float(y_um), float(x_um))
    return arr, meta
