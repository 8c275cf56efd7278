"""Minimal TIFF reader/writer: baseline + BigTIFF read.

Copy of ``magellanmapper_tpu/io/tiff.py``: grayscale multi-page stacks,
8/16/32-bit integer and float32 sample formats, uncompressed or
deflate/LZW/PackBits compressed strips (with the horizontal-differencing
predictor), strip organization, little/big endian, ImageJ-style
multi-page writing with optional compression, and :class:`LazyTiffStack`.
The same arrays write the same bytes as the reference, and the same
files read to the same arrays. LZW and PackBits strips decode through
the native decoders of :mod:`magellanmapper_torch.io._tiffcodec` (built
with ``g++`` at first use; a failed build raises); the Python decoders
here are their plain versions.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from magellanmapper_torch.io import _tiffcodec

_TAG_WIDTH = 256
_TAG_HEIGHT = 257
_TAG_BITS = 258
_TAG_COMPRESSION = 259
_TAG_PHOTOMETRIC = 262
_TAG_DESCRIPTION = 270
_TAG_STRIP_OFFSETS = 273
_TAG_SPP = 277
_TAG_ROWS_PER_STRIP = 278
_TAG_STRIP_COUNTS = 279
_TAG_PREDICTOR = 317
_TAG_SAMPLE_FORMAT = 339

#: TIFF compression ids
COMP_NONE = 1
COMP_LZW = 5
COMP_DEFLATE_ADOBE = 8
COMP_PACKBITS = 32773
COMP_DEFLATE = 32946


# ---------------------------------------------------------------------------
# strip codecs (TIFF 6.0 section 7/9 + Adobe deflate note)


def packbits_decode(data: bytes) -> bytes:
    """Apple PackBits RLE decode (TIFF 6.0 section 9)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        ctl = data[i]
        i += 1
        if ctl < 128:          # literal run of ctl+1 bytes
            out += data[i:i + ctl + 1]
            i += ctl + 1
        elif ctl > 128:        # repeat next byte 257-ctl times
            out += data[i:i + 1] * (257 - ctl)
            i += 1
        # ctl == 128: no-op
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits RLE encode (runs >= 3 become repeats)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out.append(257 - run)
            out.append(data[i])
            i += run
            continue
        # literal: scan until a >=3 repeat starts (or 128 cap)
        j = i + 1
        while j < n and j - i < 128:
            if j + 2 < n and data[j] == data[j + 1] == data[j + 2]:
                break
            j += 1
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


def lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW decode: MSB-first bit packing, ClearCode 256,
    EOI 257, code width grows at table sizes 511/1023/2047 ("early
    change", TIFF 6.0 section 13). The plain version of the native
    decoder; the same bytes as the reference's, in time linear in the
    stream."""
    out = bytearray()
    table: List[bytes] = []

    def reset():
        nonlocal table, width
        table = [bytes([i]) for i in range(256)] + [b"", b""]
        width = 9

    width = 9
    reset()
    buf = 0
    nbits = 0
    prev: Optional[bytes] = None
    for byte in data:
        buf = (buf << 8) | byte
        nbits += 8
        while nbits >= width:
            code = (buf >> (nbits - width)) & ((1 << width) - 1)
            nbits -= width
            # keep only the unread bits: the reference's buffer grows
            # with the stream, which makes its decode quadratic
            buf &= (1 << nbits) - 1
            if code == 256:      # clear
                reset()
                prev = None
                continue
            if code == 257:      # end of information
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError("corrupt LZW stream")
            out += entry
            prev = entry
            if len(table) in (511, 1023, 2047):
                width += 1
    return bytes(out)


def lzw_encode(data: bytes) -> bytes:
    """TIFF-variant LZW encode (matches :func:`lzw_decode`): the
    reference's bytes, in time linear in the data."""
    out = bytearray()
    buf = 0
    nbits = 0
    width = 9

    def emit(code):
        nonlocal buf, nbits
        buf = (buf << width) | code
        nbits += width
        while nbits >= 8:
            out.append((buf >> (nbits - 8)) & 0xFF)
            nbits -= 8
        # keep only the unwritten bits (the reference keeps them all,
        # which makes its encode quadratic in the strip's length)
        buf &= (1 << nbits) - 1

    table = {bytes([i]): i for i in range(256)}
    next_code = 258
    emit(256)  # initial clear
    w = b""
    for byte in data:
        c = bytes([byte])
        wc = w + c
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = next_code
        next_code += 1
        # the encoder's table runs one entry ahead of the decoder's (the
        # decoder adds each entry one code later), so widening here at
        # 512/1024/2048 lands exactly on the decoder's "early change" at
        # table sizes 511/1023/2047
        if next_code in (512, 1024, 2048):
            width += 1
        elif next_code == 4094:
            emit(256)
            table = {bytes([i]): i for i in range(256)}
            next_code = 258
            width = 9
        w = c
    if w:
        emit(table[w])
    emit(257)  # EOI
    if nbits:
        out.append((buf << (8 - nbits)) & 0xFF)
    return bytes(out)


def _decode_strip(raw: bytes, comp: int, path: str, max_out: int) -> bytes:
    """One strip's bytes; LZW and PackBits decode natively into at most
    ``max_out`` bytes."""
    if comp == COMP_NONE:
        return raw
    if comp in (COMP_DEFLATE_ADOBE, COMP_DEFLATE):
        return zlib.decompress(raw)   # zlib is already C
    if comp == COMP_LZW:
        return _tiffcodec.lzw_decode(raw, max_out)
    if comp == COMP_PACKBITS:
        return _tiffcodec.packbits_decode(raw, max_out)
    raise ValueError(f"unsupported TIFF compression {comp} in {path}")


def _unpredict(page: np.ndarray, predictor: int) -> np.ndarray:
    """Undo the horizontal-differencing predictor (tag 317 value 2).

    Differences run across image columns *per sample*: for ``spp > 1``
    pages shaped ``(h, w, spp)`` the accumulation axis is the column
    axis (-2), not the trailing sample axis. Predictor 2 is defined for
    integer samples only (floating-point pages use predictor 3, which
    is not supported); anything other than 1/2 is rejected.
    """
    if predictor == 1:
        return page
    if predictor != 2:
        raise ValueError(f"unsupported TIFF predictor {predictor}")
    if page.dtype.kind not in "iu":
        raise ValueError(
            "TIFF predictor 2 (horizontal differencing) is only valid "
            f"for integer samples, got dtype {page.dtype}")
    axis = -2 if page.ndim == 3 else -1
    return np.cumsum(page, axis=axis, dtype=page.dtype)

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d",
             16: "Q", 17: "q"}


def _read_ifd_entries(f, bo, big):
    """Read one IFD; returns (tags dict, next IFD offset)."""
    if big:
        n = struct.unpack(bo + "Q", f.read(8))[0]
        entry_size, count_fmt, off_fmt = 20, "Q", "Q"
    else:
        n = struct.unpack(bo + "H", f.read(2))[0]
        entry_size, count_fmt, off_fmt = 12, "I", "I"
    tags: Dict[int, list] = {}
    for _ in range(int(n)):
        data = f.read(entry_size)
        tag, typ = struct.unpack(bo + "HH", data[:4])
        count = struct.unpack(
            bo + count_fmt, data[4:4 + (8 if big else 4)])[0]
        val_bytes = data[4 + (8 if big else 4):]
        size = _TYPE_SIZES.get(typ, 1) * count
        if size <= len(val_bytes):
            raw = val_bytes[:size]
        else:
            off = struct.unpack(bo + off_fmt, val_bytes)[0]
            pos = f.tell()
            f.seek(off)
            raw = f.read(size)
            f.seek(pos)
        fmt = _TYPE_FMT.get(typ)
        if fmt:
            tags[tag] = list(struct.unpack(bo + fmt * count, raw))
        elif typ == 5:  # rational
            vals = struct.unpack(bo + "II" * count, raw)
            tags[tag] = [vals[i] / max(vals[i + 1], 1)
                         for i in range(0, len(vals), 2)]
        elif typ in (2, 7):  # ASCII / UNDEFINED: raw bytes
            tags[tag] = raw
    nxt = struct.unpack(bo + off_fmt, f.read(8 if big else 4))[0]
    return tags, nxt


def read_tiff(path: str, return_description: bool = False):
    """Read a grayscale multi-page TIFF into a ``(pages, H, W)`` array
    (single page -> ``(H, W)``). With ``return_description``, also
    return the first page's ImageDescription text (where OME-TIFF
    carries its OME-XML block) or None."""
    with open(path, "rb") as f:
        hdr = f.read(8)
        bo = {"II": "<", "MM": ">"}[hdr[:2].decode("ascii")]
        magic = struct.unpack(bo + "H", hdr[2:4])[0]
        if magic == 43:  # BigTIFF
            f.read(8 - len(hdr) + 8)  # already read 8; need offsetsize+pad
            f.seek(8)
            ifd_off = struct.unpack(bo + "Q", f.read(8))[0]
            big = True
        elif magic == 42:
            ifd_off = struct.unpack(bo + "I", hdr[4:8])[0]
            big = False
        else:
            raise ValueError(f"not a TIFF file: {path}")
        pages = []
        description = None
        while ifd_off:
            f.seek(ifd_off)
            tags, ifd_off = _read_ifd_entries(f, bo, big)
            if description is None and isinstance(
                    tags.get(_TAG_DESCRIPTION), bytes):
                # guard: a numeric-typed tag 270 decodes to a list
                description = tags[_TAG_DESCRIPTION].split(
                    b"\x00")[0].decode("utf-8", errors="replace")
            if _TAG_WIDTH not in tags:
                continue
            w = tags[_TAG_WIDTH][0]
            h = tags[_TAG_HEIGHT][0]
            bits = tags.get(_TAG_BITS, [8])[0]
            comp = tags.get(_TAG_COMPRESSION, [1])[0]
            spp = tags.get(_TAG_SPP, [1])[0]
            sfmt = tags.get(_TAG_SAMPLE_FORMAT, [1])[0]
            predictor = tags.get(_TAG_PREDICTOR, [1])[0]
            dtype = {
                (1, 8): np.uint8, (1, 16): np.uint16, (1, 32): np.uint32,
                (2, 8): np.int8, (2, 16): np.int16, (2, 32): np.int32,
                (3, 32): np.float32, (3, 64): np.float64,
            }[(sfmt, bits)]
            dtype = np.dtype(dtype).newbyteorder(bo)
            offsets = tags[_TAG_STRIP_OFFSETS]
            counts = tags.get(_TAG_STRIP_COUNTS,
                              [h * w * spp * bits // 8])
            page_bytes = h * w * spp * bits // 8
            raw = b""
            for off, cnt in zip(offsets, counts):
                f.seek(off)
                raw += _decode_strip(
                    f.read(cnt), comp, path, max_out=page_bytes)
            arr = np.frombuffer(raw, dtype=dtype, count=h * w * spp)
            if spp > 1:
                arr = arr.reshape(h, w, spp)
            else:
                arr = arr.reshape(h, w)
            arr = _unpredict(arr, predictor)
            pages.append(arr)
    if not pages:
        raise ValueError(f"no image pages in {path}")
    out = np.stack(pages) if len(pages) > 1 else pages[0]
    return (out, description) if return_description else out


#: writer name -> TIFF compression id
_WRITE_COMP = {None: COMP_NONE, "none": COMP_NONE,
               "deflate": COMP_DEFLATE_ADOBE, "zlib": COMP_DEFLATE_ADOBE,
               "lzw": COMP_LZW, "packbits": COMP_PACKBITS}


def write_tiff(path: str, arr: np.ndarray,
               compression: Optional[str] = None,
               description: Optional[str] = None) -> None:
    """Write a grayscale 2D/3D array as a multi-page TIFF.

    ``compression``: None/"none", "deflate"/"zlib", "lzw", "packbits"
    (one strip per page). Prefer "deflate" for compressed writes — it
    runs through zlib's C encoder; the LZW/PackBits encoders are pure
    Python (reads of such files decode natively, see ``_tiffcodec``).
    ``description`` writes an ImageDescription (tag 270) on the first
    page — e.g. an OME-XML block for OME-TIFF interchange.
    """
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    sfmt = {"u": 1, "i": 2, "f": 3}[arr.dtype.kind]
    bits = arr.dtype.itemsize * 8
    comp = _WRITE_COMP[compression]
    n_pages, h, w = arr.shape[:3]
    with open(path, "wb") as f:
        f.write(b"II*\x00")
        ifd_pos_holder = f.tell()
        f.write(struct.pack("<I", 0))  # first IFD offset placeholder
        prev_ifd_link = ifd_pos_holder
        desc_bytes = (description.encode("utf-8") + b"\x00"
                      if description else None)
        if desc_bytes and len(desc_bytes) <= 4:
            # the IFD entry stores an offset; values <= 4 bytes would
            # be read inline per the TIFF value rule, so pad past it
            desc_bytes += b"\x00" * (5 - len(desc_bytes))
        for p in range(n_pages):
            data = np.ascontiguousarray(arr[p]).tobytes()
            if comp in (COMP_DEFLATE_ADOBE, COMP_DEFLATE):
                data = zlib.compress(data)
            elif comp == COMP_LZW:
                data = lzw_encode(data)
            elif comp == COMP_PACKBITS:
                data = packbits_encode(data)
            data_off = f.tell()
            f.write(data)
            desc_entry = []
            if p == 0 and desc_bytes:
                desc_off = f.tell()
                f.write(desc_bytes)
                desc_entry = [(_TAG_DESCRIPTION, 2, len(desc_bytes),
                               desc_off)]
            ifd_off = f.tell()
            # link previous IFD (or header) to this one
            entries = [
                (_TAG_WIDTH, 4, 1, w),
                (_TAG_HEIGHT, 4, 1, h),
                (_TAG_BITS, 3, 1, bits),
                (_TAG_COMPRESSION, 3, 1, comp),
                (_TAG_PHOTOMETRIC, 3, 1, 1),
                (_TAG_STRIP_OFFSETS, 4, 1, data_off),
                (_TAG_SPP, 3, 1, 1),
                (_TAG_ROWS_PER_STRIP, 4, 1, h),
                (_TAG_STRIP_COUNTS, 4, 1, len(data)),
                (_TAG_SAMPLE_FORMAT, 3, 1, sfmt),
            ] + desc_entry
            entries.sort()   # TIFF requires ascending tag order
            f.write(struct.pack("<H", len(entries)))
            for tag, typ, cnt, val in entries:
                f.write(struct.pack("<HHI", tag, typ, cnt))
                f.write(struct.pack("<I", val))
            next_link_pos = f.tell()
            f.write(struct.pack("<I", 0))
            end = f.tell()
            f.seek(prev_ifd_link)
            f.write(struct.pack("<I", ifd_off))
            f.seek(end)
            prev_ifd_link = next_link_pos


class LazyTiffStack:
    """Lazy multi-page TIFF: pages load on demand.

    Covers the reference's lazy TIF loading (``magmap/io/np_io.py:646``
    ``read_tif`` memmap/zarr path): no pixel data is read until a page is
    indexed. Uncompressed single-strip pages memory-map with no copy;
    deflate/LZW/PackBits pages decode per access.
    """

    def __init__(self, path: str):
        self.path = path
        #: per page: (strip offsets, strip byte counts, compression,
        #: predictor)
        self._pages: List[Tuple[List[int], List[int], int, int]] = []
        self._shape_page: Optional[Tuple[int, int]] = None
        self.dtype: Optional[np.dtype] = None
        self._scan()

    def _scan(self):
        with open(self.path, "rb") as f:
            hdr = f.read(8)
            bo = {"II": "<", "MM": ">"}[hdr[:2].decode("ascii")]
            magic = struct.unpack(bo + "H", hdr[2:4])[0]
            if magic == 43:
                f.seek(8)
                ifd_off = struct.unpack(bo + "Q", f.read(8))[0]
                big = True
            else:
                ifd_off = struct.unpack(bo + "I", hdr[4:8])[0]
                big = False
            while ifd_off:
                f.seek(ifd_off)
                tags, ifd_off = _read_ifd_entries(f, bo, big)
                if _TAG_WIDTH not in tags:
                    continue
                comp = tags.get(_TAG_COMPRESSION, [1])[0]
                predictor = tags.get(_TAG_PREDICTOR, [1])[0]
                offsets = tags[_TAG_STRIP_OFFSETS]
                w = tags[_TAG_WIDTH][0]
                h = tags[_TAG_HEIGHT][0]
                bits = tags.get(_TAG_BITS, [8])[0]
                sfmt = tags.get(_TAG_SAMPLE_FORMAT, [1])[0]
                counts = tags.get(
                    _TAG_STRIP_COUNTS, [h * w * bits // 8])
                dtype = np.dtype({
                    (1, 8): np.uint8, (1, 16): np.uint16,
                    (1, 32): np.uint32, (2, 8): np.int8,
                    (2, 16): np.int16, (2, 32): np.int32,
                    (3, 32): np.float32, (3, 64): np.float64,
                }[(sfmt, bits)]).newbyteorder(bo)
                if self._shape_page is None:
                    self._shape_page = (h, w)
                    self.dtype = dtype
                elif self._shape_page != (h, w) or self.dtype != dtype:
                    raise ValueError("inconsistent TIFF pages")
                self._pages.append(
                    (list(offsets), list(counts), comp, predictor))

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (len(self._pages),) + self._shape_page

    def __len__(self):
        return len(self._pages)

    def page(self, i: int) -> np.ndarray:
        """Load one page: zero-copy memmap when uncompressed
        single-strip, per-access strip decode otherwise."""
        h, w = self._shape_page
        offsets, counts, comp, predictor = self._pages[i]
        if comp == COMP_NONE and len(offsets) == 1:
            return np.memmap(
                self.path, dtype=self.dtype, mode="r",
                offset=offsets[0], shape=(h, w))
        page_bytes = h * w * self.dtype.itemsize
        raw = b""
        with open(self.path, "rb") as f:
            for off, cnt in zip(offsets, counts):
                f.seek(off)
                raw += _decode_strip(
                    f.read(cnt), comp, self.path, max_out=page_bytes)
        arr = np.frombuffer(raw, dtype=self.dtype, count=h * w)
        return _unpredict(arr.reshape(h, w), predictor)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.page(key)
        if isinstance(key, slice):
            return np.stack(
                [self.page(i) for i in range(*key.indices(len(self)))])
        # (z, y, x)-style tuple: map z pages, slice the rest
        z = key[0]
        rest = key[1:]
        if isinstance(z, int):
            return self.page(z)[rest]
        return np.stack(
            [self.page(i)[rest]
             for i in range(*z.indices(len(self)))])

    def asarray(self) -> np.ndarray:
        return self[:]
