"""Minimal pure-Python HDF5 reader — enough for Imaris ``.ims`` files.

Copy of ``magellanmapper_tpu/io/hdf5.py``: the same arrays, metadata
and errors from the same files. The upstream MagellanMapper imports IMS
through Bioformats on a JVM (``magmap/io/importer.py:97-156``); this
reads them without h5py. Imaris files are HDF5 written with
libhdf5 defaults, which pins a narrow, stable on-disk profile this
module implements from the HDF5 File Format Specification (v1.10):

 - superblock version 0 (legacy default) or 2/3 (1.10+ ``latest``),
   8-byte offsets/lengths;
 - version-1 object headers (with continuation blocks) and their
   messages: dataspace (0x0001), datatype (0x0003), data layout
   (0x0008), filter pipeline (0x000B), attribute (0x000C), symbol
   table (0x0011), link (0x0002) and link-info for v2 groups is NOT
   implemented — libhdf5 only emits those under ``latest`` group
   flags, which Imaris writers do not use;
 - groups as symbol tables: v1 B-trees (``TREE`` node type 0) over
   ``SNOD`` symbol nodes with names in a local heap (``HEAP``);
 - datasets stored contiguous, compact, or chunked behind a v1 B-tree
   (node type 1) with gzip (filter 1) and shuffle (filter 2) filters —
   what Imaris/libhdf5 actually emit;
 - fixed-point/float/string datatypes, attribute values included
   (Imaris stores image sizes as one-char-per-element string attrs).

Anything outside the profile raises with the message naming the
missing feature, so exotic files fail loudly rather than wrongly.
"""

from __future__ import annotations

import mmap
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF


class Hdf5File:
    """Read-only HDF5 tree: ``obj = f["group/dataset"]``."""

    def __init__(self, path: str):
        # memory-map rather than slurp: a multi-GB IMS would otherwise
        # cost file-size bytes of RAM on top of the decoded arrays
        with open(path, "rb") as f:
            self._d = mmap.mmap(
                f.fileno(), 0, access=mmap.ACCESS_READ)
        if self._d[:8] != SIGNATURE:
            raise ValueError(f"not an HDF5 file: {path}")
        ver = self._d[8]
        if ver == 0:
            # v0: sizes at 13/14, group k at 16/18, base addr 24,
            # root symbol-table entry at 64 (offsets 8-byte assumed)
            so, sl = self._d[13], self._d[14]
            if (so, sl) != (8, 8):
                raise NotImplementedError(
                    f"offset/length sizes {so}/{sl} (only 8/8)")
            # root group symbol table entry begins after 24 bytes of
            # header scalars + 4 addresses (base, free, eof, driver)
            entry = 24 + 4 * 8
            self.root_header = struct.unpack_from(
                "<Q", self._d, entry + 8)[0]
        elif ver in (2, 3):
            so = self._d[9]
            if so != 8:
                raise NotImplementedError(f"offset size {so}")
            # v2/3: base 12, extension 20, eof 28, root header 36
            self.root_header = struct.unpack_from("<Q", self._d, 36)[0]
        else:
            raise NotImplementedError(f"superblock version {ver}")

    # -- low-level ----------------------------------------------------------

    def _object_messages(self, addr: int) -> List[Tuple[int, bytes]]:
        """All (type, body) messages of a version-1 object header."""
        d = self._d
        if d[addr:addr + 4] == b"OHDR":
            raise NotImplementedError(
                "version-2 object headers — file written with libhdf5 "
                "'latest' format flags, which Imaris writers do not "
                "use; convert with h5repack on an h5py-equipped host")
        version = d[addr]
        if version != 1:
            raise NotImplementedError(
                f"object header version {version} at {addr}")
        n_msgs = struct.unpack_from("<H", d, addr + 2)[0]
        header_size = struct.unpack_from("<I", d, addr + 8)[0]
        blocks = [(addr + 16, header_size)]
        msgs = []
        while blocks and len(msgs) < n_msgs:
            pos, remaining = blocks.pop(0)
            while remaining >= 8 and len(msgs) < n_msgs:
                mtype, msize, _flags = struct.unpack_from(
                    "<HHB", d, pos)
                body = d[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                remaining -= 8 + msize
                if mtype == 0x0010:     # continuation
                    cont_addr, cont_len = struct.unpack_from(
                        "<QQ", body, 0)
                    blocks.append((cont_addr, cont_len))
                    msgs.append((mtype, body))
                else:
                    msgs.append((mtype, body))
        return msgs

    def _local_heap(self, addr: int) -> int:
        d = self._d
        if d[addr:addr + 4] != b"HEAP":
            raise ValueError(f"no local heap at {addr}")
        return struct.unpack_from("<Q", d, addr + 24)[0]

    def _heap_string(self, heap_data: int, offset: int) -> str:
        d = self._d
        end = d.find(b"\x00", heap_data + offset)
        if end < 0:
            raise ValueError("unterminated local-heap string")
        return d[heap_data + offset:end].decode("utf-8")

    def _group_entries(self, btree_addr: int,
                       heap_addr: int) -> Dict[str, int]:
        """name -> object header address via the v1 group B-tree."""
        d = self._d
        heap_data = self._local_heap(heap_addr)
        out: Dict[str, int] = {}

        def walk(addr):
            if d[addr:addr + 4] == b"SNOD":
                n = struct.unpack_from("<H", d, addr + 6)[0]
                pos = addr + 8
                for _ in range(n):
                    name_off, hdr = struct.unpack_from("<QQ", d, pos)
                    out[self._heap_string(heap_data, name_off)] = hdr
                    pos += 40   # symbol table entry is 40 bytes
                return
            if d[addr:addr + 4] != b"TREE":
                raise ValueError(f"bad group B-tree node at {addr}")
            level = d[addr + 5]
            n = struct.unpack_from("<H", d, addr + 6)[0]
            # keys are heap offsets (8 B) interleaved with children
            pos = addr + 8 + 16 + 8   # sig+type+lvl+n, siblings, key0
            for _ in range(n):
                child = struct.unpack_from("<Q", d, pos)[0]
                walk(child)
                pos += 16   # child + next key

        walk(btree_addr)
        return out

    # -- messages -----------------------------------------------------------

    @staticmethod
    def _parse_dataspace(body: bytes) -> Tuple[int, ...]:
        version = body[0]
        rank = body[1]
        if version == 1:
            pos = 8
        elif version == 2:
            pos = 4
        else:
            raise NotImplementedError(f"dataspace version {version}")
        return tuple(
            struct.unpack_from("<Q", body, pos + 8 * i)[0]
            for i in range(rank))

    @staticmethod
    def _parse_datatype(body: bytes) -> np.dtype:
        cls_ver = body[0]
        cls = cls_ver & 0x0F
        bits0 = body[1]
        size = struct.unpack_from("<I", body, 4)[0]
        endian = ">" if (bits0 & 1) else "<"
        if cls == 0:    # fixed-point
            signed = "i" if (bits0 & 0x08) else "u"
            return np.dtype(f"{endian}{signed}{size}")
        if cls == 1:    # float
            return np.dtype(f"{endian}f{size}")
        if cls == 3:    # string
            return np.dtype(f"S{size}")
        raise NotImplementedError(f"datatype class {cls}")

    def _parse_layout(self, body: bytes) -> Dict:
        version = body[0]
        if version == 3:
            cls = body[1]
            if cls == 0:      # compact
                size = struct.unpack_from("<H", body, 2)[0]
                return {"class": "compact",
                        "data": body[4:4 + size]}
            if cls == 1:      # contiguous
                addr, size = struct.unpack_from("<QQ", body, 2)
                return {"class": "contiguous", "addr": addr,
                        "size": size}
            if cls == 2:      # chunked
                ndims = body[2]
                btree = struct.unpack_from("<Q", body, 3)[0]
                dims = tuple(
                    struct.unpack_from("<I", body, 11 + 4 * i)[0]
                    for i in range(ndims))
                return {"class": "chunked", "btree": btree,
                        "chunk": dims}
        raise NotImplementedError(
            f"data layout version {version} class {body[1]}")

    @staticmethod
    def _parse_filters(body: bytes) -> List[int]:
        version = body[0]
        n = body[1]
        filters = []
        pos = 8 if version == 1 else 2
        for _ in range(n):
            fid = struct.unpack_from("<H", body, pos)[0]
            pos += 2
            # v2 omits the Name Length field entirely for builtin
            # filters (id < 256); v1 always carries it
            name_len = 0
            if version == 1 or fid >= 256:
                name_len = struct.unpack_from("<H", body, pos)[0]
                pos += 2
            _flags, n_vals = struct.unpack_from("<HH", body, pos)
            pos += 4
            pos += (name_len + (-name_len) % 8 if version == 1
                    else name_len)
            pos += 4 * n_vals
            if version == 1 and n_vals % 2:
                pos += 4
            filters.append(fid)
        return filters

    def _parse_attribute(self, body: bytes):
        version = body[0]
        if version not in (1, 3):
            raise NotImplementedError(f"attribute version {version}")
        name_size, dt_size, ds_size = struct.unpack_from(
            "<HHH", body, 2)
        pos = 8
        if version == 3:
            pos += 1   # name character-set encoding
        name = body[pos:pos + name_size].split(b"\x00")[0].decode()
        pos += name_size + ((-name_size) % 8 if version == 1 else 0)
        dt = self._parse_datatype(body[pos:pos + dt_size])
        pos += dt_size + ((-dt_size) % 8 if version == 1 else 0)
        shape = self._parse_dataspace(body[pos:pos + ds_size])
        pos += ds_size + ((-ds_size) % 8 if version == 1 else 0)
        count = int(np.prod(shape)) if shape else 1
        data = np.frombuffer(
            body, dt, count=count, offset=pos)
        return name, data.reshape(shape) if shape else data[0]

    # -- public -------------------------------------------------------------

    def _node(self, addr: int) -> Dict:
        msgs = self._object_messages(addr)
        node: Dict = {"attrs": {}, "addr": addr}
        for mtype, body in msgs:
            if mtype == 0x0011:   # symbol table (group)
                btree, heap = struct.unpack_from("<QQ", body, 0)
                node["group"] = self._group_entries(btree, heap)
            elif mtype == 0x0001:
                node["shape"] = self._parse_dataspace(body)
            elif mtype == 0x0003:
                node["dtype"] = self._parse_datatype(body)
            elif mtype == 0x0008:
                node["layout"] = self._parse_layout(body)
            elif mtype == 0x000B:
                node["filters"] = self._parse_filters(body)
            elif mtype == 0x000C:
                name, value = self._parse_attribute(body)
                node["attrs"][name] = value
            elif mtype == 0x0002:
                raise NotImplementedError(
                    "v2 (link-message) groups — file written with "
                    "libhdf5 'latest' group format")
        return node

    def node(self, path: str) -> Dict:
        node = self._node(self.root_header)
        for part in [p for p in path.split("/") if p]:
            group = node.get("group")
            if group is None or part not in group:
                raise KeyError(path)
            node = self._node(group[part])
        return node

    def list_group(self, path: str = "/") -> List[str]:
        return sorted(self.node(path).get("group", {}))

    def attrs(self, path: str) -> Dict:
        return self.node(path)["attrs"]

    def _decode_chunk(self, raw: bytes, filters: List[int],
                      itemsize: int) -> bytes:
        for fid in reversed(filters):
            if fid == 1:
                raw = zlib.decompress(raw)
            elif fid == 2:
                arr = np.frombuffer(raw, np.uint8)
                raw = arr.reshape(itemsize, -1).T.tobytes()
            else:
                raise NotImplementedError(f"HDF5 filter id {fid}")
        return raw

    def read_dataset(self, path: str) -> np.ndarray:
        node = self.node(path)
        if "layout" not in node:
            raise KeyError(f"{path} is not a dataset")
        shape = node["shape"]
        dt = node["dtype"]
        layout = node["layout"]
        if layout["class"] == "compact":
            return np.frombuffer(
                layout["data"], dt,
                count=int(np.prod(shape))).reshape(shape)
        if layout["class"] == "contiguous":
            if layout["addr"] == UNDEF:
                return np.zeros(shape, dt)
            return np.frombuffer(
                self._d, dt, count=int(np.prod(shape)),
                offset=layout["addr"]).reshape(shape)
        # chunked: walk the v1 B-tree (node type 1)
        chunk = layout["chunk"][:-1]   # last dim is the element size
        filters = node.get("filters", [])
        out = np.zeros(shape, dt)
        d = self._d
        rank = len(chunk)

        def walk(addr):
            if d[addr:addr + 4] != b"TREE":
                raise ValueError(f"bad chunk B-tree node at {addr}")
            level = d[addr + 5]
            n = struct.unpack_from("<H", d, addr + 6)[0]
            key_size = 8 + 8 * (rank + 1)
            pos = addr + 24
            for _ in range(n):
                size, _mask = struct.unpack_from("<II", d, pos)
                offs = tuple(
                    struct.unpack_from("<Q", d, pos + 8 + 8 * i)[0]
                    for i in range(rank))
                child = struct.unpack_from(
                    "<Q", d, pos + key_size)[0]
                if level > 0:
                    walk(child)
                else:
                    raw = self._decode_chunk(
                        d[child:child + size], filters, dt.itemsize)
                    block = np.frombuffer(
                        raw, dt,
                        count=int(np.prod(chunk))).reshape(chunk)
                    sl = tuple(
                        slice(o, min(o + c, s))
                        for o, c, s in zip(offs, chunk, shape))
                    trim = tuple(
                        slice(0, s.stop - s.start) for s in sl)
                    out[sl] = block[trim]
                pos += key_size + 8
        walk(layout["btree"])
        return out


def _attr_str(attrs: Dict, key: str) -> Optional[str]:
    """Imaris stores scalars as one-char-per-element S1 arrays."""
    v = attrs.get(key)
    if v is None:
        return None
    if isinstance(v, np.ndarray):
        return b"".join(np.asarray(v).reshape(-1)).decode(
            "utf-8", errors="replace")
    return str(v)


def read_ims(path: str, resolution_level: int = 0,
             timepoint: int = 0) -> Tuple[np.ndarray, Dict]:
    """Read an Imaris ``.ims`` volume into ``(array, meta)``.

    Output ``(Z, Y, X)`` single-channel, else ``(C, Z, Y, X)``. Z/Y/X
    extents come from the DataSetInfo/Image attributes (Imaris pads the
    stored datasets to chunk multiples); ``resolutions`` derive from
    the ExtMin/ExtMax bounding box when present.

    The pure-Python reader handles the profile libhdf5 defaults (and
    hence Imaris writers) emit; files written with ``libver='latest'``
    bounds (v2 object headers etc.) fall back to the system libhdf5
    via ctypes (``io.hdf5_native``) when that library is present.
    """
    try:
        return _read_ims_from(Hdf5File(path), path, resolution_level,
                              timepoint)
    except NotImplementedError:
        from magellanmapper_torch.io import hdf5_native
        if not hdf5_native.available():
            raise
        with hdf5_native.NativeHdf5File(path) as f:
            return _read_ims_from(f, path, resolution_level,
                                  timepoint)


def _read_ims_from(f, path: str, resolution_level: int,
                   timepoint: int) -> Tuple[np.ndarray, Dict]:
    """IMS tree walk over either HDF5 engine (pure or native)."""
    base = (f"DataSet/ResolutionLevel {resolution_level}/"
            f"TimePoint {timepoint}")
    channels = [c for c in f.list_group(base)
                if c.startswith("Channel")]
    if not channels:
        raise ValueError(f"no channels under {base} in {path}")
    channels.sort(key=lambda c: int(c.split()[-1]))

    img_attrs = {}
    try:
        img_attrs = f.attrs("DataSetInfo/Image")
    except KeyError:
        pass
    vols = []
    for ch in channels:
        node_attrs = f.attrs(f"{base}/{ch}")
        vol = f.read_dataset(f"{base}/{ch}/Data")
        sizes = []
        for axis, default in (("Z", vol.shape[0]),
                              ("Y", vol.shape[1]),
                              ("X", vol.shape[2])):
            v = (_attr_str(node_attrs, f"ImageSize{axis}")
                 or _attr_str(img_attrs, axis))
            sizes.append(int(v) if v else default)
        vols.append(vol[:sizes[0], :sizes[1], :sizes[2]])
    arr = np.stack(vols)
    meta: Dict = {"components": len(channels),
                  "resolution_level": resolution_level}
    try:
        ext = [float(_attr_str(img_attrs, k))
               for k in ("ExtMin2", "ExtMax2", "ExtMin1", "ExtMax1",
                         "ExtMin0", "ExtMax0")]
        nz, ny, nx = arr.shape[1:]
        meta["resolutions"] = (
            (ext[1] - ext[0]) / max(nz, 1),
            (ext[3] - ext[2]) / max(ny, 1),
            (ext[5] - ext[4]) / max(nx, 1))
    except (TypeError, ValueError):
        pass
    if arr.shape[0] == 1:
        arr = arr[0]
    return arr, meta
