"""ctypes binding to the system libhdf5 — the 'latest'-format escape
hatch for Imaris ``.ims`` files.

Copy of ``magellanmapper_tpu/io/hdf5_native.py``. The pure-Python reader
(:mod:`.hdf5`) implements the narrow on-disk profile libhdf5 emits by
default (v0 superblock, v1 object headers, symbol-table groups) — which
is what Imaris writers produce. Files written with ``H5F_LIBVER_LATEST``
bounds instead use v3 superblocks, v2 object headers, and
fractal-heap/v2-B-tree link storage, a far larger surface that is read
through the HDF5 C library itself (``libhdf5_serial`` or ``libhdf5``,
1.10 or later) bound with ctypes: no h5py and no headers, since the HDF5
public API is handle-based and no struct layout crosses the boundary
except ``H5G_info_t``. Without the library, :class:`NativeHdf5File` and
:class:`NativeHdf5Writer` raise ``ImportError`` naming it.

The upstream MagellanMapper reads IMS through Bioformats on a JVM
(``magmap/io/importer.py:97-156``), which links the same libhdf5
underneath. The pure-Python reader stays primary and this engine is the
fallback for 'latest'-profile files (see ``hdf5.read_ims``).

The writer half builds test fixtures (files produced by the C library,
never by the pure reader's sibling code) and the volumes the smoke run
imports, when the library is present.
"""

from __future__ import annotations

import ctypes as C
import ctypes.util
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

hid_t = C.c_int64            # HDF5 >= 1.10: 64-bit handles
herr_t = C.c_int
hsize_t = C.c_uint64
H5P_DEFAULT = 0
H5S_ALL = 0
H5F_ACC_RDONLY = 0x0000
H5F_ACC_TRUNC = 0x0002
H5_INDEX_NAME = 0
H5_ITER_INC = 0
# H5F_libver_t: EARLIEST=0, V18=1, V110=2(=LATEST in 1.10)
H5F_LIBVER_EARLIEST = 0
H5F_LIBVER_LATEST_110 = 2
H5T_INTEGER, H5T_FLOAT, H5T_STRING = 0, 1, 3
H5T_SGN_NONE = 0

_SIGNATURES = {
    # readers
    "H5open": (herr_t, []),
    "H5Eset_auto2": (herr_t, [hid_t, C.c_void_p, C.c_void_p]),
    "H5Fopen": (hid_t, [C.c_char_p, C.c_uint, hid_t]),
    "H5Fclose": (herr_t, [hid_t]),
    "H5Oopen": (hid_t, [hid_t, C.c_char_p, hid_t]),
    "H5Oclose": (herr_t, [hid_t]),
    "H5Gopen2": (hid_t, [hid_t, C.c_char_p, hid_t]),
    "H5Gclose": (herr_t, [hid_t]),
    "H5Gget_info": (herr_t, [hid_t, C.c_void_p]),
    "H5Lget_name_by_idx": (
        C.c_ssize_t,
        [hid_t, C.c_char_p, C.c_int, C.c_int, hsize_t,
         C.c_char_p, C.c_size_t, hid_t]),
    "H5Dopen2": (hid_t, [hid_t, C.c_char_p, hid_t]),
    "H5Dclose": (herr_t, [hid_t]),
    "H5Dget_space": (hid_t, [hid_t]),
    "H5Dget_type": (hid_t, [hid_t]),
    "H5Dread": (herr_t, [hid_t, hid_t, hid_t, hid_t, hid_t,
                         C.c_void_p]),
    "H5Sget_simple_extent_ndims": (C.c_int, [hid_t]),
    "H5Sget_simple_extent_dims": (
        C.c_int, [hid_t, C.POINTER(hsize_t), C.POINTER(hsize_t)]),
    "H5Sclose": (herr_t, [hid_t]),
    "H5Tget_class": (C.c_int, [hid_t]),
    "H5Tget_size": (C.c_size_t, [hid_t]),
    "H5Tget_sign": (C.c_int, [hid_t]),
    "H5Tis_variable_str": (C.c_int, [hid_t]),
    "H5Tcopy": (hid_t, [hid_t]),
    "H5Tset_size": (herr_t, [hid_t, C.c_size_t]),
    "H5Tclose": (herr_t, [hid_t]),
    "H5Aget_num_attrs": (C.c_int, [hid_t]),
    "H5Aopen_by_idx": (hid_t, [hid_t, C.c_char_p, C.c_int, C.c_int,
                               hsize_t, hid_t, hid_t]),
    "H5Aget_name": (C.c_ssize_t, [hid_t, C.c_size_t, C.c_char_p]),
    "H5Aget_space": (hid_t, [hid_t]),
    "H5Aget_type": (hid_t, [hid_t]),
    "H5Aread": (herr_t, [hid_t, hid_t, C.c_void_p]),
    "H5Aclose": (herr_t, [hid_t]),
    # writers
    "H5Pcreate": (hid_t, [hid_t]),
    "H5Pset_libver_bounds": (herr_t, [hid_t, C.c_int, C.c_int]),
    "H5Pset_chunk": (herr_t, [hid_t, C.c_int, C.POINTER(hsize_t)]),
    "H5Pset_deflate": (herr_t, [hid_t, C.c_uint]),
    "H5Pset_shuffle": (herr_t, [hid_t]),
    "H5Pset_create_intermediate_group": (herr_t, [hid_t, C.c_uint]),
    "H5Pclose": (herr_t, [hid_t]),
    "H5Fcreate": (hid_t, [C.c_char_p, C.c_uint, hid_t, hid_t]),
    "H5Screate_simple": (
        hid_t, [C.c_int, C.POINTER(hsize_t), C.POINTER(hsize_t)]),
    "H5Screate": (hid_t, [C.c_int]),
    "H5Gcreate2": (hid_t, [hid_t, C.c_char_p, hid_t, hid_t, hid_t]),
    "H5Dcreate2": (hid_t, [hid_t, C.c_char_p, hid_t, hid_t, hid_t,
                           hid_t, hid_t]),
    "H5Dwrite": (herr_t, [hid_t, hid_t, hid_t, hid_t, hid_t,
                          C.c_void_p]),
    "H5Acreate2": (hid_t, [hid_t, C.c_char_p, hid_t, hid_t, hid_t,
                           hid_t]),
    "H5Awrite": (herr_t, [hid_t, hid_t, C.c_void_p]),
}

#: numpy dtype -> H5T_NATIVE_* global symbol (fixed-width aliases,
#: present in every 1.8+ build)
_NATIVE_BY_DTYPE = {
    np.dtype(np.uint8): "H5T_NATIVE_UINT8_g",
    np.dtype(np.int8): "H5T_NATIVE_INT8_g",
    np.dtype(np.uint16): "H5T_NATIVE_UINT16_g",
    np.dtype(np.int16): "H5T_NATIVE_INT16_g",
    np.dtype(np.uint32): "H5T_NATIVE_UINT32_g",
    np.dtype(np.int32): "H5T_NATIVE_INT32_g",
    np.dtype(np.uint64): "H5T_NATIVE_UINT64_g",
    np.dtype(np.int64): "H5T_NATIVE_INT64_g",
    np.dtype(np.float32): "H5T_NATIVE_FLOAT_g",
    np.dtype(np.float64): "H5T_NATIVE_DOUBLE_g",
}

_LIB_NAMES = ("hdf5_serial", "hdf5")
_lib = None
_lib_tried = False


class _GInfo(C.Structure):
    """H5G_info_t — the one struct the public read API requires."""
    _fields_ = [("storage_type", C.c_int), ("nlinks", hsize_t),
                ("max_corder", C.c_int64), ("mounted", C.c_uint)]


def _load() -> Optional[C.CDLL]:
    """Bind the system libhdf5 once; None when absent."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    for name in _LIB_NAMES:
        path = ctypes.util.find_library(name)
        candidates = [path] if path else [
            f"lib{name}.so.103", f"lib{name}.so.100", f"lib{name}.so"]
        for cand in candidates:
            if not cand:
                continue
            try:
                lib = C.CDLL(cand)
                lib.H5open.restype = herr_t
                if lib.H5open() < 0:
                    continue
            except OSError:
                continue
            for fname, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, fname, None)
                if fn is None:
                    continue
                fn.restype, fn.argtypes = res, args
            # route expected failures (missing paths probed by
            # open attempts) away from stderr
            lib.H5Eset_auto2(0, None, None)
            _lib = lib
            return _lib
    return None


def available() -> bool:
    """True when a bindable system libhdf5 exists."""
    return _load() is not None


def _global(name: str) -> int:
    return hid_t.in_dll(_load(), name).value


def _check(ret, what: str):
    if (hasattr(ret, "value") and ret.value < 0) or (
            isinstance(ret, int) and ret < 0):
        raise OSError(f"libhdf5 call failed: {what}")
    return ret


class _Handle:
    """Scope guard for one hid_t, closed with the given H5*close."""

    def __init__(self, lib, hid: int, closer: str):
        self._lib, self.hid, self._closer = lib, hid, closer

    def __enter__(self):
        return self.hid

    def __exit__(self, *exc):
        if self.hid > 0:
            getattr(self._lib, self._closer)(self.hid)
        return False


class NativeHdf5File:
    """Read-only HDF5 access through the system C library, with the
    same surface as the pure-Python ``hdf5.Hdf5File`` (``list_group``,
    ``attrs``, ``read_dataset``) so ``read_ims`` can run on either."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise ImportError(
                "no system libhdf5 found (tried libhdf5_serial/"
                "libhdf5); 'latest'-format HDF5 needs it")
        self._lib = lib
        self._fid = lib.H5Fopen(
            path.encode(), H5F_ACC_RDONLY, H5P_DEFAULT)
        if self._fid < 0:
            raise ValueError(f"libhdf5 could not open {path}")
        self._path = path

    # -- plumbing -----------------------------------------------------------

    def _space_shape(self, sid: int) -> Tuple[int, ...]:
        nd = self._lib.H5Sget_simple_extent_ndims(sid)
        if nd < 0:
            raise OSError("H5Sget_simple_extent_ndims failed")
        if nd == 0:
            return ()
        dims = (hsize_t * nd)()
        self._lib.H5Sget_simple_extent_dims(sid, dims, None)
        return tuple(int(d) for d in dims)

    def _read_typed(self, tid: int, shape: Tuple[int, ...],
                    reader) -> Union[np.ndarray, np.generic]:
        """Read a dataset/attribute of file type ``tid`` via
        ``reader(mem_tid, buf_ptr)``; returns array (or scalar for a
        scalar dataspace), matching the pure reader's conventions."""
        lib = self._lib
        cls = lib.H5Tget_class(tid)
        size = lib.H5Tget_size(tid)
        count = int(np.prod(shape)) if shape else 1
        if cls == H5T_STRING:
            if lib.H5Tis_variable_str(tid) > 0:
                raise NotImplementedError(
                    "variable-length HDF5 strings")
            mem = lib.H5Tcopy(_global("H5T_C_S1_g"))
            lib.H5Tset_size(mem, size)
            with _Handle(lib, mem, "H5Tclose"):
                arr = np.zeros(count, dtype=f"S{size}")
                _check(reader(mem, arr.ctypes.data), "read(str)")
        elif cls in (H5T_INTEGER, H5T_FLOAT):
            if cls == H5T_INTEGER:
                signed = lib.H5Tget_sign(tid) != H5T_SGN_NONE
                kind = "i" if signed else "u"
            else:
                kind = "f"
            try:
                dt = np.dtype(f"{kind}{size}")
            except TypeError:
                dt = None
            if dt is None or dt not in _NATIVE_BY_DTYPE:
                raise NotImplementedError(
                    f"HDF5 {kind}{size}-byte datatype")
            arr = np.empty(count, dtype=dt)
            _check(reader(_global(_NATIVE_BY_DTYPE[dt]),
                          arr.ctypes.data), "read(num)")
        else:
            raise NotImplementedError(f"HDF5 datatype class {cls}")
        return arr.reshape(shape) if shape else arr[0]

    # -- Hdf5File-compatible surface ----------------------------------------

    def list_group(self, path: str = "/") -> List[str]:
        lib = self._lib
        gid = lib.H5Gopen2(self._fid, path.encode(), H5P_DEFAULT)
        if gid < 0:
            raise KeyError(f"no group {path} in {self._path}")
        with _Handle(lib, gid, "H5Gclose"):
            info = _GInfo()
            _check(lib.H5Gget_info(gid, C.byref(info)), "H5Gget_info")
            names = []
            for i in range(int(info.nlinks)):
                n = lib.H5Lget_name_by_idx(
                    gid, b".", H5_INDEX_NAME, H5_ITER_INC, i,
                    None, 0, H5P_DEFAULT)
                buf = C.create_string_buffer(n + 1)
                lib.H5Lget_name_by_idx(
                    gid, b".", H5_INDEX_NAME, H5_ITER_INC, i,
                    buf, n + 1, H5P_DEFAULT)
                names.append(buf.value.decode())
        return sorted(names)

    def attrs(self, path: str) -> Dict:
        lib = self._lib
        oid = lib.H5Oopen(self._fid, path.encode(), H5P_DEFAULT)
        if oid < 0:
            raise KeyError(f"no object {path} in {self._path}")
        out: Dict = {}
        with _Handle(lib, oid, "H5Oclose"):
            for i in range(max(lib.H5Aget_num_attrs(oid), 0)):
                aid = lib.H5Aopen_by_idx(
                    oid, b".", H5_INDEX_NAME, H5_ITER_INC, i,
                    H5P_DEFAULT, H5P_DEFAULT)
                if aid < 0:
                    continue
                with _Handle(lib, aid, "H5Aclose"):
                    n = lib.H5Aget_name(aid, 0, None)
                    buf = C.create_string_buffer(n + 1)
                    lib.H5Aget_name(aid, n + 1, buf)
                    sid = lib.H5Aget_space(aid)
                    tid = lib.H5Aget_type(aid)
                    with _Handle(lib, sid, "H5Sclose"), \
                            _Handle(lib, tid, "H5Tclose"):
                        shape = self._space_shape(sid)
                        out[buf.value.decode()] = self._read_typed(
                            tid, shape,
                            lambda mem, ptr: lib.H5Aread(
                                aid, mem, ptr))
        return out

    def read_dataset(self, path: str) -> np.ndarray:
        lib = self._lib
        did = lib.H5Dopen2(self._fid, path.encode(), H5P_DEFAULT)
        if did < 0:
            raise KeyError(f"{path} is not a dataset in {self._path}")
        with _Handle(lib, did, "H5Dclose"):
            sid = lib.H5Dget_space(did)
            tid = lib.H5Dget_type(did)
            with _Handle(lib, sid, "H5Sclose"), \
                    _Handle(lib, tid, "H5Tclose"):
                shape = self._space_shape(sid)
                out = self._read_typed(
                    tid, shape,
                    lambda mem, ptr: lib.H5Dread(
                        did, mem, H5S_ALL, H5S_ALL, H5P_DEFAULT,
                        ptr))
        return out if isinstance(out, np.ndarray) else np.asarray(out)

    def close(self):
        if getattr(self, "_fid", -1) > 0:
            self._lib.H5Fclose(self._fid)
            self._fid = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeHdf5Writer:
    """Create HDF5 files through the system library.

    ``libver='earliest'`` (the libhdf5 default) emits the v0-superblock
    / v1-object-header profile the pure-Python reader understands —
    used to validate that reader against the reference implementation's
    actual output. ``libver='latest'`` emits v3 superblocks + v2 object
    headers, the profile that *requires* this engine to read back."""

    def __init__(self, path: str, libver: str = "earliest"):
        lib = _load()
        if lib is None:
            raise ImportError("no system libhdf5 found")
        self._lib = lib
        fapl = H5P_DEFAULT
        if libver == "latest":
            fapl = lib.H5Pcreate(_global("H5P_CLS_FILE_ACCESS_ID_g"))
            _check(lib.H5Pset_libver_bounds(
                fapl, H5F_LIBVER_LATEST_110, H5F_LIBVER_LATEST_110),
                "H5Pset_libver_bounds")
        elif libver != "earliest":
            raise ValueError(f"libver {libver!r}")
        self._fid = lib.H5Fcreate(
            path.encode(), H5F_ACC_TRUNC, H5P_DEFAULT, fapl)
        if fapl != H5P_DEFAULT:
            lib.H5Pclose(fapl)
        if self._fid < 0:
            raise OSError(f"libhdf5 could not create {path}")

    def _lcpl(self) -> int:
        lcpl = self._lib.H5Pcreate(_global("H5P_CLS_LINK_CREATE_ID_g"))
        self._lib.H5Pset_create_intermediate_group(lcpl, 1)
        return lcpl

    def create_group(self, path: str) -> None:
        lcpl = self._lcpl()
        gid = self._lib.H5Gcreate2(
            self._fid, path.encode(), lcpl, H5P_DEFAULT, H5P_DEFAULT)
        self._lib.H5Pclose(lcpl)
        _check(hid_t(gid), f"H5Gcreate2 {path}")
        self._lib.H5Gclose(gid)

    def write_dataset(self, path: str, arr: np.ndarray,
                      chunks: Optional[Sequence[int]] = None,
                      gzip: Optional[int] = None,
                      shuffle: bool = False) -> None:
        lib = self._lib
        arr = np.ascontiguousarray(arr)
        if arr.dtype not in _NATIVE_BY_DTYPE:
            raise NotImplementedError(
                f"HDF5 write of dtype {arr.dtype}")
        mem = _global(_NATIVE_BY_DTYPE[arr.dtype])
        dims = (hsize_t * arr.ndim)(*arr.shape)
        sid = lib.H5Screate_simple(arr.ndim, dims, None)
        dcpl = H5P_DEFAULT
        if chunks is not None or gzip is not None or shuffle:
            dcpl = lib.H5Pcreate(
                _global("H5P_CLS_DATASET_CREATE_ID_g"))
            cdims = (hsize_t * arr.ndim)(*(
                chunks if chunks is not None else arr.shape))
            lib.H5Pset_chunk(dcpl, arr.ndim, cdims)
            if shuffle:
                lib.H5Pset_shuffle(dcpl)
            if gzip is not None:
                lib.H5Pset_deflate(dcpl, gzip)
        lcpl = self._lcpl()
        did = lib.H5Dcreate2(self._fid, path.encode(), mem, sid,
                             lcpl, dcpl, H5P_DEFAULT)
        lib.H5Pclose(lcpl)
        if dcpl != H5P_DEFAULT:
            lib.H5Pclose(dcpl)
        with _Handle(lib, sid, "H5Sclose"), \
                _Handle(lib, did, "H5Dclose"):
            _check(hid_t(did), f"H5Dcreate2 {path}")
            _check(lib.H5Dwrite(did, mem, H5S_ALL, H5S_ALL,
                                H5P_DEFAULT, arr.ctypes.data),
                   f"H5Dwrite {path}")

    def write_attr(self, path: str, name: str,
                   value: Union[str, bytes, int, float,
                                np.ndarray]) -> None:
        """Imaris convention: strings are stored as one-char-per-
        element S1 arrays (what ``hdf5._attr_str`` reassembles)."""
        lib = self._lib
        oid = lib.H5Oopen(self._fid, path.encode(), H5P_DEFAULT)
        _check(hid_t(oid), f"H5Oopen {path}")
        with _Handle(lib, oid, "H5Oclose"):
            if isinstance(value, str):
                value = value.encode()
            if isinstance(value, bytes):
                arr = np.frombuffer(value, dtype="S1")
                tid = lib.H5Tcopy(_global("H5T_C_S1_g"))
                lib.H5Tset_size(tid, 1)
                mem = tid
            else:
                arr = np.asarray(value)
                if arr.ndim:   # ascontiguousarray promotes 0-d -> (1,)
                    arr = np.ascontiguousarray(arr)
                mem = _global(_NATIVE_BY_DTYPE[arr.dtype])
                tid = -1
            dims = (hsize_t * max(arr.ndim, 1))(*(arr.shape or (1,)))
            try:
                sid = (lib.H5Screate_simple(arr.ndim, dims, None)
                       if arr.ndim else lib.H5Screate(0))  # H5S_SCALAR
                aid = lib.H5Acreate2(oid, name.encode(), mem, sid,
                                     H5P_DEFAULT, H5P_DEFAULT)
                with _Handle(lib, sid, "H5Sclose"), \
                        _Handle(lib, aid, "H5Aclose"):
                    _check(hid_t(aid), f"H5Acreate2 {name}")
                    _check(lib.H5Awrite(aid, mem, arr.ctypes.data),
                           f"H5Awrite {name}")
            finally:
                if tid > 0:
                    lib.H5Tclose(tid)

    def close(self):
        if getattr(self, "_fid", -1) > 0:
            self._lib.H5Fclose(self._fid)
            self._fid = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
