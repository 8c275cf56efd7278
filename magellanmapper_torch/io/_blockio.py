"""Threaded block extraction from (memmapped) volumes, built at first use.

``g++`` compiles ``magellanmapper_torch/csrc/host/blockio.cpp`` (the
port's copy of the reference's ``native/blockio.cpp``) into
``build/host/`` (:mod:`._hostbuild`) and loads it with ``ctypes``.
:func:`extract_blocks` gathers ``(z, y, x)`` windows of a strided volume
into one contiguous float32 batch with worker threads, whose page faults
overlap. Where the reference's ``native.extract_blocks`` falls back to a
numpy loop, this raises: a failed build, a volume of a type outside
:data:`DTYPES`, a window outside the volume or a failed call.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from magellanmapper_torch.io import _hostbuild

_SRC = _hostbuild.SRC_DIR / "blockio.cpp"
_BUILD_DIR = _hostbuild.BUILD_DIR
#: the volume types the library reads, with their codes in blockio.cpp
DTYPES = {
    np.dtype(np.uint8): 0, np.dtype(np.uint16): 1,
    np.dtype(np.int16): 2, np.dtype(np.uint32): 3,
    np.dtype(np.int32): 4, np.dtype(np.float32): 5,
    np.dtype(np.float64): 6,
}
_I64 = ctypes.c_int64

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    return _hostbuild.library_path(_SRC, _BUILD_DIR)


def build() -> Path:
    """Compile the extractor unless a library for this source exists."""
    return _hostbuild.build(_SRC, _BUILD_DIR)


def library() -> ctypes.CDLL:
    """The loaded extractor library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.blockio_extract.restype = ctypes.c_int
            lib.blockio_extract.argtypes = [
                ctypes.c_void_p, ctypes.c_int, _I64, _I64, _I64,
                _I64, _I64, _I64, ctypes.POINTER(_I64), _I64,
                _I64, _I64, _I64, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int]
            _lib = lib
    return _lib


def extract_blocks(
        volume: np.ndarray, starts: np.ndarray,
        block_shape: Sequence[int],
        out: Optional[np.ndarray] = None,
        n_threads: Optional[int] = None) -> np.ndarray:
    """Gather ``(n, bz, by, bx)`` float32 blocks of the 3D ``volume`` at
    ``starts`` (``(n, 3)`` z, y, x, each window inside the volume) into
    ``out`` (a new array when None), with ``n_threads`` workers (default:
    the CPU count). Any strides, so views and memmaps pass as they are."""
    starts = np.ascontiguousarray(starts, dtype=np.int64).reshape(-1, 3)
    bz, by, bx = (int(v) for v in block_shape)
    n = len(starts)
    code = DTYPES.get(volume.dtype)
    if code is None or volume.ndim != 3:
        raise ValueError(
            f"extract_blocks reads 3D volumes of {sorted(map(str, DTYPES))}"
            f", not a {volume.ndim}D {volume.dtype} one")
    if n and (np.any(starts < 0) or np.any(
            starts + (bz, by, bx) > np.asarray(volume.shape))):
        raise ValueError(
            f"a window of {(bz, by, bx)} at {starts.tolist()} leaves the "
            f"volume of {volume.shape}")
    if out is None:
        out = np.empty((n, bz, by, bx), np.float32)
    elif (out.dtype != np.float32 or out.shape != (n, bz, by, bx)
          or not out.flags.c_contiguous):
        raise ValueError(
            f"out must be a C-contiguous float32 {(n, bz, by, bx)} array, "
            f"not a {out.dtype} {out.shape} one")
    rc = library().blockio_extract(
        volume.ctypes.data_as(ctypes.c_void_p), code,
        *[_I64(int(s)) for s in volume.shape],
        *[_I64(int(s)) for s in volume.strides],
        starts.ctypes.data_as(ctypes.POINTER(_I64)), _I64(n),
        _I64(bz), _I64(by), _I64(bx),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(n_threads or os.cpu_count() or 4))
    if rc != 0:
        raise RuntimeError(f"blockio_extract failed with code {rc}")
    return out
