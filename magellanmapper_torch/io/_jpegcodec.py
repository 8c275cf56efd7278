"""Native JPEG codec over the system libjpeg, built at first use.

``g++`` compiles ``magellanmapper_torch/csrc/host/jpegcodec.cpp`` (the
port's copy of the reference's ``native/jpegcodec.cpp``) with ``-ljpeg``
into ``build/host/`` (:mod:`._hostbuild`) and loads it with ``ctypes``.
CZI subblocks of compression id 1 are baseline JFIF streams
(:mod:`.czi_lif`). Where the reference's ``native.jpeg_decode`` returns
None without its library, these raise: a missing compiler, libjpeg or
``jpeglib.h`` fails the build by name, and a stream libjpeg rejects
raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from magellanmapper_torch.io import _hostbuild

_SRC = _hostbuild.SRC_DIR / "jpegcodec.cpp"
_BUILD_DIR = _hostbuild.BUILD_DIR
LIBS = ("-ljpeg",)
NEEDS = "libjpeg and its header jpeglib.h"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    return _hostbuild.library_path(_SRC, _BUILD_DIR, LIBS)


def build() -> Path:
    """Compile the codec unless a library for this source exists."""
    return _hostbuild.build(_SRC, _BUILD_DIR, LIBS, NEEDS)


def library() -> ctypes.CDLL:
    """The loaded codec, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.jpegcodec_info.restype = ctypes.c_int
            lib.jpegcodec_info.argtypes = [
                _U8P, ctypes.c_ulong, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.jpegcodec_decode.restype = ctypes.c_long
            lib.jpegcodec_decode.argtypes = [
                _U8P, ctypes.c_ulong, _U8P, ctypes.c_ulong]
            lib.jpegcodec_encode.restype = ctypes.c_long
            lib.jpegcodec_encode.argtypes = [
                _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, _U8P, ctypes.c_ulong]
            _lib = lib
    return _lib


def jpeg_decode(data: bytes) -> np.ndarray:
    """Decode a JFIF stream to ``(h, w)`` or ``(h, w, ncomp)`` uint8;
    ``ValueError`` on a bad stream."""
    lib = library()
    src = np.frombuffer(data, np.uint8)
    sp = src.ctypes.data_as(_U8P)
    w, h, nc = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    if lib.jpegcodec_info(sp, len(data), ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(nc)) != 0:
        raise ValueError("corrupt JPEG stream")
    dst = np.empty(h.value * w.value * nc.value, np.uint8)
    n = lib.jpegcodec_decode(sp, len(data), dst.ctypes.data_as(_U8P),
                             dst.size)
    if n != dst.size:
        raise ValueError("JPEG decode failed")
    return (dst.reshape(h.value, w.value) if nc.value == 1
            else dst.reshape(h.value, w.value, nc.value))


def jpeg_encode(img: np.ndarray, quality: int = 95) -> bytes:
    """Encode ``(h, w)`` or ``(h, w, 3)`` uint8 to a JFIF stream."""
    lib = library()
    img = np.ascontiguousarray(img, np.uint8)
    ncomp = 1 if img.ndim == 2 else img.shape[2]
    cap = img.size + (1 << 16)
    dst = np.empty(cap, np.uint8)
    n = lib.jpegcodec_encode(
        img.ctypes.data_as(_U8P), img.shape[1], img.shape[0], ncomp,
        quality, dst.ctypes.data_as(_U8P), cap)
    if n < 0:
        raise ValueError("JPEG encode failed")
    return dst[:n].tobytes()
