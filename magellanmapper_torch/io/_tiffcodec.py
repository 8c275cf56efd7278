"""Native TIFF strip decoders (LZW, PackBits), built at first use.

``g++`` compiles ``magellanmapper_torch/csrc/host/tiffcodec.cpp`` (the
port's copy of the reference's ``native/tiffcodec.cpp``) into a shared
library under ``build/host/`` at the repository root, named after a hash
of the source and flags, and loads it with ``ctypes``. A failed build or
a stream the decoder rejects raises: nothing falls back to the Python
decoders of :mod:`magellanmapper_torch.io.tiff`, which are the plain
versions the tests hold these to.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from magellanmapper_torch.io import _hostbuild

_SRC = _hostbuild.SRC_DIR / "tiffcodec.cpp"
_BUILD_DIR = _hostbuild.BUILD_DIR
_ARGTYPES = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
             ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
             ctypes.POINTER(ctypes.c_int64)]
#: the decoders' return codes
_ERRORS = {-1: "corrupt stream", -2: "output past the page's size"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    return _hostbuild.library_path(_SRC, _BUILD_DIR)


def build() -> Path:
    """Compile the decoders unless a library for this source exists."""
    return _hostbuild.build(_SRC, _BUILD_DIR)


def library() -> ctypes.CDLL:
    """The loaded decoder library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name in ("tiff_lzw_decode", "tiff_packbits_decode"):
                fn = getattr(lib, name)
                fn.argtypes = _ARGTYPES
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _decode(fn_name: str, data: bytes, max_out: int) -> bytes:
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(int(max_out), np.uint8)
    out_len = ctypes.c_int64(0)
    rc = getattr(library(), fn_name)(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(data)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(int(max_out)), ctypes.byref(out_len))
    if rc != 0:
        raise ValueError(
            f"{fn_name}: {_ERRORS.get(rc, f'error {rc}')} (a strip of "
            f"{len(data)} bytes, at most {max_out} out)")
    return dst[:out_len.value].tobytes()


def lzw_decode(data: bytes, max_out: int) -> bytes:
    """TIFF-variant LZW decode in C++ into at most ``max_out`` bytes."""
    return _decode("tiff_lzw_decode", data, max_out)


def packbits_decode(data: bytes, max_out: int) -> bytes:
    """PackBits decode in C++ into at most ``max_out`` bytes."""
    return _decode("tiff_packbits_decode", data, max_out)
