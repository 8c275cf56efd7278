"""JPEG 2000 codec via ctypes over the system ``libopenjp2``.

Copy of ``magellanmapper_tpu/io/jp2k.py``. Legacy (pre-chunk-map) Nikon
ND2 files are JP2 containers whose frames live in ``jp2c`` codestream
boxes; the upstream MagellanMapper decodes them through Bioformats on a
JVM (``magmap/io/importer.py:97-156``). This binds the shared library
``libopenjp2`` (2.x) without its headers: its decode surface is almost
entirely opaque handles — only ``opj_image_t``/``opj_image_comp_t``
cross the ABI, declared here field-for-field from the public 2.x API.
Without the library, :func:`decode` and :func:`encode` raise
``ImportError`` naming it.

The encoder exists to build test fixtures (codestreams produced by the
reference C library, never by this module's own decode path) and for
export. ``opj_cparameters_t`` is a large version-sensitive struct, so
it is handled as an oversized zeroed buffer initialised by
``opj_set_default_encoder_parameters``; the three fields an encode
must set are located structurally:

 - ``cp_disto_alloc`` sits at byte 20 — the struct opens with eight
   ints (``tile_size_on``, four tile scalars, then the three
   allocation flags) before any pointer, fixed across 2.x;
 - ``tcp_numlayers`` is found by probing for its neighbourhood: it is
   the int directly before ``tcp_rates[100]`` + ``tcp_distoratio[100]``
   (800 zero bytes after defaults) followed by ``numresolution=6``,
   ``cblockw_init=64``, ``cblockh_init=64``. The probe demands exactly
   one candidate or encoding reports unavailable — it never guesses.
"""

from __future__ import annotations

import ctypes as C
import ctypes.util
import os
import struct
import tempfile
from typing import Optional, Tuple

import numpy as np

OPJ_CODEC_J2K = 0
OPJ_CODEC_JP2 = 2
OPJ_CLRSPC_GRAY = 2

#: 12-byte JP2 signature box (ISO 15444-1 I.5.1)
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
#: raw codestream magic (SOC + SIZ marker)
J2K_SOC = b"\xff\x4f\xff\x51"


class ImageComp(C.Structure):
    """opj_image_comp_t (openjpeg 2.x public API)."""
    _fields_ = [("dx", C.c_uint32), ("dy", C.c_uint32),
                ("w", C.c_uint32), ("h", C.c_uint32),
                ("x0", C.c_uint32), ("y0", C.c_uint32),
                ("prec", C.c_uint32), ("bpp", C.c_uint32),
                ("sgnd", C.c_uint32), ("resno_decoded", C.c_uint32),
                ("factor", C.c_uint32),
                ("data", C.POINTER(C.c_int32)), ("alpha", C.c_uint16)]


class Image(C.Structure):
    """opj_image_t (openjpeg 2.x public API)."""
    _fields_ = [("x0", C.c_uint32), ("y0", C.c_uint32),
                ("x1", C.c_uint32), ("y1", C.c_uint32),
                ("numcomps", C.c_uint32), ("color_space", C.c_int),
                ("comps", C.POINTER(ImageComp)),
                ("icc_profile_buf", C.c_void_p),
                ("icc_profile_len", C.c_uint32)]


class CmptParm(C.Structure):
    """opj_image_cmptparm_t."""
    _fields_ = [(n, C.c_uint32) for n in
                ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp",
                 "sgnd")]


_SIGS = {
    "opj_create_compress": (C.c_void_p, [C.c_int]),
    "opj_create_decompress": (C.c_void_p, [C.c_int]),
    "opj_set_default_encoder_parameters": (None, [C.c_void_p]),
    "opj_set_default_decoder_parameters": (None, [C.c_void_p]),
    "opj_image_create": (
        C.POINTER(Image), [C.c_uint32, C.POINTER(CmptParm), C.c_int]),
    "opj_image_destroy": (None, [C.POINTER(Image)]),
    "opj_setup_encoder": (
        C.c_int, [C.c_void_p, C.c_void_p, C.POINTER(Image)]),
    "opj_setup_decoder": (C.c_int, [C.c_void_p, C.c_void_p]),
    "opj_stream_create_default_file_stream": (
        C.c_void_p, [C.c_char_p, C.c_int]),
    "opj_stream_destroy": (None, [C.c_void_p]),
    "opj_start_compress": (
        C.c_int, [C.c_void_p, C.POINTER(Image), C.c_void_p]),
    "opj_encode": (C.c_int, [C.c_void_p, C.c_void_p]),
    "opj_end_compress": (C.c_int, [C.c_void_p, C.c_void_p]),
    "opj_read_header": (
        C.c_int, [C.c_void_p, C.c_void_p,
                  C.POINTER(C.POINTER(Image))]),
    "opj_decode": (C.c_int, [C.c_void_p, C.c_void_p,
                             C.POINTER(Image)]),
    "opj_end_decompress": (C.c_int, [C.c_void_p, C.c_void_p]),
    "opj_destroy_codec": (None, [C.c_void_p]),
}

_CP_DISTO_ALLOC_OFF = 20
_ENC_PARAMS_BYTES = 1 << 16
_DEC_PARAMS_BYTES = 1 << 14

_lib = None
_lib_tried = False
_numlayers_off: Optional[int] = None


def _load() -> Optional[C.CDLL]:
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    path = ctypes.util.find_library("openjp2")
    for cand in ([path] if path else []) + ["libopenjp2.so.7",
                                            "libopenjp2.so"]:
        try:
            lib = C.CDLL(cand)
            lib.opj_version.restype = C.c_char_p
            lib.opj_version()
        except (OSError, AttributeError):
            continue
        for name, (res, args) in _SIGS.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.restype, fn.argtypes = res, args
        _lib = lib
        return _lib
    return None


def available() -> bool:
    """True when a bindable libopenjp2 exists."""
    return _load() is not None


def _probe_numlayers_offset(lib) -> int:
    """Locate ``tcp_numlayers`` in the defaults buffer (see module
    docstring); raises when the layout is not the expected 2.x one."""
    global _numlayers_off
    if _numlayers_off is not None:
        return _numlayers_off
    buf = (C.c_char * _ENC_PARAMS_BYTES)()
    lib.opj_set_default_encoder_parameters(buf)
    raw = bytes(buf)
    ints = np.frombuffer(raw, np.int32)
    cands = [
        4 * i for i in range(300, _ENC_PARAMS_BYTES // 4 - 3)
        if ints[i] == 6 and ints[i + 1] == 64 and ints[i + 2] == 64
        and not raw[4 * i - 804:4 * i].strip(b"\x00")]
    if len(cands) != 1:
        raise RuntimeError(
            f"libopenjp2 cparameters layout probe found {len(cands)} "
            "candidates; JPEG 2000 encoding unavailable on this "
            "library build")
    _numlayers_off = cands[0] - 804
    return _numlayers_off


def _codec_for(data: bytes) -> int:
    if data[:12] == JP2_SIGNATURE:
        return OPJ_CODEC_JP2
    if data[:2] == J2K_SOC[:2]:    # SOC marker opens a raw codestream
        return OPJ_CODEC_J2K
    raise ValueError("not a JPEG 2000 codestream or JP2 container")


def _comp_dtype(prec: int, sgnd: int) -> np.dtype:
    if prec <= 8:
        return np.dtype(np.int8 if sgnd else np.uint8)
    if prec <= 16:
        return np.dtype(np.int16 if sgnd else np.uint16)
    return np.dtype(np.int32)


def decode(data: bytes) -> np.ndarray:
    """Decode a J2K codestream or JP2 container to ``(h, w)`` or
    ``(h, w, ncomp)``; dtype follows the codestream precision."""
    lib = _load()
    if lib is None:
        raise ImportError("no system libopenjp2 found")
    fmt = _codec_for(data)
    # libopenjp2's zero-callback path is its file stream; spill the
    # buffer to a temp file rather than re-implement the stream ABI
    fd, tmp = tempfile.mkstemp(suffix=".j2k")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        dparams = (C.c_char * _DEC_PARAMS_BYTES)()
        lib.opj_set_default_decoder_parameters(dparams)
        codec = lib.opj_create_decompress(fmt)
        stream = None
        pimg = C.POINTER(Image)()
        try:
            if not lib.opj_setup_decoder(codec, dparams):
                raise ValueError("opj_setup_decoder failed")
            stream = lib.opj_stream_create_default_file_stream(
                tmp.encode(), 1)
            if not stream:
                raise ValueError("opj stream creation failed")
            if not lib.opj_read_header(stream, codec, C.byref(pimg)):
                raise ValueError("corrupt JPEG 2000 stream (header)")
            if not lib.opj_decode(codec, stream, pimg):
                raise ValueError("corrupt JPEG 2000 stream (body)")
            lib.opj_end_decompress(codec, stream)
            im = pimg.contents
            ncomp = im.numcomps
            planes = []
            for ci in range(ncomp):
                comp = im.comps[ci]
                n = comp.w * comp.h
                vals = np.ctypeslib.as_array(comp.data, shape=(n,))
                planes.append(vals.reshape(comp.h, comp.w).astype(
                    _comp_dtype(comp.prec, comp.sgnd)))
            out = (planes[0] if ncomp == 1
                   else np.stack(planes, axis=-1))
        finally:
            if pimg:
                lib.opj_image_destroy(pimg)
            if stream:
                lib.opj_stream_destroy(stream)
            lib.opj_destroy_codec(codec)
    finally:
        os.unlink(tmp)
    return out


def encode(img: np.ndarray, codec_format: int = OPJ_CODEC_J2K,
           num_resolutions: Optional[int] = None) -> bytes:
    """Encode a 2D (or ``(h, w, c)``) integer image losslessly;
    returns the raw codestream (J2K) or JP2 container bytes."""
    lib = _load()
    if lib is None:
        raise ImportError("no system libopenjp2 found")
    nl_off = _probe_numlayers_offset(lib)
    img = np.asarray(img)
    if img.dtype.kind not in "iu" or img.dtype.itemsize > 2:
        raise ValueError(
            f"JPEG 2000 encode needs <=16-bit integer samples, got "
            f"{img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ncomp = img.shape
    prec = img.dtype.itemsize * 8
    sgnd = 1 if img.dtype.kind == "i" else 0
    params = (C.c_char * _ENC_PARAMS_BYTES)()
    lib.opj_set_default_encoder_parameters(params)
    one = C.c_int32(1)
    C.memmove(C.addressof(params) + _CP_DISTO_ALLOC_OFF,
              C.byref(one), 4)          # cp_disto_alloc = 1
    C.memmove(C.addressof(params) + nl_off, C.byref(one), 4)
    # tcp_rates[0] stays 0.0 -> lossless 5/3 wavelet
    if num_resolutions is not None:
        # numresolution sits right after the rates/distoratio arrays
        C.memmove(C.addressof(params) + nl_off + 804,
                  C.byref(C.c_int32(num_resolutions)), 4)
    parms = (CmptParm * ncomp)(*[
        CmptParm(1, 1, w, h, 0, 0, prec, 0, sgnd)
        for _ in range(ncomp)])
    image = lib.opj_image_create(ncomp, parms, OPJ_CLRSPC_GRAY)
    if not image:
        raise ValueError("opj_image_create failed")
    fd, tmp = tempfile.mkstemp(suffix=".j2k")
    os.close(fd)
    try:
        im = image.contents
        im.x0, im.y0, im.x1, im.y1 = 0, 0, w, h
        for ci in range(ncomp):
            np.ctypeslib.as_array(
                im.comps[ci].data, shape=(h * w,))[:] = (
                img[:, :, ci].astype(np.int32).reshape(-1))
        codec = lib.opj_create_compress(codec_format)
        stream = None
        try:
            if not lib.opj_setup_encoder(codec, params, image):
                raise ValueError("opj_setup_encoder failed")
            stream = lib.opj_stream_create_default_file_stream(
                tmp.encode(), 0)
            if not stream:
                raise ValueError("opj stream creation failed")
            if not (lib.opj_start_compress(codec, image, stream)
                    and lib.opj_encode(codec, stream)
                    and lib.opj_end_compress(codec, stream)):
                raise ValueError("JPEG 2000 encode failed")
        finally:
            if stream:
                lib.opj_stream_destroy(stream)
            lib.opj_destroy_codec(codec)
        with open(tmp, "rb") as f:
            return f.read()
    finally:
        lib.opj_image_destroy(image)
        os.unlink(tmp)
