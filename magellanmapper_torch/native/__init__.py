"""Native (C++) host runtime: threaded block extraction and the TIFF and
JPEG codecs, through ``ctypes``.

The reference's ``native`` module under its own names and parameters,
over the port's own libraries: :mod:`~magellanmapper_torch.io._blockio`,
:mod:`~magellanmapper_torch.io._tiffcodec` and
:mod:`~magellanmapper_torch.io._jpegcodec`, each compiled from
``csrc/host/`` into ``build/host/`` at first use. Nothing falls back:
where the reference returns None (a library that did not build or load, a
stream its decoder rejects) or gathers blocks in a numpy loop (a volume
type outside the library's table), these raise. :func:`available` and
:func:`jpeg_available` build and load their library at first use and
report whether that worked.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np

from magellanmapper_torch.io import _blockio, _jpegcodec, _tiffcodec

_logger = logging.getLogger(__name__)


def _loads(module) -> bool:
    try:
        module.library()
    except (RuntimeError, OSError) as exc:
        _logger.warning("%s: %s", module.__name__, exc)
        return False
    return True


def available() -> bool:
    """True when the block extractor builds and loads."""
    return _loads(_blockio)


def extract_blocks(
        volume: np.ndarray, starts: np.ndarray,
        block_shape: Sequence[int],
        out: Optional[np.ndarray] = None,
        n_threads: Optional[int] = None) -> np.ndarray:
    """Gather ``(n, bz, by, bx)`` float32 blocks of the 3D ``volume`` at
    ``starts``, each window inside the volume, with worker threads; raises
    on a volume type the library does not read."""
    return _blockio.extract_blocks(volume, starts, block_shape, out,
                                   n_threads)


def lzw_decode(data: bytes, max_out: int) -> bytes:
    """TIFF-variant LZW decode in C++ into at most ``max_out`` bytes;
    ``ValueError`` on a corrupt stream."""
    return _tiffcodec.lzw_decode(data, max_out)


def packbits_decode(data: bytes, max_out: int) -> bytes:
    """PackBits decode in C++ into at most ``max_out`` bytes;
    ``ValueError`` on a corrupt stream."""
    return _tiffcodec.packbits_decode(data, max_out)


def jpeg_available() -> bool:
    """True when the JPEG codec builds against the system libjpeg and
    loads."""
    return _loads(_jpegcodec)


def jpeg_decode(data: bytes) -> np.ndarray:
    """Decode a JFIF stream to ``(h, w)`` or ``(h, w, ncomp)`` uint8;
    ``ValueError`` on a bad stream."""
    return _jpegcodec.jpeg_decode(data)


def jpeg_encode(img: np.ndarray, quality: int = 95) -> bytes:
    """Encode ``(h, w)`` or ``(h, w, 3)`` uint8 to a JFIF stream."""
    return _jpegcodec.jpeg_encode(img, quality)
