"""The port's TIFF codec (``magellanmapper_torch.io.tiff``) against the
reference's: the same arrays write byte-identical files, the same files
(baseline and BigTIFF, either byte order, strips, the predictor, every
compression) read to equal arrays, descriptions and lazy pages, and the
native LZW/PackBits decoders equal their Python plain versions."""

import filecmp
import struct
import zlib

import numpy as np
import pytest

from magellanmapper_tpu.io import tiff as ref_tiff
from magellanmapper_torch.io import _hostbuild, _tiffcodec, tiff

_DTYPES = [np.uint8, np.uint16, np.int16, np.uint32, np.int32, np.float32,
           np.float64]
_COMPRESSIONS = [None, "deflate", "lzw", "packbits"]


def _array(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.normal(0, 100, shape).astype(dtype)
    info = np.iinfo(dtype)
    # runs and repeats as well as noise, so every codec has work
    arr = rng.integers(max(info.min, -1000), min(info.max, 4000), shape)
    arr[:, :3] = 7
    return arr.astype(dtype)


@pytest.mark.parametrize("compression", _COMPRESSIONS)
@pytest.mark.parametrize("dtype", _DTYPES)
def test_write_tiff_bytes_equal_reference(tmp_path, dtype, compression):
    arr = _array(dtype, (3, 20, 24), seed=len(str(compression)))
    got, want = str(tmp_path / "port.tif"), str(tmp_path / "ref.tif")
    tiff.write_tiff(got, arr, compression=compression)
    ref_tiff.write_tiff(want, arr, compression=compression)
    assert filecmp.cmp(got, want, shallow=False)
    back = tiff.read_tiff(got)
    np.testing.assert_array_equal(back, ref_tiff.read_tiff(want))
    np.testing.assert_array_equal(back, arr.astype(back.dtype))


@pytest.mark.parametrize("description", [
    None, "abc", "hello tiff",
    '<?xml version="1.0"?><OME><Image><Pixels SizeX="24" SizeY="20" '
    'SizeZ="3" SizeC="1" SizeT="1" DimensionOrder="XYZCT"/></Image></OME>'])
def test_descriptions_write_and_read_as_the_reference(tmp_path, description):
    arr = _array(np.uint16, (3, 20, 24), seed=1)
    got, want = str(tmp_path / "port.tif"), str(tmp_path / "ref.tif")
    tiff.write_tiff(got, arr, compression="packbits",
                    description=description)
    ref_tiff.write_tiff(want, arr, compression="packbits",
                        description=description)
    assert filecmp.cmp(got, want, shallow=False)
    out, desc = tiff.read_tiff(got, return_description=True)
    ref_out, ref_desc = ref_tiff.read_tiff(got, return_description=True)
    np.testing.assert_array_equal(out, ref_out)
    assert desc == ref_desc == description


def test_single_page_reads_as_2d(tmp_path):
    arr = _array(np.uint8, (16, 18), seed=2)
    path = str(tmp_path / "plane.tif")
    tiff.write_tiff(path, arr)
    back = tiff.read_tiff(path)
    assert back.shape == (16, 18)
    np.testing.assert_array_equal(back, ref_tiff.read_tiff(path))


# -- files the writer does not make: BigTIFF, big endian, strips, predictor

def _encode(data: bytes, comp: int) -> bytes:
    if comp == tiff.COMP_NONE:
        return data
    if comp in (tiff.COMP_DEFLATE, tiff.COMP_DEFLATE_ADOBE):
        return zlib.compress(data)
    if comp == tiff.COMP_LZW:
        return tiff.lzw_encode(data)
    return tiff.packbits_encode(data)


def _write_general(path, pages, big=False, order="<", rows_per_strip=None,
                   comp=tiff.COMP_NONE, predictor=1):
    """A TIFF of ``pages`` (``(n, h, w)`` or ``(n, h, w, spp)``) in any
    byte order, baseline or BigTIFF, in strips of ``rows_per_strip``, with
    the horizontal-differencing predictor when ``predictor`` is 2."""
    pages = np.asarray(pages)
    n, h, w = pages.shape[:3]
    spp = pages.shape[3] if pages.ndim == 4 else 1
    dt = pages.dtype
    sfmt = {"u": 1, "i": 2, "f": 3}[dt.kind]
    rows = rows_per_strip or h
    out = bytearray(b"II" if order == "<" else b"MM")
    if big:
        out += struct.pack(order + "HHHQ", 43, 8, 0, 0)
        link = 8
    else:
        out += struct.pack(order + "HI", 42, 0)
        link = 4
    for page in pages:
        if predictor == 2:
            axis = 1 if page.ndim == 3 else -1
            page = np.diff(page, axis=axis, prepend=np.zeros_like(
                np.take(page, [0], axis=axis)))
        raw = np.ascontiguousarray(page).astype(dt.newbyteorder(order))
        offsets, counts = [], []
        for r0 in range(0, h, rows):
            strip = _encode(raw[r0:r0 + rows].tobytes(), comp)
            offsets.append(len(out))
            counts.append(len(strip))
            out += strip
        if len(out) % 2:
            out += b"\0"
        # strip arrays past 1 entry live outside the IFD
        big_fmt = "Q" if big else "I"
        arrays = {}
        for tag, vals in ((273, offsets), (279, counts)):
            if len(vals) > 1:
                arrays[tag] = len(out)
                out += struct.pack(order + big_fmt * len(vals), *vals)
        typ_long = 16 if big else 4
        entries = [
            (256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, dt.itemsize * 8),
            (259, 3, 1, comp), (262, 3, 1, 1),
            (273, typ_long, len(offsets), arrays.get(273, offsets[0])),
            (277, 3, 1, spp), (278, 4, 1, rows),
            (279, typ_long, len(counts), arrays.get(279, counts[0])),
            (317, 3, 1, predictor), (339, 3, 1, sfmt)]
        ifd = len(out)
        out += struct.pack(order + ("Q" if big else "H"), len(entries))
        for tag, typ, count, val in entries:
            out += struct.pack(order + "HH" + big_fmt, tag, typ, count)
            # a single value sits left-justified in the entry's field;
            # several are an offset
            fmt = {3: "H", 4: "I", 16: "Q"}[typ] if count == 1 else big_fmt
            field = struct.pack(order + fmt, val)
            out += field + b"\0" * ((8 if big else 4) - len(field))
        struct.pack_into(order + big_fmt, out, link, ifd)
        link = len(out)
        out += struct.pack(order + big_fmt, 0)
    with open(path, "wb") as f:
        f.write(bytes(out))


@pytest.mark.parametrize("comp", [tiff.COMP_NONE, tiff.COMP_DEFLATE,
                                  tiff.COMP_LZW, tiff.COMP_PACKBITS])
@pytest.mark.parametrize("big,order,rows,predictor,dtype", [
    (False, "<", None, 1, np.uint16),
    (False, ">", 7, 1, np.float32),
    (True, "<", 5, 2, np.uint16),
    (True, ">", None, 2, np.int16),
    (False, "<", 3, 2, np.uint8),
])
def test_general_files_read_as_the_reference(tmp_path, comp, big, order,
                                             rows, predictor, dtype):
    pages = _array(dtype, (3, 19, 23), seed=rows or 0)
    path = str(tmp_path / "general.tif")
    _write_general(path, pages, big=big, order=order, rows_per_strip=rows,
                   comp=comp, predictor=predictor)
    got = tiff.read_tiff(path)
    np.testing.assert_array_equal(got, ref_tiff.read_tiff(path))
    np.testing.assert_array_equal(got, pages)
    stack, ref_stack = tiff.LazyTiffStack(path), ref_tiff.LazyTiffStack(path)
    assert stack.shape == ref_stack.shape and stack.dtype == ref_stack.dtype
    np.testing.assert_array_equal(stack.asarray(), ref_stack.asarray())


def test_multisample_predictor_reads_as_the_reference(tmp_path):
    pages = _array(np.uint16, (2, 9, 11, 3), seed=4)
    path = str(tmp_path / "rgb.tif")
    _write_general(path, pages, comp=tiff.COMP_LZW, predictor=2,
                   rows_per_strip=4)
    np.testing.assert_array_equal(tiff.read_tiff(path),
                                  ref_tiff.read_tiff(path))
    np.testing.assert_array_equal(tiff.read_tiff(path), pages)


@pytest.mark.parametrize("compression", _COMPRESSIONS)
def test_lazy_pages_equal_reference(tmp_path, compression):
    arr = _array(np.uint16, (6, 20, 24), seed=5)
    path = str(tmp_path / "lazy.tif")
    tiff.write_tiff(path, arr, compression=compression)
    got, want = tiff.LazyTiffStack(path), ref_tiff.LazyTiffStack(path)
    assert got.shape == want.shape == arr.shape and len(got) == 6
    assert got.dtype == want.dtype
    for key in (2, slice(1, 5), slice(None, None, 2), (3, slice(2, 9)),
                (slice(0, 4), slice(None), slice(5, 7))):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got.asarray(), arr)


@pytest.mark.parametrize("predictor,shape,dtype", [
    (1, (4, 5), np.uint16), (2, (4, 5), np.uint16), (2, (4, 5, 3), np.uint8),
    (2, (3, 6), np.int16)])
def test_unpredict_copy(predictor, shape, dtype):
    page = _array(dtype, shape, seed=6)
    np.testing.assert_array_equal(tiff._unpredict(page, predictor),
                                  ref_tiff._unpredict(page, predictor))


@pytest.mark.parametrize("predictor,dtype", [(3, np.uint16),
                                             (2, np.float32)])
def test_unpredict_rejects_as_the_reference(predictor, dtype):
    page = np.ones((3, 4), dtype)
    with pytest.raises(ValueError):
        ref_tiff._unpredict(page, predictor)
    with pytest.raises(ValueError):
        tiff._unpredict(page, predictor)


# -- codecs ------------------------------------------------------------------

def _codec_data(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "runs":
        vals = rng.integers(0, 4, n // 37 + 1, dtype=np.uint8)
        return np.repeat(vals, 37)[:n].tobytes()
    # image-like: 16-bit noise over a slow ramp
    img = (np.arange(n // 2) // 50 + rng.normal(300, 20, n // 2)).astype(
        np.uint16)
    return img.tobytes()


@pytest.mark.parametrize("n", [1, 2, 255, 4099, 60000])
@pytest.mark.parametrize("kind", ["noise", "runs", "image"])
def test_codecs_equal_reference_and_native_equals_python(kind, n):
    data = _codec_data(kind, n, seed=n)
    lzw = tiff.lzw_encode(data)
    assert lzw == ref_tiff.lzw_encode(data)
    packed = tiff.packbits_encode(data)
    assert packed == ref_tiff.packbits_encode(data)
    assert tiff.lzw_decode(lzw) == ref_tiff.lzw_decode(lzw) == data
    assert tiff.packbits_decode(packed) == ref_tiff.packbits_decode(
        packed) == data
    assert _tiffcodec.lzw_decode(lzw, len(data)) == data
    assert _tiffcodec.packbits_decode(packed, len(data)) == data


def test_lzw_of_a_long_strip_is_linear_and_equal():
    """The reference's LZW coders keep every bit of the stream in one
    Python integer, so their time grows with its square (a 785 KB page
    takes about a minute); the port's keep the unread bits only and give
    the same bytes. Past 4,094 codes the tables clear, several times
    here."""
    data = _codec_data("image", 200000, seed=7)
    lzw = tiff.lzw_encode(data)
    assert tiff.lzw_decode(lzw) == data
    assert _tiffcodec.lzw_decode(lzw, len(data)) == data
    head = data[:30000]
    assert tiff.lzw_encode(head) == ref_tiff.lzw_encode(head)


def test_corrupt_streams_raise_as_the_reference():
    # clear, "A", then code 300: past the table
    stream = bytes([0x80, 0x10, 0x65, 0x80])
    with pytest.raises(ValueError):
        ref_tiff.lzw_decode(stream)
    with pytest.raises(ValueError):
        tiff.lzw_decode(stream)
    with pytest.raises(ValueError, match="corrupt"):
        _tiffcodec.lzw_decode(stream, 100)
    with pytest.raises(ValueError, match="past the page"):
        _tiffcodec.packbits_decode(bytes([0x81, 7]), 10)


def test_no_python_fallback_when_the_build_fails(tmp_path, monkeypatch):
    arr = _array(np.uint16, (2, 8, 9), seed=8)
    path = str(tmp_path / "lzw.tif")
    tiff.write_tiff(path, arr, compression="lzw")
    monkeypatch.setattr(_tiffcodec, "_lib", None)
    monkeypatch.setattr(_tiffcodec, "_BUILD_DIR", tmp_path / "nobuild")
    monkeypatch.setattr(_hostbuild.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        tiff.read_tiff(path)
    # uncompressed and deflate strips need no native code
    tiff.write_tiff(path, arr, compression="deflate")
    np.testing.assert_array_equal(tiff.read_tiff(path), arr)


def test_native_library_builds_under_build_host():
    path = _tiffcodec.build()
    assert path.exists() and path.parent.name == "host"
    assert path.parent.parent.name == "build"
    assert path == _tiffcodec.library_path()
