"""``magellanmapper_torch.native`` against the reference's ``native``, on
the CPU: block extraction on every type of its table, the TIFF strip
decoders on the codec fixtures of ``test_torch_tiff``, the JPEG codec
(with the system libjpeg), and the recorded differences: where the
reference returns None (a stream its decoder rejects) or gathers in a
numpy loop (a type outside the table, a volume that is not 3D), the port
raises.

Tolerance: none. Both libraries cast to float32 in C++, as numpy's
``astype`` does, and run the same decoders.
"""

import ctypes.util

import numpy as np
import pytest

from magellanmapper_tpu import native as ref_native
from magellanmapper_tpu.io import tiff as ref_tiff
from magellanmapper_torch import native
from magellanmapper_torch.io import _blockio

SHAPE = (19, 33, 29)
BLOCK = (6, 11, 13)
NAMES = ("available", "extract_blocks", "lzw_decode", "packbits_decode",
         "jpeg_available", "jpeg_decode", "jpeg_encode")


def _volume(dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        vol = rng.normal(0, 1000, SHAPE)
        vol[0, 0, :3] = (np.inf, -np.inf, np.nan)
    else:
        info = np.iinfo(dtype)
        vol = rng.integers(info.min, info.max, SHAPE, endpoint=True,
                           dtype=np.int64 if info.max < 2**63 else None)
    return vol.astype(dtype)


def _starts(seed=1, n=7):
    rng = np.random.default_rng(seed)
    hi = np.asarray(SHAPE) - BLOCK
    starts = rng.integers(0, hi + 1, (n, 3))
    starts[0], starts[1] = 0, hi
    return starts


def test_the_reference_names_and_parameters():
    import inspect
    for name in NAMES:
        assert (list(inspect.signature(getattr(native, name)).parameters)
                == list(inspect.signature(
                    getattr(ref_native, name)).parameters)), name


def test_available_builds_and_loads():
    assert native.available() is True
    assert native.available() == ref_native.available()


@pytest.mark.parametrize("dtype", sorted(_blockio.DTYPES, key=str))
def test_extract_blocks_equals_the_reference(dtype):
    vol = _volume(dtype)
    starts = _starts()
    got = native.extract_blocks(vol, starts, BLOCK)
    want = ref_native.extract_blocks(vol, starts, BLOCK)
    assert got.shape == (len(starts),) + BLOCK and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_extract_blocks_into_out_with_threads():
    vol = _volume(np.uint16)[:, ::2, 1:]
    starts = np.asarray([[0, 0, 0], [3, 2, 5]])
    shape = (2, 4, 5, 6)
    got = np.empty(shape, np.float32)
    assert native.extract_blocks(vol, starts, shape[1:], got, 3) is got
    want = ref_native.extract_blocks(vol, starts, shape[1:],
                                     np.empty(shape, np.float32), 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vol", [
    np.zeros(SHAPE, np.int8), np.zeros(SHAPE, np.float16),
    np.zeros(SHAPE, bool)], ids=["int8", "float16", "bool"])
def test_extract_blocks_raises_where_the_reference_loops_in_numpy(vol):
    """Recorded difference: a type outside the library's table."""
    starts = _starts()
    want = ref_native.extract_blocks(vol, starts, BLOCK)
    assert want.shape == (len(starts),) + BLOCK
    with pytest.raises(ValueError, match="reads 3D volumes"):
        native.extract_blocks(vol, starts, BLOCK)


def _codec_data(kind, n, seed):
    """The codec fixtures of ``test_torch_tiff``."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "runs":
        vals = rng.integers(0, 4, n // 37 + 1, dtype=np.uint8)
        return np.repeat(vals, 37)[:n].tobytes()
    img = (np.arange(n // 2) // 50 + rng.normal(300, 20, n // 2)).astype(
        np.uint16)
    return img.tobytes()


@pytest.mark.parametrize("n", [1, 255, 4099, 60000])
@pytest.mark.parametrize("kind", ["noise", "runs", "image"])
def test_strip_decoders_equal_the_reference(kind, n):
    data = _codec_data(kind, n, seed=n)
    lzw = ref_tiff.lzw_encode(data)
    packed = ref_tiff.packbits_encode(data)
    for max_out in (len(data), len(data) + 16):
        assert (native.lzw_decode(lzw, max_out)
                == ref_native.lzw_decode(lzw, max_out) == data)
        assert (native.packbits_decode(packed, max_out)
                == ref_native.packbits_decode(packed, max_out) == data)


@pytest.mark.parametrize("fn,stream,max_out,match", [
    ("lzw_decode", bytes([0x80, 0x10, 0x65, 0x80]), 100, "corrupt"),
    ("packbits_decode", bytes([0x81, 7]), 10, "past the page"),
])
def test_strip_decoders_raise_where_the_reference_returns_none(
        fn, stream, max_out, match):
    """Recorded difference: a stream the decoder rejects."""
    assert getattr(ref_native, fn)(stream, max_out) is None
    with pytest.raises(ValueError, match=match):
        getattr(native, fn)(stream, max_out)


@pytest.fixture
def libjpeg():
    if ctypes.util.find_library("jpeg") is None:
        pytest.skip("no system libjpeg: the JPEG codec cannot be built")
    assert native.jpeg_available() and ref_native.jpeg_available()


@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("shape", [(8, 16), (17, 23, 3)])
def test_jpeg_codec_equals_the_reference(libjpeg, shape, quality):
    img = np.random.default_rng(3).integers(0, 255, shape, dtype=np.uint8)
    enc = native.jpeg_encode(img, quality)
    assert enc == ref_native.jpeg_encode(img, quality)
    got = native.jpeg_decode(enc)
    assert got.shape == shape
    np.testing.assert_array_equal(got, ref_native.jpeg_decode(enc))


def test_jpeg_default_quality_and_corrupt_stream(libjpeg):
    img = np.full((8, 8), 77, np.uint8)
    assert native.jpeg_encode(img) == ref_native.jpeg_encode(img)
    for codec in (native, ref_native):
        with pytest.raises(ValueError, match="corrupt"):
            codec.jpeg_decode(b"not a jpeg stream")


def test_jpeg_raises_where_the_reference_returns_none(monkeypatch, tmp_path):
    """Recorded difference: without its library (here: no compiler) the
    reference's codec returns None; the port's build raises by name and
    ``jpeg_available`` reports False."""
    from magellanmapper_torch.io import _hostbuild, _jpegcodec

    monkeypatch.setattr(_jpegcodec, "_lib", None)
    monkeypatch.setattr(_jpegcodec, "_BUILD_DIR", tmp_path / "nobuild")
    monkeypatch.setattr(_hostbuild.shutil, "which", lambda name: None)
    assert native.jpeg_available() is False
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        native.jpeg_encode(np.zeros((4, 4), np.uint8))
    monkeypatch.setattr(ref_native, "_jpeg_lib", None)
    monkeypatch.setattr(ref_native, "_JPEG_LIB_PATH",
                        str(tmp_path / "none.so"))
    monkeypatch.setattr(ref_native.os.path, "exists", lambda p: False)
    monkeypatch.setattr("subprocess.run", lambda *a, **k: None)
    assert ref_native.jpeg_encode(np.zeros((4, 4), np.uint8)) is None


def test_native_imports_no_jax():
    import subprocess
    import sys
    code = ("import sys; import magellanmapper_torch.native as n; "
            "assert n.available(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'magellanmapper_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True)
