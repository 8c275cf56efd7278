"""The port's CZI and LIF readers and writers against the reference's.

Every file is read by both packages: arrays equal exactly (dtype and
values), metadata equal, and where the reference raises, the port raises
the same exception type with the same message. Files are built byte by
byte from the ZISRAW and LIF layouts (``testing.czi_*``, copies of the
reference tests' builders), and each package's writer is read by the
other's reader; the writers' bytes are equal. JPEG subblocks need the
system libjpeg (skipped by name without it), Zstd ones ``libzstd``.
"""

import ctypes.util
import struct
import zlib

import numpy as np
import pytest

from magellanmapper_torch import testing
from magellanmapper_torch.io import czi_lif, importer
from magellanmapper_torch.io import np_io
from magellanmapper_tpu.io import czi_lif as ref_czi_lif
from magellanmapper_tpu.io import importer as ref_importer
from magellanmapper_tpu.io import np_io as ref_np_io

seg, sub = testing.czi_segment, testing.czi_subblock
FILE_SEG = seg(b"ZISRAWFILE", b"\x00" * 512)
DIMS_2x4x4 = [(b"C", 0, 1), (b"Z", 0, 2), (b"Y", 0, 4), (b"X", 0, 4)]
SCALING_XML = (
    b"<ImageDocument><Metadata><Scaling><Items>"
    b'<Distance Id="Z"><Value>2e-06</Value></Distance>'
    b'<Distance Id="Y"><Value>5e-07</Value></Distance>'
    b'<Distance Id="X"><Value>5e-07</Value></Distance>'
    b"</Items></Scaling></Metadata></ImageDocument>")

needs_zstd = pytest.mark.skipif(
    ctypes.util.find_library("zstd") is None, reason="no system libzstd")


def _hilo(raw: bytes) -> bytes:
    words = np.frombuffer(raw, np.uint8)
    return np.concatenate([words[0::2], words[1::2]]).tobytes()


def _czi_files():
    """``{name: bytes}`` of hand-built CZI segment streams, each a case
    the reference's tests pin (read or raise)."""
    rng = np.random.default_rng(0)
    left = rng.integers(0, 60000, (2, 4, 3), dtype=np.uint16)
    right = rng.integers(0, 60000, (2, 4, 5), dtype=np.uint16)
    base = np.arange(32, dtype=np.uint16).reshape(2, 4, 4)
    lvl = np.zeros((2, 2, 2), np.uint16)
    small = np.arange(15, dtype=np.uint16).reshape(1, 3, 5)
    hilo = rng.integers(0, 65535, (2, 4, 4), dtype=np.uint16)
    two_c = rng.integers(0, 255, (2, 2, 3, 4), dtype=np.uint8)
    f32 = rng.random((1, 3, 4), dtype=np.float32)
    files = {
        "mosaic": FILE_SEG
        + seg(b"ZISRAWMETADATA", testing.czi_metadata(SCALING_XML))
        + seg(b"ZISRAWSUBBLOCK", sub(left[None].tobytes(), [
            (b"C", 0, 1), (b"Z", 0, 2), (b"Y", 0, 4), (b"X", 0, 3)]))
        + seg(b"ZISRAWSUBBLOCK", sub(right[None].tobytes(), [
            (b"C", 0, 1), (b"Z", 0, 2), (b"Y", 0, 4), (b"X", 3, 5)])),
        "pyramid": FILE_SEG
        + seg(b"ZISRAWSUBBLOCK", sub(base[None].tobytes(), DIMS_2x4x4))
        + seg(b"ZISRAWSUBBLOCK", sub(lvl[None].tobytes(), DIMS_2x4x4,
                                     pyramid_type=1,
                                     stored_override={"Y": 2, "X": 2}))
        + seg(b"ZISRAWSUBBLOCK", sub(lvl[None].tobytes(), DIMS_2x4x4,
                                     stored_override={"Y": 2, "X": 2})),
        "zlib": FILE_SEG + seg(b"ZISRAWSUBBLOCK", sub(
            zlib.compress(small[None].tobytes()),
            [(b"C", 0, 1), (b"Z", 0, 1), (b"Y", 0, 3), (b"X", 0, 5)],
            compression=2)),
        "two_channels_gray8": FILE_SEG + seg(b"ZISRAWSUBBLOCK", sub(
            two_c.tobytes(),
            [(b"C", 0, 2), (b"Z", 0, 2), (b"Y", 0, 3), (b"X", 0, 4)],
            pixel_type=0)),
        "float32": FILE_SEG + seg(b"ZISRAWSUBBLOCK", sub(
            f32.tobytes(),
            [(b"C", 0, 1), (b"Z", 0, 1), (b"Y", 0, 3), (b"X", 0, 4)],
            pixel_type=2)),
        "jpegxr": FILE_SEG + seg(b"ZISRAWSUBBLOCK", sub(
            b"\x00" * 8,
            [(b"C", 0, 1), (b"Z", 0, 1), (b"Y", 0, 2), (b"X", 0, 2)],
            compression=4)),
        "pixel_type_rgb": FILE_SEG + seg(b"ZISRAWSUBBLOCK", sub(
            b"\x00" * 12, [(b"Y", 0, 2), (b"X", 0, 2)], pixel_type=3)),
        "not_czi": b"NOTACZI".ljust(64, b"\x00"),
        "no_subblocks": FILE_SEG + seg(
            b"ZISRAWMETADATA", testing.czi_metadata(SCALING_XML)),
        "bad_metadata_xml": FILE_SEG
        + seg(b"ZISRAWMETADATA", testing.czi_metadata(b"<unclosed"))
        + seg(b"ZISRAWSUBBLOCK", sub(small[None].tobytes(), [
            (b"C", 0, 1), (b"Z", 0, 1), (b"Y", 0, 3), (b"X", 0, 5)])),
    }
    if ctypes.util.find_library("zstd") is not None:
        zstd = ref_czi_lif._compress_zstd
        files["zstd0"] = FILE_SEG + seg(b"ZISRAWSUBBLOCK", sub(
            zstd(base[None].tobytes()), DIMS_2x4x4, compression=5))
        files["zstd1"] = FILE_SEG + seg(b"ZISRAWSUBBLOCK", sub(
            b"\x01" + zstd(base[None].tobytes()), DIMS_2x4x4,
            compression=6))
        files["zstd1_hilo"] = FILE_SEG + seg(b"ZISRAWSUBBLOCK", sub(
            b"\x03\x01\x01" + zstd(_hilo(hilo[None].tobytes())),
            DIMS_2x4x4, compression=6))
        files["zstd1_bad_header"] = FILE_SEG + seg(b"ZISRAWSUBBLOCK", sub(
            b"\x02" + zstd(base[None].tobytes()), DIMS_2x4x4,
            compression=6))
        files["zstd1_bad_chunk_type"] = FILE_SEG + seg(
            b"ZISRAWSUBBLOCK", sub(b"\x03\x02\x01" + zstd(b"x"), DIMS_2x4x4,
                                   compression=6))
        files["zstd_corrupt"] = FILE_SEG + seg(b"ZISRAWSUBBLOCK", sub(
            b"\x28\xb5\x2f\xfd garbage", DIMS_2x4x4, compression=5))
    return files


CZI_CASES = ["mosaic", "pyramid", "zlib", "two_channels_gray8", "float32",
             "jpegxr", "pixel_type_rgb", "not_czi", "no_subblocks",
             "bad_metadata_xml"]
ZSTD_CASES = ["zstd0", "zstd1", "zstd1_hilo", "zstd1_bad_header",
              "zstd1_bad_chunk_type", "zstd_corrupt"]


@pytest.mark.parametrize("name", CZI_CASES + [
    pytest.param(n, marks=needs_zstd) for n in ZSTD_CASES])
def test_czi_spec_streams_read_as_reference(tmp_path, name):
    path = tmp_path / f"{name}.czi"
    path.write_bytes(_czi_files()[name])
    out = testing.same_outcome(lambda: ref_czi_lif.read_czi(str(path)),
                               lambda: czi_lif.read_czi(str(path)))
    if name == "mosaic":
        assert out[0].shape == (2, 4, 8)
        assert out[1]["resolutions"] == pytest.approx([2.0, 0.5, 0.5])
    if name in ("jpegxr", "not_czi", "no_subblocks", "pixel_type_rgb"):
        assert isinstance(out, tuple) and isinstance(out[0], str)


@pytest.mark.parametrize("compression", [
    "none", "zlib", pytest.param("zstd0", marks=needs_zstd),
    pytest.param("zstd1", marks=needs_zstd),
    pytest.param("zstd1hilo", marks=needs_zstd)])
@pytest.mark.parametrize("dtype,channels", [
    (np.uint16, 1), (np.uint8, 2), (np.float32, 1)])
def test_czi_writers_equal_and_read_each_other(tmp_path, compression,
                                               dtype, channels):
    rng = np.random.default_rng(7)
    shape = (3, 8, 9) + ((channels,) if channels > 1 else ())
    img = (rng.random(shape) * 250).astype(dtype)
    got, want = str(tmp_path / "port.czi"), str(tmp_path / "ref.czi")

    def write(mod, path):
        return mod.write_czi(path, img, resolutions=(1.5, 0.4, 0.4),
                             compression=compression)

    testing.same_outcome(lambda: bool(write(ref_czi_lif, want)),
                         lambda: bool(write(czi_lif, got)))
    if compression == "zstd1hilo" and dtype != np.uint16:
        return  # both raised: hi-lo packing needs 16-bit samples
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    arr, meta = testing.same_outcome(lambda: ref_czi_lif.read_czi(got),
                                     lambda: czi_lif.read_czi(want))
    np.testing.assert_array_equal(arr, img)
    assert meta["resolutions"] == pytest.approx([1.5, 0.4, 0.4])


@pytest.mark.parametrize("kwargs", [
    {"image": np.zeros((2, 4, 4), np.uint8), "compression": "jpeg"},
    {"image": np.zeros((1, 4, 4), np.uint16), "compression": "jpeg"},
    {"image": np.zeros((1, 4, 4), np.uint8), "compression": "lzw"},
    {"image": np.zeros((1, 4, 4), np.int64)}])
def test_czi_writer_errors_match(tmp_path, kwargs):
    testing.same_outcome(
        lambda: ref_czi_lif.write_czi(str(tmp_path / "r.czi"), **kwargs),
        lambda: czi_lif.write_czi(str(tmp_path / "p.czi"), **kwargs))


# -- JPEG subblocks ----------------------------------------------------------

@pytest.fixture
def jpeg():
    if ctypes.util.find_library("jpeg") is None:
        pytest.skip("no system libjpeg: the JPEG codec cannot be built")
    from magellanmapper_tpu import native
    if not native.jpeg_available():
        pytest.skip("the reference's native jpegcodec is not built")
    from magellanmapper_torch.io import _jpegcodec
    return _jpegcodec


def _jpeg_planes():
    planes = [np.full((8, 16), v, np.uint8) for v in (40, 200)]
    planes[0][:4, :8] = 90
    planes[1][4:, 8:] = 120
    return planes


def test_jpeg_codec_equals_the_reference(jpeg):
    from magellanmapper_tpu import native
    rng = np.random.default_rng(3)
    for img in (_jpeg_planes()[0], rng.integers(0, 255, (17, 23, 3),
                                                dtype=np.uint8)):
        for quality in (50, 100):
            enc = jpeg.jpeg_encode(img, quality=quality)
            assert enc == native.jpeg_encode(img, quality=quality)
            np.testing.assert_array_equal(jpeg.jpeg_decode(enc),
                                          native.jpeg_decode(enc))


def test_jpeg_subblocks_read_as_reference(tmp_path, jpeg):
    """Two per-plane JPEG subblocks of a hand-built segment stream
    assemble into a z stack equal to the reference's decode, and within
    2 of the source (baseline q100 JPEG on piecewise-constant planes)."""
    segs = FILE_SEG
    for z, plane in enumerate(_jpeg_planes()):
        segs += seg(b"ZISRAWSUBBLOCK", sub(
            jpeg.jpeg_encode(plane, quality=100),
            [(b"C", 0, 1), (b"Z", z, 1), (b"Y", 0, 8), (b"X", 0, 16)],
            pixel_type=0, compression=1))
    path = tmp_path / "jpeg.czi"
    path.write_bytes(segs)
    img, _ = testing.same_outcome(lambda: ref_czi_lif.read_czi(str(path)),
                                  lambda: czi_lif.read_czi(str(path)))
    assert img.shape == (2, 8, 16) and img.dtype == np.uint8
    for z, plane in enumerate(_jpeg_planes()):
        assert np.abs(img[z].astype(int) - plane.astype(int)).max() <= 2


def test_jpeg_write_read_round_trip(tmp_path, jpeg):
    data = np.full((1, 12, 20), 7, np.uint8)
    data[0, 3:9, 5:15] = 180
    got, want = str(tmp_path / "p.czi"), str(tmp_path / "r.czi")
    czi_lif.write_czi(got, data, compression="jpeg")
    ref_czi_lif.write_czi(want, data, compression="jpeg")
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    img, _ = testing.same_outcome(lambda: ref_czi_lif.read_czi(got),
                                  lambda: czi_lif.read_czi(want))
    assert np.abs(img.astype(int) - data.astype(int)).max() <= 2


@pytest.mark.parametrize("case", ["size_mismatch", "corrupt"])
def test_jpeg_errors_match(tmp_path, jpeg, case):
    if case == "size_mismatch":
        data = jpeg.jpeg_encode(np.zeros((4, 4), np.uint8))
        dims = [(b"C", 0, 1), (b"Z", 0, 1), (b"Y", 0, 8), (b"X", 0, 8)]
    else:
        data = b"\xff\xd8 not really a jpeg"
        dims = [(b"C", 0, 1), (b"Z", 0, 1), (b"Y", 0, 4), (b"X", 0, 4)]
    path = tmp_path / f"{case}.czi"
    path.write_bytes(FILE_SEG + seg(b"ZISRAWSUBBLOCK", sub(
        data, dims, pixel_type=0, compression=1)))
    out = testing.same_outcome(lambda: ref_czi_lif.read_czi(str(path)),
                               lambda: czi_lif.read_czi(str(path)))
    assert out[0] == "ValueError"


def test_jpeg_without_its_codec_raises_by_name(tmp_path, monkeypatch):
    """No fallback: a JPEG subblock whose codec cannot be built raises
    naming libjpeg."""
    from magellanmapper_torch.io import _hostbuild, _jpegcodec
    path = tmp_path / "j.czi"
    path.write_bytes(FILE_SEG + seg(b"ZISRAWSUBBLOCK", sub(
        b"\xff\xd8\xff", [(b"Y", 0, 2), (b"X", 0, 2)], pixel_type=0,
        compression=1)))
    monkeypatch.setattr(_jpegcodec, "_lib", None)
    monkeypatch.setattr(_jpegcodec, "_BUILD_DIR", tmp_path / "nobuild")
    monkeypatch.setattr(_jpegcodec, "LIBS", ("-lno_such_jpeg_library",))
    with pytest.raises(RuntimeError, match="libjpeg"):
        czi_lif.read_czi(str(path))
    monkeypatch.setattr(_hostbuild.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        czi_lif.read_czi(str(path))


def test_jpeg_codec_builds_under_build_host(jpeg):
    path = jpeg.build()
    assert path.exists() and path.parent.name == "host"
    assert path.parent.parent.name == "build"
    assert path == jpeg.library_path()
    assert path.name.startswith("libjpegcodec_")


# -- LIF ---------------------------------------------------------------------

def _lif_bytes(data: np.ndarray, xml: str, block="MemBlock_1") -> bytes:
    def chunk(payload):
        return struct.pack("<ii", 0x70, len(payload)) + payload

    head = b"\x2a" + struct.pack("<I", len(xml)) + xml.encode("utf-16-le")
    mem = (b"\x2a" + struct.pack("<Q", data.nbytes) + b"\x2a"
           + struct.pack("<I", len(block)) + block.encode("utf-16-le")
           + data.tobytes())
    return chunk(head) + chunk(mem)


def _lif_xml(dims, bits=16, n_chl=1, block="MemBlock_1"):
    return ('<LMSDataContainerHeader><Element Name="S0"><Data><Image>'
            + "".join(
                f'<DimensionDescription DimID="{i}" NumberOfElements="{n}"'
                + (f' Length="{length}"' if length is not None else "")
                + "/>" for i, n, length in dims)
            + f'<ChannelDescription Resolution="{bits}"/>' * n_chl
            + f'</Image></Data><Memory MemoryBlockID="{block}"/>'
            "</Element></LMSDataContainerHeader>")


def _lif_files():
    data = np.arange(24, dtype=np.uint16).reshape(2, 3, 4)
    two = (np.arange(2 * 2 * 3 * 4) % 250).astype(np.uint8)
    return {
        "lengths": _lif_bytes(data, _lif_xml(
            [(1, 4, "1.2e-6"), (2, 3, "1.0e-6"), (3, 2, "2.0e-6")])),
        "no_z_length": _lif_bytes(data, _lif_xml(
            [(1, 4, "1.2e-6"), (2, 3, "1.0e-6"), (3, 2, None)])),
        "bad_length": _lif_bytes(data, _lif_xml(
            [(1, 4, "wide"), (2, 3, "1.0e-6"), (3, 2, None)])),
        "unnamed_block": _lif_bytes(data, _lif_xml(
            [(1, 4, None), (2, 3, None), (3, 2, None)]), block="Other"),
        "two_channels": _lif_bytes(two, _lif_xml(
            [(1, 4, None), (2, 3, None), (3, 2, None)], bits=8, n_chl=2)),
        "no_images": _lif_bytes(data, "<LMSDataContainerHeader/>"),
        "not_lif": struct.pack("<ii", 0x70, 8) + b"\x00" * 16,
        "corrupt_chunk": struct.pack("<ii", 0x71, 8) + b"\x00" * 16,
    }


@pytest.mark.parametrize("name", list(_lif_files()))
def test_lif_spec_streams_read_as_reference(tmp_path, name):
    path = tmp_path / f"{name}.lif"
    path.write_bytes(_lif_files()[name])
    out = testing.same_outcome(lambda: ref_czi_lif.read_lif(str(path)),
                               lambda: czi_lif.read_lif(str(path)))
    if name == "lengths":
        assert out[1]["resolutions"] == pytest.approx((2.0, 0.5, 0.4))
    if name == "two_channels":
        assert out[0].shape == (2, 3, 4, 2)


@pytest.mark.parametrize("dtype,channels,res", [
    (np.uint8, 1, (1.5, 0.3, 0.25)), (np.uint16, 1, None),
    (np.uint16, 3, (2.0, 0.5, 0.5))])
def test_lif_writers_equal_and_read_each_other(tmp_path, dtype, channels,
                                               res):
    rng = np.random.default_rng(11)
    shape = (3, 4, 5) + ((channels,) if channels > 1 else ())
    img = rng.integers(0, 250, shape).astype(dtype)
    got, want = str(tmp_path / "p.lif"), str(tmp_path / "r.lif")
    czi_lif.write_lif(got, img, resolutions=res)
    ref_czi_lif.write_lif(want, img, resolutions=res)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    arr, meta = testing.same_outcome(lambda: ref_czi_lif.read_lif(got),
                                     lambda: czi_lif.read_lif(want))
    np.testing.assert_array_equal(arr, img)
    if res is not None:
        assert meta["resolutions"] == pytest.approx(res)


# -- corrupt input -----------------------------------------------------------

def _full_files(tmp_path):
    planes = np.random.default_rng(0).integers(0, 60000, (3, 16, 16),
                                               dtype=np.uint16)
    out = {}
    for fmt, write in (("czi", czi_lif.write_czi),
                       ("lif", czi_lif.write_lif)):
        path = str(tmp_path / f"full.{fmt}")
        write(path, planes)
        with open(path, "rb") as f:
            out[fmt] = f.read()
    return out


@pytest.mark.parametrize("fmt", ["czi", "lif"])
@pytest.mark.parametrize("cut_frac", [0.05, 0.3, 0.7, 0.97])
def test_truncated_files_fail_as_the_reference(tmp_path, fmt, cut_frac):
    full = _full_files(tmp_path)[fmt]
    path = str(tmp_path / f"cut.{fmt}")
    with open(path, "wb") as f:
        f.write(full[:max(1, int(len(full) * cut_frac))])
    read, ref_read = (getattr(czi_lif, f"read_{fmt}"),
                      getattr(ref_czi_lif, f"read_{fmt}"))
    out = testing.same_outcome(lambda: ref_read(path), lambda: read(path))
    assert isinstance(out[0], str)  # both raised


@pytest.mark.parametrize("fmt", ["czi", "lif"])
def test_header_bit_flips_fail_as_the_reference(tmp_path, fmt):
    full = _full_files(tmp_path)[fmt]
    rng = np.random.default_rng(1)
    read, ref_read = (getattr(czi_lif, f"read_{fmt}"),
                      getattr(ref_czi_lif, f"read_{fmt}"))
    for trial in range(8):
        data = bytearray(full)
        data[int(rng.integers(0, min(len(data), 256)))] ^= 0xFF
        path = str(tmp_path / f"flip{trial}.{fmt}")
        with open(path, "wb") as f:
            f.write(bytes(data))
        testing.same_outcome(lambda: ref_read(path), lambda: read(path))


# -- the importers and the CLI -----------------------------------------------

@pytest.mark.parametrize("fmt,res", [("czi", None), ("czi", (3.0, 1.0, 1.0)),
                                     ("lif", None)])
def test_import_czi_lif_matches_reference(tmp_path, fmt, res):
    """``import_czi``/``import_lif`` write the reference importer's
    image5d and metadata; the replaced by-name stubs' successor."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 4000, (3, 8, 10, 2)).astype(np.uint16)
    src = str(tmp_path / f"img.{fmt}")
    getattr(czi_lif, f"write_{fmt}")(src, img, resolutions=(2.0, 0.5, 0.5))
    got = getattr(importer, f"import_{fmt}")(
        src, out_path=str(tmp_path / "p"), resolutions=res)
    want = getattr(ref_importer, f"import_{fmt}")(
        src, out_path=str(tmp_path / "r"), resolutions=res)
    np.testing.assert_array_equal(np.asarray(got.img), np.asarray(want.img))
    assert got.img.shape == (1, 3, 8, 10, 2)
    assert got.meta["resolutions"] == want.meta["resolutions"]
    for prefix in ("p", "r"):
        loaded, ref_loaded = (np_io.read_file(str(tmp_path / prefix)),
                              ref_np_io.read_file(str(tmp_path / prefix)))
        np.testing.assert_array_equal(np.asarray(loaded.img), img[None])
        assert loaded.meta["resolutions"] == ref_loaded.meta["resolutions"]


def test_cli_imports_a_lif_series(tmp_path):
    """``--proc import_only`` on a ``.lif`` passes ``--series``, as the
    reference CLI; a series past the file's raises as there."""
    from magellanmapper_torch.io import cli
    from magellanmapper_tpu.io import cli as ref_cli
    img = np.arange(2 * 3 * 4, dtype=np.uint16).reshape(2, 3, 4)
    src = str(tmp_path / "s.lif")
    czi_lif.write_lif(src, img)
    for series in ("0", "1"):
        testing.same_outcome(
            lambda: ref_cli.main(["--img", src, "--proc", "import_only",
                                  "--series", series, "--prefix",
                                  str(tmp_path / "r")]).img[:],
            lambda: cli.main(["--img", src, "--proc", "import_only",
                              "--series", series, "--prefix",
                              str(tmp_path / "p")]).img[:])
