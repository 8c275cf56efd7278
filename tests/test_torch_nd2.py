"""The port's Nikon ND2 reader against the reference's.

Chunk-map files are built byte by byte from the container's layout
(``testing.nd2_bytes``, a copy of the reference test's builder); legacy
files are JP2 containers whose codestreams come from the system
libopenjp2 (skipped by name without it). Both packages read each file:
arrays equal exactly, metadata equal, the same exception type and
message where the reference raises. The importer moves ``(C, Z, Y, X)``
to ``(Z, Y, X, C)`` as the reference's does.
"""

import numpy as np
import pytest

from magellanmapper_torch import testing
from magellanmapper_torch.io import importer, jp2k, nd2
from magellanmapper_tpu.io import importer as ref_importer
from magellanmapper_tpu.io import jp2k as ref_jp2k
from magellanmapper_tpu.io import nd2 as ref_nd2

attrs, build = testing.nd2_attributes, testing.nd2_bytes
lv_item, lv_level = testing.lv_item, testing.lv_level
needs_openjp2 = pytest.mark.skipif(
    not ref_jp2k.available(), reason="no system libopenjp2")


def _same_read(path):
    return testing.same_outcome(lambda: ref_nd2.read_nd2(str(path)),
                                lambda: nd2.read_nd2(str(path)))


@pytest.mark.parametrize("items", [
    [lv_item("flag", True, 1), lv_item("i", -7, 2), lv_item("u", 42, 3),
     lv_item("q", 1 << 40, 5), lv_item("d", 2.5, 6),
     lv_item("s", "hello", 8)],
    [lv_level("outer", [lv_item("a", 1, 3),
                        lv_level("inner", [lv_item("b", 2, 3)]),
                        lv_item("c", 3, 3)])],
    [lv_item("u", 42, 3)[:-2]],
    [b"\x07\x02" + "x\x00".encode("utf-16-le") + b"\x00" * 4]])
def test_lite_variant_parses_as_reference(items):
    data = b"".join(items)
    testing.same_outcome(lambda: ref_nd2.parse_lite_variant(data),
                         lambda: nd2.parse_lite_variant(data))


def _chunk_map_files():
    rng = np.random.default_rng(0)
    u16 = rng.integers(0, 65535, (3, 4, 6), dtype=np.uint16)
    zyxc = rng.integers(0, 255, (2, 3, 5, 2), dtype=np.uint8)
    padded = np.arange(30, dtype=np.uint16).reshape(2, 3, 5)
    f32 = np.linspace(0, 1, 24, dtype=np.float32).reshape(1, 4, 6)
    zero = np.zeros((1, 2, 2), np.uint16)
    cal = (b"ImageCalibrationLV|0!", lv_level(
        "SLxCalibration", [lv_item("dCalibration", 0.65, 6)]))
    lagging = np.arange(12, dtype=np.uint16).reshape(2, 2, 3)
    return {
        "uint16_stack": build(list(u16), attrs(6, 4, n_seq=3)),
        "two_channels": build(list(zyxc), attrs(5, 3, comp=2, bpc=8,
                                                n_seq=2)),
        "padded_rows": build(list(padded), attrs(5, 3, n_seq=2, stride=16),
                             stride=16),
        "float32": build(list(f32), attrs(6, 4, bpc=32)),
        "calibration": build(list(zero), attrs(2, 2), extra_chunks=[cal]),
        "lossless": build(list(zero), attrs(2, 2, compression=0)),
        "lossy": build(list(zero), attrs(2, 2, compression=1)),
        "bad_geometry": build(list(zero), attrs(0, 2)),
        "bad_bits": build(list(zero), attrs(2, 2, bpc=12)),
        "chunk_map_over_attributes": build(list(lagging),
                                           attrs(3, 2, n_seq=5)),
        "legacy_zeros": b"\x00" * 4096,
        "too_short": b"\x00" * 20,
    }


@pytest.mark.parametrize("name", list(_chunk_map_files()))
def test_chunk_map_files_read_as_reference(tmp_path, name):
    path = tmp_path / f"{name}.nd2"
    path.write_bytes(_chunk_map_files()[name])
    out = _same_read(path)
    if name == "two_channels":
        assert out[0].shape == (2, 2, 3, 5) and out[1]["components"] == 2
    if name == "calibration":
        assert out[1]["resolutions"] == pytest.approx((0.65,) * 3)
    if name in ("lossless", "lossy", "legacy_zeros"):
        assert out[0] == "NotImplementedError"


def _frames(n, h=24, w=32, dtype=np.uint16, seed=0):
    rng = np.random.default_rng(seed)
    hi = 255 if dtype == np.uint8 else 60000
    return [rng.integers(0, hi, (h, w), dtype=dtype) for _ in range(n)]


def _legacy(frames, header, junk=False, xl=False):
    box = testing.jp2_xlbox if xl else testing.jp2_box
    payload = testing.JP2_SIG + testing.JP2_FTYP + header
    for fr in frames:
        if junk:
            payload += testing.jp2_box(b"uuid", bytes(16) + b"\x01\x02" * 8)
        payload += box(b"jp2c", ref_jp2k.encode(fr, num_resolutions=4))
    return payload + (testing.jp2_box(b"nikx", b"\x00" * 37) if junk
                      else b"")


def _legacy_files():
    frames = _frames(3)
    return {
        "calibrated_with_junk": _legacy(frames, testing.jp2_header(
            24, 32, res_box=testing.jp2_resc(2, 1, 6)), junk=True),
        "xlbox": _legacy(frames[:1], testing.jp2_header(24, 32), xl=True),
        "uint8": _legacy(_frames(2, dtype=np.uint8, seed=3),
                         testing.jp2_header(24, 32, bpc=8)),
        "two_components": _legacy(
            [np.stack(_frames(2, seed=s), -1) for s in (4, 5)],
            testing.jp2_header(24, 32, nc=2)),
        "no_codestreams": testing.JP2_SIG + testing.JP2_FTYP
        + testing.jp2_header(8, 8),
        "corrupt_box_length": testing.JP2_SIG
        + (1 << 20).to_bytes(4, "big") + b"jp2c",
        "inconsistent_shapes": _legacy(
            [_frames(1)[0], _frames(1, h=16, seed=5)[0]],
            testing.jp2_header(24, 32)),
    }


@needs_openjp2
@pytest.mark.parametrize("name", list(_legacy_files()))
def test_legacy_files_read_as_reference(tmp_path, name):
    path = tmp_path / f"{name}.nd2"
    path.write_bytes(_legacy_files()[name])
    out = _same_read(path)
    if name == "calibrated_with_junk":
        assert out[0].shape == (3, 24, 32) and out[1]["legacy"]
        assert out[1]["resolutions"] == pytest.approx((0.5, 0.5, 0.5))
    if name == "two_components":
        assert out[0].shape == (2, 2, 24, 32)


@needs_openjp2
def test_legacy_without_libopenjp2_raises_by_name(tmp_path, monkeypatch):
    path = tmp_path / "gated.nd2"
    path.write_bytes(_legacy_files()["xlbox"])
    monkeypatch.setattr(jp2k, "available", lambda: False)
    monkeypatch.setattr(ref_jp2k, "available", lambda: False)
    out = _same_read(path)
    assert out[0] == "NotImplementedError" and "libopenjp2" in out[1]


def _importer_files():
    rng = np.random.default_rng(4)
    files = {
        "one_channel": build(
            list(rng.integers(0, 4000, (3, 8, 10), dtype=np.uint16)),
            attrs(10, 8, n_seq=3)),
        "two_channels": build(
            list(rng.integers(0, 255, (2, 3, 5, 2), dtype=np.uint8)),
            attrs(5, 3, comp=2, bpc=8, n_seq=2), extra_chunks=[(
                b"ImageCalibrationLV|0!", lv_level(
                    "SLxCalibration", [lv_item("dCalibration", 0.4, 6)]))]),
    }
    if ref_jp2k.available():
        files["legacy_two_components"] = _legacy(
            [np.stack(_frames(2, seed=s), -1) for s in (6, 7)],
            testing.jp2_header(24, 32, nc=2, res_box=testing.jp2_resc(
                1, 1, 6)))
    return files


@pytest.mark.parametrize("name", [
    "one_channel", "two_channels",
    pytest.param("legacy_two_components", marks=needs_openjp2)])
def test_import_nd2_matches_reference(tmp_path, name):
    """``import_nd2`` writes the reference importer's image5d: channels
    last, its calibration; through the CLI's ``--proc import_only``
    too."""
    from magellanmapper_torch.io import cli
    from magellanmapper_tpu.io import cli as ref_cli
    src = tmp_path / "img.nd2"
    src.write_bytes(_importer_files()[name])
    want = ref_importer.import_nd2(str(src), out_path=str(tmp_path / "r"))
    got = importer.import_nd2(str(src), out_path=str(tmp_path / "p"))
    np.testing.assert_array_equal(np.asarray(got.img), np.asarray(want.img))
    assert got.meta.get("resolutions") == want.meta.get("resolutions")
    if name != "one_channel":
        assert got.img.ndim == 5 and got.img.shape[-1] == 2
    for main, prefix in ((cli.main, "pc"), (ref_cli.main, "rc")):
        out = main(["--img", str(src), "--proc", "import_only", "--prefix",
                    str(tmp_path / prefix)])
        np.testing.assert_array_equal(np.asarray(out.img),
                                      np.asarray(want.img))
