"""The port's Olympus OIB/OIF readers against the reference's.

OIB files are compound files built byte by byte from the CFBF layout
(``testing.cfbf_bytes``, a copy of the reference test's builder) around
per-plane TIFFs; OIF files are a UTF-16 INI beside a ``.files``
directory. Both packages read each file: arrays equal exactly, metadata
equal, the same exception type and message where the reference raises.
The importers move ``(C, Z, Y, X)`` to ``(Z, Y, X, C)`` as the
reference's do.
"""

import numpy as np
import pytest

from magellanmapper_torch import testing
from magellanmapper_torch.io import importer, oib
from magellanmapper_tpu.io import importer as ref_importer
from magellanmapper_tpu.io import oib as ref_oib

cfbf, tif = testing.cfbf_bytes, testing.tiff_bytes


def _oib_files():
    rng = np.random.default_rng(1)
    planes = rng.integers(0, 4000, (3, 48, 52), dtype=np.uint16)
    grid = rng.integers(0, 255, (2, 2, 2, 40, 44), dtype=np.uint8)
    small = np.arange(128, dtype=np.uint16).reshape(2, 8, 8)
    settings = ("[Reference Image Parameter]\nWidthConvertValue=0.41\n"
                "[Axis 3 Parameters Common]\n"
                'AxisCode="Z"\nInterval=2.0\n')
    stack = {"OibInfo.txt": "[Storage]\nplanes=3\n".encode("utf-16-le")}
    stack.update({f"s_C001Z{z + 1:03d}.tif": tif(planes[z])
                  for z in range(3)})
    return {
        "stack": cfbf(stack),
        "channels_timepoints": cfbf({
            f"s_C{c + 1:03d}Z{z + 1:03d}T{t + 1:03d}.tif": tif(grid[c, t, z])
            for c in range(2) for t in range(2) for z in range(2)}),
        "manifest_names": cfbf({
            "OibInfo.txt": ("[OibSaveInfo]\nStream00001=s_C001Z001.tif\n"
                            "Stream00002=s_C001Z002.tif\n"
                            ).encode("utf-16-le"),
            "Stream00002": tif(planes[1]), "Stream00001": tif(planes[0])}),
        "embedded_settings": cfbf({
            "MainFile.oif": b"\xff\xfe" + settings.encode("utf-16-le"),
            "s_C001Z001.tif": tif(small[0]),
            "s_C001Z002.tif": tif(small[1])}),
        "no_planes": cfbf({"Readme.txt": b"nothing here"}),
        "not_ole": b"not an ole file" * 40,
        "truncated_fat": cfbf(stack)[:1500],
    }


@pytest.mark.parametrize("name", list(_oib_files()))
def test_oib_files_read_as_reference(tmp_path, name):
    path = tmp_path / f"{name}.oib"
    path.write_bytes(_oib_files()[name])
    out = testing.same_outcome(lambda: ref_oib.read_oib(str(path)),
                               lambda: oib.read_oib(str(path)))
    if name == "channels_timepoints":
        assert out[0].shape == (2, 4, 40, 44) and out[1]["components"] == 2
    if name == "embedded_settings":
        assert out[1]["resolutions"] == pytest.approx((2.0, 0.41, 0.41))
    if name in ("no_planes", "not_ole"):
        assert out[0] == "ValueError"


def test_compound_file_streams_match_reference(tmp_path):
    rng = np.random.default_rng(0)
    streams = {"BigStream": rng.integers(0, 255, 9000,
                                         dtype=np.uint8).tobytes(),
               "SmallStream": b"hello compound world",
               "Chain": bytes(range(256)) * 64}
    path = str(tmp_path / "t.oib")
    with open(path, "wb") as f:
        f.write(cfbf(streams))
    got, want = oib.CompoundFile(path), ref_oib.CompoundFile(path)
    assert got.list_streams() == want.list_streams()
    for name, data in streams.items():
        assert got.read_stream(name) == want.read_stream(name) == data


@pytest.mark.parametrize("case", ["stack", "missing_dir", "two_channels"])
def test_oif_read_as_reference(tmp_path, case):
    rng = np.random.default_rng(3)
    if case == "missing_dir":
        main = tmp_path / "lone.oif"
        main.write_bytes(b"\xff\xfe" + "[x]\n".encode("utf-16-le"))
        main = str(main)
    elif case == "stack":
        main = testing.oif_files(str(tmp_path), rng.integers(
            0, 4000, (4, 24, 28), dtype=np.uint16))
    else:
        main = testing.oif_files(str(tmp_path), rng.integers(
            0, 4000, (2, 24, 28), dtype=np.uint16))
        files = tmp_path / "img.oif.files"
        for z in range(2):
            (files / f"s_C002Z{z + 1:03d}.tif").write_bytes(tif(
                rng.integers(0, 4000, (24, 28), dtype=np.uint16)))
    out = testing.same_outcome(lambda: ref_oib.read_oif(main),
                               lambda: oib.read_oif(main))
    if case == "stack":
        assert out[1]["resolutions"] == pytest.approx((1.5, 0.62, 0.62))
    if case == "missing_dir":
        assert out[0] == "FileNotFoundError"


@pytest.mark.parametrize("cut_frac", [0.05, 0.3, 0.7, 0.97])
def test_truncated_oib_fails_as_the_reference(tmp_path, cut_frac):
    full = _oib_files()["stack"]
    path = str(tmp_path / "cut.oib")
    with open(path, "wb") as f:
        f.write(full[:max(1, int(len(full) * cut_frac))])
    out = testing.same_outcome(lambda: ref_oib.read_oib(path),
                               lambda: oib.read_oib(path))
    assert isinstance(out[0], str)  # both raised


def test_oib_header_bit_flips_fail_as_the_reference(tmp_path):
    full = _oib_files()["stack"]
    rng = np.random.default_rng(1)
    for trial in range(8):
        data = bytearray(full)
        data[int(rng.integers(0, 256))] ^= 0xFF
        path = str(tmp_path / f"flip{trial}.oib")
        with open(path, "wb") as f:
            f.write(bytes(data))
        testing.same_outcome(lambda: ref_oib.read_oib(path),
                             lambda: oib.read_oib(path))


@pytest.mark.parametrize("fmt", ["oib", "oif"])
def test_import_oib_oif_matches_reference(tmp_path, fmt):
    """Two channels of two planes through ``import_oib``/``import_oif``
    and the CLI: the reference importer's image5d, channels last."""
    from magellanmapper_torch.io import cli
    from magellanmapper_tpu.io import cli as ref_cli
    rng = np.random.default_rng(4)
    grid = rng.integers(0, 4000, (2, 2, 16, 16), dtype=np.uint16)
    if fmt == "oib":
        src = str(tmp_path / "img.oib")
        with open(src, "wb") as f:
            f.write(cfbf({f"s_C{c + 1:03d}Z{z + 1:03d}.tif": tif(grid[c, z])
                          for c in range(2) for z in range(2)}))
    else:
        src = testing.oif_files(str(tmp_path), grid[0])
        for z in range(2):
            (tmp_path / "img.oif.files" / f"s_C002Z{z + 1:03d}.tif"
             ).write_bytes(tif(grid[1, z]))
    got = getattr(importer, f"import_{fmt}")(src, str(tmp_path / "p"))
    want = getattr(ref_importer, f"import_{fmt}")(src, str(tmp_path / "r"))
    np.testing.assert_array_equal(np.asarray(got.img), np.asarray(want.img))
    np.testing.assert_array_equal(np.asarray(got.img)[0],
                                  np.moveaxis(grid, 0, -1))
    assert got.meta.get("resolutions") == want.meta.get("resolutions")
    out = cli.main(["--img", src, "--proc", "import_only", "--prefix",
                    str(tmp_path / "pc")])
    ref_out = ref_cli.main(["--img", src, "--proc", "import_only",
                            "--prefix", str(tmp_path / "rc")])
    np.testing.assert_array_equal(np.asarray(out.img),
                                  np.asarray(ref_out.img))
