"""The port's HDF5 readers (``io.hdf5``, ``io.hdf5_native``) and
``read_ims`` against the reference's.

Files come from two independent writers: built byte by byte from the HDF5
specification (``testing.H5Builder``/``ims_bytes``, copies of the
reference test's builder), and written by the system libhdf5 through
each package's ``NativeHdf5Writer`` (skipped by name without the
library). Both packages read each file: arrays
equal exactly, attributes and metadata equal, the same exception type and
message where the reference raises.
"""

import struct

import numpy as np
import pytest

from magellanmapper_torch import testing
from magellanmapper_torch.io import hdf5, hdf5_native, importer
from magellanmapper_tpu.io import hdf5 as ref_hdf5
from magellanmapper_tpu.io import hdf5_native as ref_hdf5_native
from magellanmapper_tpu.io import importer as ref_importer

H5Builder, s1 = testing.H5Builder, testing.s1
needs_libhdf5 = pytest.mark.skipif(
    not ref_hdf5_native.available(), reason="no system libhdf5")


def _tree(f, group="/"):
    """Every dataset and attribute under ``group`` of an open file."""
    out = {"attrs": f.attrs(group) if group != "/" else {}}
    for name in f.list_group(group):
        path = name if group == "/" else f"{group}/{name}"
        try:
            out[name] = {"data": f.read_dataset(path),
                         "attrs": f.attrs(path)}
        except KeyError:  # a group
            out[name] = _tree(f, path)
    return out


def _unknown_filter_file():
    arr = np.zeros((2, 2), np.uint16)
    b = H5Builder()
    msgs = [b.msg(0x0001, b.dataspace(arr.shape)),
            b.msg(0x0003, b.datatype(arr.dtype))]
    caddr = b.add(arr.tobytes())
    node = struct.pack("<4sBBH", b"TREE", 1, 0, 1)
    node += struct.pack("<QQ", b.UNDEF, b.UNDEF)
    node += struct.pack("<IIQQQQ", arr.nbytes, 0, 0, 0, 0, caddr)
    node += struct.pack("<II", 0, 0) + b"\x00" * 24
    layout = struct.pack("<BBBQIII", 3, 2, 3, b.add(node), 2, 2,
                         arr.itemsize)
    msgs.append(b.msg(0x0008, layout))
    msgs.append(H5Builder.msg(0x000B, struct.pack("<BB6xHHHH", 1, 1, 32005,
                                                  0, 1, 0)))
    return b.finish(b.group({"D": b.object_header(msgs)}))


def _h5_files():
    rng = np.random.default_rng(1)
    files = {}
    b = H5Builder()
    arr = np.arange(24, dtype=np.uint16).reshape(2, 3, 4)
    inner = b.group({"Data": b.dataset(arr, attrs={"note": s1("hi")})},
                    attrs={"n": np.int32(7)})
    files["contiguous_groups"] = b.finish(b.group({"grp": inner}))
    for gzip, shuffle in ((False, False), (True, False), (True, True)):
        b = H5Builder()
        big = rng.integers(0, 60000, (5, 7, 6), dtype=np.uint16)
        files[f"chunked_gzip{int(gzip)}_shuffle{int(shuffle)}"] = b.finish(
            b.group({"D": b.dataset(big, chunk=(2, 3, 4), gzip=gzip,
                                    shuffle=shuffle)}))
    for dtype in (np.float32, np.int32, np.uint8):
        b = H5Builder()
        a = (np.linspace(-5, 250, 12).reshape(3, 4)).astype(dtype)
        files[f"dtype_{np.dtype(dtype).name}"] = b.finish(
            b.group({"F": b.dataset(a)}))
    files["unknown_filter"] = _unknown_filter_file()
    files["not_hdf5"] = b"junk" * 100
    return files


@pytest.mark.parametrize("name", list(_h5_files()))
def test_hdf5_files_read_as_reference(tmp_path, name):
    path = str(tmp_path / f"{name}.h5")
    with open(path, "wb") as f:
        f.write(_h5_files()[name])
    out = testing.same_outcome(lambda: _tree(ref_hdf5.Hdf5File(path)),
                               lambda: _tree(hdf5.Hdf5File(path)))
    if name == "unknown_filter":
        assert out[0] == "NotImplementedError" and "filter" in out[1]
    if name == "not_hdf5":
        assert out[0] == "ValueError"


def _ims_files():
    rng = np.random.default_rng(3)
    one = rng.integers(0, 60000, (3, 6, 5), dtype=np.uint16)
    two = [rng.integers(0, 255, (2, 4, 4), dtype=np.uint8) for _ in range(2)]
    full = rng.integers(0, 60000, (4, 8, 8), dtype=np.uint16)
    b = H5Builder()

    def chan(vol):
        pad = np.zeros([-(-s // c) * c for s, c in zip(vol.shape, (2, 4, 4))],
                       vol.dtype)
        pad[tuple(slice(0, s) for s in vol.shape)] = vol
        return b.group({"Data": b.dataset(pad, chunk=(2, 4, 4), gzip=True)},
                       attrs={f"ImageSize{ax}": s1(str(s))
                              for ax, s in zip("ZYX", vol.shape)})

    levels = {f"ResolutionLevel {i}": b.group({"TimePoint 0": b.group(
        {"Channel 0": chan(v)})}) for i, v in enumerate(
            (full, full[::2, ::2, ::2]))}
    pyramid = b.finish(b.group({"DataSet": b.group(levels)}))
    b = H5Builder()
    empty = b.finish(b.group({"DataSet": b.group({"ResolutionLevel 0": b.group(
        {"TimePoint 0": b.group({})})})}))
    return {
        "one_channel_padded": testing.ims_bytes([one]),
        "two_channels_extents": testing.ims_bytes(
            two, sizes=(4, 4, 2), ext=[(0.0, 8.0), (0.0, 12.0), (0.0, 5.0)]),
        "pyramid": pyramid,
        "no_channels": empty,
    }


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("name", list(_ims_files()))
def test_read_ims_as_reference(tmp_path, name, level):
    path = str(tmp_path / f"{name}.ims")
    with open(path, "wb") as f:
        f.write(_ims_files()[name])
    out = testing.same_outcome(
        lambda: ref_hdf5.read_ims(path, resolution_level=level),
        lambda: hdf5.read_ims(path, resolution_level=level))
    if name == "two_channels_extents" and level == 0:
        assert out[0].shape == (2, 2, 4, 4)
        assert out[1]["resolutions"] == pytest.approx((2.5, 3.0, 2.0))


@pytest.mark.parametrize("cut_frac", [0.05, 0.3, 0.7, 0.97])
def test_truncated_ims_fails_as_the_reference(tmp_path, cut_frac):
    full = testing.ims_bytes([np.random.default_rng(0).integers(
        0, 60000, (3, 16, 16), dtype=np.uint16)])
    path = str(tmp_path / "cut.ims")
    with open(path, "wb") as f:
        f.write(full[:max(1, int(len(full) * cut_frac))])
    out = testing.same_outcome(lambda: ref_hdf5.read_ims(path),
                               lambda: hdf5.read_ims(path))
    assert isinstance(out[0], str)  # both raised


def test_ims_header_bit_flips_fail_as_the_reference(tmp_path):
    full = testing.ims_bytes([np.random.default_rng(0).integers(
        0, 60000, (3, 16, 16), dtype=np.uint16)])
    rng = np.random.default_rng(1)
    for trial in range(8):
        data = bytearray(full)
        data[int(rng.integers(0, 256))] ^= 0xFF
        path = str(tmp_path / f"flip{trial}.ims")
        with open(path, "wb") as f:
            f.write(bytes(data))
        testing.same_outcome(lambda: ref_hdf5.read_ims(path),
                             lambda: hdf5.read_ims(path))


# -- the system libhdf5 -------------------------------------------------------

def _native_ims(tmp_path, mod, name, libver, vols, sizes, ext=None):
    """``testing.write_ims``'s layout through ``mod``'s writer (the
    reference test's builder), chunked, gzip and shuffle."""
    path = str(tmp_path / name)
    with mod.NativeHdf5Writer(path, libver=libver) as w:
        base = "DataSet/ResolutionLevel 0/TimePoint 0"
        for ci, vol in enumerate(vols):
            ch = f"{base}/Channel {ci}"
            w.write_dataset(f"{ch}/Data", vol, chunks=(2,) + vol.shape[1:],
                            gzip=4, shuffle=True)
            for ax, size in zip("ZYX", sizes):
                w.write_attr(ch, f"ImageSize{ax}", str(size))
        w.create_group("DataSetInfo/Image")
        for ax, size in zip("ZYX", sizes):
            w.write_attr("DataSetInfo/Image", ax, str(size))
        for key, val in (ext or {}).items():
            w.write_attr("DataSetInfo/Image", key, str(val))
    return path


EXT = {"ExtMin2": 0.0, "ExtMax2": 10.0, "ExtMin1": 0.0, "ExtMax1": 8.0,
       "ExtMin0": 0.0, "ExtMax0": 10.0}


@needs_libhdf5
@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("channels", [1, 2])
def test_native_ims_read_as_reference(tmp_path, libver, channels):
    """Files the system libhdf5 writes: 'earliest' is read by the pure
    reader, 'latest' (v2 object headers) falls back to the library, in
    both packages; the port's writer reads back the same."""
    vol = np.arange(6 * 8 * 10, dtype=np.uint16).reshape(6, 8, 10)
    vols = [vol + 100 * c for c in range(channels)]
    want = _native_ims(tmp_path, ref_hdf5_native, "r.ims", libver, vols,
                       (5, 8, 10), EXT)
    got = _native_ims(tmp_path, hdf5_native, "p.ims", libver, vols,
                      (5, 8, 10), EXT)
    out = testing.same_outcome(lambda: ref_hdf5.read_ims(want),
                               lambda: hdf5.read_ims(got))
    np.testing.assert_array_equal(out[0], np.stack(vols)[:, :5].squeeze())
    assert out[1]["resolutions"] == (2.0, 1.0, 1.0)


@needs_libhdf5
def test_latest_profile_refused_by_the_pure_reader_as_reference(tmp_path):
    path = str(tmp_path / "latest.h5")
    arr = np.arange(210, dtype=np.uint16).reshape(5, 6, 7)
    with hdf5_native.NativeHdf5Writer(path, libver="latest") as w:
        w.write_dataset("G/Data", arr, chunks=(2, 6, 7), gzip=4, shuffle=True)
        w.write_attr("G", "Label", "hello")
        w.write_attr("G", "Level", np.float64(2.5))
    out = testing.same_outcome(
        lambda: ref_hdf5.Hdf5File(path).list_group("/"),
        lambda: hdf5.Hdf5File(path).list_group("/"))
    assert out[0] == "NotImplementedError"

    def native(mod):
        with mod.NativeHdf5File(path) as f:
            return _tree(f)

    out = testing.same_outcome(lambda: native(ref_hdf5_native),
                               lambda: native(hdf5_native))
    np.testing.assert_array_equal(out["G"]["Data"]["data"], arr)
    assert hdf5._attr_str(out["G"]["attrs"], "Label") == "hello"


@needs_libhdf5
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_native_writers_write_equal_datasets(tmp_path, libver):
    arrays = {"u8": np.arange(24, dtype=np.uint8).reshape(4, 6),
              "i32": (np.arange(24, dtype=np.int32) - 12).reshape(4, 6),
              "f64": np.linspace(-1, 1, 24).reshape(4, 6),
              "f32": np.linspace(0, 9, 720, dtype=np.float32).reshape(
                  6, 10, 12)}
    for mod, name in ((hdf5_native, "p.h5"), (ref_hdf5_native, "r.h5")):
        with mod.NativeHdf5Writer(str(tmp_path / name), libver=libver) as w:
            for key, a in arrays.items():
                w.write_dataset(f"A/{key}", a,
                                chunks=(3, 10, 12) if a.ndim == 3 else None,
                                gzip=6 if a.ndim == 3 else None)
            w.write_attr("A", "Note", "from-libhdf5")

    def native(mod, name):
        with mod.NativeHdf5File(str(tmp_path / name)) as f:
            return _tree(f)

    out = testing.same_outcome(lambda: native(ref_hdf5_native, "p.h5"),
                               lambda: native(hdf5_native, "r.h5"))
    for key, a in arrays.items():
        np.testing.assert_array_equal(out["A"][key]["data"], a)
    with pytest.raises(ValueError, match="libver"):
        hdf5_native.NativeHdf5Writer(str(tmp_path / "x.h5"), libver="newest")


@needs_libhdf5
def test_native_missing_paths_raise_as_reference(tmp_path):
    path = str(tmp_path / "miss.h5")
    with hdf5_native.NativeHdf5Writer(path) as w:
        w.write_dataset("D", np.zeros(3, np.uint8))
    for call in ("read_dataset", "list_group", "attrs"):
        def run(mod):
            with mod.NativeHdf5File(path) as f:
                return getattr(f, call)("nope")
        out = testing.same_outcome(lambda: run(ref_hdf5_native),
                                   lambda: run(hdf5_native))
        assert out[0] == "KeyError"


def test_without_libhdf5_both_raise_by_name(tmp_path, monkeypatch):
    for mod in (hdf5_native, ref_hdf5_native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_lib_tried", True)
    path = str(tmp_path / "x.h5")
    for call in (lambda m: m.NativeHdf5Writer(path),
                 lambda m: m.NativeHdf5File(path)):
        out = testing.same_outcome(lambda: call(ref_hdf5_native),
                                   lambda: call(hdf5_native))
        assert out[0] == "ImportError" and "libhdf5" in out[1]


@pytest.mark.parametrize("source", [
    "bytes_one_channel", "bytes_two_channels",
    pytest.param("libhdf5_latest_two_channels", marks=needs_libhdf5)])
def test_import_ims_matches_reference(tmp_path, source):
    """``import_ims`` and the CLI write the reference importer's image5d,
    channels last, with the extents' resolutions."""
    from magellanmapper_torch.io import cli
    from magellanmapper_tpu.io import cli as ref_cli
    rng = np.random.default_rng(5)
    vols = [rng.integers(0, 60000, (3, 8, 8), dtype=np.uint16)
            for _ in range(1 if source == "bytes_one_channel" else 2)]
    if source.startswith("bytes"):
        src = str(tmp_path / "img.ims")
        with open(src, "wb") as f:
            f.write(testing.ims_bytes(vols, ext=[(0, 8), (0, 4), (0, 6)]))
    else:
        src = testing.write_ims(str(tmp_path / "img.ims"), vols, (3, 8, 8),
                                libver="latest", ext=EXT)
    got = importer.import_ims(src, out_path=str(tmp_path / "p"))
    want = ref_importer.import_ims(src, out_path=str(tmp_path / "r"))
    np.testing.assert_array_equal(np.asarray(got.img), np.asarray(want.img))
    assert got.meta["resolutions"] == want.meta["resolutions"]
    if len(vols) == 2:
        np.testing.assert_array_equal(np.asarray(got.img)[0],
                                      np.stack(vols, -1))
    out = cli.main(["--img", src, "--proc", "import_only", "--prefix",
                    str(tmp_path / "pc")])
    ref_out = ref_cli.main(["--img", src, "--proc", "import_only",
                            "--prefix", str(tmp_path / "rc")])
    np.testing.assert_array_equal(np.asarray(out.img),
                                  np.asarray(ref_out.img))
