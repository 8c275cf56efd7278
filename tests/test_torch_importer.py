"""The port's importer (``magellanmapper_torch.io.importer``) and the rest
of its ``io.np_io`` against the reference's: the same TIFF, OME-TIFF, RAW,
plane and channel files import to equal ``.npy`` archives and metadata,
the name and metadata helpers return the same, and each vendor format
imports to the reference's archive."""

import os
import types

import numpy as np
import pytest

from magellanmapper_tpu.cv import blobs as ref_blobs
from magellanmapper_tpu.io import importer as ref_importer
from magellanmapper_tpu.io import np_io as ref_np_io
from magellanmapper_tpu.io import sitk_io as ref_sitk_io
from magellanmapper_tpu.io import tiff as ref_tiff
from magellanmapper_torch.io import importer, np_io, tiff


def _same_archive(got, want):
    """Two imported image5d archives hold equal arrays and metadata (the
    metadata's image name is each one's own base name)."""
    np.testing.assert_array_equal(np.asarray(got.img), np.asarray(want.img))
    assert got.img.dtype == want.img.dtype
    meta = dict(got.meta)
    ref_meta = dict(want.meta)
    assert meta.pop("names") == ref_meta.pop("names")
    assert meta == ref_meta


def _both(tmp_path, fn_port, fn_ref, name="img"):
    """Run an import into ``port/`` and ``ref/`` under one base name."""
    for sub in ("port", "ref"):
        (tmp_path / sub).mkdir(exist_ok=True)
    return (fn_port(str(tmp_path / "port" / name)),
            fn_ref(str(tmp_path / "ref" / name)))


@pytest.mark.parametrize("dtype,res", [
    (np.uint16, (2.0, 1.0, 1.0)), (np.float32, None),
    (np.uint8, [5, 0.5, 0.5])])
def test_import_tiff_matches_reference(tmp_path, dtype, res):
    rng = np.random.default_rng(0)
    arr = (rng.random((6, 24, 20)) * 200).astype(dtype)
    src = str(tmp_path / "stack.tif")
    tiff.write_tiff(src, arr)
    got, want = _both(
        tmp_path, lambda p: importer.import_tiff(src, p, resolutions=res),
        lambda p: ref_importer.import_tiff(src, p, resolutions=res))
    _same_archive(got, want)
    assert got.img.shape == (1,) + arr.shape


def _ome_xml(w, h, sz, sc, st, order="XYZCT", phys=None):
    attrs = (f'SizeX="{w}" SizeY="{h}" SizeZ="{sz}" SizeC="{sc}" '
             f'SizeT="{st}" DimensionOrder="{order}"')
    if phys:
        attrs += (f' PhysicalSizeX="{phys[0]}" PhysicalSizeY="{phys[1]}" '
                  f'PhysicalSizeZ="{phys[2]}"')
    return ('<?xml version="1.0"?><OME xmlns="http://www.openmicroscopy.'
            f'org/Schemas/OME/2016-06"><Image><Pixels {attrs}/></Image>'
            '</OME>')


@pytest.mark.parametrize("order,sizes,phys", [
    ("XYZCT", (3, 2, 2), None), ("XYCZT", (3, 2, 2), (0.5, 0.6, 2.0)),
    ("XYZTC", (2, 3, 1), None), ("XYZCT", (4, 1, 1), (1.5, 1.5, 4.0))])
def test_import_ome_tiff_matches_reference(tmp_path, order, sizes, phys):
    sz, sc, st = sizes
    rng = np.random.default_rng(1)
    pages = rng.integers(0, 500, (sz * sc * st, 6, 8)).astype(np.uint16)
    src = str(tmp_path / "ome.tif")
    tiff.write_tiff(src, pages, description=_ome_xml(8, 6, sz, sc, st,
                                                      order, phys))
    assert importer.parse_ome_description(
        tiff.read_tiff(src, return_description=True)[1]) == \
        ref_importer.parse_ome_description(
            ref_tiff.read_tiff(src, return_description=True)[1])
    got, want = _both(tmp_path, lambda p: importer.import_tiff(src, p),
                      lambda p: ref_importer.import_tiff(src, p))
    _same_archive(got, want)


def test_ome_page_count_mismatch_raises_as_the_reference(tmp_path):
    pages = np.zeros((2, 6, 8), np.uint16)
    src = str(tmp_path / "bad.tif")
    tiff.write_tiff(src, pages, description=_ome_xml(8, 6, 5, 1, 1))
    for mod in (importer, ref_importer):
        with pytest.raises(ValueError, match="page count"):
            mod.import_tiff(src, str(tmp_path / f"{mod.__name__}_out"))


@pytest.mark.parametrize("desc", [None, "just a note", "<OME><bad",
                                  "<OME><Image/></OME>"])
def test_parse_ome_description_copy(desc):
    assert importer.parse_ome_description(desc) == \
        ref_importer.parse_ome_description(desc)


@pytest.mark.parametrize("shape,dtype,offset", [
    ((4, 8, 8), np.float32, 0), ((3, 5, 7), np.uint16, 16),
    ((2, 6, 6, 2), np.uint8, 4)])
def test_import_raw_matches_reference(tmp_path, shape, dtype, offset):
    rng = np.random.default_rng(2)
    arr = (rng.random(shape) * 100).astype(dtype)
    raw = str(tmp_path / "vol.raw")
    with open(raw, "wb") as f:
        f.write(b"\0" * offset + arr.tobytes())
    got, want = _both(
        tmp_path, lambda p: importer.import_raw(
            raw, shape, dtype, p, offset_bytes=offset,
            resolutions=(3.0, 1.0, 1.0)),
        lambda p: ref_importer.import_raw(
            raw, shape, dtype, p, offset_bytes=offset,
            resolutions=(3.0, 1.0, 1.0)))
    _same_archive(got, want)


def test_import_planes_to_stack_matches_reference(tmp_path):
    rng = np.random.default_rng(3)
    planes = tmp_path / "planes"
    planes.mkdir()
    for i in range(5):
        page = rng.integers(0, 255, (10, 12)).astype(np.uint8)
        # some files hold more than one page: the first one is imported
        tiff.write_tiff(str(planes / f"plane_{i:03d}.tif"),
                        np.stack([page, page // 2]) if i % 2 else page)
    files = importer.setup_import_dir(str(planes))
    assert files == ref_importer.setup_import_dir(str(planes))
    got, want = _both(
        tmp_path, lambda p: importer.import_planes_to_stack(
            files, p, resolutions=(4.0, 2.0, 2.0)),
        lambda p: ref_importer.import_planes_to_stack(
            files, p, resolutions=(4.0, 2.0, 2.0)))
    _same_archive(got, want)


def test_setup_import_dir_sorts_as_strings_pin(tmp_path):
    """Reference defect kept for parity: a directory of 12 tiles sorts
    ``tile_10`` and ``tile_11`` before ``tile_2`` (``importer.py:253-260``),
    so a grid of 10 tiles or more is read out of order."""
    for t in range(12):
        tiff.write_tiff(str(tmp_path / f"tile_{t}_ch_0.tif"),
                        np.full((2, 3, 3), t, np.uint16))
    names = [os.path.basename(f)
             for f in importer.setup_import_dir(str(tmp_path))]
    assert names == [os.path.basename(f)
                     for f in ref_importer.setup_import_dir(str(tmp_path))]
    assert names[:4] == ["tile_0_ch_0.tif", "tile_10_ch_0.tif",
                         "tile_11_ch_0.tif", "tile_1_ch_0.tif"]
    with pytest.raises(FileNotFoundError):
        importer.setup_import_dir(str(tmp_path), "*.npy")


def _channel_files(tmp_path, n_chl=2, planes=False):
    rng = np.random.default_rng(4)
    vols = []
    for c in range(n_chl):
        vol = rng.integers(0, 300, (4, 9, 7)).astype(np.uint16)
        vols.append(vol)
        if planes:
            for z, page in enumerate(vol):
                tiff.write_tiff(str(tmp_path / f"spec_ch_{c}_z{z}.tif"),
                                page)
        else:
            tiff.write_tiff(str(tmp_path / f"spec_ch_{c}.tif"), vol)
    return vols


@pytest.mark.parametrize("n_chl,planes,channel", [
    (2, False, None), (1, False, None), (2, True, None), (3, False, [0, 2]),
    (2, False, 1)])
def test_multipage_channel_import_matches_reference(tmp_path, n_chl, planes,
                                                    channel):
    _channel_files(tmp_path, n_chl, planes)
    first = str(tmp_path / ("spec_ch_0_z0.tif" if planes else "spec_ch_0.tif"))
    chl_paths, prefix = importer.setup_import_multipage(first)
    ref_paths, ref_prefix = ref_importer.setup_import_multipage(first)
    assert chl_paths == ref_paths and prefix == ref_prefix
    for z_max in (-1, 2):
        assert importer.setup_import_metadata(
            chl_paths, channel, z_max=z_max) == \
            ref_importer.setup_import_metadata(ref_paths, channel,
                                               z_max=z_max)
    got, want = _both(
        tmp_path, lambda p: importer.import_multiplane_images(
            chl_paths, p, channel=channel),
        lambda p: ref_importer.import_multiplane_images(
            ref_paths, p, channel=channel))
    _same_archive(got, want)


def test_multipage_without_channel_files_matches_reference(tmp_path):
    tiff.write_tiff(str(tmp_path / "solo.tif"), np.ones((3, 4, 5), np.uint8))
    path = str(tmp_path / "solo.tif")
    assert importer.setup_import_multipage(path) == \
        ref_importer.setup_import_multipage(path)


@pytest.mark.parametrize("name", [
    "/d/brain_(10,20,3)x(40,50,6).npy", "/d/brain.npy",
    "rel/spec_(0,0,0)x(1,1,1)_image5d.npy", "x_(1,2)x(3,4).tif"])
def test_name_helpers_copy(name):
    assert importer.deconstruct_img_name(name) == \
        ref_importer.deconstruct_img_name(name)
    for kwargs in ({}, {"modifier": "crop"}, {"modifier": "_crop"},
                   {"keep_ext": True}):
        assert importer.filename_to_base(name, **kwargs) == \
            ref_importer.filename_to_base(name, **kwargs)
    _, offset, size = importer.deconstruct_img_name(name)
    for suffixes in (None, {}, {"atlas": "a.mhd"}, {"atlas": None}):
        assert importer.parse_deconstructed_name(
            name, offset, size, suffixes) == \
            ref_importer.parse_deconstructed_name(name, offset, size,
                                                  suffixes)
    assert importer.make_subimage_name(name, (1, 2, 3), (4, 5, 6)) == \
        ref_importer.make_subimage_name(name, (1, 2, 3), (4, 5, 6))


@pytest.mark.parametrize("shape", [(5, 6, 7), (2, 5, 6, 7), (6, 7)])
def test_find_sizes_copy(tmp_path, shape):
    arr = np.zeros(shape, np.uint16)
    for ext in (".tif", ".npy"):
        path = str(tmp_path / f"v{ext}")
        if ext == ".tif":
            if len(shape) > 3:
                continue
            tiff.write_tiff(path, arr)
        else:
            np.save(path, arr)
        assert importer.find_sizes(path) == ref_importer.find_sizes(path)


@pytest.mark.parametrize("lows,highs", [
    ([], []), ([1.0, 2.0, 0.5], [10.0, 9.0, 12.0]),
    ([[1.0, 3.0], [0.5, 4.0]], [[10.0, 20.0], [11.0, 19.0]])])
def test_calc_near_intensity_bounds_copy(lows, highs):
    got = ([7.0], [8.0])
    want = ([7.0], [8.0])
    importer.calc_near_intensity_bounds(*got, lows, highs)
    ref_importer.calc_near_intensity_bounds(*want, lows, highs)
    assert got == want


def test_save_scaling_and_roi_helpers_copy(tmp_path):
    img = np.arange(2 * 3 * 4, dtype=np.uint16).reshape(2, 3, 4)
    got, want = _both(tmp_path,
                      lambda p: importer.save_np_image(img, p + ".tif"),
                      lambda p: ref_importer.save_np_image(img, p + ".tif"))
    assert os.path.basename(got) == os.path.basename(want)
    _same_archive(np_io.read_file(got), ref_np_io.read_file(want))
    big = np.zeros((1, 40, 30, 20))
    small = np.zeros((1, 10, 15, 5))
    np.testing.assert_array_equal(
        importer.calc_scaling(big, small),
        ref_importer.calc_scaling(big, small))
    np.testing.assert_array_equal(
        importer.calc_scaling(None, None, (40, 30, 20), (10, 15, 5)),
        ref_importer.calc_scaling(None, None, (40, 30, 20), (10, 15, 5)))
    np.testing.assert_array_equal(importer.roi_to_image5d(img),
                                  ref_importer.roi_to_image5d(img))


def test_assign_metadata_copy(tmp_path):
    md = {"resolutions": [[1.0, 2.0, 2.0]], "zoom": 2.0, "near_min": None}
    got, want = types.SimpleNamespace(), types.SimpleNamespace()
    importer.assign_metadata(got, md)
    ref_importer.assign_metadata(want, md)
    assert vars(got) == vars(want)
    # an Image5d's resolutions come from its metadata and cannot be set
    path = str(tmp_path / "v.npy")
    img5d = np_io.write_npy(path, np.zeros((2, 3, 4), np.uint8))
    ref_img5d = ref_np_io.read_file(path)
    for mod, img in ((importer, img5d), (ref_importer, ref_img5d)):
        with pytest.raises(AttributeError):
            mod.assign_metadata(img, md)


def _vendor_file(tmp_path, ext, vol):
    """A two-channel ``(Z, Y, X, C)`` ``vol`` as a small file of a vendor
    format, calibrated where the format carries it."""
    from magellanmapper_torch import testing
    from magellanmapper_torch.io import czi_lif
    path = str(tmp_path / f"src{ext}")
    chans = np.moveaxis(vol, -1, 0)
    if ext == ".czi":
        czi_lif.write_czi(path, vol, resolutions=(2.0, 0.5, 0.5))
    elif ext == ".lif":
        czi_lif.write_lif(path, vol, resolutions=(2.0, 0.5, 0.5))
    elif ext == ".nd2":
        data = testing.nd2_bytes(list(vol), testing.nd2_attributes(
            vol.shape[2], vol.shape[1], comp=2, n_seq=vol.shape[0]))
    elif ext == ".oib":
        data = testing.cfbf_bytes({
            f"s_C{c + 1:03d}Z{z + 1:03d}.tif": testing.tiff_bytes(
                chans[c, z]) for c in range(2) for z in range(len(vol))})
    elif ext == ".oif":
        path = testing.oif_files(str(tmp_path), chans[0], name="src")
        for z in range(len(vol)):
            (tmp_path / "src.oif.files" / f"s_C002Z{z + 1:03d}.tif"
             ).write_bytes(testing.tiff_bytes(chans[1, z]))
    else:
        data = testing.ims_bytes(list(chans), ext=[(0, 9), (0, 6), (0, 8)])
    if ext in (".nd2", ".oib", ".ims"):
        with open(path, "wb") as f:
            f.write(data)
    return path


@pytest.mark.parametrize("ext", [".czi", ".lif", ".nd2", ".oib", ".oif",
                                 ".ims"])
def test_vendor_formats_import_as_reference(tmp_path, ext):
    """Each vendor importer (``import_czi`` ... ``import_ims``) writes the
    reference importer's archive and metadata from the same two-channel
    file, channels last; the by-name stubs they replace are gone."""
    vol = np.random.default_rng(3).integers(0, 4000, (4, 6, 9, 2)).astype(
        np.uint16)
    src = _vendor_file(tmp_path, ext, vol)
    fn = getattr(importer, f"import_{ext[1:]}")
    assert fn is importer.VENDOR_IMPORTERS[ext]
    got, want = _both(
        tmp_path, lambda out: fn(src, out_path=out),
        lambda out: getattr(ref_importer, f"import_{ext[1:]}")(
            src, out_path=out))
    _same_archive(got, want)
    np.testing.assert_array_equal(np.asarray(got.img)[0], vol)


# -- the rest of np_io -------------------------------------------------------

def test_setup_images_matches_reference(tmp_path):
    rng = np.random.default_rng(5)
    path = str(tmp_path / "spec.npy")
    np_io.write_npy(path, rng.integers(0, 100, (8, 12, 10)).astype(
        np.uint16), resolutions=[[2.0, 1.0, 1.0]])
    blobs = np.column_stack([rng.integers(0, 8, 6), rng.integers(0, 12, 6),
                             rng.integers(0, 10, 6), np.ones(6) * 2,
                             np.ones((6, 3)), rng.integers(0, 8, (6, 3))])
    archive = ref_blobs.Blobs(blobs.astype(float))
    archive.path = str(tmp_path / "spec_blobs.npz")
    archive.save_archive()
    labels = rng.integers(0, 4, (4, 6, 5)).astype(np.int32)
    ref_sitk_io.write_med_img(
        ref_sitk_io.reg_out_path(path, "annotation.mhd"),
        ref_sitk_io.MedImage(labels))
    kwargs = dict(reg_suffixes={"annotation": "annotation.mhd",
                                "atlas": "missing.mhd"})
    got = np_io.setup_images(path, **kwargs)
    want = ref_np_io.setup_images(path, **kwargs)
    assert sorted(got) == sorted(want) == ["blobs", "img5d", "labels_img"]
    np.testing.assert_array_equal(got["img5d"].img, want["img5d"].img)
    np.testing.assert_array_equal(got["labels_img"], want["labels_img"])
    np.testing.assert_array_equal(got["blobs"].blobs, want["blobs"].blobs)
    sub = np_io.setup_images(path, offset=(1, 2, 3), size=(4, 5, 2),
                             load_blobs=False)
    ref_sub = ref_np_io.setup_images(path, offset=(1, 2, 3), size=(4, 5, 2),
                                     load_blobs=False)
    np.testing.assert_array_equal(sub["img5d"].img, ref_sub["img5d"].img)
    assert "blobs" not in sub and "blobs" not in ref_sub


@pytest.mark.parametrize("compression", [None, "lzw"])
def test_read_tif_matches_reference(tmp_path, compression):
    arr = np.random.default_rng(6).integers(0, 900, (4, 7, 9)).astype(
        np.uint16)
    path = str(tmp_path / "s.tif")
    tiff.write_tiff(path, arr, compression=compression)
    for lazy in (True, False):
        got = np_io.read_tif(path, lazy=lazy)
        want = ref_np_io.read_tif(path, lazy=lazy)
        assert type(got).__name__ == type(want).__name__
        np.testing.assert_array_equal(np.asarray(got[:]), np.asarray(want[:]))


def test_np_io_helpers_copy(tmp_path):
    assert np_io.img_to_blobs_path("/a/b.npy") == \
        ref_np_io.img_to_blobs_path("/a/b.npy")
    npz = str(tmp_path / "a.npz")
    np.savez(npz, x=np.arange(3), o=np.array([{"k": 1}], dtype=object))
    with np.load(npz) as arc, np.load(npz) as ref_arc:
        got, want = np_io.read_np_archive(arc), ref_np_io.read_np_archive(
            ref_arc)
    assert sorted(got) == sorted(want) == ["x"]
    shape = (np.int64(2), 3, np.int32(4))
    assert np_io.fix_memmap_shape(shape) == ref_np_io.fix_memmap_shape(shape)
    for img, is_3d in ((None, False), (np.zeros((1, 2, 3, 4)), False),
                       (np.zeros((1, 2, 3, 4, 3)), False),
                       (np.zeros((2, 3, 4, 2)), True)):
        assert np_io.get_num_channels(img, is_3d) == \
            ref_np_io.get_num_channels(img, is_3d)
    arr = np.random.default_rng(7).random((3, 4, 5)).astype(np.float32)
    for mod, sub in ((np_io, "port"), (ref_np_io, "ref")):
        (tmp_path / sub).mkdir()
        mod.write_raw_file(arr, str(tmp_path / sub / "v.raw"))
        for name in ("v.tif", "w"):
            mod.write_tif(arr, str(tmp_path / sub / name))
    for name in ("v.raw", "v.tif", "w.tif"):
        with open(tmp_path / "port" / name, "rb") as a, \
                open(tmp_path / "ref" / name, "rb") as b:
            assert a.read() == b.read(), name
