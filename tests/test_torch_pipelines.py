"""The port's pipeline runner (``magellanmapper_torch.io.pipelines``)
against the reference's, both on the CPU: detection with resume, TIFF
import, stitching of a small tile set and the full run from tiles to
blobs, each stage's output held to the reference's on the same input."""

import os
import sys

import numpy as np
import pytest
import torch

from magellanmapper_tpu.cv import blobs as ref_blobs
from magellanmapper_tpu.io import np_io as ref_np_io
from magellanmapper_tpu.io import pipelines as ref_pipelines
from magellanmapper_tpu.settings.roi_prof import ROIProfile as RefProfile
from magellanmapper_tpu.stitch import stitcher as ref_stitcher
from magellanmapper_torch import testing
from magellanmapper_torch.cv import blobs
from magellanmapper_torch.io import np_io, pipelines, tiff
from magellanmapper_torch.settings.roi_prof import ROIProfile
from magellanmapper_torch.stitch import stitcher

torch.set_num_threads(1)


def _profiles():
    prof, ref = ROIProfile(), RefProfile()
    prof.add_profiles("lightsheet")
    ref.add_profiles("lightsheet")
    return prof, ref


def _blobs(path, mod=blobs):
    return mod.Blobs().load_blobs(path).blobs


def nuclei_scene(shape, seed, n):
    """Seeded uint16 nuclei (the detector's sigma) at random places over
    N(200, 30) noise: no lattice for phase correlation to alias on."""
    rng = np.random.default_rng(seed)
    r = 9
    g = np.arange(-r, r + 1, dtype=np.float32)
    stamp = np.exp(-(g[:, None, None] ** 2 + g[None, :, None] ** 2
                     + g[None, None, :] ** 2) / np.float32(2 * 2.7 ** 2))
    vol = np.pad(rng.normal(200, 30, shape).astype(np.float32), r)
    for (z, y, x), amp in zip(rng.integers(0, shape, (n, 3)),
                              rng.uniform(1500, 3000, n)):
        vol[z:z + 2 * r + 1, y:y + 2 * r + 1, x:x + 2 * r + 1] += \
            np.float32(amp) * stamp
    return np.clip(vol[r:-r, r:-r, r:-r], 0, 65535).astype(np.uint16)


def test_detection_with_resume_matches_reference(tmp_path):
    vol = nuclei_scene((24, 96, 96), seed=0, n=60)
    prof, ref_prof = _profiles()
    for sub in ("port", "ref"):
        (tmp_path / sub).mkdir()
        np_io.write_npy(str(tmp_path / sub / "vol.npy"), vol,
                        resolutions=[[1.0, 1.0, 1.0]])
    port, ref = str(tmp_path / "port" / "vol.npy"), str(
        tmp_path / "ref" / "vol.npy")
    out = pipelines.run_pipeline("detection", port, prof, device="cpu")
    want = ref_pipelines.run_pipeline("detection", ref, ref_prof)
    assert sorted(out) == sorted(want) == ["detection"]
    got = _blobs(out["detection"])
    assert len(got) > 20
    assert testing.rows_equal(got, _blobs(want["detection"], ref_blobs))
    # resumed: the archive is there, nothing runs again
    mtime = os.path.getmtime(out["detection"])
    assert pipelines.run_pipeline("detection", port, prof,
                                  device="cpu") == {}
    assert os.path.getmtime(out["detection"]) == mtime


def test_import_pipeline_matches_reference(tmp_path):
    vol = nuclei_scene((6, 30, 28), seed=1, n=4)
    outs = []
    for sub, run in (("port", lambda p: pipelines.run_pipeline(
            "import", p, resolutions=(2.0, 1.0, 1.0), device="cpu")),
                     ("ref", lambda p: ref_pipelines.run_pipeline(
                         "import", p, resolutions=(2.0, 1.0, 1.0)))):
        (tmp_path / sub).mkdir()
        src = str(tmp_path / sub / "stack.tif")
        tiff.write_tiff(src, vol)
        outs.append(run(src))
    got, want = outs
    assert sorted(got) == sorted(want) == ["import"]
    a, b = np_io.read_file(got["import"]), ref_np_io.read_file(
        want["import"])
    np.testing.assert_array_equal(a.img, b.img)
    assert a.meta == b.meta


@pytest.fixture(scope="module")
def tile_set(tmp_path_factory):
    """A 2 x 2 set of uint16 tiles of a random nuclei scene, 25% nominal
    overlap, offsets within +-3 (``testing.make_tiles``), as TIFF files."""
    vol = nuclei_scene((30, 130, 130), seed=0, n=300)
    tiles, planted = testing.make_tiles(vol, 2, 2, 0.25, seed=0,
                                        max_shift=3, max_dz=2, device="cpu")
    tile_dir = tmp_path_factory.mktemp("tiles")
    for t, tile in enumerate(tiles):
        tiff.write_tiff(str(tile_dir / f"tile_{t}_ch_0.tif"), tile)
    return {"dir": str(tile_dir), "rows": 2, "cols": 2, "overlap": 0.25}, \
        tiles, planted


def test_stitching_pipeline_recovers_the_tiles_pin(tmp_path, tile_set):
    """The port's stitching stage fuses the tiles at positions within 0.02
    voxels of where they were cut, bit for bit as the reference's fusion
    at those positions; the reference's own stage, correlating whole
    tiles only, lands over a voxel off here (recorded deviation)."""
    grid, tiles, planted = tile_set
    out = pipelines.run_pipeline("stitching", str(tmp_path / "acq.npy"),
                                 tile_grid=grid, resolutions=(2.0, 1.0, 1.0),
                                 device="cpu")
    fused = np_io.read_file(out["stitching"])
    assert fused.meta["resolutions"] == [[2.0, 1.0, 1.0]]
    _, pos = stitcher.stitch(tiles, stitcher.TileGrid(
        2, 2, tiles[0].shape, 0.25), device="cpu")
    err = np.abs((pos - pos[0]) - (planted - planted[0])).max()
    assert err < 0.02
    want = ref_stitcher.fuse_tiles(tiles, pos)
    np.testing.assert_array_equal(np.asarray(fused.img[0]).view(np.int32),
                                  want.view(np.int32))
    _, ref_pos = ref_stitcher.stitch(tiles, ref_stitcher.TileGrid(
        2, 2, tiles[0].shape, 0.25))
    assert np.abs((ref_pos - ref_pos[0]) - (planted - planted[0])).max() > 1


def test_full_pipeline_stages_match_reference(tmp_path, tile_set):
    """``full`` from the tiles: the port stitches, then transforms and
    detects the fused image; the reference's transformation and detection
    stages on the same fused image give the same image and blobs. A
    second ``full`` resumes: nothing runs again."""
    grid, _, _ = tile_set
    prof, ref_prof = _profiles()
    img = str(tmp_path / "acq.tif")
    out = pipelines.run_pipeline("full", img, prof, rescale=0.5,
                                 tile_grid=grid, device="cpu")
    assert sorted(out) == ["detection", "stitching", "transformation"]
    fused_path = out["stitching"]
    assert pipelines.run_pipeline("full", img, prof, rescale=0.5,
                                  tile_grid=grid, device="cpu") == {}
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    ref_path = str(ref_dir / os.path.basename(fused_path))
    ref_np_io.write_npy(ref_path, np.asarray(np_io.read_file(
        fused_path).img))
    want = ref_pipelines.run_pipeline("full", ref_path, ref_prof,
                                      rescale=0.5)
    assert sorted(want) == ["detection", "transformation"]
    small = np_io.read_file(out["transformation"])
    ref_small = ref_np_io.read_file(want["transformation"])
    assert small.img.shape == ref_small.img.shape
    np.testing.assert_allclose(small.img, ref_small.img, rtol=1e-5,
                               atol=1e-3)
    for key in ("resolutions", "scaling"):
        assert small.meta[key] == ref_small.meta[key]
    got = _blobs(out["detection"])
    assert len(got) > 50
    assert testing.rows_equal(got, _blobs(want["detection"], ref_blobs))


def test_resumed_full_run_reads_the_fused_image_pin(tmp_path, tile_set):
    """Reference defect (``io/pipelines.py:54-76``): a resumed ``full``
    run whose fused image exists skips stitching but goes on with the
    tiles' path, so it imports a TIFF that does not exist and fails; the
    port's later stages read the fused image."""
    grid, _, _ = tile_set
    prof, ref_prof = _profiles()
    for sub in ("port", "ref"):
        (tmp_path / sub).mkdir()
    port_img, ref_img = str(tmp_path / "port" / "acq.tif"), str(
        tmp_path / "ref" / "acq.tif")
    pipelines.run_pipeline("stitching", port_img, tile_grid=grid,
                           device="cpu")
    ref_pipelines.run_pipeline("stitching", ref_img, tile_grid=grid)
    with pytest.raises(FileNotFoundError):
        ref_pipelines.run_pipeline("full", ref_img, ref_prof, rescale=0.5,
                                   tile_grid=grid)
    out = pipelines.run_pipeline("full", port_img, prof, rescale=0.5,
                                 tile_grid=grid, device="cpu")
    assert sorted(out) == ["detection", "transformation"]
    assert out["transformation"].endswith("acq_fused_scale0.5.npy")
    assert out["detection"].endswith("acq_fused_blobs.npz")


@pytest.mark.parametrize("kwargs,named", [
    ({"s3_bucket": "bucket"}, "boto3"),
    ({"notify_url": "http://localhost:1"}, "x")])
def test_cloud_stages_raise_by_name(tmp_path, monkeypatch, kwargs, named):
    """The cloud stages run as the reference's: without boto3 the S3
    download raises the reference's ``ImportError`` naming it; with a
    webhook, a missing image raises ``FileNotFoundError`` naming it
    before any message is sent."""
    monkeypatch.setitem(sys.modules, "boto3", None)
    errs = []
    for mod, extra in ((pipelines, {"device": "cpu"}), (ref_pipelines, {})):
        with pytest.raises((ImportError, FileNotFoundError)) as err:
            mod.run_pipeline("full", str(tmp_path / "x.npy"), **kwargs,
                             **extra)
        errs.append((type(err.value), str(err.value)))
    assert errs[0] == errs[1] and named in errs[0][1]


def test_unknown_pipeline_raises_as_the_reference(tmp_path):
    for mod in (pipelines, ref_pipelines):
        with pytest.raises(ValueError, match="unknown pipeline"):
            mod.run_pipeline("stitch", str(tmp_path / "x.npy"))
    assert pipelines.PIPELINES == ref_pipelines.PIPELINES
    # download without a bucket does nothing, as in the reference
    assert pipelines.run_pipeline("download", str(tmp_path / "x.npy"),
                                  device="cpu") == {}
