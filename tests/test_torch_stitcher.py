"""The port's stitching (``magellanmapper_torch.stitch``) against the
reference's, both on the CPU: phase correlation (surface, peak, shift),
the reference's whole-tile pairwise step, the global optimisation, fusion
(bit for bit, in slabs too), the tile grid and TileConfiguration files,
and the acquisition helpers; the port's check of each pair's peak by the
overlap's cross-correlation (a recorded deviation) and the reference's
mesoSPIM tile-order defect, kept for parity."""

import filecmp
import os

import numpy as np
import pytest
import torch

from magellanmapper_tpu.io import pipelines as ref_pipelines
from magellanmapper_tpu.settings.roi_prof import ROIProfile as RefProfile
from magellanmapper_tpu.stitch import acquisition as ref_acquisition
from magellanmapper_tpu.stitch import stitcher as ref_stitcher
from magellanmapper_torch import testing
from magellanmapper_torch.io import np_io, pipelines, tiff
from magellanmapper_torch.settings.roi_prof import ROIProfile
from magellanmapper_torch.stitch import acquisition, stitcher

torch.set_num_threads(1)
CPU = torch.device("cpu")


def make_scene(shape=(16, 200, 200), seed=0, n=120):
    """The reference test's scene (``tests/test_stitcher.py``): Gaussian
    spots, normalised."""
    rng = np.random.default_rng(seed)
    scene = np.zeros(shape, np.float32)
    zz, yy, xx = np.indices(shape).astype(np.float32)
    for cz, cy, cx in np.column_stack(
            [rng.uniform(2, s - 2, n) for s in shape]):
        scene += np.exp(-((zz - cz) ** 2 + (yy - cy) ** 2
                          + (xx - cx) ** 2) / 6.0)
    return scene / scene.max()


def cut_tiles(scene, tile_shape, positions):
    return [np.array(scene[tuple(slice(p, p + s) for p, s in zip(
        pos, tile_shape))]) for pos in np.round(positions).astype(int)]


def two_by_two(seed=3):
    """The reference test's 2 x 2 grid: tiles of (16, 110, 110), overlap
    0.2, jittered by up to 3 voxels (tile 0 at its nominal position)."""
    scene = make_scene()
    grid = stitcher.TileGrid(2, 2, (16, 110, 110), overlap_frac=0.2)
    nominal = grid.nominal_positions()
    jitter = np.random.default_rng(seed).uniform(-3, 3, nominal.shape)
    jitter[0] = 0
    true_pos = np.clip(nominal + jitter, 0, None)
    true_pos[:, 0] = 0
    return cut_tiles(scene, grid.tile_shape, true_pos), grid, np.round(
        true_pos)


def ref_grid(grid):
    return ref_stitcher.TileGrid(grid.rows, grid.cols, grid.tile_shape,
                                 grid.overlap_frac, grid.snake)


# -- phase correlation -------------------------------------------------------

@pytest.mark.parametrize("shape,shift,seed", [
    ((8, 48, 48), (0, 5, 7), 0), ((12, 40, 52), (2, -6, 9), 1),
    ((9, 33, 31), (-1, 4, -3), 2), ((16, 64, 40), (3, 11, -8), 3)])
def test_phase_correlation_matches_reference(shape, shift, seed):
    big = tuple(s + 2 * abs(d) + 4 for s, d in zip(shape, shift))
    scene = make_scene(big, seed, n=80)
    noise = np.random.default_rng(seed).normal(0, 0.01, big)
    scene = (scene + noise).astype(np.float32)
    a = scene[tuple(slice(0, s) for s in shape)]
    b = np.roll(scene, tuple(-d for d in shift), (0, 1, 2))[
        tuple(slice(0, s) for s in shape)]
    want = np.asarray(ref_stitcher._phase_corr_surface(a, b))
    got = stitcher._phase_corr_surface(
        stitcher._spectrum(a, CPU), stitcher._spectrum(b, CPU), a.shape)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    assert int(torch.argmax(got)) == int(np.argmax(want))
    got_shift, got_score = stitcher.phase_correlation(a, b, device="cpu")
    want_shift, want_score = ref_stitcher.phase_correlation(a, b)
    np.testing.assert_allclose(got_shift, want_shift, atol=1e-3, rtol=0)
    assert got_score == pytest.approx(want_score, rel=1e-4)


def test_peak_ties_take_the_first_flat_index():
    surf = torch.zeros(4, 5, 6)
    surf[1, 2, 3] = surf[2, 0, 0] = surf[3, 4, 5] = 1.0
    surf[1, 2, 4] = 0.25
    peak, vals = stitcher._peak(surf)
    assert peak.tolist() == list(np.unravel_index(
        np.argmax(surf.numpy()), surf.shape))
    # peak, then lo/hi along z, y and x, wrapped
    assert vals.tolist() == [1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.25]


def test_refinement_rounds_in_float32_as_the_reference():
    # the peak past half of z (it wraps to -1) and at x = 0 (its low
    # neighbour wraps to x = 8)
    surf = np.zeros((5, 7, 9), np.float32)
    surf[4, 3, 0] = np.float32(1.0)
    surf[3, 3, 0], surf[0, 3, 0] = np.float32(0.3), np.float32(0.7)
    surf[4, 2, 0], surf[4, 4, 0] = np.float32(0.1), np.float32(0.1 + 1e-8)
    surf[4, 3, 8], surf[4, 3, 1] = np.float32(0.6), np.float32(0.2)
    peak, vals = stitcher._peak(torch.from_numpy(surf))
    got = stitcher._refine(peak, vals, surf.shape)
    # the reference's arithmetic on the same surface
    want_peak = np.unravel_index(np.argmax(surf), surf.shape)
    shift = np.asarray(want_peak, float)
    for ax, n in enumerate(surf.shape):
        if shift[ax] > n / 2:
            shift[ax] -= n
    for ax, n in enumerate(surf.shape):
        lo, hi = list(want_peak), list(want_peak)
        lo[ax] = (want_peak[ax] - 1) % n
        hi[ax] = (want_peak[ax] + 1) % n
        c0, c1, c2 = surf[tuple(lo)], surf[want_peak], surf[tuple(hi)]
        denom = c0 - 2 * c1 + c2
        if abs(denom) > 1e-12:
            shift[ax] += 0.5 * (c0 - c2) / denom
    np.testing.assert_array_equal(got[0], shift)
    assert got[1] == float(surf[want_peak])


def test_phase_shifts_match_reference_pairwise_shifts():
    tiles, grid, _ = two_by_two()
    got = stitcher.phase_shifts(tiles, grid, device="cpu")
    want = ref_stitcher.compute_pairwise_shifts(tiles, ref_grid(grid))
    assert [(i, j) for i, j, _, _ in got] == [(i, j) for i, j, _, _ in want]
    for (_, _, d, s), (_, _, rd, rs) in zip(got, want):
        np.testing.assert_allclose(d, rd, atol=1e-3, rtol=0)
        assert s == pytest.approx(rs, rel=1e-4)


def test_overlap_check_recovers_the_reference_scene_pin():
    """Recorded deviation: the reference correlates whole tiles whitened
    over a floor of ``1e-2 * max(mag)``, so on its own 2 x 2 scene its
    positions are 0.72 voxels off; the port checks each peak by the
    overlap's cross-correlation and lands within 0.02."""
    tiles, grid, truth = two_by_two()
    _, ref_pos = ref_stitcher.stitch(tiles, ref_grid(grid))
    fused, pos = stitcher.stitch(tiles, grid, device="cpu")
    ref_err = np.abs((ref_pos - ref_pos[0]) - (truth - truth[0])).max()
    err = np.abs((pos - pos[0]) - (truth - truth[0])).max()
    assert 0.5 < ref_err < 1.0
    assert err < 0.02
    # the fused volume is the reference's fusion at the port's positions
    want = ref_stitcher.fuse_tiles(tiles, pos)
    np.testing.assert_array_equal(fused.view(np.int32), want.view(np.int32))


def test_small_tiles_at_ten_percent_overlap_stitch_far_off_pin():
    """Recorded limit of the port's route (and the reference's): on a 3 x
    3 set of (24, 96, 96) tiles of random nuclei, offsets within +-3, the
    whole-tile phase peak of most pairs lies tens of voxels off at the
    reference's default 10% overlap and the overlap check climbs at most
    ``NCC_MAX_STEPS`` voxels from it, so tiles land over 5 voxels off;
    at 30% overlap the port lands within 0.02 and the reference within
    a voxel. A fix of the route (several phase peaks, or a search around
    the nominal offset) turns the first half of this test."""
    from test_torch_pipelines import nuclei_scene

    shift = 3
    for overlap in (0.1, 0.3):
        span = [round(2 * 96 * (1 - overlap)) + 96 + 2 * shift] * 2
        vol = nuclei_scene((24, *span), seed=0, n=200)
        tiles, planted = testing.make_tiles(vol, 3, 3, overlap, seed=0,
                                            max_shift=shift, max_dz=0,
                                            device="cpu")
        grid = stitcher.TileGrid(3, 3, tiles[0].shape, overlap)
        _, pos = stitcher.stitch(tiles, grid, device="cpu")
        _, ref_pos = ref_stitcher.stitch(tiles, ref_grid(grid))
        err = np.abs((pos - pos[0]) - (planted - planted[0])).max()
        ref_err = np.abs((ref_pos - ref_pos[0])
                         - (planted - planted[0])).max()
        if overlap == 0.1:
            assert err > 5 and ref_err > 5
        else:
            assert err < 0.02 and ref_err < 1


@pytest.mark.parametrize("start", [(0, 0, 0), (2, -3, 1), (-1, 2, 3)])
def test_refine_by_overlap_climbs_to_the_integer_offset(start, monkeypatch):
    scene = make_scene((20, 90, 90), seed=4, n=150)
    scene = scene + np.random.default_rng(4).normal(0, 0.02, scene.shape)
    truth = np.array([2, 5, 40])
    a = torch.from_numpy(scene[:14, :60, :60].astype(np.float32))
    b = torch.from_numpy(scene[2:16, 5:65, 40:100].astype(np.float32))
    got = stitcher.refine_by_overlap(a, b, truth + np.array(start, float))
    np.testing.assert_allclose(got, truth, atol=0.05)
    # without room to climb, it stops where it is
    monkeypatch.setattr(stitcher, "NCC_MAX_STEPS", 0)
    stuck = stitcher.refine_by_overlap(a, b, truth + 3.0)
    assert np.abs(stuck - (truth + 3)).max() <= 0.5


# -- global optimisation and fusion -----------------------------------------

@pytest.mark.parametrize("seed,thresh,anchored", [
    (0, 0.0, True), (1, 0.3, True), (2, 0.0, False)])
def test_globally_optimize_matches_reference(seed, thresh, anchored):
    rng = np.random.default_rng(seed)
    grid = stitcher.TileGrid(3, 4, (10, 50, 60), 0.15)
    pairs = [(i, j, rng.normal(0, 40, 3), float(rng.uniform(0, 1)))
             for i, j in grid.adjacent_pairs()]
    nominal = grid.nominal_positions() + 7.5 if anchored else None
    got = stitcher.globally_optimize(pairs, 12, nominal, thresh)
    want = ref_stitcher.globally_optimize(pairs, 12, nominal, thresh)
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)


@pytest.mark.parametrize("dtype,blend,slab", [
    (np.float32, "linear", None), (np.uint16, "linear", None),
    (np.uint16, "linear", 3 * 50 * 60), (np.float32, "max", 1),
    (np.uint8, "linear", 7 * 50 * 60)])
def test_fuse_tiles_bit_equal_reference(monkeypatch, dtype, blend, slab):
    if slab is not None:
        monkeypatch.setattr(stitcher, "FUSE_SLAB_VOXELS", slab)
    rng = np.random.default_rng(5)
    tiles = [(rng.random((9, 30, 34)) * 4000).astype(dtype)
             for _ in range(4)]
    positions = np.array([[0.4, -2.5, 3.5], [1.5, 0.2, 27.7],
                          [2.5, 24.6, -1.5], [0.0, 26.5, 29.49]])
    got = stitcher.fuse_tiles(tiles, positions, blend=blend, device="cpu")
    want = ref_stitcher.fuse_tiles(tiles, positions, blend=blend)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    ipos, extent = stitcher.fuse_layout(tiles, positions)
    assert extent == want.shape


def test_fuse_tiles_single_tile_voxels_keep_its_value():
    rng = np.random.default_rng(6)
    tiles = [rng.integers(0, 65535, (5, 20, 20)).astype(np.uint16)
             for _ in range(2)]
    fused = stitcher.fuse_tiles(tiles, np.array([[0, 0, 0], [0, 0, 15.]]),
                                device="cpu")
    np.testing.assert_array_equal(fused[:, :, :15], tiles[0][:, :, :15])
    np.testing.assert_array_equal(fused[:, :, 20:], tiles[1][:, :, 5:])


def test_tile_grid_and_tile_config_copy(tmp_path):
    for rows, cols, snake in ((2, 3, True), (3, 2, False), (1, 4, True)):
        grid = stitcher.TileGrid(rows, cols, (8, 100, 90), 0.12, snake)
        want = ref_grid(grid)
        np.testing.assert_array_equal(grid.nominal_positions(),
                                      want.nominal_positions())
        assert grid.adjacent_pairs() == want.adjacent_pairs()
        assert [grid.tile_index(r, c) for r in range(rows)
                for c in range(cols)] == [want.tile_index(r, c)
                                          for r in range(rows)
                                          for c in range(cols)]
    names = ["t0.tif", "t1.tif", "t 2.tif"]
    pos = np.array([[0.0, 0, 0], [0.25, 10.04, 90.5], [-1, 200.96, -3.3]])
    got, want = str(tmp_path / "port.txt"), str(tmp_path / "ref.txt")
    stitcher.write_tile_config(got, names, pos)
    ref_stitcher.write_tile_config(want, names, pos)
    assert filecmp.cmp(got, want, shallow=False)
    g_names, g_pos = stitcher.read_tile_config(got)
    r_names, r_pos = ref_stitcher.read_tile_config(got)
    assert g_names == r_names == names
    np.testing.assert_array_equal(g_pos, r_pos)


# -- acquisition -------------------------------------------------------------

@pytest.mark.parametrize("rows,cols,size,overlap,direction,start", [
    (2, 3, (100.0, 80.0), 0.1, "bi", "right"),
    (3, 2, (512, 512), 0.15, "uni", "left"),
    (2, 2, (64.5, 32.0, 10.0), 0.2, "bi", "left")])
def test_tile_config_grid_files_identical(tmp_path, rows, cols, size,
                                          overlap, direction, start):
    args = ("img.tif", rows, cols, size, overlap, direction, start)
    assert acquisition.build_tile_config(*args) == \
        ref_acquisition.build_tile_config(*args)
    for sub in ("port", "ref"):
        (tmp_path / sub).mkdir()
    got = acquisition.write_tile_config_grid(str(tmp_path / "port"), *args)
    want = ref_acquisition.write_tile_config_grid(str(tmp_path / "ref"),
                                                  *args)
    assert os.path.basename(got) == os.path.basename(want)
    assert filecmp.cmp(got, want, shallow=False)


def test_tile_config_rejects_as_the_reference():
    for bad in ({"directionality": "zigzag"}, {"start_direction": "up"}):
        for mod in (acquisition, ref_acquisition):
            with pytest.raises(ValueError):
                mod.build_tile_config("i.tif", 2, 2, (10, 10), 0.1, **bad)


def _mesospim_dir(path, parts, zoom=True):
    path.mkdir()
    for key, arr in parts.items():
        raw = path / f"{key}.raw"
        np.ascontiguousarray(arr).tofile(raw)
        (path / f"{key}.raw_meta.txt").write_text(
            f"[z_planes] {arr.shape[0]}\n[y_pixels] {arr.shape[1]}\n"
            f"[x_pixels] {arr.shape[2]}\n[z_stepsize] 5.0\n"
            "[Pixelsize in um] 2.6\n" + ("[Zoom] 1x\n" if zoom else ""))
    return str(path)


def test_mesospim_conversion_identical(tmp_path):
    rng = np.random.default_rng(7)
    parts = {f"{chl}_{tile}": (rng.random((4, 8, 10)) * 900).astype(np.uint16)
             for chl in ("488", "561") for tile in ("X0Y0", "X1Y0")}
    outs = []
    for sub in ("port", "ref"):
        src = _mesospim_dir(tmp_path / sub, parts)
        mod = acquisition if sub == "port" else ref_acquisition
        outs.append(mod.mesospim_to_tif(src))
        meta = f"{src}/488_X0Y0.raw_meta.txt"
        assert acquisition.parse_mesospim_meta(meta) == \
            ref_acquisition.parse_mesospim_meta(meta)
        assert acquisition.mesospim_shape_res(
            acquisition.parse_mesospim_meta(meta)) == \
            ref_acquisition.mesospim_shape_res(
                ref_acquisition.parse_mesospim_meta(meta))
    got, want = outs
    assert [(os.path.basename(p), t, c) for p, t, c in got] == \
        [(os.path.basename(p), t, c) for p, t, c in want]
    for (p, _, _), (q, _, _) in zip(got, want):
        assert filecmp.cmp(p, q, shallow=False)
    with pytest.raises(FileNotFoundError):
        acquisition.mesospim_to_tif(str(tmp_path / "port"), pattern="*.x")


def test_mesospim_stitches_the_wrong_mosaic_pin(tmp_path):
    """Reference defect kept for parity (``acquisition.py:92-139``,
    ``stitcher.py:111-122``): mesoSPIM's ``X<c>Y<r>`` tiles are numbered
    in sorted-name order, column by column, but ``TileGrid`` pairs them
    row by row, so the reference test's 2 x 2 scene (true positions
    (0,0,0), (0,0,24), (0,24,0), (0,24,24)) stitches to other positions
    and a fused volume larger than (4, 60, 60). The port numbers the
    tiles as the reference does: its whole-tile phase step gives the
    reference's positions, and its pipeline's fused volume is not the
    scene either."""
    from scipy import ndimage
    rng = np.random.default_rng(0)
    scene = (ndimage.gaussian_filter(
        rng.random((4, 60, 60)).astype(np.float32), 2) * 1000).astype(
        np.uint16)
    parts = {"488_X0Y0": scene[:, :36, :36], "488_X1Y0": scene[:, :36, 24:],
             "488_X0Y1": scene[:, 24:, :36], "488_X1Y1": scene[:, 24:, 24:]}
    grid_args = {"rows": 2, "cols": 2, "overlap": 0.33, "mesospim": True}
    out = pipelines.run_pipeline(
        "stitching", str(tmp_path / "port.npy"), ROIProfile(),
        tile_grid={"dir": _mesospim_dir(tmp_path / "port_tiles", parts),
                   **grid_args}, device="cpu")
    want = ref_pipelines.run_pipeline(
        "stitching", str(tmp_path / "ref.npy"), RefProfile(),
        tile_grid={"dir": _mesospim_dir(tmp_path / "ref_tiles", parts),
                   **grid_args})
    fused = np_io.read_file(out["stitching"]).img[0]
    ref_fused = np.asarray(np_io.read_file(want["stitching"]).img[0])
    assert ref_fused.shape != (4, 60, 60) and fused.shape != (4, 60, 60)
    # tiles in the reference's order: X0Y0, X0Y1, X1Y0, X1Y1
    files = sorted(os.listdir(tmp_path / "port_tiles"))
    tifs = [f for f in files if f.endswith(".tif")]
    assert tifs == ["tile_0_ch_0.tif", "tile_1_ch_0.tif", "tile_2_ch_0.tif",
                    "tile_3_ch_0.tif"]
    tiles = [tiff.read_tiff(str(tmp_path / "port_tiles" / f)) for f in tifs]
    np.testing.assert_array_equal(tiles[1], parts["488_X0Y1"])
    grid = stitcher.TileGrid(2, 2, tiles[0].shape, 0.33)
    pairs = stitcher.phase_shifts(tiles, grid, device="cpu")
    pos = stitcher.globally_optimize(pairs, 4, grid.nominal_positions())
    _, ref_pos = ref_stitcher.stitch(tiles, ref_grid(grid))
    np.testing.assert_allclose(pos, ref_pos, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(
        ref_fused, ref_stitcher.fuse_tiles(tiles, ref_pos))
    truth = np.array([[0, 0, 0], [0, 0, 24], [0, 24, 0], [0, 24, 24]])
    assert np.abs(ref_pos - truth).max() > 10
