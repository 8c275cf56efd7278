"""Each CUDA kernel of the port against its plain PyTorch version on the
card. These need a CUDA card and ``nvcc``; without a card they skip.
Run them on a machine with a card (``--noconftest``: the suite's conftest
imports jax, which this file does not need):
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

from magellanmapper_torch import device as dev_mod
from magellanmapper_torch import testing
from magellanmapper_torch.kernels import extract_candidates as k2
from magellanmapper_torch.kernels import peak_candidates as k1
from magellanmapper_torch.kernels import prune_overlap as k3
from magellanmapper_torch.kernels import tile_percentiles as k4

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(10, 31, 64, 130), (3, 8, 16, 128)])
def test_peak_candidates_kernel(card, shape):
    rng = np.random.default_rng(0)
    cube = torch.from_numpy(rng.normal(0, 0.1, shape).astype(
        np.float32)).to(card)
    cube[0, 0, 0, :5] = 0.5        # a plateau at the border
    before = dev_mod.LAUNCHES["peak_candidates"]
    got = k1.select_top_sparse(*k1.peak_candidates(cube, 0.1), cube.numel())
    want = k1.select_top_sparse(
        *k1.peak_candidates_plain(cube, 0.1), cube.numel())
    assert dev_mod.LAUNCHES["peak_candidates"] > before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _k1_cube(case, rng):
    """Edge cases of K1: planted NaNs, one, two and twelve scales (two
    scale chunks), x widths of 1, 127 and 130, more peaks than the first
    buffer holds."""
    shape = {"nan": (10, 31, 64, 130), "s1": (1, 40, 64, 96),
             "s2": (2, 40, 64, 96), "s12": (12, 20, 40, 64),
             "x1": (3, 20, 30, 1),
             "x127": (4, 17, 45, 127), "x130": (10, 31, 64, 130),
             "many_peaks": (4, 64, 256, 256)}[case]
    cube = rng.normal(0, 0.1, shape).astype(np.float32)
    if case == "nan":
        flat = cube.reshape(-1)
        flat[rng.integers(0, flat.size, 3000)] = np.nan
        flat[np.flatnonzero(flat > 0.2)[::3] + 1] = np.nan
    return cube, 0.05 if case in ("x1", "many_peaks") else 0.1


@pytest.mark.parametrize("case", [
    "nan", "s1", "s2", "s12", "x1", "x127", "x130", "many_peaks"])
def test_peak_candidates_kernel_edges(card, case):
    cube, thr = _k1_cube(case, np.random.default_rng(3))
    cube = torch.from_numpy(cube).to(card)
    got = k1.select_top_sparse(*k1.peak_candidates(cube, thr), cube.numel())
    want = k1.select_top_sparse(
        *k1.peak_candidates_plain(cube, thr), cube.numel())
    assert want[0].numel() > (k1.FIRST_BUFFER if case == "many_peaks" else 0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_peak_candidates_kernel_relaunches_past_its_buffer(card):
    cube = torch.zeros((1, 2, 512, 512), device=card)
    cube[0, 1] = 1.0               # 262144 plateau peaks
    vals, idx = k1.peak_candidates(cube, 0.5)
    assert len(vals) == 512 * 512
    assert torch.equal(torch.sort(idx).values,
                       torch.arange(512 * 512, 2 * 512 * 512, device=card))


def test_peak_candidates_kernel_rejects_what_it_does_not_take(card):
    with pytest.raises(TypeError):
        k1.peak_candidates(torch.ones((2, 3, 4, 5), device=card,
                                      dtype=torch.float64), 0.1)
    with pytest.raises(ValueError):
        k1.peak_candidates(torch.ones((3, 4, 5), device=card), 0.1)


def _k2_rows(case, r, rng):
    rows = np.full((r, 128), -np.inf, np.float32)
    if case == "sparse":
        hit = rng.random(rows.shape) < 0.02
        rows[hit] = rng.uniform(0, 1, hit.sum())
    elif case == "plateau":
        rows[::3] = 0.5
        rows[1::3, ::5] = 0.25
    elif case == "duplicates":
        rows[:] = rng.integers(0, 4, rows.shape)
        rows[rng.random(rows.shape) < 0.3] = -np.inf
    elif case == "inf":
        rows[:, 7] = np.inf
        rows[::2, 3] = np.inf
    return rows


@pytest.mark.parametrize("case", [
    "sparse", "plateau", "duplicates", "all_neg_inf", "inf"])
@pytest.mark.parametrize("r", [1, 8, 4099, 100003])
def test_extract_candidates_kernel(card, case, r):
    rows = torch.from_numpy(_k2_rows(case, r, np.random.default_rng(r))).to(
        card)
    before = dev_mod.LAUNCHES["extract_candidates"]
    got_v, got_l = k2.extract_candidates(rows)
    want_v, want_l = k2.extract_candidates_plain(rows)
    torch.cuda.synchronize()
    assert dev_mod.LAUNCHES["extract_candidates"] == before + 1
    assert torch.equal(got_v, want_v) and torch.equal(got_l, want_l)


def test_extract_candidates_kernel_rejects_what_it_does_not_take(card):
    with pytest.raises(ValueError):
        k2.extract_candidates(torch.zeros((4, 64), device=card))
    with pytest.raises(TypeError):
        k2.extract_candidates(torch.zeros((4, 128), device=card,
                                          dtype=torch.float64))
    with pytest.raises(TypeError):
        k2.extract_candidates(torch.zeros((128, 4), device=card).t())


@pytest.mark.parametrize("spread,frac_valid", [
    (128.0, 0.2), (40.0, 0.95), (128.0, 0.0)])
def test_prune_overlap_kernel(card, spread, frac_valid):
    rng = np.random.default_rng(1)
    k = 4096
    coords = torch.from_numpy(rng.uniform(0, spread, (k, 3)).astype(
        np.float32)).to(card)
    sigmas = torch.from_numpy(rng.uniform(1.5, 4.0, k).astype(
        np.float32)).to(card)
    valid = torch.from_numpy(rng.random(k) < frac_valid).to(card)
    got = k3.prune_overlap(coords, sigmas, valid, 0.55)
    want = k3.prune_overlap_plain(coords, sigmas, valid, 0.55)
    assert torch.equal(got, want)


def _k3_case(case, rng):
    """Edge cases of K3: a mask that is no prefix, equal radii (the tie
    rule decides), a K of no tile's multiple, the grid search's K."""
    k = {"non_prefix": 4096, "equal_radii": 4096, "k_4099": 4099,
         "k_1": 1, "k16384": 16384}[case]
    box = {"k16384": (64, 256, 256)}.get(case, (24, 24, 24))
    coords = (rng.random((k, 3)) * np.asarray(box)).astype(np.float32)
    sigmas = rng.uniform(1.5, 4.0, k).astype(np.float32)
    valid = rng.random(k) < 0.9
    if case == "non_prefix":
        valid[::2] = False
        valid[-100:] = True
    elif case == "equal_radii":
        sigmas[:] = 2.5
    elif case == "k_1":
        valid[:] = True
    return coords, sigmas, valid


@pytest.mark.parametrize("case", [
    "non_prefix", "equal_radii", "k_4099", "k_1", "k16384"])
def test_prune_overlap_kernel_edges(card, case):
    coords, sigmas, valid = (torch.from_numpy(a).to(card) for a in _k3_case(
        case, np.random.default_rng(4)))
    before = dev_mod.LAUNCHES["prune_overlap"]
    got = k3.prune_overlap(coords, sigmas, valid, 0.55)
    want = k3.prune_overlap_plain(coords, sigmas, valid, 0.55)
    assert dev_mod.LAUNCHES["prune_overlap"] == before + 1
    assert torch.equal(got, want)
    if case != "k_1":
        assert 0 < int(got.sum()) < int(valid.sum())


@pytest.fixture(scope="module")
def k4_cases():
    return testing.k4_cases()


@pytest.mark.parametrize("case", [
    "u16_wide", "u16_all_equal", "u16_hot_bin", "u16_v1", "u16_v7",
    "u16_odd_v", "u16_long_row", "u16_long_rows", "f32_negative",
    "f32_signed_zeros", "f32_odd_v", "f32_long_rows", "u8",
    "u16_15625", "u16_12345", "u16_7", "u8_15625", "u8_12345", "u8_7",
    "f32_15625", "f32_12345", "f32_7"])
def test_tile_percentiles_kernel(card, k4_cases, case):
    """Bit for bit (signs of zero too) against the plain version, on
    the edge cases of
    ``testing.k4_cases`` (negative floats included) and on values 0-254
    at three widths, on both routes of ``k4.split``."""
    if case in k4_cases:
        tiles = torch.from_numpy(k4_cases[case]).to(card)
    else:
        name, v = case.split("_")
        dtype = {"u16": torch.uint16, "u8": torch.uint8,
                 "f32": torch.float32}[name]
        tiles = torch.from_numpy(np.random.default_rng(2).integers(
            0, 255, (252, int(v))).astype(np.int32)).to(card).to(dtype)
    n_chunks, _ = k4.split(*tiles.shape, max(2, tiles.element_size()))
    assert (n_chunks > 1) == ("long" in case)
    before = dev_mod.LAUNCHES["tile_percentiles"]
    for q in testing.K4_QS:
        got = k4.tile_percentiles(tiles, *q)
        want = k4.tile_percentiles_plain(tiles, *q)
        assert torch.equal(got.view(torch.int32),
                           want.view(torch.int32)), (case, q)
    assert dev_mod.LAUNCHES["tile_percentiles"] == before + len(testing.K4_QS)


def test_tile_percentiles_kernel_negative_rows(card):
    """Rows of negative floats, and rows mixing signs, equal the plain
    version (which equals ``np.percentile``) on both routes."""
    rng = np.random.default_rng(5)
    for shape in ((64, 15625), (1, 300001)):
        rows = rng.normal(0, 100, shape).astype(np.float32)
        rows[: shape[0] // 2] = -np.abs(rows[: shape[0] // 2])
        tiles = torch.from_numpy(rows).to(card)
        for q in testing.K4_QS:
            got = k4.tile_percentiles(tiles, *q)
            want = k4.tile_percentiles_plain(tiles, *q)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            np.testing.assert_allclose(
                got.cpu().numpy(), np.percentile(rows, q, axis=1).T,
                rtol=1e-6)
