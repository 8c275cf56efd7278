"""Per-tile percentiles (K4) and block preprocessing of the port against
the JAX reference.

K4's plain version must equal ``tile_percentiles_pallas`` exactly: both
take the same exact order statistics and interpolate with the same f32
steps. Preprocessing goes through a float32 chain whose sums (tile means,
the sigma-8 blur) run in another order than the reference's, hence
atol 1e-5 on values in [0, 1].
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from magellanmapper_tpu.cv import stack_detect as ref_sd
from magellanmapper_tpu.ops import pallas_kernels
from magellanmapper_tpu.ops import preproc as ref_preproc
from magellanmapper_tpu.settings.roi_prof import ROIProfile
from magellanmapper_torch.cv import stack_detect as sd
from magellanmapper_torch.kernels import tile_percentiles as k4
from magellanmapper_torch.ops import preproc

torch.set_num_threads(1)

ATOL = 1e-5


def _tiles(kind, t, v, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "u16":
        return rng.integers(0, 4000, (t, v)).astype(np.uint16)
    if kind == "u16_duplicates":
        return rng.integers(100, 104, (t, v)).astype(np.uint16)
    if kind == "u8":
        return rng.integers(0, 256, (t, v)).astype(np.uint8)
    if kind == "f32_duplicates":
        return rng.integers(0, 3, (t, v)).astype(np.float32) * 0.25
    return rng.gamma(2.0, 0.3, (t, v)).astype(np.float32)


@pytest.mark.parametrize("kind", [
    "u16", "u16_duplicates", "u8", "f32", "f32_duplicates"])
@pytest.mark.parametrize("v,q", [
    (15625, (5, 98.5)), (1000, (5, 99.5)), (37, (0, 100))])
def test_tile_percentiles_matches_reference(kind, v, q):
    tiles = _tiles(kind, 9, v, seed=v)
    want = np.asarray(pallas_kernels.tile_percentiles_pallas(
        jnp.asarray(tiles), *q))
    got = k4.tile_percentiles(torch.from_numpy(tiles), *q).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got, np.percentile(tiles, q, axis=1).T, rtol=1e-6)


@pytest.mark.parametrize("t", [1, 252])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("v", [1, 7, 15625, 2555904, 2 ** 31 - 1])
def test_tile_percentiles_split_covers_each_element_once(t, itemsize, v):
    """The host's route for K4: chunk i of a row covers
    [i * chunk, min(v, (i + 1) * chunk)); the chunks tile the row with no
    gap, no overlap and no empty chunk, fit the kernel's int arguments,
    and a row longer than one CTA's staging takes the split route."""
    n, chunk = k4.split(t, v, itemsize)
    starts = np.arange(n, dtype=np.int64) * chunk
    ends = np.minimum(starts + chunk, v)
    assert starts[0] == 0 and ends[-1] == v
    assert np.all(starts[1:] == ends[:-1]) and np.all(ends > starts)
    assert int((ends - starts).sum()) == v
    assert chunk < 2 ** 31 and n < 2 ** 31
    if n == 1:
        assert chunk == v and v * itemsize <= k4.SHORT_ROW_BYTES
    else:
        assert v * itemsize > k4.SHORT_ROW_BYTES and chunk % 8 == 0
    assert (n > 1) == (v >= 2555904)


@settings(max_examples=300, deadline=None)
@given(q=st.floats(0, 100), v=st.integers(1, 2 ** 31 - 1))
def test_tile_percentiles_rank_matches_reference(q, v):
    """``_rank`` against the reference's own rank and f32 weight
    (``pallas_kernels.py:303-307``: ``int(np.floor(r)) + 1`` and
    ``jnp.float32(r - np.floor(r))``)."""
    r = q / 100.0 * (v - 1)
    want = (int(np.floor(r)) + 1, float(jnp.float32(r - np.floor(r))))
    k, frac = k4._rank(q, v)
    assert (k, frac) == want and isinstance(k, int)
    assert 1 <= k <= v


@pytest.mark.parametrize("q", [(5, 98.5), (0.01, 99.99), (25, 75)])
def test_tile_percentiles_negative_floats(q):
    """Rows with negative values: the plain version (the port's CPU route,
    which the kernel equals on the card) equals ``np.percentile``; the
    reference's ``tile_percentiles_pallas`` orders the raw float bits, which
    puts negative values in reverse, and misses it (a recorded deviation,
    ROADMAP §3)."""
    rng = np.random.default_rng(11)
    tiles = rng.normal(0, 100, (6, 1000)).astype(np.float32)
    tiles[:3] = -np.abs(tiles[:3])
    exact = np.percentile(tiles, q, axis=1).T
    got = k4.tile_percentiles(torch.from_numpy(tiles), *q).numpy()
    np.testing.assert_allclose(got, exact, rtol=1e-6)
    ref = np.asarray(pallas_kernels.tile_percentiles_pallas(
        jnp.asarray(tiles), *q, interpret=True))
    assert not np.allclose(ref, exact, rtol=1e-3)


def test_tile_percentiles_plain_orders_signed_zeros():
    """The plain version puts ``-0.0`` before ``+0.0``, as the kernel's
    keys do, so the two agree on a zero's sign; by value it is still
    ``np.percentile``."""
    rng = np.random.default_rng(12)
    tiles = np.zeros((4, 1001), np.float32)
    tiles[:, :251] = -0.0           # ranks 1-251 are -0.0, 252-1001 +0.0
    tiles = rng.permuted(tiles, axis=1)
    tiles[3, :5] = [-1.0, -1.0, -1.0, 1.0, 1.0]     # still equal by value
    for q, neg in (((0, 100), [True, False]), ((25, 25.2), [True, False]),
                   ((10, 50), [True, False])):
        got = k4.tile_percentiles(torch.from_numpy(tiles[:3]), *q).numpy()
        assert np.signbit(got).tolist() == [neg] * 3, q
    for q in ((0, 100), (5, 98.5), (25.01, 25.03)):
        np.testing.assert_array_equal(
            k4.tile_percentiles(torch.from_numpy(tiles), *q).numpy(),
            np.percentile(tiles, q, axis=1).T)


def test_tile_percentiles_rejects_other_dtypes():
    with pytest.raises(TypeError):
        k4.tile_percentiles(torch.zeros((2, 5), dtype=torch.int32), 5, 95)


def _vol(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def test_saturate_and_denoise_match_reference():
    vol = _vol((20, 24, 28), 1) * 3000
    want = ref_preproc.saturate(jnp.asarray(vol), 5, 98.5, 900.0)
    got = preproc.saturate(torch.from_numpy(vol), 5, 98.5, 900.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    args = (0.0, 0.5, 0.02, 0.3, 0.1)
    want = ref_preproc.denoise(want, *args)
    got = preproc.denoise(got, *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_tv_chambolle_matches_reference():
    vol = _vol((8, 9, 10), 2)
    want = np.asarray(ref_preproc.tv_chambolle(jnp.asarray(vol), 0.05))
    got = preproc.tv_chambolle(torch.from_numpy(vol), 0.05).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _block_params(profiles, **overrides):
    prof = ROIProfile()
    prof.add_profiles(profiles)
    prof.update(overrides)
    shape = (30, 60, 60)
    blocks = sd.setup_blocks(prof, shape, (1.0, 1.0, 1.0))
    block_shape = np.minimum(blocks.max_pixels + blocks.overlap, shape)
    return sd.step_params(prof, blocks, block_shape, (1.0, 1.0, 1.0),
                          near_max=2500.0)


def _block(dtype):
    rng = np.random.default_rng(3)
    vol = rng.gamma(2.0, 300.0, (30, 60, 60))
    vol[10:16, 20:30, 35:41] += 3000
    return vol.astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_preprocess_block_matches_both_reference_forms(dtype):
    """One port form against the reference's fused (Pallas percentiles)
    and tiled (per-tile vmap) preprocessing."""
    params = _block_params("lightsheet")
    prep = dict(params.preproc_items)
    vol = _block(dtype)
    got = sd.preprocess_block(
        torch.from_numpy(vol), params.denoise_shape,
        params.preproc_items).numpy()
    fused = np.asarray(ref_sd._preproc_sub_blocks_fused(
        jnp.asarray(vol), params.denoise_shape, prep))
    tiled = np.asarray(ref_sd._preproc_sub_blocks(
        jnp.asarray(vol), params.denoise_shape, prep))
    assert got.shape == vol.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, fused, atol=ATOL)
    np.testing.assert_allclose(got, tiled, atol=ATOL)


def test_preprocess_block_total_variation_route():
    """Profiles with total-variation denoising take the reference's tiled
    route on every backend; the port runs TV per tile in the same form.
    ``clip_vmax`` stays at lightsheet's 98.5, where the tiled route's
    ``jnp.percentile`` is exact (see the next test)."""
    params = _block_params("lightsheet,minpreproc", clip_vmax=98.5)
    prep = dict(params.preproc_items)
    assert prep["tot_var_denoise"]
    vol = _block(np.uint16)
    got = sd.preprocess_block(
        torch.from_numpy(vol), params.denoise_shape,
        params.preproc_items).numpy()
    want = np.asarray(ref_sd._preproc_sub_blocks(
        jnp.asarray(vol), params.denoise_shape, prep))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_tiled_reference_percentile_rank_pin():
    """Fault of the reference's tiled route, pinned: ``jnp.percentile``
    forms the rank ``q / 100 * (n - 1)`` in float32, so at minpreproc's
    ``clip_vmax`` 99.99 over a 25^3 tile its upper bound misses numpy's
    by ~2e-5 relative. The port, like the reference's fused route
    (``tile_percentiles_pallas``), takes numpy's exact percentile."""
    tile = _block(np.uint16)[:25, :25, :25]
    q = (0.0, 99.99)
    got = k4.tile_percentiles(torch.from_numpy(tile.reshape(1, -1)), *q)
    exact = np.percentile(tile, q)
    np.testing.assert_allclose(got.numpy()[0], exact, rtol=1e-7)
    tiled = np.asarray(jnp.percentile(
        jnp.asarray(tile, jnp.float32), jnp.asarray(q, jnp.float32)))
    assert abs(tiled[1] - exact[1]) > 1e-6 * exact[1]


def test_preprocess_whole_block_without_denoise_tiles():
    params = _block_params("lightsheet")
    vol = _block(np.float32)
    got = sd.preprocess_block(
        torch.from_numpy(vol), None, params.preproc_items).numpy()
    want = np.asarray(ref_sd._preproc_one(
        jnp.asarray(vol), None, params.preproc_items))
    np.testing.assert_allclose(got, want, atol=ATOL)
