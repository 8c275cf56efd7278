"""``magellanmapper_torch.atlas.transform`` against
``magellanmapper_tpu.atlas.transform`` on seeded inputs.

Tolerances: ``sample_volume`` at order 0, the coordinate grids, the
B-spline basis and every integer result exactly; the coordinate gradient
of ``sample_volume`` at integer coordinates (where every optimisation
starts) exactly; order-1 samples within 1e-6 absolute (values in [0, 1]);
mapped coordinates (up to ~40 voxels) within 1e-5 absolute, since the
B-spline products sum in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magellanmapper_tpu.atlas import reg_engine as ref_engine
from magellanmapper_tpu.atlas import transform as ref
from magellanmapper_torch.atlas import reg_engine, transform

torch.set_num_threads(1)

SHAPE = (9, 11, 10)
SPACING = (4.0, 5.0, 4.5)
COORD_ATOL = 1e-5


def _params(seed=0):
    rng = np.random.default_rng(seed)
    gs = ref.bspline_grid_shape(SHAPE, SPACING)
    return {"t": rng.normal(0, 1, 3).astype(np.float32),
            "W": rng.normal(0, 0.05, (3, 3)).astype(np.float32),
            "grid": rng.normal(0, 1, (3,) + gs).astype(np.float32)}


def _j(d):
    return None if d is None else {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return None if d is None else {
        k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _coords_with_ties(seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2, 12, (3, 4, 5, 6)).astype(np.float32)
    c[:, 0] = np.round(c[:, 0]) + 0.5     # ties at +.5
    c[:, 1] = -0.5                        # ties at -.5 (round to -1: out)
    c[:, 2, 0] = -1.5
    c[:, 2, 1] = np.asarray(SHAPE, np.float32)[:, None] - 0.5  # upper edge
    c[:, 3] = np.nextafter(np.float32(2.5), np.float32(0))  # just below .5
    return c


@pytest.mark.parametrize("order", [0, 1])
def test_sample_volume_matches_reference(order):
    vol = np.random.default_rng(1).random(SHAPE).astype(np.float32)
    c = _coords_with_ties()
    want = np.asarray(ref.sample_volume(jnp.asarray(vol), jnp.asarray(c),
                                        order=order))
    got = transform.sample_volume(torch.from_numpy(vol), torch.from_numpy(c),
                                  order=order).numpy()
    if order == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sample_volume_labels_keep_their_integers():
    labels = np.random.default_rng(2).integers(
        0, 1000, SHAPE).astype(np.int32)
    c = _coords_with_ties(3)
    want = np.asarray(ref.sample_volume(
        jnp.asarray(labels.astype(np.float32)), jnp.asarray(c), order=0))
    got = transform.sample_volume(torch.from_numpy(labels),
                                  torch.from_numpy(c), order=0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_label_ids_past_2_24_stay_exact_pin():
    """Recorded deviation (ROADMAP §3): the reference's
    ``RegResult.transform_img`` samples labels as float32, so an Allen
    CCFv3 ID of 614,454,277 comes back as 614,454,272; the port gathers
    labels in their own integer dtype."""
    labels = np.zeros((6, 7, 8), np.uint32)
    labels[2:5, 2:6, 3:7] = 614_454_277
    labels[0, 0, 0] = 16_777_217
    stages = [("affine", {"W": np.zeros((3, 3), np.float32),
                          "t": np.asarray([0.2, -0.3, 0.4], np.float32)})]
    want = ref_engine.RegResult(stages, labels.shape).transform_img(
        labels, order=0)
    got = reg_engine.RegResult.from_numpy(
        stages, labels.shape, device="cpu").transform_img(labels, order=0)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, labels)
    assert set(np.unique(want)) == {0, 16_777_216, 614_454_272}


def test_sample_gradient_at_integer_coordinates_is_exact():
    """At an integer coordinate the gradient comes from the upper corner,
    ``v[i+1] - v[i]``, and is ``0 - v[i]`` at the upper edge."""
    rng = np.random.default_rng(4)
    vol = rng.random(SHAPE).astype(np.float32)
    w = rng.random((3, 4, 5)).astype(np.float32)
    c = np.stack([rng.integers(0, s, (3, 4, 5)) for s in SHAPE]).astype(
        np.float32)
    c[0, 0, 0] = SHAPE[0] - 1                 # upper edge
    want = jax.grad(lambda cc: jnp.sum(jnp.asarray(w) * ref.sample_volume(
        jnp.asarray(vol), cc)))(jnp.asarray(c))
    ct = torch.from_numpy(c).requires_grad_(True)
    torch.sum(torch.from_numpy(w) * transform.sample_volume(
        torch.from_numpy(vol), ct)).backward()
    np.testing.assert_array_equal(ct.grad.numpy(), np.asarray(want))
    i, j, k = (int(v) for v in c[:, 0, 0, 0])
    assert ct.grad[0, 0, 0, 0] == -w[0, 0, 0] * vol[i, j, k]


@pytest.mark.parametrize("stride,offset", [
    ((1, 1, 1), None), ((2, 3, 2), (1, 2, 1)), ((2, 2, 2), None),
    ((4, 4, 4), (3, 3, 3))])
def test_coords_and_strided_sample_match_reference(stride, offset):
    vol = np.random.default_rng(5).random(SHAPE).astype(np.float32)
    off_j = None if offset is None else jnp.asarray(offset, jnp.int32)
    np.testing.assert_array_equal(
        transform._coords(SHAPE, stride, offset, "cpu").numpy(),
        np.asarray(ref._coords(SHAPE, stride, off_j)))
    np.testing.assert_array_equal(
        transform.strided_sample(torch.from_numpy(vol), stride,
                                 offset).numpy(),
        np.asarray(ref.strided_sample(jnp.asarray(vol), stride, off_j)))


@pytest.mark.parametrize("kind", ["translation", "affine", "bspline",
                                  "bspline_pre_affine"])
@pytest.mark.parametrize("stride,offset", [
    ((1, 1, 1), None), ((2, 3, 2), (1, 2, 1)), ((2, 2, 2), None)])
def test_transform_coords_and_resample_match_reference(kind, stride, offset):
    p = _params()
    pre = None
    if kind == "bspline_pre_affine":
        kind, pre = "bspline", {"W": p["W"], "t": p["t"]}
    keys = {"translation": ["t"], "affine": ["W", "t"],
            "bspline": ["grid"]}[kind]
    params = {k: p[k] for k in keys}
    off_j = None if offset is None else jnp.asarray(offset, jnp.int32)
    want = np.asarray(ref.transform_coords(
        _j(params), kind, SHAPE, SPACING, _j(pre), stride, off_j))
    got = transform.transform_coords(
        _t(params), kind, SHAPE, SPACING, _t(pre), stride, offset).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=COORD_ATOL)
    vol = np.random.default_rng(6).random(SHAPE).astype(np.float32)
    want = np.asarray(ref.resample(jnp.asarray(vol), _j(params), kind, SHAPE,
                                   SPACING, _j(pre), 1, stride, off_j))
    got = transform.resample(torch.from_numpy(vol), _t(params), kind, SHAPE,
                             SPACING, _t(pre), 1, stride, offset).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bspline_helpers_match_reference():
    p = _params(7)
    grid = p["grid"]
    assert transform.bspline_grid_shape((160, 240, 200), (50.0,) * 3) == \
        ref.bspline_grid_shape((160, 240, 200), (50.0,) * 3)
    for args in ((40, 5, 10.0, 1), (37, 9, 4.5, 3), (8, 4, 50.0, 2)):
        np.testing.assert_array_equal(transform._bspline_basis(*args),
                                      ref._bspline_basis(*args))
    u = np.linspace(-3, 3, 101)
    np.testing.assert_array_equal(transform.cubic_bspline(u),
                                  ref.cubic_bspline(u))
    for stride in ((1, 1, 1), (2, 3, 1)):
        np.testing.assert_allclose(
            transform.bspline_displacement(
                torch.from_numpy(grid), SHAPE, SPACING, stride).numpy(),
            np.asarray(ref.bspline_displacement(
                jnp.asarray(grid), SHAPE, SPACING, stride)),
            rtol=0, atol=COORD_ATOL)
    pts = np.random.default_rng(8).uniform(-1, 11, (50, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        transform.bspline_displacement_at(
            torch.from_numpy(grid), torch.from_numpy(pts), SPACING).numpy(),
        np.asarray(ref.bspline_displacement_at(
            jnp.asarray(grid), jnp.asarray(pts), SPACING)),
        rtol=0, atol=COORD_ATOL)
    new_shape, new_sp = (5, 6, 5), (3.0, 3.5, 3.0)
    np.testing.assert_allclose(
        transform.resample_grid(torch.from_numpy(grid), SPACING, new_shape,
                                new_sp).numpy(),
        np.asarray(ref.resample_grid(jnp.asarray(grid), SPACING, new_shape,
                                     new_sp)), rtol=0, atol=COORD_ATOL)
    pre = {"W": p["W"], "t": p["t"]}
    for kind, params, pre_a in (("translation", {"t": p["t"]}, None),
                                ("affine", pre, None),
                                ("bspline", {"grid": grid}, pre)):
        np.testing.assert_allclose(
            transform.transform_points(
                torch.from_numpy(pts), _t(params), kind, SHAPE, SPACING,
                _t(pre_a)).numpy(),
            np.asarray(ref.transform_points(
                jnp.asarray(pts), _j(params), kind, SHAPE, SPACING,
                _j(pre_a))), rtol=0, atol=COORD_ATOL)
    for kind, gs in (("translation", None), ("affine", None),
                     ("bspline", (4, 5, 6))):
        got = transform.identity_params(kind, gs, "cpu")
        want = ref.identity_params(kind, gs)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
