"""``magellanmapper_torch.atlas.metrics`` (and its gradients through
``transform.resample``), ``cv.cv_nd`` and ``atlas_refiner.
measure_overlap_combined_labels`` against the reference on seeded inputs.

Tolerances: metric values within 1e-5 absolute (MI over 32x32 bins, sums
in another order); gradients within 2e-5 of the largest gradient
component (the same comparison, through ~50 float32 operations); the
Parzen weights within 1e-6; Dice, Otsu overlaps, the JFA distances and
nearest-seed indices, in-painting and carving exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magellanmapper_tpu.atlas import atlas_refiner as ref_refiner
from magellanmapper_tpu.atlas import metrics as ref
from magellanmapper_tpu.atlas import transform as ref_transform
from magellanmapper_tpu.cv import cv_nd as ref_cv_nd
from magellanmapper_torch.atlas import atlas_refiner, metrics, transform
from magellanmapper_torch.cv import cv_nd

torch.set_num_threads(1)

VAL_ATOL = 1e-5
GRAD_RTOL = 2e-5
SHAPE = (9, 11, 10)
SPACING = (4.0, 5.0, 4.5)
METRICS = ["AdvancedMattesMutualInformation", "ncc", "mse"]


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    fixed = rng.random(SHAPE).astype(np.float32)
    moving = (0.6 * fixed + 0.4 * rng.random(SHAPE)).astype(np.float32)
    mask = (rng.random(SHAPE) > 0.3).astype(np.float32)
    return fixed, moving, mask


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("masked", [False, True])
def test_metric_loss_matches_reference(metric, masked):
    fixed, moving, mask = _pair()
    m_j = jnp.asarray(mask) if masked else None
    m_t = torch.from_numpy(mask) if masked else None
    want = float(ref.metric_loss(metric, jnp.asarray(fixed),
                                 jnp.asarray(moving), mask=m_j))
    got = float(metrics.metric_loss(metric, torch.from_numpy(fixed),
                                    torch.from_numpy(moving), mask=m_t))
    assert abs(got - want) <= VAL_ATOL
    with pytest.raises(ValueError, match="unknown metric"):
        metrics.metric_loss("nope", torch.zeros(3), torch.zeros(3))


def test_ncc_mi_and_parzen_weights_match_reference():
    fixed, moving, mask = _pair(1)
    f, m = jnp.asarray(fixed), jnp.asarray(moving)
    ft, mt = torch.from_numpy(fixed), torch.from_numpy(moving)
    assert abs(float(metrics.ncc(ft, mt)) - float(ref.ncc(f, m))) <= VAL_ATOL
    assert abs(float(metrics.mattes_mi(ft, mt, nbins=16))
               - float(ref.mattes_mi(f, m, nbins=16))) <= VAL_ATOL
    x = np.linspace(-1, 33, 301).astype(np.float32)
    np.testing.assert_allclose(
        metrics._parzen_weights(torch.from_numpy(x), 32).numpy(),
        np.asarray(ref._parzen_weights(jnp.asarray(x), 32)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", ["translation", "affine", "bspline"])
@pytest.mark.parametrize("at_identity", [True, False])
def test_metric_gradient_through_resample_matches_reference(
        metric, kind, at_identity):
    fixed, moving, mask = _pair(2)
    rng = np.random.default_rng(3)
    gs = ref_transform.bspline_grid_shape(SHAPE, SPACING)
    full = {"t": rng.normal(0, 1, 3), "W": rng.normal(0, 0.05, (3, 3)),
            "grid": rng.normal(0, 1, (3,) + gs)}
    keys = {"translation": ["t"], "affine": ["W", "t"],
            "bspline": ["grid"]}[kind]
    params = {k: np.zeros_like(full[k], np.float32) if at_identity
              else (0.3 * full[k]).astype(np.float32) for k in keys}

    def ref_loss(p):
        moved = ref_transform.resample(jnp.asarray(moving), p, kind, SHAPE,
                                       SPACING)
        return ref.metric_loss(metric, jnp.asarray(fixed), moved,
                               mask=jnp.asarray(mask))

    want_v, want_g = jax.value_and_grad(ref_loss)(
        {k: jnp.asarray(v) for k, v in params.items()})
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in params.items()}
    moved = transform.resample(torch.from_numpy(moving), p, kind, SHAPE,
                               SPACING)
    loss = metrics.metric_loss(metric, torch.from_numpy(fixed), moved,
                               mask=torch.from_numpy(mask))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_v)) <= VAL_ATOL
    for k in keys:
        w = np.asarray(want_g[k])
        scale = max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(p[k].grad.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale)


def test_dice_and_measure_overlap_match_reference():
    fixed, moving, _ = _pair(4)
    a, b = fixed > 0.4, moving > 0.5
    assert float(metrics.dice(torch.from_numpy(a), torch.from_numpy(b))) == \
        float(ref.dice(jnp.asarray(a), jnp.asarray(b)))
    assert metrics.measure_overlap(fixed, moving, device="cpu") == \
        ref.measure_overlap(fixed, moving)
    assert metrics.measure_overlap(fixed, moving, 0.3, 0.6,
                                   device="cpu") == \
        ref.measure_overlap(fixed, moving, 0.3, 0.6)
    labels = np.where(moving > 0.45, 3, 0).astype(np.int32)
    assert atlas_refiner.measure_overlap_combined_labels(
        fixed, labels, device="cpu") == \
        ref_refiner.measure_overlap_combined_labels(fixed, labels)


@pytest.mark.parametrize("shape,frac,sampling", [
    ((12, 20, 17), 0.9, None), ((16, 16, 16), 0.98, (2.0, 1.0, 1.0)),
    ((7, 30, 9), 0.5, None), ((1, 12, 12), 0.9, None)])
def test_jfa_edt_and_in_paint_match_reference(shape, frac, sampling):
    rng = np.random.default_rng(5)
    mask = rng.random(shape) < frac
    want_d, want_i = ref_cv_nd.distance_transform_edt(
        mask, sampling, return_indices=True)
    got_d, got_i = cv_nd.distance_transform_edt(
        mask, sampling, return_indices=True, device="cpu")
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)
    roi = rng.integers(0, 9, shape).astype(np.int32)
    np.testing.assert_array_equal(cv_nd.in_paint(roi, mask, device="cpu"),
                                  ref_cv_nd.in_paint(roi, mask))


@pytest.mark.parametrize("thresh,holes", [(None, None), (None, 50),
                                          (0.6, 200)])
def test_carve_matches_reference(thresh, holes):
    vol = np.random.default_rng(6).random((20, 30, 25)).astype(np.float32)
    want = ref_cv_nd.carve(vol, thresh, holes, return_unfilled=True)
    got = cv_nd.carve(vol, thresh, holes, return_unfilled=True,
                      device="cpu")
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
