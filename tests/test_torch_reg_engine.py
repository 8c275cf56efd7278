"""``magellanmapper_torch.atlas.reg_engine`` against
``magellanmapper_tpu.atlas.reg_engine`` on a seeded (20, 28, 28) gauntlet
pair (15,680 voxels, so every metric stride is 1 and no level jitters),
and on a (64, 72, 64) pair for the downsampling route's four levels, its
metric sample cap raised so that every stride is 1 there too.

Tolerances, after up to 160 Adam steps a stage: the translation within
1e-3 voxels, the affine's linear part within 1e-3 and its shift within
1e-2 voxels, the B-spline lattice within 0.05 voxels (Adam divides each
gradient component by its own running RMS, so float32 noise in the
lattice's near-zero components turns into sign flips of full-size
steps), final losses within 1e-4, ``dsc_fixed_moved`` within 2e-3 and the
moved image within 2e-3. The pyramid, mask and schedule helpers, and the
reference's own transform put through the port's ``RegResult``, within
1e-5 (labels exactly).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magellanmapper_tpu.atlas import gauntlet as ref_gauntlet
from magellanmapper_tpu.atlas import reg_engine as ref
from magellanmapper_tpu.settings import atlas_prof as ref_prof
from magellanmapper_torch.atlas import reg_engine
from magellanmapper_torch.settings import atlas_prof

torch.set_num_threads(1)

SHAPE = (20, 28, 28)
PARAM_ATOL = {"t": 1e-2, "W": 1e-3, "grid": 5e-2}
LOSS_ATOL = 1e-4
DSC_ATOL = 2e-3


@pytest.fixture(scope="module")
def pair():
    return ref_gauntlet.build_pair(SHAPE, seed=0, ffd_spacing=16.0,
                                   ffd_ctrl_sigma=3.0)


def _assert_params(got, want, kind):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        atol = 1e-3 if kind == "translation" else PARAM_ATOL[k]
        np.testing.assert_allclose(np.asarray(got[k].cpu()), np.asarray(w),
                                   rtol=0, atol=atol, err_msg=k)


def test_pyramids_and_masks_match_reference(pair):
    img = pair["moving"]
    for levels in (1, 2, 3):
        for fn in ("_pyramid", "_smoothing_pyramid"):
            got = getattr(reg_engine, fn)(torch.from_numpy(img), levels)
            want = getattr(ref, fn)(jnp.asarray(img), levels)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=0, atol=1e-5)
    mask = pair["labels"] > 3
    for radius in (0, 1, 2):
        np.testing.assert_array_equal(
            reg_engine._erode_mask_by(torch.from_numpy(mask), radius).numpy(),
            np.asarray(ref._erode_mask_by(jnp.asarray(mask), radius)))
    for erode in (False, True):
        got = reg_engine._mask_pyramid(torch.from_numpy(mask), 2, erode)
        want = ref._mask_pyramid(jnp.asarray(mask), 2, erode)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_schedule_helpers_match_reference():
    assert reg_engine._LEARNING_RATES == ref._LEARNING_RATES
    assert reg_engine._LR_DECAY_FLOOR == ref._LR_DECAY_FLOOR
    for shape in ((160, 240, 200), (20, 28, 28), (80, 120, 100), (7, 5, 3)):
        for cap in (1 << 14, 2000):
            assert reg_engine._metric_stride(shape, cap) == \
                ref._metric_stride(shape, cap)
    for sched, cap in (([8.0, 8.0, 4.0, 4.0, 4.0, 2.0, 2.0, 2.0, 1.0, 1.0,
                         1.0, 1.0], 99), ([4, 2, 1], 99), ([4, 2, 1], 2),
                       ([2, 2, 1, 1, 1, 1], 5)):
        assert reg_engine._parse_grid_schedule(sched, cap) == \
            ref._parse_grid_schedule(sched, cap)
    p = {"t": torch.ones(3), "grid": torch.ones(3, 2, 2, 2)}
    for kind in ("affine", "bspline"):
        got = reg_engine._scale_params(p, 0.5, kind)
        want = ref._scale_params({k: jnp.asarray(v.numpy())
                                  for k, v in p.items()}, 0.5, kind)
        for k in p:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


#: one stage each, at 2 pyramid levels: the translation under Mattes MI,
#: the affine under NCC with both masks and landmarks, the
#: B-spline with a grid-spacing schedule, and the B-spline on the
#: constant-shape smoothing pyramid with an eroded fixed mask
STAGES = {
    "translation": ("translation", dict(max_iter=96), {}),
    "affine_masks_points": (
        "affine", dict(max_iter=64, metric="ncc", point_based=True),
        dict(masks=True, points=True)),
    "bspline_schedule": (
        "bspline", dict(max_iter=48, grid_space_voxels=6,
                        grid_spacing_schedule=[2.0, 1.0]), {}),
    "bspline_smoothing": (
        "bspline", dict(max_iter=24, grid_space_voxels=8,
                        pyramid_mode="smoothing", erode_mask=True),
        dict(masks=True)),
}


@pytest.mark.parametrize("name", sorted(STAGES))
def test_register_stage_matches_reference(pair, name):
    kind, cfg, extra = STAGES[name]
    stage = ref_prof.make_reg_param_map(kind, num_resolutions=2, **cfg)
    assert stage == atlas_prof.make_reg_param_map(
        kind, num_resolutions=2, **cfg)
    kwargs = {}
    if extra.get("masks"):
        kwargs.update(fixed_mask=(pair["fixed"] > 0.05).astype(np.float32),
                      moving_mask=(pair["moving"] > 0.05).astype(np.float32))
    if extra.get("points"):
        rng = np.random.default_rng(9)
        fix_pts = rng.uniform(4, 16, (5, 3)).astype(np.float32)
        kwargs.update(fix_pts=fix_pts, mov_pts=fix_pts + 0.5)
    pre = None
    if kind == "bspline":
        pre = {"W": np.eye(3, dtype=np.float32) * 0.01,
               "t": np.asarray([0.5, -0.5, 0.25], np.float32)}
    want, want_loss = ref.register_stage(
        pair["fixed"], pair["moving"], stage, kind=kind, pre_affine=pre,
        **kwargs)
    got, got_loss = reg_engine.register_stage(
        pair["fixed"], pair["moving"], stage, kind=kind, pre_affine=pre,
        device="cpu", **kwargs)
    _assert_params(got, want, kind)
    assert np.isfinite(want_loss)
    assert abs(got_loss - want_loss) <= LOSS_ATOL


#: the default profile's downsampling route at all 4 of its levels on a
#: (64, 72, 64) pair, with the metric sample cap raised past the voxel
#: count so every stride is 1: the translation (``_scale_params`` between
#: levels), the affine with both masks (``_mask_pyramid``), and the
#: B-spline with eroded masks and a grid-spacing schedule whose finer
#: levels re-lattice the control points from twice the previous spacing.
#: The affine runs NCC: under Mattes MI its (8, 9, 8) level keeps 134
#: samples in the moving mask, and Adam doubles a float32 difference about
#: every step there (1e-7 after one step, 1.7e-2 voxels after 24)
DEEP_SHAPE = (64, 72, 64)
DEEP_STAGES = {
    "translation": ("translation", dict(max_iter=32), False),
    "affine_masks": ("affine", dict(max_iter=24, metric="ncc"), True),
    "bspline_schedule_erode": (
        "bspline", dict(max_iter=16, grid_space_voxels=16,
                        grid_spacing_schedule=[4.0, 2.0, 1.0, 1.0],
                        erode_mask=True), True),
}


@pytest.fixture(scope="module")
def deep_pair():
    return ref_gauntlet.build_pair(DEEP_SHAPE, seed=0, ffd_spacing=32.0,
                                   ffd_ctrl_sigma=4.0)


@pytest.mark.parametrize("name", sorted(DEEP_STAGES))
def test_four_level_downsampling_stage_matches_reference(deep_pair, name):
    kind, cfg, masks = DEEP_STAGES[name]
    cfg = dict(cfg, num_resolutions=4, num_spatial_samples=1 << 19)
    stage = ref_prof.make_reg_param_map(kind, **cfg)
    assert stage == atlas_prof.make_reg_param_map(kind, **cfg)
    assert reg_engine._metric_stride(DEEP_SHAPE, 1 << 19) == (1, 1, 1)
    kwargs = {}
    if masks:
        kwargs.update(
            fixed_mask=(deep_pair["fixed"] > 0.05).astype(np.float32),
            moving_mask=(deep_pair["moving"] > 0.05).astype(np.float32))
    clock = reg_engine._LevelClock(torch.device("cpu"))
    want, want_loss = ref.register_stage(
        deep_pair["fixed"], deep_pair["moving"], stage, kind=kind, **kwargs)
    got, got_loss = reg_engine.register_stage(
        deep_pair["fixed"], deep_pair["moving"], stage, kind=kind,
        device="cpu", clock=clock, **kwargs)
    assert [r["shape"] for r in clock.read()] == [
        [-(-s // 2 ** k) for s in DEEP_SHAPE] for k in (3, 2, 1, 0)]
    _assert_params(got, want, kind)
    assert abs(got_loss - want_loss) <= LOSS_ATOL


#: Mattes MI with both masks at the affine's coarsest level of the
#: four-level route, (8, 9, 8): the first step's loss within 1e-6 and its
#: gradient within 5e-5 of the largest component, relative (measured:
#: 1.8e-7 and 1.5e-5; summing the 32-bin joint histogram over 168 masked
#: samples in another order moves the last bits)
MI_LOSS_RTOL = 1e-6
MI_GRAD_RTOL = 5e-5


@pytest.mark.parametrize("start", ["identity", "perturbed"])
def test_four_level_mattes_mi_masked_first_step_matches_reference(
        deep_pair, start):
    import jax
    from magellanmapper_tpu.atlas import metrics as ref_metrics
    from magellanmapper_tpu.atlas import transform as ref_transform

    metric = "AdvancedMattesMutualInformation"
    masks = [(deep_pair[k] > 0.05).astype(np.float32)
             for k in ("fixed", "moving")]
    fixed, moving = (reg_engine._pyramid(torch.from_numpy(deep_pair[k]), 4)[0]
                     for k in ("fixed", "moving"))
    fmask, mmask = (reg_engine._mask_pyramid(
        torch.from_numpy(m), 4, False)[0].to(torch.float32) for m in masks)
    w_fixed, w_moving = (ref._pyramid(jnp.asarray(deep_pair[k]), 4)[0]
                         for k in ("fixed", "moving"))
    w_fmask, w_mmask = (ref._mask_pyramid(jnp.asarray(m), 4, False)[0]
                        .astype(jnp.float32) for m in masks)
    assert tuple(fixed.shape) == (8, 9, 8)
    np.testing.assert_array_equal(fmask.numpy(), np.asarray(w_fmask))
    np.testing.assert_array_equal(mmask.numpy(), np.asarray(w_mmask))
    rng = np.random.default_rng(3)
    scale = 0.0 if start == "identity" else 1.0
    p = {"W": (rng.normal(0, 0.02, (3, 3)) * scale).astype(np.float32),
         "t": (rng.normal(0, 0.5, 3) * scale).astype(np.float32)}

    def ref_loss(q):
        # the reference's level loss (reg_engine.py:182-198) at stride 1
        moved = ref_transform.resample(w_moving, q, "affine", w_fixed.shape)
        mm = jax.lax.stop_gradient(ref_transform.resample(
            w_mmask, q, "affine", w_fixed.shape))
        mask = w_fmask * (mm > 0.5).astype(jnp.float32)
        return ref_metrics.metric_loss(metric, w_fixed, moved, mask=mask)

    want, want_grads = jax.value_and_grad(ref_loss)(
        {k: jnp.asarray(v) for k, v in p.items()})
    loss_fn = reg_engine._level_loss_fn(
        fixed, moving, None, "affine", metric, None, fixed_mask=fmask,
        moving_mask=mmask)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    loss = loss_fn(tp)
    grads = torch.autograd.grad(loss, list(tp.values()))
    assert abs(float(loss.detach()) - float(want)) <= MI_LOSS_RTOL * abs(
        float(want))
    for (k, _), g in zip(tp.items(), grads):
        w = np.asarray(want_grads[k])
        assert np.abs(g.numpy() - w).max() <= MI_GRAD_RTOL * np.abs(w).max()


@pytest.fixture(scope="module")
def duos(pair):
    """Both engines' three-stage registration of the pair (160, 80 and 40
    Adam steps at the coarse level, half that at the fine one)."""
    profs = []
    for cls in (ref_prof.AtlasProfile, atlas_prof.AtlasProfile):
        prof = cls()
        prof.add_profiles("smalliter")
        for key, n in (("reg_translation", 160), ("reg_affine", 80),
                       ("reg_bspline", 40)):
            prof[key]["max_iter"] = n
        prof["reg_bspline"]["grid_space_voxels"] = 8
        profs.append(prof)
    want = ref.register_duo(pair["fixed"], pair["moving"], profs[0],
                            record_stage_dsc=True)
    got = reg_engine.register_duo(pair["fixed"], pair["moving"], profs[1],
                                  record_stage_dsc=True, device="cpu")
    return got, want


def test_register_duo_matches_reference(duos):
    (moved, result), (want_moved, want) = duos
    assert [k for k, _ in result.stages] == [k for k, _ in want.stages]
    for (kind, got_p), (_, want_p) in zip(result.stages_numpy(),
                                          want.stages):
        _assert_params({k: torch.from_numpy(v) for k, v in got_p.items()},
                       want_p, kind)
    assert result.bspline_spacing == want.bspline_spacing
    assert sorted(result.metrics) == sorted(want.metrics)
    for k, v in want.metrics.items():
        assert abs(result.metrics[k] - v) <= DSC_ATOL, k
    np.testing.assert_allclose(moved, want_moved, rtol=0, atol=2e-3)
    assert [(r["kind"], r["level"], r["iters"]) for r in result.levels] == [
        (k, lvl, n) for k, n0 in (("translation", 160), ("affine", 80),
                                  ("bspline", 40))
        for lvl, n in enumerate((n0, n0 // 2))]
    assert all(r["seconds"] > 0 for r in result.levels)


@pytest.mark.parametrize("order", [0, 1])
def test_reference_transform_through_the_port(pair, duos, order):
    """The reference's found transform as the port's ``RegResult``: the
    moved atlas within 1e-5, the labels equal."""
    _, (_, want) = duos
    port = reg_engine.RegResult.from_numpy(
        want.stages, want.fixed_shape, want.bspline_spacing, "cpu")
    img = pair["labels"] if order == 0 else pair["moving"]
    got = port.transform_img(img, order=order)
    expect = want.transform_img(img, order=order)
    if order == 0:
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, expect)
    else:
        np.testing.assert_allclose(got, expect, rtol=0, atol=1e-5)


def test_jittered_levels_repeat_on_the_cpu(pair):
    """With fewer samples than voxels the levels stride and jitter; the
    offsets come from a seeded CPU generator, so two runs agree bit for
    bit."""
    stage = atlas_prof.make_reg_param_map(
        "affine", 24, num_resolutions=2, num_spatial_samples=1500)
    assert reg_engine._metric_stride(SHAPE, 1500) != (1, 1, 1)
    a, _ = reg_engine.register_stage(pair["fixed"], pair["moving"], stage,
                                     device="cpu")
    b, _ = reg_engine.register_stage(pair["fixed"], pair["moving"], stage,
                                     device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k])


def test_later_slices_raise_and_name_their_roadmap_item(pair):
    prof = atlas_prof.AtlasProfile()
    with pytest.raises(NotImplementedError, match="queue item 10"):
        reg_engine.register_duo(pair["fixed"], pair["moving"], prof,
                                mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="queue item 10"):
        reg_engine.register_groupwise([pair["fixed"], pair["moving"]],
                                      mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="queue item 10"):
        reg_engine.register_stage(pair["fixed"], pair["moving"],
                                  prof["reg_affine"], mesh=object(),
                                  device="cpu")


def test_engine_asks_for_the_card(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    prof = atlas_prof.AtlasProfile()
    for call in (
            lambda: reg_engine.register_duo(pair["fixed"], pair["moving"],
                                            prof),
            lambda: reg_engine.register_stage(
                pair["fixed"], pair["moving"], prof["reg_translation"]),
            lambda: reg_engine.RegResult.from_numpy([], SHAPE)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
