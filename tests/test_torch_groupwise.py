"""Groupwise registration of ``magellanmapper_torch`` against
``magellanmapper_tpu``: ``reg_engine.register_groupwise`` (the affine
pass over the pyramid, then the joint B-spline refinement on the
groupwise profile's schedule), ``register.register_group`` (joint and
evolving-mean routes) and ``--register group``, on K = 3 seeded brains of
(24, 28, 24) (16,128 voxels: every metric stride 1).

Tolerances: the pyramid within 1e-6; the batched warp (one gather for
the group) equal to each image's own; the loss and its gradient at the
first step of every level within 1e-5 of the reference, relative to the
loss and to the gradient's largest component; after 4 Adam steps of a
level, the affine's linear part within 1e-6 and its shift and the
lattice within 2e-5 voxels (measured: 3e-8, 2e-6 and 1.5e-6; Adam's first
steps are the gradient's sign times the rate, so only a sign flip of a
component near zero would part them further); after a whole run (64
affine and 16 B-spline steps), where float32 noise can turn into sign
flips (as for ``register_duo``), the mean image within 2e-3 and the
variance ratio within 1e-4 of the reference's (measured: 1.1e-4 and
4e-7); through ``register_group`` and the command line, whose shorter
schedules end on steps where a sign flip has not settled, the mean image
within 2e-2 (measured: 7.2e-3), and the evolving-mean route's
translations, rounds of ``register_duo``, within 1e-2 voxels
(``test_torch_reg_engine.py``).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from magellanmapper_tpu.atlas import reg_engine as ref
from magellanmapper_tpu.atlas import register as ref_register
from magellanmapper_tpu.atlas import transform as ref_transform
from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.ops import filters as ref_filters
from magellanmapper_tpu.settings import atlas_prof as ref_prof
from magellanmapper_torch.atlas import reg_engine, register, transform
from magellanmapper_torch.io import cli, np_io
from magellanmapper_torch.settings import atlas_prof

torch.set_num_threads(1)

SHAPE = (24, 28, 24)
#: the groupwise profile's schedule, cut to two levels for this size
SCHEDULE = [2.0, 2.0, 2.0, 1.0, 1.0, 1.0]
GRID_VOXELS = 12.0
STEP_RTOL = 1e-5
FEW_STEPS_ATOL = {"W": 1e-6, "t": 2e-5, "grid": 2e-5}
RUN_ATOL = 2e-3
RATIO_ATOL = 1e-4
ROUTE_ATOL = 2e-2


def _group(seed=0, k=3):
    """K blobby brains, each the same anatomy under its own small affine
    (a shift, a scaling and a shear)."""
    rng = np.random.default_rng(seed)
    base = ndimage.gaussian_filter(rng.random(SHAPE), 1.5)
    zz, yy, xx = np.indices(SHAPE)
    c = [(s - 1) / 2 for s in SHAPE]
    brain = (((zz - c[0]) / 9) ** 2 + ((yy - c[1]) / 11) ** 2
             + ((xx - c[2]) / 9) ** 2) < 1
    base = (base / base.max() * brain).astype(np.float32)
    imgs = []
    for i in range(k):
        w = rng.normal(0, 0.03, (3, 3)).astype(np.float32)
        t = rng.normal(0, 1.2, 3).astype(np.float32)
        imgs.append(np.asarray(ref_transform.resample(
            jnp.asarray(base), {"W": jnp.asarray(w), "t": jnp.asarray(t)},
            "affine", SHAPE)))
    return imgs


@pytest.fixture(scope="module")
def imgs():
    return _group()


def _ref_group_loss(vols, p, stride, spacing=None):
    """The reference's groupwise loss (``reg_engine.py:765-786``: the
    closure inside ``_optimize_group_level``), built from its public
    transform."""
    shape = vols.shape[1:]
    if "grid" in p:
        moved = jax.vmap(lambda vol, w, t, g: ref_transform.resample(
            vol, {"grid": g}, "bspline", shape, spacing,
            pre_affine={"W": w, "t": t}, stride=stride))(
            vols, p["W"], p["t"], p["grid"])
    else:
        moved = jax.vmap(lambda vol, w, t: ref_transform.resample(
            vol, {"W": w, "t": t}, "affine", shape, stride=stride))(
            vols, p["W"], p["t"])
    reg = jnp.mean(p["t"] ** 2) * 1e-4 + jnp.mean(p["W"] ** 2) * 1e-2
    if "grid" in p:
        reg = reg + jnp.mean(p["grid"] ** 2) * 1e-3
    return jnp.mean(jnp.var(moved, axis=0)) + reg


def _params(k, seed, grid_shape=None, scale=1.0):
    rng = np.random.default_rng(seed)
    p = {"W": rng.normal(0, 0.02 * scale, (k, 3, 3)).astype(np.float32),
         "t": rng.normal(0, 0.8 * scale, (k, 3)).astype(np.float32)}
    if grid_shape is not None:
        p["grid"] = rng.normal(0, 0.4 * scale, (k, 3) + tuple(
            grid_shape)).astype(np.float32)
    return p


def _levels(imgs):
    """Both engines' inputs at each level: the pyramid's levels (affine)
    and the schedule's lattices (B-spline), with their strides."""
    vols = np.stack(imgs)
    want = ref_engine_pyramid(vols)
    got = reg_engine._group_pyramid(torch.from_numpy(vols), len(want))
    out = [("affine", g, np.asarray(w), None, None)
           for g, w in zip(got, want)]
    for mult in reg_engine._group_schedule(SCHEDULE):
        spacing = tuple(GRID_VOXELS * m for m in mult)
        out.append(("bspline", torch.from_numpy(vols), vols, spacing,
                    transform.bspline_grid_shape(SHAPE, spacing)))
    return out


def ref_engine_pyramid(vols):
    """The reference's group pyramid (``reg_engine.py:831-836``)."""
    levels = max(1, min(3, int(np.floor(np.log2(max(min(SHAPE) / 8, 1))))
                        + 1))
    pyr = [jnp.asarray(vols)]
    for _ in range(levels - 1):
        sm = jax.vmap(lambda v: ref_filters.gaussian_filter(
            v, 1.0, mode="nearest"))(pyr[0])
        pyr.insert(0, sm[:, ::2, ::2, ::2])
    return pyr


def test_group_pyramid_and_schedule_match_reference(imgs):
    levels = _levels(imgs)
    assert [lv[0] for lv in levels] == ["affine", "affine", "bspline",
                                        "bspline"]
    for _, got, want, _, _ in levels[:2]:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert reg_engine._group_schedule(SCHEDULE) == [(2.0,) * 3, (1.0,) * 3]
    assert reg_engine._group_schedule([4.0, 2.0]) == [(4.0,) * 3,
                                                     (2.0,) * 3]
    assert reg_engine._group_schedule(None) == [(1.0, 1.0, 1.0)]


def test_batched_warp_is_each_image_own(imgs):
    vols = torch.from_numpy(np.stack(imgs))
    gshape = transform.bspline_grid_shape(SHAPE, (8.0,) * 3)
    p = {k: torch.from_numpy(v) for k, v in _params(3, 5, gshape).items()}
    for stride in ((1, 1, 1), (2, 3, 2)):
        coords = transform.group_coords(p, SHAPE, (8.0,) * 3, stride)
        batched = transform.sample_volume(vols, coords)
        for i in range(3):
            one = transform.resample(
                vols[i], {"grid": p["grid"][i]}, "bspline", SHAPE,
                (8.0,) * 3, {"W": p["W"][i], "t": p["t"][i]},
                stride=stride)
            assert torch.equal(batched[i], one)
        labels = (vols * 10).to(torch.int32)
        lab = transform.sample_volume(labels, coords, order=0)
        for i in range(3):
            assert torch.equal(lab[i], transform.sample_volume(
                labels[i], coords[i], order=0))
    relat = transform.resample_grid(p["grid"], (8.0,) * 3, (5, 6, 5),
                                    (6.0,) * 3)
    for i in range(3):
        assert torch.equal(relat[i], transform.resample_grid(
            p["grid"][i], (8.0,) * 3, (5, 6, 5), (6.0,) * 3))


@pytest.mark.parametrize("level", range(4))
@pytest.mark.parametrize("start", ["identity", "perturbed"])
def test_first_step_loss_and_gradient_match_reference(imgs, level, start):
    kind, got_v, want_v, spacing, gshape = _levels(imgs)[level]
    stride = reg_engine._metric_stride(got_v.shape[1:])
    p = _params(3, 10 + level, gshape,
                scale=0.0 if start == "identity" else 1.0)
    loss_fn = reg_engine._group_loss_fn(got_v, stride, spacing)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    loss = loss_fn(tp)
    grads = torch.autograd.grad(loss, list(tp.values()))
    loss = loss.detach()
    want_loss, want_grads = jax.value_and_grad(_ref_group_loss, argnums=1)(
        jnp.asarray(want_v), {k: jnp.asarray(v) for k, v in p.items()},
        stride, spacing)
    assert abs(float(loss) - float(want_loss)) <= STEP_RTOL * abs(
        float(want_loss))
    for (k, _), g in zip(tp.items(), grads):
        w = np.asarray(want_grads[k])
        scale = np.abs(w).max()
        assert scale > 0, k
        assert np.abs(g.numpy() - w).max() <= STEP_RTOL * scale, k


@pytest.mark.parametrize("level", [0, 2])
def test_few_steps_match_reference(imgs, level):
    kind, got_v, want_v, spacing, gshape = _levels(imgs)[level]
    stride = reg_engine._metric_stride(got_v.shape[1:])
    p = _params(3, 20 + level, gshape, scale=0.5)
    lrs = reg_engine._GROUP_LRS_BSPLINE if gshape else reg_engine._GROUP_LRS
    got, got_loss = reg_engine._optimize_group_level(
        got_v, {k: torch.from_numpy(v) for k, v in p.items()}, 4, lrs,
        stride, spacing)
    want, want_loss = ref._optimize_group_level(
        jnp.asarray(want_v), {k: jnp.asarray(v) for k, v in p.items()}, 4,
        lrs, stride, spacing=spacing)
    for k in p:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=FEW_STEPS_ATOL[k],
                                   err_msg=k)
    assert abs(float(got_loss) - float(want_loss)) <= 1e-4 * abs(
        float(want_loss))


def _variance(imgs, per_img, spacing=None):
    vols = torch.from_numpy(np.stack(imgs))
    p = {k: torch.from_numpy(np.stack([q[k] for q in per_img]))
         for k in ("W", "t", "grid") if k in per_img[0]}
    moved = transform.sample_volume(
        vols, transform.group_coords(p, SHAPE, spacing))
    return float(torch.var(moved, dim=0, correction=0).mean())


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.fixture(scope="module")
def runs(imgs):
    kw = dict(max_iter=48, bspline_iter=16, grid_space_voxels=GRID_VOXELS,
              grid_spacing_schedule=SCHEDULE)
    logger = logging.getLogger("magellanmapper_torch.atlas.reg_engine")
    handler, level = _Records(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        got = reg_engine.register_groupwise(imgs, device="cpu", **kw)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    levels = [r.args[0] for r in handler.records
              if r.msg.startswith("groupwise levels")]
    want = ref.register_groupwise(imgs, **kw)
    return got, want, levels[0]


def test_register_groupwise_matches_reference(imgs, runs):
    (mean, per_img), (want_mean, want_per), levels = runs
    assert mean.shape == want_mean.shape and mean.dtype == np.float32
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=RUN_ATOL)
    assert [sorted(p) for p in per_img] == [sorted(p) for p in want_per]
    assert per_img[0]["spacing"] == want_per[0]["spacing"]
    before = float(np.var(np.stack(imgs), axis=0).mean())
    spacing = per_img[0]["spacing"]
    ratio = _variance(imgs, per_img, spacing) / before
    want_ratio = _variance(imgs, want_per, spacing) / before
    assert ratio < 0.5
    assert abs(ratio - want_ratio) <= RATIO_ATOL
    assert [(r["kind"], r["iters"]) for r in levels] == [
        ("affine", 48), ("affine", 24), ("bspline", 8), ("bspline", 8)]
    assert all(r["seconds"] > 0 for r in levels)


def test_register_group_routes_match_reference(imgs):
    prof, want_prof = atlas_prof.AtlasProfile(), ref_prof.AtlasProfile()
    for p in (prof, want_prof):
        p.add_profiles("groupwise")
        p["groupwise_iter_max"] = 32
        p["reg_bspline"]["max_iter"] = 8
        p["reg_bspline"]["grid_spacing_schedule"] = SCHEDULE
        p["reg_bspline"]["grid_space_voxels"] = GRID_VOXELS
    mean, per_img = register.register_group(imgs, prof, device="cpu")
    want_mean, want_per = ref_register.register_group(imgs, want_prof)
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=ROUTE_ATOL)
    assert len(per_img) == 3 and "grid" in per_img[0]
    # the evolving-mean route: rounds of register_duo onto the mean
    for p in (prof, want_prof):
        p["reg_translation"] = p["reg_translation"] | {
            "max_iter": 24, "num_resolutions": 2,
            "metric_similarity": "AdvancedNormalizedCorrelation"}
        p["reg_affine"] = None
        p["reg_bspline"] = None
    mean, results = register.register_group(imgs, prof, n_iters=1,
                                            joint=False, device="cpu")
    want_mean, want_res = ref_register.register_group(
        imgs, want_prof, n_iters=1, joint=False)
    assert len(results) == len(want_res) == 3
    for got, want in zip(results, want_res):
        np.testing.assert_allclose(
            got.stages_numpy()[0][1]["t"], want.stages[0][1]["t"],
            rtol=0, atol=1e-2)
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=ROUTE_ATOL)


def test_group_cli_runs_as_the_reference(imgs, tmp_path):
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(tmp_path / f"brain{i}.npy"))
        np_io.write_npy(paths[i], img)
    prof = tmp_path / "group.yml"
    prof.write_text("groupwise_iter_max: 16\nreg_bspline:\n  max_iter: 4\n"
                    "  grid_space_voxels: 12\n  grid_spacing_schedule: "
                    "[2.0, 2.0, 2.0, 1.0, 1.0, 1.0]\n")
    argv = ["--img"] + paths + ["--register", "group", "--atlas_profile",
                                str(prof)]
    mean, per_img = cli.main(argv + ["--device", "cpu"])
    want_mean, _ = ref_cli.main(argv)
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=ROUTE_ATOL)
    assert sorted(tmp_path.iterdir()) == sorted(
        [tmp_path / "group.yml"] + [tmp_path / f"brain{i}{ext}"
                                    for i in range(3) for ext in (
                                        "_image5d.npy", "_meta.yml")])
