"""The port's registration over the ranks of a mesh against the
reference's mesh-sharded registration (``tests/test_reg_sharded.py``).

One world of four CPU ranks over gloo runs every case of this module once
(the ``world`` fixture); the reference runs here on its virtual CPU
devices on the same seeded inputs. The reference's metric mesh is
(sp, spy) = (4, 2) over 8 devices; the port's is (sp, spy) = (2, 2) over
4 ranks, and meshes of 1 and 2 ranks are sub-meshes of the world.

Tolerances, as the reference's tests state them: a level's loss within
2e-5 of the reference's unsharded loss; its gradients at rtol 2e-3, atol
2e-6; a stage's translation within 0.2 voxels of the reference's sharded
stage (and 0.5 of the truth); the chain's DSC within 0.03; groupwise
means at rtol 1e-3, atol 1e-4 (the B-spline stage 2e-3, 2e-4) and
parameters at 1e-3 (grids 2e-3); two ranks holding one image each equal
the port's one-process groupwise run and loss gradient bit for bit, and
four ranks its gradient at rtol 2e-3, atol 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from magellanmapper_tpu.atlas import metrics as ref_metrics
from magellanmapper_tpu.atlas import reg_engine as ref_engine
from magellanmapper_tpu.atlas import transform as ref_transform
from magellanmapper_tpu.settings import atlas_prof as ref_prof
from magellanmapper_torch.atlas import reg_engine
from magellanmapper_torch.parallel import cases, launch
from magellanmapper_torch.settings import atlas_prof

torch.set_num_threads(1)

CASES = "magellanmapper_torch.parallel.cases:"
ENGINE = "magellanmapper_torch.atlas.reg_engine:"
METRICS = ["AdvancedMattesMutualInformation",
           "AdvancedNormalizedCorrelation", "AdvancedMeanSquares"]
LRS = (("W", 0.01), ("t", 1.0))
PARAMS = {"W": np.eye(3, dtype=np.float32) * 0.02,
          "t": np.asarray([0.5, -0.3, 0.2], np.float32)}
GRAD_PARAMS = {"W": np.eye(3, dtype=np.float32) * 0.01,
               "t": np.asarray([0.4, -0.2, 0.6], np.float32)}
MESH4 = dict(n_devices=4, dp=1, sp=2, spy=2)


def _pair(shape=(24, 28, 26), seed=0):
    """The reference test's pair: Gaussian blobs and their translate."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.indices(shape).astype(np.float32)
    fixed = np.zeros(shape, np.float32)
    for cz, cy, cx in np.column_stack(
            [rng.uniform(4, s - 4, 25) for s in shape]):
        fixed += np.exp(
            -((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
    fixed /= fixed.max()
    moving = np.asarray(ref_transform.resample(
        jnp.asarray(fixed), {"t": jnp.asarray([1.5, -2.0, 1.0])},
        "translation", shape))
    return fixed, moving


def _group(shape, n_blobs, width, spread, seed):
    """The reference groupwise tests' four shifted copies of one image."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.indices(shape).astype(np.float32)
    base = np.zeros(shape, np.float32)
    for cz, cy, cx in np.column_stack(
            [rng.uniform(4, s - 4, n_blobs) for s in shape]):
        base += np.exp(
            -((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2) / width)
    base /= base.max()
    return [np.asarray(ref_transform.resample(
        jnp.asarray(base), {"t": jnp.asarray(rng.uniform(-spread, spread,
                                                          3))},
        "translation", shape)) for _ in range(4)]


def _group_params(k, seed=4):
    """Affines of ``k`` images near identity, at which the groupwise
    loss's gradient is compared."""
    rng = np.random.default_rng(seed)
    return {"W": rng.normal(0, 0.01, (k, 3, 3)).astype(np.float32),
            "t": rng.normal(0, 0.5, (k, 3)).astype(np.float32)}


def _duo_profile(module):
    prof = module.AtlasProfile()
    prof["reg_translation"] = module.make_reg_param_map(
        "translation", 64, num_resolutions=2)
    prof["reg_affine"] = module.make_reg_param_map(
        "affine", 64, num_resolutions=2)
    prof["reg_bspline"] = module.make_reg_param_map(
        "bspline", 32, grid_space_voxels=12, num_resolutions=2)
    return prof


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    fixed3, moving3 = _pair(seed=3)
    return {
        "pair0": _pair(), "pair3": (fixed3, moving3), "pair5": _pair(seed=5),
        "pair7": _pair(seed=7), "pair9": _pair(seed=9),
        "fmask": (rng.random(fixed3.shape) > 0.3).astype(np.float32),
        "mmask": (moving3 > 0.05).astype(np.float32),
        "group": _group((20, 24, 22), 15, 6.0, 2.0, 11),
        "group_bs": _group((16, 20, 18), 10, 5.0, 1.5, 13),
    }


def _cases(d):
    cpu = {"device": "cpu"}
    cases = []
    for n, mesh in ((4, MESH4), (2, dict(n_devices=2, dp=1, sp=2)),
                    (1, dict(n_devices=1))):
        for metric in METRICS:
            cases.append(dict(
                key=f"loss_{metric}_{n}", fn=CASES + "level_loss",
                args=(*d["pair0"], PARAMS, "affine", metric, LRS, (1, 1, 1)),
                kwargs=cpu, mesh=mesh))
        cases.append(dict(
            key=f"grads_{n}", fn=CASES + "mattes_mi_grads",
            args=(*d["pair5"], GRAD_PARAMS), kwargs=cpu, mesh=mesh))
        cases.append(dict(
            key=f"group_{n}", fn=ENGINE + "register_groupwise",
            args=(d["group"],),
            kwargs=dict(cpu, max_iter=48, num_resolutions=1),
            mesh=dict(n_devices=n, dp=n, sp=1)))
    stage = atlas_prof.make_reg_param_map("translation", 96,
                                          num_resolutions=2)
    cases += [
        dict(key="masked", fn=CASES + "level_loss",
             args=(*d["pair3"], {"t": np.asarray([1.0, 0.5, -0.5],
                                                 np.float32)},
                   "translation", METRICS[0], (("t", 1.0),), (2, 2, 2)),
             kwargs=dict(cpu, fixed_mask=d["fmask"], moving_mask=d["mmask"],
                         jitter=False), mesh=MESH4),
        dict(key="stage", fn=CASES + "register_stage_t",
             args=(*d["pair7"], stage, "translation"), kwargs=cpu,
             mesh=MESH4),
        dict(key="duo", fn=CASES + "register_duo_dsc",
             args=(*d["pair9"], _duo_profile(atlas_prof)), kwargs=cpu,
             mesh=MESH4),
        dict(key="group_pair", fn=ENGINE + "register_groupwise",
             args=(d["group"][:2],),
             kwargs=dict(cpu, max_iter=48, num_resolutions=1),
             mesh=dict(n_devices=2, dp=2, sp=1)),
        *(dict(key=f"group_grads_{n}", fn=CASES + "group_grads",
               args=(d["group"][:n], _group_params(n)), kwargs=cpu,
               mesh=dict(n_devices=n, dp=n, sp=1)) for n in (2, 4)),
        dict(key="group_bs", fn=ENGINE + "register_groupwise",
             args=(d["group_bs"],),
             kwargs=dict(cpu, max_iter=24, num_resolutions=1,
                         bspline_iter=16, grid_space_voxels=10.0),
             mesh=dict(n_devices=4, dp=4, sp=1)),
    ]
    return cases


@pytest.fixture(scope="module")
def world(data):
    """Every rank's ``{key: result}`` of this module's cases."""
    return launch.spawn(launch.run_cases, 4, device="cpu", timeout_s=600,
                        args=(_cases(data),))


@pytest.fixture(scope="module")
def mesh():
    devs = np.asarray(jax.devices()[:8]).reshape(4, 2)
    return Mesh(devs, ("sp", "spy"))


def _ref_loss(fixed, moving, params, kind, metric, lrs, stride, **kw):
    _, loss = ref_engine._optimize_level(
        jnp.asarray(fixed), jnp.asarray(moving),
        {k: jnp.asarray(v) for k, v in params.items()}, None, kind, metric,
        0, None, lrs, stride, **kw)
    return float(loss)


class TestShardedMetricParity:
    @pytest.mark.parametrize("metric", METRICS)
    def test_loss_matches_unsharded(self, world, data, metric):
        base = _ref_loss(*data["pair0"], PARAMS, "affine", metric, LRS,
                         (1, 1, 1))
        for n in (4, 2, 1):
            assert world[0][f"loss_{metric}_{n}"] == pytest.approx(
                base, abs=2e-5)

    def test_loss_matches_with_stride_and_masks(self, world, data):
        fixed, moving = data["pair3"]
        base = _ref_loss(
            fixed, moving, {"t": np.asarray([1.0, 0.5, -0.5], np.float32)},
            "translation", METRICS[0], (("t", 1.0),), (2, 2, 2),
            fixed_mask=jnp.asarray(data["fmask"]),
            moving_mask=jnp.asarray(data["mmask"]), jitter=False)
        assert world[0]["masked"] == pytest.approx(base, abs=2e-5)

    def test_gradients_match_unsharded(self, world, data):
        """The gradient through the summed histogram and the gathered
        intensity ranges, reduced over the ranks, is the unsharded one."""
        fixed, moving = (jnp.asarray(a) for a in data["pair5"])

        def loss_unsharded(p):
            moved = ref_transform.resample(
                moving, p, "affine", fixed.shape, order=1)
            return ref_metrics.metric_loss(METRICS[0], fixed, moved)

        g_base = jax.grad(loss_unsharded)(
            {k: jnp.asarray(v) for k, v in GRAD_PARAMS.items()})
        for n in (4, 2, 1):
            for k in GRAD_PARAMS:
                np.testing.assert_allclose(
                    world[0][f"grads_{n}"][k], np.asarray(g_base[k]),
                    rtol=2e-3, atol=2e-6)
        for r in range(1, 4):
            for k in GRAD_PARAMS:
                np.testing.assert_array_equal(world[r]["grads_4"][k],
                                              world[0]["grads_4"][k])


class TestShardedStage:
    def test_stage_recovers_translation(self, world, data, mesh):
        fixed, moving = data["pair7"]
        stage = ref_prof.make_reg_param_map("translation", 96,
                                            num_resolutions=2)
        p_shard, _ = ref_engine.register_stage(
            jnp.asarray(fixed), jnp.asarray(moving), stage,
            kind="translation", mesh=mesh)
        got = world[0]["stage"]["t"]
        np.testing.assert_allclose(got, np.asarray(p_shard["t"]), atol=0.2)
        np.testing.assert_allclose(got, [-1.5, 2.0, -1.0], atol=0.5)

    def test_register_duo_sharded_bspline_chain(self, world, data, mesh):
        _, res = ref_engine.register_duo(
            *data["pair9"], _duo_profile(ref_prof), mesh=mesh)
        want = res.metrics["dsc_fixed_moved"]
        assert world[0]["duo"] > 0.9
        assert abs(world[0]["duo"] - want) < 0.03


class TestShardedGroupwise:
    def test_groupwise_dp_sharded_matches(self, world, data):
        dp_mesh = Mesh(np.asarray(jax.devices()[:4]), ("dp",))
        mean_s, params_s = ref_engine.register_groupwise(
            data["group"], max_iter=48, num_resolutions=1, mesh=dp_mesh)
        for n in (4, 2, 1):
            mean, params = world[0][f"group_{n}"]
            np.testing.assert_allclose(mean, mean_s, rtol=1e-3, atol=1e-4)
            assert len(params) == 4
            for ps, pp in zip(params_s, params):
                np.testing.assert_allclose(pp["t"], ps["t"], rtol=1e-3,
                                           atol=1e-3)

    def test_groupwise_bspline_stage_dp_sharded(self, world, data):
        dp_mesh = Mesh(np.asarray(jax.devices()[:4]), ("dp",))
        mean_s, params_s = ref_engine.register_groupwise(
            data["group_bs"], max_iter=24, num_resolutions=1,
            bspline_iter=16, grid_space_voxels=10.0, mesh=dp_mesh)
        mean, params = world[0]["group_bs"]
        np.testing.assert_allclose(mean, mean_s, rtol=2e-3, atol=2e-4)
        for ps, pp in zip(params_s, params):
            assert "grid" in pp
            np.testing.assert_allclose(pp["grid"], ps["grid"], rtol=2e-3,
                                       atol=2e-3)


def test_groupwise_two_ranks_round_as_one_process(world, data):
    """Two ranks holding one image each give the one-process run's mean
    and parameters after 48 steps, and its loss gradient, bit for bit:
    each image's warp and gradient take the same kernels whatever the
    number of images a rank holds, and a sum of two terms does not
    depend on their order."""
    imgs = data["group"][:2]
    mean, params = reg_engine.register_groupwise(
        imgs, max_iter=48, num_resolutions=1, device="cpu")
    got_mean, got_params = world[0]["group_pair"]
    np.testing.assert_array_equal(got_mean, mean)
    for got, want in zip(got_params, params):
        for k in ("W", "t"):
            np.testing.assert_array_equal(got[k], want[k])
    want = cases.group_grads(imgs, _group_params(2), device="cpu")
    for r in range(2):
        for k in want:
            np.testing.assert_array_equal(world[r]["group_grads_2"][k],
                                          want[k])


def test_group_loss_gradient_over_four_ranks(world, data):
    """Over four ranks the groupwise loss gradient is the one process's
    within the level's gradient limits (rtol 2e-3, atol 2e-6)."""
    want = cases.group_grads(data["group"], _group_params(4), device="cpu")
    for k in want:
        np.testing.assert_allclose(world[0]["group_grads_4"][k], want[k],
                                   rtol=2e-3, atol=2e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_groupwise_world_sizes_agree(world, n):
    """Groupwise over 2 and 4 ranks gives the mean of a world of one
    (rtol 1e-3, atol 1e-4) on every rank."""
    one = world[0]["group_1"][0]
    for r in range(n):
        np.testing.assert_allclose(world[r][f"group_{n}"][0], one,
                                   rtol=1e-3, atol=1e-4)
