"""The port's sharded variants against the reference's: the threshold
sweep (``blob_log_multi_sharded``, ``make_fn_detect_multi(mesh=)``), the
sharded regional statistics, ``resize_sharded`` and ``transpose_img(mesh=)``,
the classifier's data-parallel step, the film-sharded renderers and the
dry run.

One world of four CPU ranks over gloo runs every case of this module once
(the ``world`` fixture); the reference runs here on its virtual CPU
devices on the same seeded inputs. Meshes of 1 and 2 ranks are sub-meshes
of that world.

Tolerances: sweep rows and validity, blob rows, counts and labels exactly;
the port's float64 region moments within 1e-12 relative of its unsharded
sums (the reference sums in float32: 1e-5 relative to it); resize and
renders within 1e-6 of the port's unsharded call (renders against the
reference at ``test_torch_render3d``'s 1e-4 image and 1e-3 depth limits);
the classifier's loss within 1e-5 of the reference's, its reduced
gradients within rtol 1e-5, atol 1e-7 of the reference's ``jax.grad`` of
the whole batch, its weights within 1e-7 of a fresh Adam's first step of
those gradients and within 1e-6 of the reference's weights where the
reference's gradient exceeds 1e-6 (``CLF_*``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from magellanmapper_tpu.atlas import transformer as ref_transformer
from magellanmapper_tpu.cv import classifier as ref_classifier
from magellanmapper_tpu.cv import detector as ref_detector
from magellanmapper_tpu.io import np_io as ref_np_io
from magellanmapper_tpu.ops import render3d as ref_render3d
from magellanmapper_tpu.ops import resize as ref_resize
from magellanmapper_tpu.parallel import mesh as ref_mesh
from magellanmapper_tpu.settings.roi_prof import ROIProfile as RefProfile
from magellanmapper_tpu.stats import mlearn as ref_mlearn
from magellanmapper_tpu.stats import vols as ref_vols
from magellanmapper_torch.cv import detector
from magellanmapper_torch.ops import render3d, resize
from magellanmapper_torch.parallel import dryrun, launch
from magellanmapper_torch.settings.roi_prof import ROIProfile
from magellanmapper_torch.stats import vols
from magellanmapper_torch.testing import make_nuclei_volume, rows_equal

torch.set_num_threads(1)

RES = (1.0, 1.0, 1.0)
CASES = "magellanmapper_torch.parallel.cases:"
RESIZE = "magellanmapper_torch.ops.resize:resize_sharded"
RENDER = "magellanmapper_torch.ops.render3d:"
SIGMAS = tuple(float(s) for s in detector.sigma_list(1.5, 3.0, 3))
THRESHOLDS = [0.05, 0.1, 0.2, 0.4, 0.6]
GRID = dict(min_sigma_factor=2.0, max_sigma_factor=4.0, num_sigma=4,
            max_blobs_per_block=512)
RESIZE_TO = (13, 21, 17)
HW = (8, 12)
POSE = dict(azim_deg=30.0, elev_deg=20.0)
#: the classifier step's reduced gradients against the reference's
#: ``jax.grad`` of the whole batch; its weights against a fresh Adam's
#: first step of them (``lr * g / (|g| + eps)``), and against the
#: reference's weights where the reference's gradient is far above eps
#: (near eps that step turns a gradient difference of 1e-11 into 1e-6)
CLF_GRAD_RTOL, CLF_GRAD_ATOL = 1e-5, 1e-7
CLF_LR, CLF_EPS = 1e-3, 1e-8
CLF_STEP_ATOL = 1e-7
CLF_FAR_FROM_EPS = 1e-6
CLF_PARAM_ATOL = 1e-6


def _dp(n):
    return dict(n_devices=n, dp=n, sp=1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(0)
    vol = make_nuclei_volume((24, 40, 40), seed=2)[0].astype(np.float32)
    labels = rng.integers(0, 6, (18, 19, 20)).astype(np.int32)
    labels[labels == 5] = -3
    root = tmp_path_factory.mktemp("transpose")
    src = rng.random((1, 20, 22, 18)).astype(np.float32)
    paths = {}
    for name in ("ref", "port"):
        paths[name] = str(root / f"{name}.npy")
        ref_np_io.write_npy(paths[name], src,
                            resolutions=[[2.0, 1.0, 1.0]])
    z, y, x = np.ogrid[:14, :14, :14]
    ball = np.exp(-(((z - 6.5) ** 2 + (y - 7.0) ** 2 + (x - 6.0) ** 2)
                    / 14.0)).astype(np.float32)
    return {
        "vol": vol, "labels": labels,
        "atlas": rng.random(labels.shape).astype(np.float32),
        "heat": rng.integers(0, 4, labels.shape).astype(np.int32),
        "resize": rng.random((16, 18, 20)).astype(np.float32),
        "paths": paths, "ball": ball,
        "patches": rng.random((16, ref_classifier.PATCH_SIZE,
                               ref_classifier.PATCH_SIZE), dtype=np.float32),
        "patch_labels": (rng.random(16) > 0.5).astype(np.float32),
        "tree": jax.tree.map(np.asarray, ref_classifier.BlobClassifier(
            seed=0).params),
    }


def _cases(d):
    cpu = {"device": "cpu"}
    prof = ROIProfile()
    prof.update(GRID)
    cases = [
        dict(key="odd_film", fn=CASES + "error_of",
             args=("magellanmapper_torch.ops.render3d:"
                   "render_volume_sharded", d["ball"]),
             kwargs=dict(cpu, out_hw=(6, 8), **POSE), mesh=_dp(4)),
        dict(key="transpose", fn="magellanmapper_torch.atlas.transformer:"
                                 "transpose_img",
             args=(d["paths"]["port"],), kwargs=dict(cpu, rescale=0.5),
             mesh=dict(n_devices=4)),
    ]
    for n in (4, 2, 1):
        cases += [
            dict(key=f"sweep{n}", fn="magellanmapper_torch.cv.detector:"
                                     "blob_log_multi_sharded",
                 args=(d["vol"], SIGMAS, THRESHOLDS, 0.5, 64),
                 kwargs=cpu, mesh=_dp(n)),
            dict(key=f"multi{n}", fn=CASES + "detect_multi",
                 args=(d["vol"], RES, prof, {}, THRESHOLDS), kwargs=cpu,
                 mesh=_dp(n)),
            dict(key=f"vols{n}", fn="magellanmapper_torch.stats.vols:"
                                    "measure_labels_metrics",
                 args=(d["atlas"], d["labels"]),
                 kwargs=dict(cpu, heat_map=d["heat"]),
                 mesh=dict(n_devices=n)),
            dict(key=f"resize{n}", fn=RESIZE,
                 args=(d["resize"], RESIZE_TO), kwargs=cpu,
                 mesh=dict(n_devices=n)),
            dict(key=f"labels{n}", fn=RESIZE,
                 args=(d["labels"], RESIZE_TO), kwargs=dict(cpu, order=0),
                 mesh=dict(n_devices=n)),
            dict(key=f"clf{n}", fn=CASES + "classifier_step",
                 args=(d["tree"], d["patches"], d["patch_labels"]),
                 kwargs=cpu, mesh=_dp(n)),
            dict(key=f"volume{n}", fn=RENDER + "render_volume_sharded",
                 args=(d["ball"],),
                 kwargs=dict(cpu, out_hw=HW, n_steps=24, opacity=0.2,
                             shaded=True, **POSE), mesh=_dp(n)),
            dict(key=f"persp{n}", fn=RENDER + "render_volume_sharded",
                 args=(d["ball"],),
                 kwargs=dict(cpu, out_hw=HW, n_steps=24, opacity=0.2,
                             perspective=True, **POSE), mesh=_dp(n)),
            dict(key=f"iso{n}", fn=RENDER + "render_isosurface_sharded",
                 args=(d["ball"], 0.5),
                 kwargs=dict(cpu, out_hw=HW, n_steps=24, **POSE),
                 mesh=_dp(n)),
        ]
    return cases


@pytest.fixture(scope="module")
def world(data):
    """Every rank's ``{key: result}`` of this module's cases."""
    return launch.spawn(launch.run_cases, 4, device="cpu", timeout_s=600,
                        args=(_cases(data),))


@pytest.fixture(scope="module")
def ref_dp():
    return ref_mesh.make_mesh(4, dp=4, sp=1)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_blob_log_multi_sharded_matches_reference(world, data, ref_dp, n):
    """Thresholds dealt over ``dp`` (5 padded to a multiple of the axis):
    the port's unsharded sweep and the reference's sharded one."""
    rows, valid = world[0][f"sweep{n}"]
    p_rows, p_valid = detector.blob_log_multi(
        torch.from_numpy(data["vol"]), SIGMAS, THRESHOLDS, 0.5, 64)
    np.testing.assert_array_equal(valid, p_valid.numpy())
    np.testing.assert_array_equal(rows, p_rows.numpy())
    r_rows, r_valid = ref_detector.blob_log_multi_sharded(
        jnp.asarray(data["vol"]), SIGMAS, THRESHOLDS, 0.5, 64, ref_dp)
    np.testing.assert_array_equal(valid, r_valid)
    np.testing.assert_array_equal(rows[valid], r_rows[r_valid])
    assert valid.sum() > 0


@pytest.mark.parametrize("n", [1, 2, 4])
def test_make_fn_detect_multi_mesh_matches_reference(world, data, ref_dp, n):
    prof = RefProfile()
    prof.update(GRID)
    fn = ref_mlearn.make_fn_detect_multi(data["vol"], RES, prof,
                                         mesh=ref_dp)
    want = fn({}, THRESHOLDS)
    got = world[0][f"multi{n}"]
    assert len(got) == len(want) == len(THRESHOLDS)
    assert any(g is not None for g in got)
    for g, w in zip(got, want):
        assert (g is None and w is None) or rows_equal(g, w)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_measure_labels_metrics_mesh(world, data, n):
    """Voxels dealt over the ranks, one all-reduce of the per-label sums:
    the port's unsharded table (counts exact, moments 1e-12) and the
    reference's sharded one (float32 sums: 1e-5)."""
    got = world[0][f"vols{n}"]
    want = vols.measure_labels_metrics(data["atlas"], data["labels"],
                                       heat_map=data["heat"], device="cpu")
    ref = ref_vols.measure_labels_metrics(
        data["atlas"], data["labels"], heat_map=data["heat"],
        mesh=ref_mesh.make_mesh(4))
    assert list(got.columns) == list(want.columns)
    for col in got.columns:
        g = got[col].to_numpy(dtype=float)
        if col in ("Region", "VolPx", "Volume", "Nuclei"):
            np.testing.assert_array_equal(g, want[col].to_numpy(float))
            np.testing.assert_array_equal(g, ref[col].to_numpy(float))
        else:
            np.testing.assert_allclose(g, want[col].to_numpy(float),
                                       rtol=1e-12, equal_nan=True)
            np.testing.assert_allclose(g, ref[col].to_numpy(float),
                                       rtol=1e-5, atol=1e-7,
                                       equal_nan=True)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_resize_sharded_matches(world, data, n):
    """z and y on x-slabs, an all-to-all, x on z-slabs: the port's
    unsharded resize within 1e-6, and the reference's sharded resize;
    labels (order 0) exactly."""
    got = world[0][f"resize{n}"].numpy()
    want = resize.resize(torch.from_numpy(data["resize"]), RESIZE_TO)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-6)
    ref = np.asarray(ref_resize.resize_sharded(
        jnp.asarray(data["resize"]), RESIZE_TO, ref_mesh.make_mesh(4)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    labels = world[0][f"labels{n}"].numpy()
    assert labels.dtype == np.int32
    np.testing.assert_array_equal(labels, np.asarray(ref_resize.resize(
        jnp.asarray(data["labels"]), RESIZE_TO, order=0)))


def test_transpose_img_mesh_matches_reference(world, data):
    """Rank 0 writes the reference's ``transpose_img(mesh=)`` output."""
    ref_out = ref_transformer.transpose_img(
        data["paths"]["ref"], rescale=0.5, mesh=ref_mesh.make_mesh(4))
    out = world[0]["transpose"]
    assert all(world[r]["transpose"] == out for r in range(4))
    assert os.path.basename(out).replace("port", "ref") == os.path.basename(
        ref_out)
    want = np.load(ref_np_io.make_filenames(ref_out)[0])
    got = np.load(ref_np_io.make_filenames(out)[0])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_train_step_sharded_matches_reference(world, data, n):
    ref = ref_classifier.BlobClassifier(params=data["tree"])
    want = ref.train_step_sharded(ref_mesh.make_mesh(4, dp=4, sp=1),
                                  data["patches"], data["patch_labels"])
    loss, tree, grads = world[0][f"clf{n}"]
    assert loss == pytest.approx(want, abs=1e-5)
    x = jnp.asarray(data["patches"])
    y = jnp.asarray(data["patch_labels"])
    want_grads = jax.grad(lambda p: optax.sigmoid_binary_cross_entropy(
        ref.model.apply(p, x, train=True), y).mean())(data["tree"])
    for got, exp in zip(jax.tree.leaves(grads), jax.tree.leaves(want_grads)):
        np.testing.assert_allclose(got, exp, rtol=CLF_GRAD_RTOL,
                                   atol=CLF_GRAD_ATOL)
    for got, before, g, g_ref, exp in zip(*(jax.tree.leaves(t) for t in (
            tree, data["tree"], grads, want_grads, ref.params))):
        # a fresh Adam's first step of the reduced gradient
        np.testing.assert_allclose(
            got, before - CLF_LR * g / (np.abs(g) + CLF_EPS), rtol=0,
            atol=CLF_STEP_ATOL)
        far = np.abs(np.asarray(g_ref)) > CLF_FAR_FROM_EPS
        np.testing.assert_allclose(got[far], np.asarray(exp)[far], rtol=0,
                                   atol=CLF_PARAM_ATOL)
    for r in range(1, n):
        assert world[r][f"clf{n}"][0] == loss
        for got, exp in zip(jax.tree.leaves(world[r][f"clf{n}"][1]),
                            jax.tree.leaves(tree)):
            np.testing.assert_array_equal(got, exp)


@pytest.fixture(scope="module")
def frames(data):
    """Per render kind, the port's single-device frame and the
    reference's sharded one (computed once)."""
    ball = data["ball"]
    ref_mesh_dp = ref_mesh.make_mesh(4, dp=4, sp=1)
    out = {}
    for kind in ("volume", "persp"):
        kw = dict(out_hw=HW, n_steps=24, opacity=0.2, **POSE)
        kw.update(shaded=True) if kind == "volume" else kw.update(
            perspective=True)
        out[kind] = (
            render3d.render_volume(ball, device="cpu", **kw).numpy(),
            np.asarray(ref_render3d.render_volume_sharded(
                jnp.asarray(ball), ref_mesh_dp, **kw)))
    out["iso"] = (
        [t.numpy() for t in render3d.render_isosurface(
            ball, 0.5, out_hw=HW, n_steps=24, device="cpu", **POSE)],
        [np.asarray(t) for t in ref_render3d.render_isosurface_sharded(
            jnp.asarray(ball), 0.5, ref_mesh_dp, out_hw=HW, n_steps=24,
            **POSE)])
    return out


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("kind", ["volume", "persp", "iso"])
def test_sharded_renderers_match(world, frames, kind, n):
    """Film rows dealt over ``dp``: the port's single-device frame within
    1e-6 and the reference's sharded frame at the render tests' limits."""
    got = world[0][f"{kind}{n}"]
    got = ([g.numpy() for g in got] if kind == "iso" else got.numpy())
    want, ref = frames[kind]
    if kind == "iso":
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(np.isinf(got[1]), np.isinf(want[1]))
        hit = np.isfinite(got[1])
        np.testing.assert_allclose(got[1][hit], want[1][hit], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-4)
        both = hit & np.isfinite(ref[1])
        assert both.any()
        np.testing.assert_allclose(got[1][both], ref[1][both], rtol=0,
                                   atol=1e-3)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert got.max() > 0.01


def test_odd_film_height_raises_as_the_reference(world, data):
    """A film height that the axis does not divide raises ValueError on
    every rank, as the reference does (padding rows is later work)."""
    for r in range(4):
        assert world[r]["odd_film"].startswith("ValueError: film height 6")
    with pytest.raises(ValueError, match="film height 6"):
        ref_render3d.render_volume_sharded(
            jnp.asarray(data["ball"]), ref_mesh.make_mesh(4, dp=4, sp=1),
            out_hw=(6, 8), **POSE)


def test_dryrun_multichip_runs_every_sharded_path(capsys):
    line = dryrun.dryrun_multichip(2, device="cpu", timeout_s=300)
    assert line.startswith("dryrun_multichip OK: mesh dp=2 sp=1 spy=1")
    assert line in capsys.readouterr().out
    assert "stitch FFT pairs peak shift (0, 30, 29)" in line
    assert not os.environ.get("MASTER_ADDR")
