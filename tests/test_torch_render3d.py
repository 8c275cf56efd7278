"""The port's 3D renderers (``magellanmapper_torch.ops.render3d``) against
the reference's on the same seeded volumes, and the reference's analytic
sphere pins run on the port.

Fixtures: the analytic sphere of ``tests/test_render3d.py`` and a seeded
(40, 56, 48) crop of planted nuclei; poses cover each principal axis with
and without the flip, and both film variants. Tolerances, each with the
largest difference measured on the CPU:

- Images in [0, 1]: ``IMG_ATOL`` 1e-4 absolute (measured 1.8e-6 gather,
  2.4e-7 shear-warp, 2.9e-5 isosurface shades).
- Shaded gather images of the sphere: ``SHADED_PLATEAU_ATOL`` 1e-2
  (measured 3.8e-3). The sphere's interior is a plateau of 1.0, whose
  central differences are float rounding (|g| < 1e-6), so the normal
  there, and its shade, follows the last bit of each sample; on the crop,
  which has no plateau, shaded images keep ``IMG_ATOL``.
- Isosurface hit masks: equal, except pixels whose sample lies within
  float rounding of the level; at most ``HIT_MISMATCH`` (0.1%) of the
  film (measured 0).
- Depth where both hit: ``DEPTH_ATOL`` 1e-3 voxels (measured 1.1e-4
  gather, 7.6e-6 shear-warp).
- ``render_blobs_overlay``: equal (rows, cols, visible and t), since the
  camera basis is the reference's bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from magellanmapper_tpu.ops import render3d as ref
from magellanmapper_torch import testing
from magellanmapper_torch.ops import render3d

torch.set_num_threads(1)

IMG_ATOL = 1e-4
SHADED_PLATEAU_ATOL = 1e-2
HIT_MISMATCH = 1e-3
DEPTH_ATOL = 1e-3

SHAPE = (48, 48, 48)
R = 14.0
CROP = (40, 56, 48)
HW = (40, 48)
#: one pose each of (principal axis, flip, transposed film) of the crop
POSES = [(150.0, -65.0), (350.0, -65.0), (215.0, 65.0), (5.0, 65.0),
         (250.0, 20.0), (110.0, 15.0), (200.0, -20.0), (30.0, 20.0)]
GATHER_POSES = [(30.0, 20.0), (120.0, -35.0), (80.0, 75.0)]


def _sphere():
    zz, yy, xx = np.indices(SHAPE).astype(np.float32)
    c = (np.asarray(SHAPE, np.float32) - 1) / 2
    r = np.sqrt((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
    return np.clip(1.0 - (r - R) / 3.0, 0.0, 1.0).astype(np.float32)


def _crop():
    vol, _ = testing.make_nuclei_volume(CROP, seed=5, spacing=12,
                                        jitter=2)
    vol = vol.astype(np.float32)
    return vol / vol.max()


@pytest.fixture(scope="module")
def sphere_vol():
    return _sphere()


@pytest.fixture(scope="module")
def vols():
    return {"sphere": _sphere(), "crop": _crop()}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- camera and static choices -------------------------------------------------

def test_camera_basis_is_the_references_bits():
    rng = np.random.default_rng(3)
    poses = list(zip(rng.uniform(-360, 360, 300), rng.uniform(-90, 90, 300)))
    poses += [(0.0, 0.0), (30.0, 20.0), (0.0, 90.0), (45.0, -90.0)]
    for az, el in poses:
        got = render3d.camera_basis(float(az), float(el))
        want = ref.camera_basis(float(az), float(el))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_renderers_camera_is_the_jitted_references_bits():
    """Inside the jitted renderers XLA fuses ``up``'s first component the
    other way round; ``fused=True`` gives those bits."""
    jitted = jax.jit(ref.camera_basis)
    rng = np.random.default_rng(4)
    for az, el in zip(rng.uniform(0, 360, 200), rng.uniform(-89, 89, 200)):
        got = render3d.camera_basis(float(az), float(el), fused=True)
        want = jitted(jnp.float32(az), jnp.float32(el))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_poses_cover_every_principal_variant():
    seen = set()
    for az, el in POSES:
        perm, flip = render3d._principal_setup(CROP, az, el)
        assert (perm, flip) == ref._principal_setup(CROP, az, el)
        tf = render3d._film_variant_np(CROP, perm, flip, az, el)
        assert tf == ref._film_variant_np(CROP, perm, flip, az, el)
        seen.add((perm[0], flip, tf))
    # the transposed film occurs only for z-principal poses
    assert seen == {(0, f, t) for f in (False, True) for t in (False, True)
                    } | {(p, f, False) for p in (1, 2) for f in (False, True)}


# -- the gather ray casters ------------------------------------------------------

@pytest.mark.parametrize("name", ["sphere", "crop"])
@pytest.mark.parametrize("shaded,perspective", [
    (False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("az,el", GATHER_POSES)
def test_render_volume_matches_reference(vols, name, shaded, perspective,
                                         az, el):
    vol = vols[name]
    kw = dict(vmin=0.2, vmax=1.0, out_hw=HW, n_steps=64, opacity=0.15,
              shaded=shaded, perspective=perspective)
    want = np.asarray(ref.render_volume(jnp.asarray(vol), az, el, **kw))
    got = _np(render3d.render_volume(vol, az, el, device="cpu", **kw))
    assert got.shape == want.shape == HW + (3,)
    atol = SHADED_PLATEAU_ATOL if shaded and name == "sphere" else IMG_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _assert_isosurface_close(got, want):
    (rgb, depth), (rgb_r, depth_r) = got, want
    hit, hit_r = np.isfinite(depth), np.isfinite(depth_r)
    assert (hit != hit_r).mean() <= HIT_MISMATCH
    same = hit == hit_r
    np.testing.assert_allclose(rgb[same], rgb_r[same], rtol=0,
                               atol=IMG_ATOL)
    both = hit & hit_r
    np.testing.assert_allclose(depth[both], depth_r[both], rtol=0,
                               atol=DEPTH_ATOL)


@pytest.mark.parametrize("name", ["sphere", "crop"])
@pytest.mark.parametrize("perspective", [False, True])
@pytest.mark.parametrize("az,el", GATHER_POSES)
def test_render_isosurface_matches_reference(vols, name, perspective, az,
                                             el):
    vol = vols[name]
    kw = dict(out_hw=HW, n_steps=96, perspective=perspective)
    want = [np.asarray(a) for a in ref.render_isosurface(
        jnp.asarray(vol), 0.5, az, el, **kw)]
    got = [_np(a) for a in render3d.render_isosurface(
        vol, 0.5, az, el, device="cpu", **kw)]
    _assert_isosurface_close(got, want)


# -- shear-warp ---------------------------------------------------------------

ANCHORS = np.asarray([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("name", ["sphere", "crop"])
@pytest.mark.parametrize("mode,color", [
    ("composite", (1.0, 1.0, 1.0)), ("mip", (1.0, 0.5, 0.25)),
    ("composite", "anchors"), ("mip", "anchors")])
@pytest.mark.parametrize("az,el", POSES)
def test_render_volume_sw_matches_reference(vols, name, mode, color, az,
                                            el):
    vol = vols[name]
    color = ANCHORS if isinstance(color, str) else color
    kw = dict(vmin=0.2, vmax=1.0, out_hw=HW, opacity=0.15, color=color,
              mode=mode, bg=(0.1, 0.2, 0.3))
    want = np.asarray(ref.render_volume_sw(jnp.asarray(vol), az, el, **kw))
    got = _np(render3d.render_volume_sw(vol, az, el, device="cpu", **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=IMG_ATOL)


@pytest.mark.parametrize("name", ["sphere", "crop"])
@pytest.mark.parametrize("az,el", POSES)
def test_render_isosurface_sw_matches_reference(vols, name, az, el):
    vol = vols[name]
    want = [np.asarray(a) for a in ref.render_isosurface_sw(
        jnp.asarray(vol), 0.5, az, el, out_hw=HW)]
    got = [_np(a) for a in render3d.render_isosurface_sw(
        vol, 0.5, az, el, out_hw=HW, device="cpu")]
    _assert_isosurface_close(got, want)


def test_render_isosurface_sw_light_and_wrapped_ends(vols):
    """A crossing at the sheared volume's first slice reads its last one
    through the wrapped difference, as the reference's ``roll``; with a
    given light direction."""
    vol = vols["crop"].copy()
    vol[0] = 1.0
    for az, el in ((30.0, 85.0), (30.0, -85.0), (0.0, 0.0)):
        kw = dict(out_hw=HW, light_dir=(0.3, -1.0, 0.5), specular=0.7)
        want = [np.asarray(a) for a in ref.render_isosurface_sw(
            jnp.asarray(vol), 0.5, az, el, **kw)]
        got = [_np(a) for a in render3d.render_isosurface_sw(
            vol, 0.5, az, el, device="cpu", **kw)]
        _assert_isosurface_close(got, want)


@pytest.mark.parametrize("az,el", POSES[::2] + POSES[5:6])
def test_small_slabs_and_chunks_match_reference(vols, monkeypatch, az, el):
    """Slabs of 3 slices (the transmittance, running maximum and first
    crossing carried between them, the halo slices of each) and chunks of
    5 steps (the last one short) give the reference's images."""
    monkeypatch.setattr(render3d, "SLAB_VOXELS", 3 * 80 * 100)
    monkeypatch.setattr(render3d, "CHUNK_POINTS", 5 * HW[0] * HW[1])
    vol = vols["crop"]
    for mode in ("composite", "mip"):
        kw = dict(vmin=0.2, vmax=1.0, out_hw=HW, opacity=0.15, mode=mode,
                  color=ANCHORS)
        want = np.asarray(ref.render_volume_sw(jnp.asarray(vol), az, el,
                                               **kw))
        got = _np(render3d.render_volume_sw(vol, az, el, device="cpu",
                                            **kw))
        np.testing.assert_allclose(got, want, rtol=0, atol=IMG_ATOL)
    want = [np.asarray(a) for a in ref.render_isosurface_sw(
        jnp.asarray(vol), 0.5, az, el, out_hw=HW)]
    got = [_np(a) for a in render3d.render_isosurface_sw(
        vol, 0.5, az, el, out_hw=HW, device="cpu")]
    _assert_isosurface_close(got, want)
    kw = dict(out_hw=HW, n_steps=64)
    want = np.asarray(ref.render_volume(jnp.asarray(vol), az, el,
                                        shaded=True, **kw))
    got = _np(render3d.render_volume(vol, az, el, shaded=True, device="cpu",
                                     **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=IMG_ATOL)
    want = [np.asarray(a) for a in ref.render_isosurface(
        jnp.asarray(vol), 0.5, az, el, **kw)]
    got = [_np(a) for a in render3d.render_isosurface(
        vol, 0.5, az, el, device="cpu", **kw)]
    _assert_isosurface_close(got, want)


@pytest.mark.parametrize("mode", ["composite", "mip"])
def test_render_channels_sw_matches_reference(vols, mode):
    vol_c = np.stack([vols["crop"], np.roll(vols["crop"], 6, axis=1)], -1)
    kw = dict(vmin=(0.1, 0.2), vmax=(1.0, 0.9), out_hw=HW,
              opacity=(0.1, 0.2), bg=(0.2, 0.2, 0.2), mode=mode)
    want = np.asarray(ref.render_channels_sw(jnp.asarray(vol_c), 40.0,
                                             25.0, **kw))
    got = _np(render3d.render_channels_sw(vol_c, 40.0, 25.0, device="cpu",
                                          **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=IMG_ATOL)
    one = _np(render3d.render_channels_sw(vols["crop"], 40.0, 25.0,
                                          device="cpu", out_hw=HW))
    one_r = np.asarray(ref.render_channels_sw(jnp.asarray(vols["crop"]),
                                              40.0, 25.0, out_hw=HW))
    np.testing.assert_allclose(one, one_r, rtol=0, atol=IMG_ATOL)


@pytest.mark.parametrize("az,el", POSES)
def test_render_blobs_overlay_is_the_references(vols, az, el):
    rng = np.random.default_rng(int(az))
    blobs = np.column_stack([rng.uniform(-2, s + 2, 300) for s in CROP]
                            + [np.full(300, 2.0)])
    _, depth = ref.render_isosurface_sw(jnp.asarray(vols["crop"]), 0.5, az,
                                        el, out_hw=HW)
    want = ref.render_blobs_overlay(depth, blobs, CROP, az, el, out_hw=HW)
    got = render3d.render_blobs_overlay(
        torch.from_numpy(np.array(depth)), blobs, CROP, az, el,
        out_hw=HW)
    np.testing.assert_array_equal(got, want)
    assert 0 < got[:, 2].sum() < len(blobs)


@pytest.mark.parametrize("fn", ["render_volume_sharded",
                                "render_isosurface_sharded"])
def test_sharded_renderers_raise_by_name(fn):
    with pytest.raises(NotImplementedError, match=fn):
        getattr(render3d, fn)(np.zeros((4, 4, 4), np.float32), None, 0, 0)


# -- the reference's analytic pins on the port -------------------------------------

def _vol(sphere_vol, *args, **kwargs):
    return _np(render3d.render_volume(sphere_vol, *args, device="cpu",
                                      **kwargs))


def _iso(fn, sphere_vol, *args, **kwargs):
    return tuple(_np(a) for a in fn(sphere_vol, *args, device="cpu",
                                    **kwargs))


def test_silhouette_radius_and_center_brightness(sphere_vol):
    img = _vol(sphere_vol, 30.0, 20.0, vmin=0.2, vmax=1.0, out_hw=(96, 96),
               n_steps=96, opacity=0.15)
    lum = img.mean(axis=-1)
    assert lum[48, 48] > 0.3 and lum[48, 48] >= lum[48, 8]
    span = 2 * np.linalg.norm(SHAPE) / 2
    r_pix = (R + 3.0) * 95 / span
    ys, xs = np.nonzero(lum > 0.05)
    assert np.sqrt((ys - 47.5) ** 2 + (xs - 47.5) ** 2).max() <= r_pix + 2
    img2 = _vol(sphere_vol, 120.0, -15.0, vmin=0.2, vmax=1.0,
                out_hw=(96, 96), n_steps=96, opacity=0.15)
    assert abs(img2.mean() - img.mean()) < 0.02


@pytest.mark.parametrize("sw", [False, True])
def test_background_fills_misses(sphere_vol, sw):
    kw = dict(vmin=0.2, vmax=1.0, out_hw=(64, 64), opacity=0.2,
              bg=(0.0, 0.25, 0.5))
    img = (_np(render3d.render_volume_sw(sphere_vol, 10.0, 10.0,
                                         device="cpu", **kw)) if sw
           else _vol(sphere_vol, 0.0, 0.0, n_steps=64, **kw))
    np.testing.assert_allclose(img[1, 1], [0.0, 0.25, 0.5], atol=1e-3)
    rgb, depth = _iso(render3d.render_isosurface, sphere_vol, 0.5, 10.0,
                      10.0, out_hw=(64, 64), n_steps=64, bg=(0.1, 0, 0))
    assert np.isinf(depth[0, 0])
    np.testing.assert_allclose(rgb[0, 0], [0.1, 0.0, 0.0], atol=1e-4)


def test_isosurface_depth_matches_analytic_sphere(sphere_vol):
    radius = np.linalg.norm(SHAPE) / 2
    want = radius - (R + 1.5)
    rgb, depth = _iso(render3d.render_isosurface, sphere_vol, 0.5, 25.0,
                      15.0, out_hw=(96, 96), n_steps=192)
    hit = np.isfinite(depth)
    assert abs(depth[48, 48] - want) < 1.0
    assert depth[48, 48] < depth[hit].max() - 2.0
    lum = rgb.mean(axis=-1)
    ys, xs = np.nonzero(hit)
    d = np.sqrt((ys - 47.5) ** 2 + (xs - 47.5) ** 2)
    assert lum[48, 48] > lum[ys[d > d.max() - 2], xs[d > d.max() - 2]].mean()
    _, dep_sw = _iso(render3d.render_isosurface_sw, sphere_vol, 0.5, 25.0,
                     15.0, out_hw=(96, 96))
    assert abs(dep_sw[48, 48] - want) < 1.5


def test_light_direction_moves_highlight(sphere_vol):
    kw = dict(out_hw=(64, 64), n_steps=128)
    rgb_l, _ = _iso(render3d.render_isosurface, sphere_vol, 0.5, 0.0, 0.0,
                    light_dir=(0.0, -1.0, -1.0), **kw)
    rgb_r, _ = _iso(render3d.render_isosurface, sphere_vol, 0.5, 0.0, 0.0,
                    light_dir=(0.0, 1.0, -1.0), **kw)
    assert (rgb_l[:, :28].mean() - rgb_l[:, 36:].mean()) * \
        (rgb_r[:, :28].mean() - rgb_r[:, 36:].mean()) < 0


def test_perspective_shrinks_the_silhouette(sphere_vol):
    def silhouette(persp):
        _, depth = _iso(render3d.render_isosurface, sphere_vol, 0.5, 20.0,
                        10.0, out_hw=(96, 96), n_steps=192,
                        perspective=persp)
        return np.isfinite(depth), depth
    hit_o, dep_o = silhouette(False)
    hit_p, dep_p = silhouette(True)
    big_r = np.linalg.norm(SHAPE) / 2
    rs = R + 1.5
    lin = (1.5 * big_r) * rs / np.sqrt((2.5 * big_r) ** 2 - rs ** 2)
    assert abs(hit_p.sum() / hit_o.sum() - (lin / rs) ** 2) < 0.08
    assert abs(dep_p[48, 48] - dep_o[48, 48]) < 1.0


@pytest.mark.parametrize("az,el", [
    (30.0, 20.0), (120.0, -35.0), (80.0, 75.0), (200.0, 5.0)])
def test_shear_warp_matches_gather(sphere_vol, az, el):
    kw = dict(vmin=0.2, vmax=1.0, out_hw=(96, 96), opacity=0.15)
    gather = _vol(sphere_vol, az, el, n_steps=96, **kw)
    sw = _np(render3d.render_volume_sw(sphere_vol, az, el, device="cpu",
                                       **kw))
    assert abs(sw.mean() - gather.mean()) < 0.05
    m_g, m_s = gather.mean(-1) > 0.05, sw.mean(-1) > 0.05
    assert (m_g & m_s).sum() / max((m_g | m_s).sum(), 1) > 0.85
    rgb_r, dep_r = _iso(render3d.render_isosurface, sphere_vol, 0.5, az, el,
                        out_hw=(96, 96), n_steps=192)
    rgb_s, dep_s = _iso(render3d.render_isosurface_sw, sphere_vol, 0.5, az,
                        el, out_hw=(96, 96))
    hit_r, hit_s = np.isfinite(dep_r), np.isfinite(dep_s)
    assert (hit_r & hit_s).sum() / max((hit_r | hit_s).sum(), 1) > 0.85
    both = hit_r & hit_s
    assert np.median(np.abs(dep_r[both] - dep_s[both])) < 1.5
    assert np.median(np.abs(rgb_r[both] - rgb_s[both])) < 0.15


def test_zoom_scales_silhouette_both_engines(sphere_vol):
    def area(fn, **kw):
        img = _np(fn(sphere_vol, 25.0, 10.0, vmin=0.2, vmax=1.0,
                     out_hw=(96, 96), opacity=0.2, device="cpu", **kw))
        return (img.mean(-1) > 0.05).sum()
    gather = functools.partial(render3d.render_volume, n_steps=96)
    a_g1, a_g2 = area(gather), area(gather, zoom=2.0)
    a_s1 = area(render3d.render_volume_sw)
    a_s2 = area(render3d.render_volume_sw, zoom=2.0)
    assert 3.3 < a_g2 / a_g1 < 4.7 and 3.3 < a_s2 / a_s1 < 4.7
    assert abs(a_s2 - a_g2) < 0.15 * a_g2


def test_mip_and_colormap_anchors(sphere_vol):
    def sw(**kw):
        return _np(render3d.render_volume_sw(
            sphere_vol, 33.0, 21.0, vmin=0.0, vmax=1.0, out_hw=(96, 96),
            device="cpu", **kw))
    lum = sw(mode="mip").mean(axis=-1)
    assert lum.max() > 0.97 and abs(lum[48, 48] - 1.0) < 0.03
    comp = sw(opacity=0.02).mean(axis=-1)
    assert (lum + 1e-3 >= comp * 0.9).mean() > 0.95
    img = sw(opacity=0.3, color=np.asarray([[1, 0, 0], [0, 0, 1]],
                                           np.float32))
    tot = img.sum(-1)
    ys, xs = np.nonzero(tot > 0.05)
    d = np.sqrt((ys - 47.5) ** 2 + (xs - 47.5) ** 2)
    rim = d > d.max() - 3
    assert img[48, 48, 2] > img[48, 48, 0]
    assert img[ys[rim], xs[rim], 0].mean() > img[ys[rim], xs[rim], 2].mean()
    flat = sw(opacity=0.3, color=np.ones((2, 3), np.float32))
    np.testing.assert_allclose(flat, sw(opacity=0.3), atol=1e-5)


def test_blobs_behind_the_surface_are_hidden(sphere_vol):
    _, depth = _iso(render3d.render_isosurface_sw, sphere_vol, 0.5, 0.0,
                    0.0, out_hw=(96, 96))
    c = (np.asarray(SHAPE) - 1) / 2
    # the centre (behind the near surface) and a point on the near side
    blobs = np.array([[c[0], c[1], c[2], 2.0],
                      [c[0], c[1], c[2] + R + 1.5, 2.0]])
    out = render3d.render_blobs_overlay(depth, blobs, SHAPE, 0.0, 0.0,
                                        out_hw=(96, 96))
    assert out[0, 2] == 0 and out[1, 2] == 1
    assert abs(out[0, 0] - 47.5) <= 1 and abs(out[0, 1] - 47.5) <= 1
