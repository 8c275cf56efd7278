"""The port's ``plot/`` package against the reference's: the colormaps,
figure support and 2D plots (host copies: equal values, equal PNG pixels)
and ``plot_3d`` (preprocessing through the port's ``ops/preproc`` and
deconvolution on the device: within stated tolerances; voxel surfaces
equal, vertices and faces in the reference's order)."""

import os

import numpy as np
import pandas as pd
import pytest
import scipy.ndimage as ndi
import torch
from PIL import Image

from magellanmapper_tpu.plot import colormaps as ref_colormaps
from magellanmapper_tpu.plot import plot_2d as ref_plot_2d
from magellanmapper_tpu.plot import plot_3d as ref_plot_3d
from magellanmapper_tpu.plot import plot_support as ref_support
from magellanmapper_torch.plot import colormaps, plot_2d, plot_3d
from magellanmapper_torch.plot import plot_support

torch.set_num_threads(1)

#: Richardson-Lucy after 30 iterations, relative to the estimate's largest
#: value: the FFTs differ (pocketfft in both on the CPU, in other plans);
#: measured 1.2e-6
DECONV_RTOL = 1e-5
#: the denoise chain (float32 Gaussian blur and erosion in other orders);
#: measured 1.2e-7
DENOISE_ATOL = 1e-6


def pixels(path: str) -> np.ndarray:
    with Image.open(path) as img:
        return np.asarray(img.convert("RGBA"))


def _roi(seed=0, shape=(16, 24, 20)):
    rng = np.random.default_rng(seed)
    return (ndi.gaussian_filter(rng.random(shape), 1.0) * 1000).astype(
        np.float32)


# -- colormaps ----------------------------------------------------------------

@pytest.mark.parametrize("ids,symmetric", [
    ([-3, -1, 0, 1, 3], True), ([0, 2, 5, -5, 9], False), ([7], True)])
def test_discrete_colormap_copy(ids, symmetric):
    got = colormaps.DiscreteColormap(ids, symmetric_colors=symmetric)
    want = ref_colormaps.DiscreteColormap(ids, symmetric_colors=symmetric)
    assert got.colors == want.colors
    labels = np.array(ids * 3).reshape(3, -1)
    np.testing.assert_array_equal(got(labels), want(labels))
    (cmap, norm), (cmap_r, norm_r) = got.to_mpl(), want.to_mpl()
    np.testing.assert_array_equal(cmap.colors, cmap_r.colors)
    np.testing.assert_array_equal(norm.boundaries, norm_r.boundaries)


@pytest.mark.parametrize("kwargs", [
    {}, {"seed": 3, "min_any": 200}, {"mode": "GRID", "alpha": 100},
    {"prioritize_default": "cn", "jitter": 5}, {"prioritize_default": False}])
def test_discrete_palette_copy(kwargs):
    if "mode" in kwargs:
        kw_got = dict(kwargs, mode=colormaps.DiscreteModes.GRID)
        kw_want = dict(kwargs, mode=ref_colormaps.DiscreteModes.GRID)
    else:
        kw_got = kw_want = kwargs
    np.testing.assert_array_equal(
        colormaps.discrete_colormap(12, **kw_got),
        ref_colormaps.discrete_colormap(12, **kw_want))


def test_label_and_channel_colormaps_copy():
    labels = np.array([[0, 3, -3], [5, 5, 0]])
    assert colormaps.get_labels_discrete_colormap(labels, 40).colors == \
        ref_colormaps.get_labels_discrete_colormap(labels, 40).colors
    assert colormaps.setup_labels_cmap(labels).colors == \
        ref_colormaps.setup_labels_cmap(labels).colors
    borders = np.stack([labels, labels * 0], -1)
    got = colormaps.get_borders_colormap(
        borders, labels, colormaps.DiscreteColormap(np.unique(labels)))
    want = ref_colormaps.get_borders_colormap(
        borders, labels, ref_colormaps.DiscreteColormap(np.unique(labels)))
    assert [c.colors for c in got] == [c.colors for c in want]
    assert colormaps.make_binary_cmap(("k", "w")).colors == \
        ref_colormaps.make_binary_cmap(("k", "w")).colors
    values = np.linspace(0, 1, 7)
    for c in range(3):
        np.testing.assert_array_equal(
            colormaps.channel_colormap(c)(values),
            ref_colormaps.channel_colormap(c)(values))
    for got, want in zip(colormaps.setup_colormaps(2),
                         ref_colormaps.setup_colormaps(2)):
        np.testing.assert_array_equal(got(values), want(values))
    assert sorted(colormaps.setup_cmaps()) == sorted(
        ref_colormaps.setup_cmaps())
    np.testing.assert_array_equal(
        colormaps.get_cmap("green_black")(values),
        ref_colormaps.get_cmap("green_black")(values))
    np.testing.assert_array_equal(
        colormaps.get_cmap(["viridis", "gray"], 1)(values),
        ref_colormaps.get_cmap(["viridis", "gray"], 1)(values))
    assert colormaps.CHANNEL_COLORS == ref_colormaps.CHANNEL_COLORS


# -- figure support -------------------------------------------------------------

def test_plane_helpers_copy():
    rng = np.random.default_rng(1)
    img = rng.random((1, 6, 8, 10, 2))
    for plane in ("xy", "xz", "yz"):
        for mip in (False, True):
            n = slice(1, 3) if mip else 2
            got = plot_support.extract_planes(img, n, plane, mip)
            want = ref_support.extract_planes(img, n, plane, mip)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
        assert plot_support.max_plane(img[0], plane) == \
            ref_support.max_plane(img[0], plane)
        assert plot_support.get_aspect_ratio(plane, (2.0, 1.0, 0.5)) == \
            ref_support.get_aspect_ratio(plane, (2.0, 1.0, 0.5))
        assert plot_support.get_plane_axis(plane, True) == \
            ref_support.get_plane_axis(plane, True)
        for g, w in zip(plot_support.transpose_images(plane, [img[0]]),
                        ref_support.transpose_images(plane, [img[0]])):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(
                plot_support.setup_images_for_plane(plane, [img[0], None]),
                ref_support.setup_images_for_plane(plane, [img[0], None])):
            np.testing.assert_array_equal(g, w)
    for shape in ((4, 3000, 2000), (4, 500, 500), (1200,)):
        assert plot_support.get_downsample_max_sizes(shape) == \
            ref_support.get_downsample_max_sizes(shape)


def test_overlays_copy():
    rng = np.random.default_rng(2)
    plane = rng.random((10, 12, 3)).astype(np.float32)
    labels = rng.integers(-2, 3, (10, 12))
    for kwargs in ({}, {"channels": [0, 2], "alphas": [0.5, 1.0],
                        "vmins": [0.1, 0.2], "vmaxs": [0.9, 0.8]},
                   {"labels_plane": labels, "labels_alpha": 0.3}):
        np.testing.assert_array_equal(
            plot_support.overlay_images(plane, **kwargs),
            ref_support.overlay_images(plane, **kwargs))
    np.testing.assert_array_equal(
        plot_support.ImageOverlayer(None).overlay_images([plane, labels]),
        ref_support.ImageOverlayer(None).overlay_images([plane, labels]))
    a, b = plane[..., 0] > 0.5, plane[..., 1] > 0.5
    for g, w in zip(plot_support.alpha_blend_intersection(a, b, 0.3),
                    ref_support.alpha_blend_intersection(a, b, 0.3)):
        np.testing.assert_array_equal(g, w)


def test_save_fig_backs_up_and_matches(tmp_path):
    import matplotlib.pyplot as plt
    paths = []
    for sub, mod in (("port", plot_support), ("ref", ref_support)):
        os.makedirs(tmp_path / sub)
        for _ in range(2):
            fig, ax = plt.subplots()
            ax.imshow(np.arange(12).reshape(3, 4))
            paths.append(mod.save_fig(fig, str(tmp_path / sub / "f.jpg"),
                                      fmt="png"))
            plt.close(fig)
    assert os.path.basename(paths[0]) == "f.png"
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref")) == ["f(1).png", "f.png"]
    np.testing.assert_array_equal(pixels(paths[1]), pixels(paths[3]))


# -- plot_3d ------------------------------------------------------------------

@pytest.mark.parametrize("channel", [None, [1]])
def test_preprocessing_matches_reference(channel):
    roi = _roi()
    two = np.stack([roi, roi[::-1] * 0.5], -1)
    for img, kw in ((roi, {}), (two, {"channel": channel})):
        np.testing.assert_array_equal(
            plot_3d.saturate_roi(img, near_max=[800, 300], device="cpu",
                                 **kw),
            ref_plot_3d.saturate_roi(img, near_max=[800, 300], **kw))
        np.testing.assert_allclose(
            plot_3d.denoise_roi(img / 1000, device="cpu", **kw),
            ref_plot_3d.denoise_roi(img / 1000, **kw), rtol=0,
            atol=DENOISE_ATOL)
    np.testing.assert_array_equal(plot_3d.threshold(roi, device="cpu"),
                                  ref_plot_3d.threshold(roi))
    np.testing.assert_array_equal(plot_3d.remap_intensity(roi),
                                  ref_plot_3d.remap_intensity(roi))


@pytest.mark.parametrize("seed,iterations,psf", [
    (0, 30, None), (1, 30, "gauss"), (2, 5, None)])
def test_deconvolve_matches_reference(seed, iterations, psf):
    roi = _roi(seed, (16, 24, 20) if seed != 2 else (9, 14, 11))
    if psf == "gauss":
        g = np.exp(-np.arange(-2, 3) ** 2 / 2.0)
        psf = (g[:, None, None] * g[None, :, None] * g[None, None, :])
        psf = (psf / psf.sum()).astype(np.float32)
    got = plot_3d.deconvolve(roi, iterations, psf, device="cpu")
    want = ref_plot_3d.deconvolve(roi, iterations, psf)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=DECONV_RTOL * np.abs(want).max())


@pytest.mark.parametrize("seed,shape", [
    (0, (6, 7, 5)), (1, (3, 9, 8)), (2, (10, 4, 6))])
def test_show_surface_labels_is_the_references(seed, shape):
    rng = np.random.default_rng(seed)
    seg = rng.integers(-1, 5, shape)
    seg[rng.random(shape) < 0.4] = 0
    got, want = plot_3d.show_surface_labels(seg), \
        ref_plot_3d.show_surface_labels(seg)
    assert [m[0] for m in got] == [m[0] for m in want]
    for (_, v, f), (_, v_r, f_r) in zip(got, want):
        assert v.dtype == v_r.dtype and f.dtype == f_r.dtype
        np.testing.assert_array_equal(v, v_r)
        np.testing.assert_array_equal(f, f_r)

    class Vis:
        surfaces = []
    plot_3d.show_surface_labels(seg, Vis)
    assert len(Vis.surfaces) == len(want)
    for mask in (np.zeros((2, 3, 2), bool), np.ones((1, 1, 1), bool)):
        for g, w in zip(plot_3d._voxel_surface_mesh(mask),
                        ref_plot_3d._voxel_surface_mesh(mask)):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_roi_helpers_copy():
    rng = np.random.default_rng(4)
    img5d = rng.random((1, 10, 12, 14))
    np.testing.assert_array_equal(
        plot_3d.prepare_roi(img5d, (2, 3, 4), (5, 6, 3)),
        ref_plot_3d.prepare_roi(img5d, (2, 3, 4), (5, 6, 3)))
    np.testing.assert_array_equal(
        plot_3d.prepare_subimg(img5d[0], (1, 2, 3), (4, 4, 4)),
        ref_plot_3d.prepare_subimg(img5d[0], (1, 2, 3), (4, 4, 4)))
    blobs = np.array([[4, 5, 6, 2.5], [1, 1, 1, 1.0]])
    for ellipsoid in (False, True):
        np.testing.assert_array_equal(
            plot_3d.build_ground_truth(img5d[0], blobs, ellipsoid),
            ref_plot_3d.build_ground_truth(img5d[0], blobs, ellipsoid))
    for args in (((5, 5, 5), (4, 4, 4)), ((5, 5, 5), (4, 4, 4), True)):
        assert plot_3d.roi_center_to_offset(*args) == \
            ref_plot_3d.roi_center_to_offset(*args)
    vol = rng.random((4, 4, 4))
    for kw in ({"center": (1, 1, 1)}, {"offset": (8, 9, 12)},
               {"offset": (0, 0, 0), "vol_as_mask": vol > 0.5}):
        np.testing.assert_array_equal(
            plot_3d.replace_vol(img5d[0].copy(), vol, **kw),
            ref_plot_3d.replace_vol(img5d[0].copy(), vol, **kw))
    np.testing.assert_array_equal(
        plot_3d.pad_img(vol, (1, 2, 0), (6, 7, None)),
        ref_plot_3d.pad_img(vol, (1, 2, 0), (6, 7, None)))
    for iso in (None, (1.0, 0.5, 0.5)):
        np.testing.assert_array_equal(
            plot_3d.get_isotropic_vis({"isotropic_vis": iso}),
            ref_plot_3d.get_isotropic_vis({"isotropic_vis": iso}))
    assert plot_3d.setup_channels(img5d, None, 3) == \
        ref_plot_3d.setup_channels(img5d, None, 3)


# -- plot_2d --------------------------------------------------------------------

def _table():
    rng = np.random.default_rng(5)
    return pd.DataFrame({
        "Region": ["a", "b", "c", "a", "b", "c"],
        "Volume": rng.uniform(1, 5, 6), "Nuclei": rng.integers(0, 50, 6),
        "FDR": np.linspace(0.1, 0.6, 6), "SENS": np.linspace(0.5, 1.0, 6),
        "thresh": np.linspace(0.05, 0.3, 6)})


@pytest.mark.parametrize("name,args,kwargs", [
    ("plot_bars", ("Region", "Volume"), {"title": "t"}),
    ("plot_lines", ("thresh", ["Volume", "Nuclei"]), {}),
    ("plot_scatter", ("Volume", "Nuclei"), {"group_col": "Region",
                                            "annot_col": "Region"}),
    ("plot_roc", (), {}),
    ("plot_histogram", ("Volume",), {"bins": 5, "title": "h"}),
    ("plot_swarm", ("Region", "Volume"), {}),
    ("main", (), {}),
])
def test_plot_2d_figures_are_the_references(tmp_path, name, args, kwargs):
    df = _table()
    paths = []
    for sub, mod in (("port", plot_2d), ("ref", ref_plot_2d)):
        path = str(tmp_path / f"{sub}.png")
        if name == "main":
            mod.main(mod.Plot2DTypes.BAR_PLOT, df, path, x_col="Region",
                     y_col="Nuclei")
        elif name == "plot_histogram":
            mod.plot_histogram(df, *args, path=path, **kwargs)
        else:
            getattr(mod, name)(df, *args, path=path, **kwargs)
        paths.append(path)
    np.testing.assert_array_equal(pixels(paths[0]), pixels(paths[1]))


def test_image_overlay_and_category_plots_are_the_references(tmp_path):
    rng = np.random.default_rng(6)
    img = rng.random((3, 12, 10))
    df = _table()
    for name, call in (
            ("image", lambda m, p: m.plot_image(img[0], p)),
            ("overlays", lambda m, p: m.plot_overlays(
                [img, img[::-1]], 1, title="o", out_path=p)),
            ("cat", lambda m, p: m.plot_catplot(df, "Region", "Volume",
                                                out_path=p))):
        # seaborn's strip plot jitters from numpy's global generator
        np.random.seed(0)
        got, want = (str(tmp_path / f"{name}_{s}.png") for s in ("p", "r"))
        call(plot_2d, got)
        np.random.seed(0)
        call(ref_plot_2d, want)
        np.testing.assert_array_equal(pixels(got), pixels(want))
    assert [t.name for t in plot_2d.Plot2DTypes] == [
        t.name for t in ref_plot_2d.Plot2DTypes]


def test_plot_knns_is_the_references(tmp_path):
    from magellanmapper_tpu.stats import clustering as ref_clustering
    from magellanmapper_torch import testing
    from magellanmapper_torch.stats import clustering

    sets = [testing.make_point_cloud(2000, seed) for seed in (1, 2)]
    got, want = str(tmp_path / "p.png"), str(tmp_path / "r.png")
    clustering.plot_knns(sets, 4, ["a", "b"], got, device="cpu")
    ref_clustering.plot_knns(sets, 4, ["a", "b"], want)
    np.testing.assert_array_equal(pixels(got), pixels(want))
