"""The port's rendering demo (``examples/torch/demo_render3d.py``) on the
CPU against the reference's demo (``examples/demo_render3d.py``) on the
same seeded volume: the blobs exactly the reference demo's, and every
frame within the render limits of ``test_torch_render3d``: 1e-4 absolute
on images in [0, 1], the isosurface's pixels except at most 0.1% of the
film, where a sample lies within float rounding of the level. The
reference's frames are recorded from the renderer calls its demo makes.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from magellanmapper_tpu.cv import detector as ref_detector
from magellanmapper_tpu.ops import render3d as ref_render3d
from magellanmapper_torch.testing import rows_equal

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_ATOL = 1e-4
HIT_MISMATCH = 1e-3


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference demo's blobs, and its frames keyed by
    ``(engine, azimuth, elevation, out_hw, mode)``."""
    rec = {"frames": {}}
    detect = ref_detector.detect_blobs
    volume_sw = ref_render3d.render_volume_sw
    iso_sw = ref_render3d.render_isosurface_sw

    def detect_rec(*args, **kwargs):
        rec["blobs"] = detect(*args, **kwargs)
        return rec["blobs"]

    def volume_rec(vol, az, el, **kw):
        out = volume_sw(vol, az, el, **kw)
        rec["frames"][("volume_sw", float(az), float(el),
                       tuple(kw["out_hw"]), kw.get("mode", "composite"))] \
            = np.asarray(out)
        return out

    def iso_rec(vol, level, az, el, **kw):
        out = iso_sw(vol, level, az, el, **kw)
        rec["frames"][("isosurface_sw", float(az), float(el),
                       tuple(kw["out_hw"]), None)] = np.asarray(out[0])
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_detector, "detect_blobs", detect_rec)
    mp.setattr(ref_render3d, "render_volume_sw", volume_rec)
    mp.setattr(ref_render3d, "render_isosurface_sw", iso_rec)
    try:
        _load(os.path.join(ROOT, "examples", "demo_render3d.py"),
              "ref_demo_render3d").main(str(tmp_path_factory.mktemp("ref")))
    finally:
        mp.undo()
    return rec


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    demo = _load(os.path.join(ROOT, "examples", "torch",
                              "demo_render3d.py"), "torch_demo_render3d")
    return demo, demo.main([str(tmp_path_factory.mktemp("port")),
                            "--device", "cpu", "--no-figures"])


def _assert_close(got, want, hit_mismatch=0.0):
    assert got.shape == want.shape and np.isfinite(got).all()
    far = np.abs(got - want).max(axis=-1) > IMG_ATOL
    assert far.mean() <= hit_mismatch, far.mean()
    assert got.max() > 0


def test_demo_render3d_blobs_equal_the_reference(reference, port):
    _, got = port
    assert len(got["blobs"]) == len(reference["blobs"]) > 100
    assert rows_equal(got["blobs"], reference["blobs"])


@pytest.mark.parametrize("mode", ["volume", "mip", "isosurface"])
def test_demo_render3d_canvas_frames(reference, port, mode):
    demo, got = port
    pose = got["poses"][mode]
    assert (pose["azim"], pose["elev"]) == (-60.0 + demo.ORBIT[0],
                                            30.0 + demo.ORBIT[1])
    key = (("isosurface_sw", pose["azim"], pose["elev"], demo.RENDER_HW,
            None) if mode == "isosurface" else
           ("volume_sw", pose["azim"], pose["elev"], demo.RENDER_HW,
            "mip" if mode == "mip" else "composite"))
    _assert_close(got["frames"][mode], reference["frames"][key],
                  HIT_MISMATCH if mode == "isosurface" else 0.0)


def test_demo_render3d_colormap_and_rotation(reference, port):
    _, got = port
    _assert_close(got["frames"]["colormap"], reference["frames"][
        ("volume_sw", 40.0, 25.0, (512, 512), "composite")])
    rotation = got["frames"]["rotation"]
    assert rotation.shape == (18, 256, 256, 3)
    for i, frame in enumerate(rotation):
        _assert_close(frame, reference["frames"][
            ("volume_sw", 360.0 * i / 18, 20.0, (256, 256), "mip")])


def test_demo_render3d_figures(tmp_path):
    demo = _load(os.path.join(ROOT, "examples", "torch",
                              "demo_render3d.py"), "torch_demo_render3d")
    demo.main([str(tmp_path), "--device", "cpu"])
    for name in ("render_volume.png", "render_mip.png",
                 "render_isosurface.png", "render_colormap.png",
                 "rotation_mip.gif"):
        assert os.path.getsize(str(tmp_path / name)) > 1000
