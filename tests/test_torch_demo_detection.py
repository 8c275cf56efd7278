"""The port's detection demo (``examples/torch/demo_detection.py``) on the
CPU against the reference's demo (``examples/demo_detection.py``) on the
same seeded volume: blob rows, count, sensitivity and PPV exactly the
reference demo's; its figures with matplotlib, and none without."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from magellanmapper_tpu.cv import stack_detect as ref_sd
from magellanmapper_tpu.cv import verifier as ref_verifier
from magellanmapper_torch.testing import rows_equal

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference demo's detections and verification, recorded from
    its own calls."""
    calls = {}
    detect, verify = ref_sd.detect_blobs_stack, ref_verifier.verify_stack

    def detect_rec(*args, **kwargs):
        calls["detect"] = detect(*args, **kwargs)
        return calls["detect"]

    def verify_rec(*args, **kwargs):
        calls["verify"] = verify(*args, **kwargs)
        return calls["verify"]

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_sd, "detect_blobs_stack", detect_rec)
    mp.setattr(ref_verifier, "verify_stack", verify_rec)
    try:
        _load(os.path.join(ROOT, "examples", "demo_detection.py"),
              "ref_demo_detection").main(
            str(tmp_path_factory.mktemp("ref")))
    finally:
        mp.undo()
    return calls


def test_demo_detection_equals_the_reference_demo(reference, tmp_path,
                                                  capsys):
    demo = _load(os.path.join(ROOT, "examples", "torch",
                              "demo_detection.py"), "torch_demo_detection")
    got = demo.main([str(tmp_path), "--device", "cpu", "--no-figures"])
    want_blobs = reference["detect"][0].blobs
    sens, ppv, _ = reference["verify"]
    assert len(got["blobs"]) == len(want_blobs) > 200
    assert rows_equal(got["blobs"], want_blobs)
    assert (got["sens"], got["ppv"]) == (sens, ppv)
    assert f"sensitivity {sens:.3f}, PPV {ppv:.3f}" in capsys.readouterr().out
    assert os.path.exists(str(tmp_path / "demo_image5d.npy"))
    assert not any(n.endswith(".png") for n in os.listdir(tmp_path))


def test_demo_detection_figures(tmp_path):
    demo = _load(os.path.join(ROOT, "examples", "torch",
                              "demo_detection.py"), "torch_demo_detection")
    demo.main([str(tmp_path), "--device", "cpu"])
    for name in ("roi_planes.png", "mips.png"):
        assert os.path.getsize(str(tmp_path / name)) > 1000
