"""The port's registration demo (``examples/torch/demo_registration.py``)
with ``--small`` on the CPU, held to its own gate: the Dice overlap after
registration above the one before, the labels carried in their type. Its
pair is the reference demo's (``examples/demo_registration.py``), warped
by the port's resampler: held to the reference's resampler here within
1e-5. Also every demo but this one with ``--no-figures`` in a fresh
interpreter where matplotlib and jax cannot be imported, as on the card's
machine."""

import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from magellanmapper_tpu.atlas import transform as ref_transform

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "torch_demo_registration",
        os.path.join(ROOT, "examples", "torch", "demo_registration.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_demo_registration_pair_is_the_references():
    demo = _load()
    fixed, moving, labels = demo.make_pair(demo.SMALL_SHAPE, "cpu")
    want = np.asarray(ref_transform.resample(
        jnp.asarray(fixed),
        {"t": jnp.asarray([3.0, -5.0, 4.0]),
         "W": jnp.asarray([[1.05, 0.02, 0.0], [0.0, 0.96, 0.03],
                           [0.01, 0.0, 1.04]])},
        "affine", demo.SMALL_SHAPE))
    np.testing.assert_allclose(moving, want, rtol=0, atol=1e-5)
    assert labels.dtype == np.int32 and set(np.unique(labels)) == {0, 3}


def test_demo_registration_small_raises_the_overlap():
    got = _load().main(["--small", "--device", "cpu", "--no-figures"])
    assert got["shape"] == (48, 64, 56)
    assert got["dsc_after"] > got["dsc_before"]
    assert got["dsc_after"] > 0.9
    labels = got["labels_moved"]
    assert labels.dtype == np.int32 and set(np.unique(labels)) == {0, 3}
    assert np.isfinite(got["moved"]).all()


_DEMOS_ALONE = """
import importlib.util, os, sys


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("matplotlib", "mpl_toolkits", "jax",
                                  "jaxlib", "magellanmapper_tpu"):
            raise ImportError(f"{name} is blocked")


sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
root, out = sys.argv[1:3]
for name in ("demo_detection", "demo_render3d", "demo_pipeline",
             "demo_formats"):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "examples", "torch", name + ".py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    demo.main([os.path.join(out, name), "--device", "cpu", "--no-figures"])
print("DEMOS RAN")
"""


def test_demos_run_without_matplotlib_and_jax(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", _DEMOS_ALONE, ROOT, str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("DEMOS RAN")
    assert "ALL FORMATS ROUND-TRIP" in out.stdout
