"""The port's launcher (``python -m magellanmapper_torch``, the
``mm-torch`` script) against the reference's CLI, and the port's format
and pipeline demos (``examples/torch/``) on the CPU, each held to its own
gates. The detection, rendering and registration demos have a file each
(``test_torch_demo_*.py``).

A fresh interpreter runs the launcher and the demos' scripts: neither
loads jax or the reference package.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_torch.io import cli
from magellanmapper_torch.testing import make_nuclei_volume, rows_equal

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMOS = os.path.join(ROOT, "examples", "torch")
#: what a fresh interpreter prints after the command it ran: the modules
#: of jax and of the reference package it loaded
NO_JAX = ("; import sys; print(sorted(m for m in sys.modules if "
          "m.split('.')[0] in ('jax', 'jaxlib', 'magellanmapper_tpu')))")


def load_demo(name):
    """An ``examples/torch`` demo as a module (its ``main(argv)`` returns
    its results)."""
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", os.path.join(DEMOS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _launch(args, **kwargs):
    return subprocess.run(
        [sys.executable, "-m", "magellanmapper_torch", *args],
        capture_output=True, text=True, timeout=120, cwd=ROOT, **kwargs)


def test_launcher_help_lists_the_cli():
    out = _launch(["--help"])
    assert out.returncode == 0, out.stderr
    assert "--proc" in out.stdout and "--device" in out.stdout


def test_launcher_detect_equals_the_reference_cli(tmp_path):
    """``python -m magellanmapper_torch --proc detect --device cpu`` writes
    the reference CLI's blob archive."""
    vol = make_nuclei_volume((40, 140, 140), seed=4)[0]
    for name in ("port", "ref"):
        np.save(str(tmp_path / f"{name}.npy"), vol)
    out = _launch(["--img", str(tmp_path / "port.npy"), "--proc", "detect",
                   "--roi_profile", "lightsheet", "--device", "cpu"])
    assert out.returncode == 0, out.stderr
    assert "INFO:magellanmapper_torch" in out.stderr
    ref_cli.main(["--img", str(tmp_path / "ref.npy"), "--proc", "detect",
                  "--roi_profile", "lightsheet"])
    with np.load(str(tmp_path / "port_blobs.npz")) as got, \
            np.load(str(tmp_path / "ref_blobs.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        assert len(want["segments"]) > 20
        assert rows_equal(got["segments"], want["segments"])
        np.testing.assert_array_equal(got["resolutions"],
                                      want["resolutions"])


def test_launcher_logs_uncaught_exceptions(tmp_path):
    """The excepthook logs a failing run on the ``magellanmapper_torch``
    logger, as ``run.py`` logs the reference's, and the run fails."""
    out = _launch(["--img", str(tmp_path / "none.npy"), "--proc", "detect",
                   "--device", "cpu"])
    assert out.returncode != 0
    assert "CRITICAL:magellanmapper_torch: uncaught exception" in out.stderr
    assert "Traceback" in out.stderr


def test_launcher_and_mm_torch_load_no_jax():
    """The launcher's module and the ``mm-torch`` script's target, as
    ``pyproject.toml`` names it, import neither jax nor the reference."""
    import tomllib
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["mm-torch"] == "magellanmapper_torch.io.cli:main"
    module, func = scripts["mm-torch"].split(":")
    assert getattr(importlib.import_module(module), func) is cli.main
    code = ("import runpy, magellanmapper_torch.__main__ as m; "
            f"from {module} import {func}; assert callable(m.main)" + NO_JAX)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_demos_raise_without_a_card(tmp_path):
    """Each demo's device is the card by default: without one it raises,
    before any work, unless ``--device cpu`` is given."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name in ("demo_detection", "demo_render3d", "demo_pipeline",
                 "demo_formats"):
        with pytest.raises(RuntimeError, match="CUDA device"):
            load_demo(name).main([str(tmp_path), "--no-figures"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        load_demo("demo_registration").main(["--small", "--no-figures"])


def test_demo_formats_round_trips_every_format(tmp_path):
    demo = load_demo("demo_formats")
    got = demo.main([str(tmp_path), "--device", "cpu", "--no-figures"])
    assert got["ok"] and list(got["matches"]) == list(demo.FORMATS)


def test_demo_formats_takes_an_explicit_list(tmp_path):
    """A script run in a fresh interpreter, on the formats that need no
    system library."""
    demo = load_demo("demo_formats")
    names = [n for n, lib in demo.FORMATS.items() if lib is None]
    out = subprocess.run(
        [sys.executable, os.path.join(DEMOS, "demo_formats.py"),
         str(tmp_path), "--device", "cpu", "--formats", *names],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "ALL FORMATS ROUND-TRIP" in out.stdout
    assert sorted(n.split("_", 1)[1] for n in os.listdir(tmp_path)
                  if n.startswith("imp_") and n.endswith("image5d.npy")) \
        == sorted(n.lower().replace("-", "") + "_image5d.npy"
                  for n in names)


def test_demo_pipeline_stages_complete(tmp_path):
    got = load_demo("demo_pipeline").main(
        [str(tmp_path), "--device", "cpu", "--no-figures"])
    assert got["image5d_shape"] == (1, 32, 96, 96)
    assert got["dsc"] > 0.8 and got["labels"] == [0, 1, 2]
    assert got["blobs"] is not None and len(got["blobs"]) > 30
    assert np.isfinite(got["blobs"]).all()
    regions = got["regions"]
    assert len(regions) == 2 and (regions["Volume"] > 0).all()
    assert os.path.exists(str(tmp_path / "regions.csv"))
    stats = got["stats"].set_index("Region")
    # the mock cohort's planted effect on region 2, none on region 1
    assert stats.loc[2, "Padj"] < 0.05 < stats.loc[1, "Padj"]
    assert not os.path.exists(str(tmp_path / "volcano.png"))
