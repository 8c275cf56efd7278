"""BENCHMARK.json against the contract's shape, cells and metrics found
from files by name, and the whole-name check for JAX."""

import json
import pathlib
import re
import shutil

import pytest

from portbench import harness, jaxcheck

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    for p in bench["paths"]:
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        mine = [m for m in bench["end_to_end"]
                if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        layers = harness.metrics_for(bench, w["name"], "per_layer")
        assert layers
        for m in layers:
            assert m["moves"] in [x["name"] for x in mine]
        assert (ROOT / "portbench" / "workloads"
                / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench" / "limits"
                / f"{w['name']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert harness.reader_path(m["name"]).is_file()
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_metric_is_found_by_name():
    read = harness.reader("setup_s")

    class Run:
        setup_s = 12.5
    assert read(Run()) == 12.5


@pytest.mark.parametrize("name, file", [
    ("k3_roofline.sweep", "k3_roofline.py"),
    ("k3_roofline.some.new_cell", "k3_roofline.py"),
    ("sweep_s", "sweep_s.py")])
def test_a_metric_without_a_file_of_its_own_takes_its_base_names(name, file):
    assert harness.reader_path(name) == ROOT / "portbench" / "metrics" / file


def test_a_new_cell_is_taken_from_files_alone(tmp_path):
    """A cell added as a BENCHMARK.json entry, a traffic file and a limits
    file runs with no code changed."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "detect.ls.tiny", "config": "lightsheet_1um",
        "traffic": "detect.ls.tiny", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "detect.ls.cortex" in m.get("workloads", []):
            m["workloads"].append("detect.ls.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = tmp_path / "portbench"
    for sub in ("configs", "metrics", "workloads", "limits"):
        shutil.copytree(ROOT / "portbench" / sub, pb / sub)
    traffic = json.loads(
        (pb / "workloads" / "detect.ls.cortex.json").read_text())
    traffic["params"]["shape"] = [30, 128, 128]
    (pb / "workloads" / "detect.ls.tiny.json").write_text(
        json.dumps(traffic))
    (pb / "limits" / "detect.ls.tiny.json").write_text(
        (pb / "limits" / "detect.ls.cortex.json").read_text())
    out = harness.run_cell("detect.ls.tiny", 5, 0.0, False, device="cpu",
                           root=tmp_path, log=lambda *a, **k: None)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"detect_mvox_s", "setup_s"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("names, found", [
    (["magellanmapper_torch", "magellanmapper_torch.cv", "numpy"], []),
    (["jax.numpy", "numpy"], ["jax"]),
    (["jaxlib"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["magellanmapper_tpu.ops.filters"], ["magellanmapper_tpu"]),
    (["jaxtyping", "flaxen", "magellanmapper_tpu_extra"], []),
])
def test_jax_check_compares_whole_top_level_names(names, found):
    assert jaxcheck.forbidden(names) == found
