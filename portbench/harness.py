"""One run of one cell: set-up, the measured window, the traced calls,
the metrics, and the comparison that decides ``correct``.

Everything a cell is made of is found by name from files:
``BENCHMARK.json`` names the cell's configuration (its ``file``) and
traffic (``portbench/workloads/<traffic>.json``); the traffic names its
generator (``portbench/traffic/<generator>.py``) and driver
(``portbench/drivers/<driver>.py``); the cell's limits are
``portbench/limits/<cell>.json``; each metric is read by
``portbench/metrics/<metric>.py``, or where there is none by the reader
of its base name, the part before the first dot (``k3_roofline.sweep``
by ``k3_roofline.py``). Adding a cell, a configuration or a metric adds
files and entries and edits none.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import math
import pickle
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

import torch

from portbench import jaxcheck, trace as trace_mod

ROOT = Path(__file__).resolve().parents[1]
#: seconds of calls the traced run aims at (one call at least)
TRACE_TARGET_S = 2.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def by_name(entries: List[dict], name: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(name)


def cell_parts(bench: dict, name: str, root: Path = ROOT):
    """``(cell, configuration, traffic, limits)`` of cell ``name``."""
    cell = by_name(bench["workloads"], name)
    conf_entry = by_name(bench["configs"], cell["config"])
    config = load_json(root / conf_entry["file"])
    traffic = load_json(root / "portbench" / "workloads"
                        / f"{cell['traffic']}.json")
    limits = load_json(root / "portbench" / "limits" / f"{name}.json")
    return cell, config, traffic, limits


def driver_module(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def reader_path(metric: str, root: Path = ROOT) -> Path:
    """``portbench/metrics/<metric>.py``, else the file of the metric's
    base name."""
    folder = root / "portbench" / "metrics"
    path = folder / f"{metric}.py"
    return path if path.is_file() else folder / (
        metric.split(".")[0] + ".py")


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``read(run)`` of the metric's reader (:func:`reader_path`)."""
    path = reader_path(metric, root)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


@dataclass
class Run:
    """What the metric readers read."""
    records: List[dict]
    setup_s: float
    window_peak_bytes: int = 0
    card: str = ""
    trace: Optional[trace_mod.Trace] = None

    @property
    def span_s(self) -> float:
        """From the first call's start to the last call's end."""
        return self.records[-1]["t1"] - self.records[0]["t0"]


def _call(drv) -> dict:
    t0 = time.perf_counter()
    rec = drv.once()
    rec["t0"], rec["t1"] = t0, time.perf_counter()
    return rec


def check_each(drv, outputs: list, ref) -> List[dict]:
    """Each output's compared numbers; equal outputs (the same bytes) are
    compared once."""
    keys = [hashlib.sha1(pickle.dumps(out, protocol=5)).digest()
            for out in outputs]
    distinct: dict = {}
    for key, out in zip(keys, outputs):
        distinct.setdefault(key, out)
    got = dict(zip(distinct, drv.check(list(distinct.values()), ref)))
    return [got[key] for key in keys]


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device="cuda", t_start: Optional[float] = None,
             root: Path = ROOT, parts=None, log=print) -> dict:
    """One run; returns the result line's object. ``parts`` replaces the
    cell's files (``cell_parts``), as a test does with a small traffic."""
    if t_start is None:
        t_start = time.perf_counter()
    bench = benchmark(root)
    cell, config, traffic, limits = parts or cell_parts(bench, name, root)
    dmod = driver_module(traffic["driver"])
    drv = dmod.Driver(config, traffic, seed, device)
    on_card = torch.device(device).type == "cuda"
    drv.setup()
    # the device peak from here on is the program's: the generator's
    # scratch is freed, the inputs are in host memory
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    drv.once()
    warm_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    records = []
    w0 = time.perf_counter()
    while True:
        records.append(_call(drv))
        if records[-1]["t1"] - w0 >= seconds:
            break
    window_peak = (torch.cuda.max_memory_allocated(device) if on_card
                   else 0)
    run = Run(records, setup_s=records[0]["t0"] - t_start,
              window_peak_bytes=window_peak,
              card=torch.cuda.get_device_name(device) if on_card else "cpu")

    traced_outputs = []
    if traced:
        per_call = run.span_s / len(records)
        n = max(1, min(20, math.ceil(TRACE_TARGET_S / per_call)))
        span = trace_mod.PREFIX + dmod.SPAN

        def calls():
            for _ in range(n):
                with torch.profiler.record_function(span):
                    traced_outputs.append(drv.once()["out"])
        run.trace = trace_mod.profile(calls, drv.hooks(), device)
    memory_peak = max(warm_peak, torch.cuda.max_memory_allocated(device)
                      if on_card else 0)

    found = jaxcheck.forbidden(sys.modules)
    if found:
        raise SystemExit("the run loaded " + ", ".join(found))

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, name, kind):
        value = reader(m["name"], root)(run)
        if value is None:
            # a metric listed for the cell that reads nothing: the
            # program no longer runs what its reader looks for
            raise RuntimeError(f"no reading of {m['name']}")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    outputs = [r["out"] for r in records] + traced_outputs
    for r in records:
        r["out"] = None
    drv.release()
    t_ref = time.perf_counter()
    ref = drv.reference()
    per_call = check_each(drv, outputs, ref)
    ref_s = time.perf_counter() - t_ref
    failed = sum(any(got[k] > limit for k, limit in limits.items())
                 for got in per_call)
    checks = {k: {"value": max(got[k] for got in per_call), "limit": limit}
              for k, limit in limits.items()}
    found = jaxcheck.forbidden(sys.modules)
    if found:
        raise SystemExit("the run loaded " + ", ".join(found))

    dev = {"platform": "gpu" if on_card else "cpu", "kind": run.card,
           "count": int(cell["chips"]), "memory_peak_bytes": memory_peak}
    result = {"correct": failed == 0 and bool(per_call),
              "attempted": len(per_call), "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    walls = " ".join(f"{r['t1'] - r['t0']:.3f}" for r in records)
    log(f"calls {len(records)} in {run.span_s:.3f} s ({walls}), setup "
        f"{run.setup_s:.3f} s, reference {ref_s:.3f} s", file=sys.stderr)
    return result
