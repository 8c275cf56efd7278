"""The port's profiler hooks and entry point against the reference's.

``Throughput`` gives the reference's block rates and summary on the same
clock; ``trace`` writes a Chrome trace on the CPU that names the range
``annotate`` opened; ``entry(device="cpu")``'s step gives the reference
``entry()``'s blobs: equal counts and valid rows within 1e-5 (both
reduce the LoG in float32, in another order).
"""

import glob
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from magellanmapper_torch import entry as entry_mod
from magellanmapper_torch.utils import profiler
from magellanmapper_tpu.utils import profiler as ref_profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_ATOL = 1e-5


def _run(mod, monkeypatch, ticks, voxels):
    clock = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    t = mod.Throughput()
    rates = []
    for n in voxels:
        t.start()
        rates.append(t.stop(n))
    rates.append(t.stop(5))  # a stop with no start times nothing
    return rates, t.summary(), t.mvox_per_s


@pytest.mark.parametrize("ticks,voxels", [
    # a start at 0.0 reads as no start, as in the reference
    ([0.0, 0.5, 0.75, 1.0, 1.25, 2.0, 2.001, 9.0, 9.0, 9.5],
     [2 ** 20, 3, 10 ** 9]),
    ([1.0, 1.0, 4.0, 4.0], [7]),
])
def test_throughput_equals_reference(monkeypatch, ticks, voxels):
    got = _run(profiler, monkeypatch, ticks, voxels)
    want = _run(ref_profiler, monkeypatch, ticks, voxels)
    assert got == want
    assert profiler.Throughput().summary() == \
        ref_profiler.Throughput().summary()


def test_trace_writes_a_chrome_trace_naming_the_range(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiler.trace(log_dir):
        with profiler.annotate("detect_block"):
            torch.ones(8).sum()
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "detect_block" for e in events)


def test_trace_default_directory_is_under_the_temporary_directory(
        tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    with profiler.trace():
        torch.zeros(2).add_(1)
    assert glob.glob(str(tmp_path / "mmtorch_trace" / "*.pt.trace.json"))


def _rows(raws, valids, b):
    rows = np.asarray(raws[b])[np.asarray(valids[b])]
    return rows[np.lexsort(rows.T[::-1])]


def test_entry_step_matches_reference_entry():
    sys.path.insert(0, ROOT)
    try:
        import __graft_entry__
    finally:
        sys.path.remove(ROOT)
    ref_fn, (ref_batch,) = __graft_entry__.entry()
    fn, (batch,) = entry_mod.entry(device="cpu")
    assert batch.device.type == "cpu" and batch.dtype == torch.float32
    np.testing.assert_array_equal(batch.numpy(), np.asarray(ref_batch))
    raws, valids, counts = fn(batch)
    want_raws, want_valids, want_counts = ref_fn(ref_batch)
    assert raws.shape == (2, 256, 4) and valids.shape == (2, 256)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    for b in range(2):
        got, want = _rows(raws, valids, b), _rows(want_raws, want_valids, b)
        assert len(want) > 0 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ROW_ATOL)


def test_entry_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.entry()
