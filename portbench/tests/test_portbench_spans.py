"""The readers of the program's own spans and counters
(``portbench/spans.py`` and six readers in ``metrics/``), on each small
cell traced on the CPU as the harness traces it; and, on the card, that
the program's spans leave no event on the device."""

import pytest
import torch

from portbench import harness, spans, trace
from portbench.tests.small import SMALL, small

#: per cell, the readers of the program's spans and counters
READERS = {"detect.ls.cortex": ("block_host_us.detect",
                                "prune_pairs_m.detect",
                                "prune_match_share.detect"),
           "sweep.4xnuc.gridtest": ("verify_cells_m.sweep",
                                    "verify_assign_share.sweep")}


def _traced_run(cell, device="cpu"):
    """One call of the small cell, traced with the cell's hooks."""
    from magellanmapper_torch.utils import profiler
    parts = small(cell, SMALL[cell])
    drv = harness.driver_module(parts[2]["driver"]).Driver(
        parts[1], parts[2], 31, device)
    drv.setup()
    profiler.clear_spans()
    rec = drv.once()
    assert profiler.spans() == []
    span = trace.PREFIX + harness.driver_module(parts[2]["driver"]).SPAN

    def calls():
        with torch.profiler.record_function(span):
            drv.once()
    run = harness.Run([rec], setup_s=0.0)
    run.trace = trace.profile(calls, drv.hooks(), device)
    return run


@pytest.fixture(scope="module")
def runs():
    from magellanmapper_torch.utils import profiler
    out = {}
    for cell in sorted(SMALL):
        run = _traced_run(cell)
        out[cell] = (run, profiler.spans())
    profiler.clear_spans()
    return out


CASES = [(cell, m) for cell in sorted(READERS) for m in READERS[cell]]


@pytest.mark.parametrize("cell, metric", CASES)
def test_each_span_reader_reads_a_number(cell, metric, runs, monkeypatch):
    run, recs = runs[cell]
    monkeypatch.setattr(spans, "records", lambda: recs)
    value = harness.reader(metric)(run)
    assert isinstance(value, float) and value > 0, (metric, value)
    if metric.split(".")[0].endswith("_share"):
        assert value < 100


def test_launches_per_block_reads_nothing_without_a_device_trace(
        runs, monkeypatch):
    run, recs = runs["detect.ls.cortex"]
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert run.trace.ops == []
    assert harness.reader("launches_per_block.detect")(run) is None


def test_launches_per_block_counts_device_ops_over_blocks(
        runs, monkeypatch):
    run, recs = runs["detect.ls.cortex"]
    monkeypatch.setattr(spans, "records", lambda: recs)
    blocks = sum(r.name == "mm.block" for r in recs)
    run.trace.ops = [("k", 1e-6, "")] * (3 * blocks)
    try:
        assert harness.reader("launches_per_block.detect")(run) == 3.0
    finally:
        run.trace.ops = []


@pytest.mark.parametrize("metric", [m for _, m in CASES]
                         + ["launches_per_block.detect"])
def test_a_program_without_spans_gives_nothing_to_read(metric, runs,
                                                      monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: None)
    assert harness.reader(metric)(runs["detect.ls.cortex"][0]) is None


@pytest.mark.cuda
def test_no_device_event_is_named_after_a_program_span(card):
    from magellanmapper_torch.utils import profiler
    parts = small("detect.ls.cortex", SMALL["detect.ls.cortex"])
    drv = harness.driver_module("detect").Driver(parts[1], parts[2], 31,
                                                 card)
    drv.setup()
    drv.once()
    profiler.clear_spans()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        drv.once()
        torch.cuda.synchronize(card)
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    on_card = [e.name() for e in events
               if e.device_type() == DeviceType.CUDA]
    assert on_card, "the profiler recorded nothing on the card"
    assert not [n for n in on_card if n.startswith("mm.")]
    kept = {r.name for r in profiler.spans()}
    host = {e.name() for e in events if e.device_type() == DeviceType.CPU}
    assert "mm.block" in kept and kept <= host
    profiler.clear_spans()
