"""The port's spans and counters (``utils.profiler.annotate``, ``count``)
and their sites in block detection and the threshold sweep, on the CPU.

While nothing records, a span is a shared no-op: a small
``detect_blobs_blocks`` call keeps no span and opens no profiler range.
Under ``torch.profiler``, a small detection and a small sweep each keep
one root span with the expected parents, the program's ranges in the
profiler's events are all of the ``cpu_op`` kind (no
``user_annotation``, which the profiler mirrors on the device), and the
kept starts lie within 100 us of the profiler's own. The timing dict is
built from the spans' clock reads, and the ``pairs`` and ``cells``
counters equal a direct count of the same inputs; each prune match tests
fewer ``candidates`` than its ``pairs``, and no fewer than it prunes.
"""

import collections
import inspect
from collections import OrderedDict

import numpy as np
import pytest
import torch

from magellanmapper_torch import testing
from magellanmapper_torch.cv import detector, verifier
from magellanmapper_torch.cv import stack_detect as sd
from magellanmapper_torch.settings.roi_prof import ROIProfile
from magellanmapper_torch.stats import mlearn
from magellanmapper_torch.utils import profiler

torch.set_num_threads(1)

RES = (1.0, 1.0, 1.0)
#: 2 x 2 lightsheet blocks in y and x
DETECT_SHAPE = (40, 150, 140)
SWEEP_SHAPE = (24, 48, 48)
THRESHOLDS = [0.05, 0.1, 0.15, 0.2]
#: the largest distance, us, between a kept start and the profiler's
START_US = 100

#: each span's parent, by name, in a detection and in a sweep
DETECT_PARENTS = {
    "mm.stage": {"mm.detect"}, "mm.block": {"mm.detect", "mm.retry"},
    "mm.preprocess": {"mm.block"}, "mm.log": {"mm.block"},
    "mm.peaks": {"mm.block"}, "mm.overlap": {"mm.block"},
    "mm.pull": {"mm.block"}, "mm.store": {"mm.detect", "mm.retry"},
    "mm.retry": {"mm.detect"}, "mm.prune": {"mm.detect"},
    "mm.prune.match": {"mm.prune"}}
SWEEP_PARENTS = {
    "mm.detect_multi": {"mm.grid_search"}, "mm.log": {"mm.detect_multi"},
    "mm.harvest": {"mm.detect_multi"}, "mm.overlap": {"mm.detect_multi"},
    "mm.pull": {"mm.detect_multi"}, "mm.verify": {"mm.grid_search"},
    "mm.verify.assign": {"mm.verify"}}


class CountingRange:
    """Stands in for the profiler's range: counts the ranges opened."""
    opened = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        CountingRange.opened += 1
        return self

    def __exit__(self, *exc):
        return False


def _lightsheet():
    prof = ROIProfile()
    prof.add_profiles("lightsheet")
    return prof


@pytest.fixture(scope="module")
def volume():
    return testing.make_nuclei_volume(DETECT_SHAPE, seed=3)[0]


def _traced(fn):
    """``fn()`` under ``torch.profiler`` (CPU): its result, the kept
    spans and the profiler's events named after a span."""
    profiler.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    recs = profiler.spans()
    profiler.clear_spans()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("mm.")]
    return out, recs, events


@pytest.fixture(scope="module")
def detected(volume):
    """A traced detection, with the pairs each prune match was given and
the rows it pruned."""
    pairs = []
    pruned = []
    real = detector.remove_close_blobs

    def counted(blobs, blobs_master, tol):
        pairs.append(len(blobs) * len(blobs_master))
        out = real(blobs, blobs_master, tol)
        pruned.append(len(blobs) - len(out[0]))
        return out

    detector.remove_close_blobs = counted
    try:
        (blobs, timing), recs, events = _traced(
            lambda: sd.detect_blobs_blocks(volume, _lightsheet(), RES,
                                           device="cpu"))
    finally:
        detector.remove_close_blobs = real
    return {"blobs": blobs, "timing": timing, "recs": recs,
            "events": events, "pairs": pairs, "pruned": pruned}


@pytest.fixture(scope="module")
def swept():
    """A traced sweep on the batched path, with its thresholds' blobs."""
    vol, centres = testing.make_grid_roi(SWEEP_SHAPE, 0, spacing=12,
                                         jitter=2)
    truth = np.column_stack([np.asarray(centres, float),
                             np.full(len(centres), 3.0)])
    prof = ROIProfile()
    prof.add_profiles("4xnuc")
    tol = detector.calc_overlap(RES) * np.asarray(prof["verify_tol_factor"])
    found = []

    def sweep():
        fn = mlearn.make_fn_detect_multi(vol, RES, prof, "cpu")

        def fn_multi(other, thresholds):
            out = fn(other, thresholds)
            found.extend(out)
            return out
        return mlearn.grid_search(
            OrderedDict(detection_threshold=THRESHOLDS), None, truth, tol,
            fn_detect_multi=fn_multi)

    df, recs, events = _traced(sweep)
    return {"df": df, "recs": recs, "events": events, "found": found,
            "truth": truth}


def test_an_untraced_detection_keeps_no_span_and_opens_no_range(
        volume, monkeypatch):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        CountingRange)
    CountingRange.opened = 0
    profiler.clear_spans()
    blobs, timing = sd.detect_blobs_blocks(volume, _lightsheet(), RES,
                                           device="cpu")
    assert blobs is not None and timing["Pruning"] > 0
    assert profiler.spans() == [] and CountingRange.opened == 0


def test_a_span_while_nothing_records_is_a_shared_no_op(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read")
    monkeypatch.setattr("time.perf_counter", no_clock)
    span = profiler.annotate("mm.a")
    assert span is profiler.annotate("mm.b")
    with span:
        profiler.count("pairs", 3)
    assert profiler.spans() == []


def test_a_clocked_span_while_nothing_records_only_times(monkeypatch):
    ticks = iter([2.0, 2.5])
    monkeypatch.setattr("time.perf_counter", lambda: next(ticks))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        CountingRange)
    CountingRange.opened = 0
    with profiler.annotate("mm.a", clock=True) as span:
        pass
    assert (span.t0, span.t1, span.seconds) == (2.0, 2.5, 0.5)
    assert profiler.spans() == [] and CountingRange.opened == 0


@pytest.mark.parametrize("case", ["detect", "sweep"])
def test_a_traced_call_keeps_one_root_and_its_parents(
        case, detected, swept):
    got = detected if case == "detect" else swept
    root, parents = (("mm.detect", DETECT_PARENTS) if case == "detect"
                     else ("mm.grid_search", SWEEP_PARENTS))
    recs = got["recs"]
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in roots] == [root]
    assert set(parents) == {r.name for r in recs} - {root}
    for r in recs:
        assert r.root == roots[0] and r.end_ns is not None
        if r.parent is None:
            continue
        up = recs[r.parent]
        assert up.name in parents[r.name], (r.name, up.name)
        assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns


@pytest.mark.parametrize("case", ["detect", "sweep"])
def test_the_profiler_holds_each_span_as_a_cpu_op_at_its_start(
        case, detected, swept):
    got = detected if case == "detect" else swept
    events = got["events"]
    assert {str(e.activity_type()) for e in events} == {"cpu_op"}
    by_name = collections.defaultdict(list)
    for e in sorted(events, key=lambda e: e.start_ns()):
        by_name[e.name()].append(e.start_ns())
    kept = collections.defaultdict(list)
    for r in got["recs"]:
        kept[r.name].append(r.start_ns)
    assert {n: len(v) for n, v in by_name.items()} == \
        {n: len(v) for n, v in kept.items()}
    for name, starts in kept.items():
        off = np.abs(np.subtract(starts, by_name[name])) / 1e3
        assert off.max() < START_US, (name, off.max())


@pytest.mark.parametrize("key, spans", [
    ("Gather_host+Stage_h2d", ("mm.stage",)), ("Pull_wait", ("mm.pull",)),
    ("Pruning", ("mm.prune",))])
def test_the_timing_dict_is_the_spans_clock(key, spans, detected):
    timing = detected["timing"]
    want = sum(timing[k] for k in key.split("+"))
    got = sum(r.end_ns - r.start_ns for r in detected["recs"]
              if r.name in spans) / 1e9
    assert want > 0 and got == pytest.approx(want, abs=1e-3)


def test_pairs_count_the_prune_match_inputs(detected):
    kept = [r.counts["pairs"] for r in detected["recs"]
            if r.name == "mm.prune.match"]
    assert kept == detected["pairs"] and sum(kept) > 0


def test_candidates_lie_between_the_rows_pruned_and_the_pairs(detected):
    kept = [r.counts for r in detected["recs"]
            if r.name == "mm.prune.match"]
    assert len(kept) == len(detected["pruned"])
    for counts, pruned in zip(kept, detected["pruned"]):
        assert "candidates" in counts
        assert pruned <= counts["candidates"] <= counts["pairs"]
    assert (sum(c["candidates"] for c in kept)
            < sum(c["pairs"] for c in kept))


def test_cells_count_the_verified_blobs_against_the_truth(swept):
    kept = [r.counts["cells"] for r in swept["recs"]
            if r.name == "mm.verify.assign"]
    want = [len(b) * len(swept["truth"]) for b in swept["found"]
            if b is not None]
    assert kept == want and len(kept) == len(THRESHOLDS)


def test_past_the_cap_spans_are_counted_not_kept(monkeypatch):
    monkeypatch.setattr(profiler, "MAX_SPANS", 2)
    profiler.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.annotate("mm.a"):
            profiler.count("n", 2)
            for _ in range(3):
                with profiler.annotate("mm.b"):
                    profiler.count("n", 5)
    recs = profiler.spans()
    assert [r.name for r in recs] == ["mm.a", "mm.b"]
    assert recs[0].counts == {"n": 2 + 5 + 5} and recs[1].counts == {"n": 5}
    assert profiler.dropped_spans() == 2
    profiler.clear_spans()
    assert profiler.spans() == [] and profiler.dropped_spans() == 0


@pytest.mark.parametrize("fn", [sd.detect_blobs_blocks, mlearn.grid_search,
                                verifier.verify_stack])
def test_a_decorated_function_keeps_its_signature(fn):
    assert inspect.signature(fn) == inspect.signature(fn.__wrapped__)
    assert fn.__name__ == fn.__wrapped__.__name__


def test_throughput_waits_for_the_card_where_cuda_is_initialised(
        monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append("sync"))
    t = profiler.Throughput()
    t.start()
    assert t.stop(10) > 0 and calls == ["sync"]
