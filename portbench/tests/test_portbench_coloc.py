"""The two-channel colocalisation cell's parts, on the CPU at a small
size: the generator's shapes and seed rules, the driver's comparison
with faults planted here, a program without the matching entry failing
at set-up, the readers of the colocalisation spans on a recorded span
list, and the ball means' count on hand-worked cases."""

import numpy as np
import pytest
import torch

from portbench import coloc_counts, harness, programs, roofline, spans
from portbench import trace
from portbench.drivers import coloc as coloc_driver
from portbench.tests.small import small
from portbench.traffic import coloc_volume, nuclei, nuclei_volume

CELL = "coloc.ls.2ch"
#: 2 x 2 detection blocks and 1 x 2 x 2 matching blocks
SHAPE = [40, 150, 140]
PARAMS = {"shape": [40, 84, 64], "spacing": 20, "jitter": 4, "sigma": 2.7,
          "amp": [1500, 3000], "noise": [200, 30]}
H100 = "NVIDIA H100 80GB HBM3"


def test_same_seed_same_volume_and_other_seed_other():
    a = coloc_volume.make(PARAMS, 2 ** 33 + 5, "cpu")
    b = coloc_volume.make(PARAMS, 2 ** 33 + 5, "cpu")
    c = coloc_volume.make(PARAMS, 2 ** 33 + 6, "cpu")
    assert a["volume"].dtype == np.uint16
    assert a["volume"].shape == tuple(PARAMS["shape"]) + (2,)
    for key in ("volume", "centres", "coexpressed", "own"):
        assert np.array_equal(a[key], b[key]), key
    assert not np.array_equal(a["volume"][..., 1], c["volume"][..., 1])
    assert not np.array_equal(a["coexpressed"], c["coexpressed"])


def test_channel_zero_is_the_nuclei_volume_of_the_seed():
    made = coloc_volume.make(PARAMS, 9, "cpu")
    one = nuclei_volume.make(PARAMS, 9, "cpu")
    np.testing.assert_array_equal(made["volume"][..., 0], one["volume"])
    np.testing.assert_array_equal(made["centres"], one["centres"])


def test_every_seed_plants_the_same_numbers_half_a_step_apart():
    shape, spacing = tuple(PARAMS["shape"]), PARAMS["spacing"]
    n = nuclei.num_nuclei(shape, spacing)
    m = nuclei.num_nuclei([s - spacing for s in shape], spacing)
    for seed in (1, 2):
        made = coloc_volume.make(PARAMS, seed, "cpu")
        assert made["coexpressed"].sum() == n // 2
        assert len(made["own"]) == m // 2
        # the reporter's own nuclei lie on the lattice shifted half a step
        lattice = (made["own"] + PARAMS["jitter"]) % spacing
        assert lattice.min() >= 0 and lattice.max() <= 2 * PARAMS["jitter"]
        ch1 = made["volume"][..., 1]
        at = ch1[tuple(made["centres"].T)]
        # co-expressing centres are bright; the others lie in the noise
        assert at[made["coexpressed"]].min() > 1000
        assert at[~made["coexpressed"]].max() < 600
        assert ch1[tuple(made["own"].T)].min() > 1000


def test_counts_of_the_cells_traffic():
    assert nuclei.num_nuclei((640, 1024, 1024), 20) // 2 == 41616
    assert nuclei.num_nuclei((620, 1004, 1004), 20) // 2 == 38750
    assert nuclei.num_nuclei((256, 1024, 1024), 12) == 151725


@pytest.fixture(scope="module")
def readings():
    """The small cell's sound call, the call with each fault, and the
    compared numbers of each against the reference."""
    from magellanmapper_torch.cv import colocalizer
    parts = small(CELL, SHAPE)
    drv = coloc_driver.Driver(parts[1], parts[2], 77, "cpu")
    drv.setup()
    outs = {"sound": drv.once()["out"]}
    real = colocalizer.colocalize_blobs

    def inverted(*args, **kwargs):
        flags = real(*args, **kwargs)
        flags[:, 1] = 1 - flags[:, 1]
        return flags
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(colocalizer, "colocalize_blobs", inverted)
        outs["inverted"] = drv.once()["out"]
    tol = drv.tol
    drv.tol = tol / 2
    outs["tol_halved"] = drv.once()["out"]
    drv.tol = tol
    ref = drv.reference()
    return dict(zip(outs, drv.check(list(outs.values()), ref))), parts


def test_the_sound_call_reads_zero_under_the_limits(readings):
    got, parts = readings
    assert got["sound"] == {"row_diff": 0.0, "coloc_diff": 0.0,
                            "match_diff": 0.0}
    assert set(got["sound"]) == set(parts[3])


def test_inverted_flags_of_channel_one_move_the_flags_alone(readings):
    got = readings[0]["inverted"]
    assert got["coloc_diff"] == 1.0
    assert got["row_diff"] == 0 and got["match_diff"] == 0


def test_a_halved_tolerance_moves_the_matches_alone(readings):
    got = readings[0]["tol_halved"]
    assert got["match_diff"] > 0
    assert got["row_diff"] == 0 and got["coloc_diff"] == 0


def test_a_program_without_the_matching_entry_fails_at_set_up(
        monkeypatch):
    from magellanmapper_torch.cv import colocalizer
    monkeypatch.delattr(colocalizer, "match_stack")

    def made(*args):
        raise AssertionError("the volume was made")
    monkeypatch.setattr(programs, "generator", made)
    parts = small(CELL, SHAPE)
    drv = coloc_driver.Driver(parts[1], parts[2], 77, "cpu")
    with pytest.raises(AttributeError, match="match_stack"):
        drv.setup()


@pytest.fixture(scope="module")
def traced():
    """One small call traced as the harness traces it, and the program's
    span records."""
    from magellanmapper_torch.utils import profiler
    parts = small(CELL, SHAPE)
    drv = coloc_driver.Driver(parts[1], parts[2], 31, "cpu")
    drv.setup()
    rec = drv.once()
    profiler.clear_spans()
    outs = []

    def calls():
        with torch.profiler.record_function(trace.PREFIX
                                            + coloc_driver.SPAN):
            outs.append(drv.once()["out"])
    run = harness.Run([rec], setup_s=0.0)
    run.trace = trace.profile(calls, drv.hooks(), "cpu")
    recs = profiler.spans()
    profiler.clear_spans()
    return run, recs, outs[0]


@pytest.mark.parametrize("metric", ["coloc_ball_share.coloc",
                                    "coloc_match_share.coloc"])
def test_each_share_reads_its_span_over_the_pass(metric, traced,
                                                 monkeypatch):
    run, recs, _ = traced
    monkeypatch.setattr(spans, "records", lambda: recs)
    value = harness.reader(metric)(run)
    name = "mm.coloc" if metric.startswith("coloc_ball") else \
        "mm.coloc.match"
    want = 100.0 * spans.wall_s(recs, name) / run.trace.window_s
    assert 0 < value < 100 and value == pytest.approx(want)


def test_match_cells_are_the_assignments_cells_a_pass(traced, monkeypatch):
    run, recs, out = traced
    monkeypatch.setattr(spans, "records", lambda: recs)
    cells = sum(r.counts["cells"] for r in recs
                if r.name == "mm.verify.assign")
    assert cells > 0
    assert harness.reader("match_cells_m.coloc")(run) == cells / 1e6


@pytest.mark.parametrize("metric", ["coloc_ball_share.coloc",
                                    "coloc_match_share.coloc",
                                    "match_cells_m.coloc"])
def test_a_program_without_spans_gives_nothing_to_read(metric, traced,
                                                      monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: None)
    assert harness.reader(metric)(traced[0]) is None


def test_ball_roofline_reads_the_hooked_calls_over_their_device_time(
        traced, monkeypatch):
    run, _, out = traced
    calls = run.trace.calls["ball_sums"]
    # one call a channel, each serving every blob of the pass
    assert len(calls) == 2
    assert all(len(c["coords"]) == len(out["blobs"]) for c in calls)
    read = harness.reader("ball_roofline.coloc")
    assert read(run) is None
    monkeypatch.setattr(run, "card", H100)
    monkeypatch.setattr(run.trace, "ops", [
        ("k", 0.25e-3, trace.PREFIX + "ball_sums"),
        ("k", 0.25e-3, trace.PREFIX + "ball_sums"),
        ("other", 1.0, trace.PREFIX + "log_pyramid")])
    counts = coloc_counts.ball_calls(run.trace.calls)
    least, _ = roofline.bound_s(counts, roofline.PEAKS[H100])
    assert read(run) == pytest.approx(100.0 * least / 0.5e-3)


def test_ball_voxels_by_hand():
    shape = (10, 10, 10)
    assert len(coloc_counts.ref_coloc.ball_offsets(2)) == 33
    assert coloc_counts.ball_voxels([[5, 5, 5]], shape, 1) == 7
    # two neighbours share each other's centre
    assert coloc_counts.ball_voxels([[5, 5, 5], [5, 5, 6]], shape, 1) == 12
    # at a corner each outer neighbour reflects onto the centre
    assert coloc_counts.ball_voxels([[0, 0, 0]], shape, 1) == 4
    assert coloc_counts.ball_voxels(np.zeros((0, 3)), shape, 1) == 0


def test_ball_means_count_reads_and_writes_by_hand():
    nbytes, ops = coloc_counts.ball_means([[5, 5, 5], [5, 5, 6]],
                                          (10, 10, 10), 2, 1)
    # 12 distinct uint16 voxels read, 2 float32 means written, 7 adds each
    assert (nbytes, ops) == (12 * 2 + 2 * 4, 2 * 7)
    least, bound = roofline.bound_s([(nbytes, ops)],
                                    roofline.PEAKS[H100])
    assert bound == "bytes" and least == pytest.approx(32 / 3.35e12)


def test_each_hooked_name_and_parameter_is_in_the_program():
    import importlib
    import inspect
    parts = small(CELL, SHAPE)
    hooks = coloc_driver.Driver(parts[1], parts[2], 31, "cpu").hooks()
    assert "ball_sums" in [h.name for h in hooks]
    for hook in hooks:
        fn = getattr(importlib.import_module(hook.module), hook.attr)
        params = inspect.signature(fn).parameters
        assert set(hook.reads) <= set(params), (hook.attr, list(params))
