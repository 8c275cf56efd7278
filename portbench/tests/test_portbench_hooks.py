"""The harness's hooks into the program: every hooked function and every
parameter a hook reads exists in ``magellanmapper_torch``, a traced call
at a small size on the CPU records through each hook, and a traced run
in which a listed per-layer metric reads nothing fails."""

import importlib
import inspect

import pytest

from portbench import harness, readers, trace
from portbench.tests.small import SMALL, small


def _hooks(cell):
    parts = small(cell, SMALL[cell])
    drv = harness.driver_module(parts[2]["driver"]).Driver(
        parts[1], parts[2], 31, "cpu")
    return drv, drv.hooks()


CASES = [(cell, k) for cell in sorted(SMALL)
         for k in range(len(_hooks(cell)[1]))]


@pytest.mark.parametrize("cell, k", CASES)
def test_each_hooked_name_and_parameter_is_in_the_program(cell, k):
    hook = _hooks(cell)[1][k]
    fn = getattr(importlib.import_module(hook.module), hook.attr)
    assert callable(fn)
    params = inspect.signature(fn).parameters
    assert set(hook.reads) <= set(params), (hook.attr, list(params))


#: per cell, the counts its roofline readers take from the traced calls
COUNTS = {"detect.ls.cortex": (readers.log_counts, readers.k1_counts,
                               readers.k3_counts, readers.k4_counts),
          "sweep.4xnuc.gridtest": (readers.log_counts, readers.k2_counts,
                                   readers.k3_counts)}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_call_records_through_every_hook(cell):
    drv, hooks = _hooks(cell)
    drv.setup()
    originals = [getattr(importlib.import_module(h.module), h.attr)
                 for h in hooks]
    seen = trace.Spans(hooks)
    with seen:
        drv.once()
    for hook in hooks:
        if hook.record is not None:
            assert seen.calls[hook.name], hook.name
    for count in COUNTS[cell]:
        work = count(dict(seen.calls))
        assert work and all(b > 0 and o > 0 for b, o in work), count
    assert originals == [getattr(importlib.import_module(h.module), h.attr)
                         for h in hooks]


def test_a_per_layer_metric_that_reads_nothing_fails_the_run(monkeypatch):
    cell = "detect.ls.cortex"
    real = harness.reader

    def reader(name, root=harness.ROOT):
        if name == "k3_roofline.detect":
            return lambda run: None
        if name in ("staging_share.detect", "border_prune_share.detect",
                    "pull_wait_share.detect"):
            return real(name, root)
        return lambda run: 1.0
    monkeypatch.setattr(harness, "reader", reader)
    with pytest.raises(RuntimeError, match="k3_roofline.detect"):
        harness.run_cell(cell, 31, 0.0, True, device="cpu",
                         parts=small(cell, SMALL[cell]),
                         log=lambda *a, **k: None)
