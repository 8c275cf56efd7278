"""What the harness takes from the program under test, and the lookups
by name of the benchmark's own parts.

The program is ``magellanmapper_torch``; it is imported here, lazily,
and nowhere in ``reference/``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import time

import torch


def generator(name: str):
    """The traffic generator module ``portbench/traffic/<name>.py``."""
    return importlib.import_module(f"portbench.traffic.{name}")


def _plain(value):
    return json.loads(json.dumps(value))


def roi_profile(config):
    """The program's ROI profile of the configuration's
    ``roi_profile`` names, after checking that it holds each value that
    the configuration's ``profile`` states."""
    from magellanmapper_torch.settings.roi_prof import ROIProfile
    prof = ROIProfile()
    prof.add_profiles(config["roi_profile"])
    for key, want in config["profile"].items():
        have = _plain(prof[key])
        if have != want:
            raise RuntimeError(
                f"the program's profile {config['roi_profile']!r} has "
                f"{key}={have!r}; the configuration states {want!r}")
    return prof


def check_grid(config) -> None:
    """Check that the program's grid-search profile of the
    configuration's ``grid_search`` name sweeps its ``hyperparams``."""
    from magellanmapper_torch.settings.grid_search_prof import (
        GridSearchProfile)
    prof = GridSearchProfile()
    prof.add_profiles(config["grid_search"])
    have = _plain(prof.get_param_grid())
    if have != config["hyperparams"]:
        raise RuntimeError(
            f"the program's grid {config['grid_search']!r} sweeps {have!r}; "
            f"the configuration states {config['hyperparams']!r}")


@contextlib.contextmanager
def overridden(profile, values: dict):
    """``profile`` with ``values`` set, restored on exit."""
    saved = {k: profile[k] for k in values}
    profile.update(values)
    try:
        yield profile
    finally:
        profile.update(saved)


@contextlib.contextmanager
def timed(module: str, attr: str):
    """``module.attr`` timed on the host's clock while inside; yields a
    one-item list that sums the seconds of its calls."""
    mod = importlib.import_module(module)
    original = getattr(mod, attr)
    spent = [0.0]

    def inner(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return original(*args, **kwargs)
        finally:
            spent[0] += time.perf_counter() - t0
    setattr(mod, attr, inner)
    try:
        yield spent
    finally:
        setattr(mod, attr, original)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def release(device) -> None:
    """Drop the program's cached device memory."""
    gc.collect()
    if torch.device(device).type == "cuda":
        from magellanmapper_torch.ops import filters
        filters._band_on.cache_clear()
        filters.sigma_tensor.cache_clear()
        torch.cuda.empty_cache()
