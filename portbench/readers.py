"""Shared arithmetic of the metric readers in ``metrics/``.

A reader returns None where its run gives it nothing to read (no trace,
no call of its kernel, an unknown card), and the harness then leaves the
metric out of the result line.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

from portbench import counts, roofline


def timing_share(run, keys: Sequence[str]) -> Optional[float]:
    """Percent of the calls' wall that the program's timing dict puts in
    ``keys``, summed over the window's calls."""
    wall = sum(r["t1"] - r["t0"] for r in run.records)
    if not wall or "timing" not in run.records[0]:
        return None
    inside = sum(float(r["timing"].get(k, 0.0))
                 for r in run.records for k in keys)
    return 100.0 * inside / wall


def idle(run) -> Optional[float]:
    """Percent of the traced window in which no operation ran on the
    device."""
    if run.trace is None or not run.trace.window_s > 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def peak_gib(run) -> Optional[float]:
    """Peak device memory allocated during the window, GiB."""
    if not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2 ** 30


def roofline_share(run, count_calls: Callable[[dict], Iterable],
                   device_s: Callable[[object], float]) -> Optional[float]:
    """Percent of the roofline: the least time for the traced calls'
    counted work over the device time of its kernels."""
    if run.trace is None:
        return None
    work = list(count_calls(run.trace.calls))
    return roofline.share(work, device_s(run.trace), run.card)


def log_counts(calls: dict):
    return [counts.log_pyramid(c["shape"], c["sigmas"])
            for c in calls.get("log_pyramid", [])]


def k1_counts(calls: dict):
    return [counts.peak_candidates(c["shape"], c["candidates"])
            for c in calls.get("peak_candidates", [])]


def k2_counts(calls: dict):
    return [counts.extract_candidates(c["rows"])
            for c in calls.get("extract_candidates", [])]


def k3_counts(calls: dict):
    return [counts.prune_overlap(c["capacity"], c["rows"])
            for c in calls.get("peak_buffers", [])]


def k4_counts(calls: dict):
    return [counts.tile_percentiles(c["shape"][0], c["shape"][1],
                                    c["itemsize"])
            for c in calls.get("tile_percentiles", [])]


#: kernel names (substrings of the demangled names) of each kernel
K1 = ("peak_candidates_kernel",)
K2 = ("extract_candidates_kernel",)
K3 = ("::compact_kernel", "::pairs_kernel")
K4 = ("tile_percentiles_short_kernel", "tile_percentiles_long_kernel")
