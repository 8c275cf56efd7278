"""Wall-clock timing and throughput counters.

Copy of ``magellanmapper_tpu/utils/timing.py``: a segment timer, Mvox/s,
and the per-stage detection times CSV (``stack_detection_times.csv``).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional

#: timing CSV emitted after whole-stack detection (reference artifact name).
STACK_TIMES_CSV = "stack_detection_times.csv"


class StopWatch:
    """Simple segment timer."""

    def __init__(self):
        self.times: Dict[str, float] = {}
        self._start: Optional[float] = None
        self._label: Optional[str] = None

    def start(self, label: str):
        self.stop()
        self._label = label
        self._start = time.perf_counter()

    def stop(self) -> Optional[float]:
        if self._start is None:
            return None
        elapsed = time.perf_counter() - self._start
        self.times[self._label] = self.times.get(self._label, 0.0) + elapsed
        self._start = None
        return elapsed


def mvox_per_sec(nvox: int, seconds: float) -> float:
    return nvox / seconds / 1e6 if seconds > 0 else float("inf")


def save_stack_times(
        times: Dict[str, float], path: Optional[str] = None,
        extra: Optional[Dict[str, float]] = None):
    """Append a row of stage times to the detection-times CSV."""
    path = path or STACK_TIMES_CSV
    row = dict(times)
    if extra:
        row.update(extra)
    exists = os.path.isfile(path)
    with open(path, "a", newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=list(row))
        if not exists:
            writer.writeheader()
        writer.writerow(row)
