"""Profiling hooks: ``torch.profiler`` traces and throughput counters.

Port of ``magellanmapper_tpu/utils/profiler.py``. :func:`trace` records
the host's operators and, on a card, its kernels with
``torch.profiler`` and writes a Chrome trace
(``<host>_<pid>.<ms>.pt.trace.json``) into its directory, which
TensorBoard's profiler plugin, Perfetto and ``chrome://tracing`` open;
:func:`annotate` names a range of that trace; :class:`Throughput` is the
reference's per-block Mvox/s accumulator, copied as it is.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from typing import Dict, Iterator, Optional

import torch

_logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Record a profiler trace of the block into ``log_dir`` (default
    ``mmtorch_trace`` in the temporary directory, as the reference's
    ``/tmp/mmtpu_trace``): CPU operators, and CUDA kernels when a card is
    visible.

    Usage::

        with profiler.trace("traces"):
            detect_blobs_stack(...)
    """
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "mmtorch_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield
    _logger.info("profiler trace written to %s", log_dir)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named range in the profiler timeline (``record_function``)."""
    with torch.profiler.record_function(name):
        yield


class Throughput:
    """Accumulates voxels/sec across pipeline steps (the per-block
    Mvox/s counter used by the detection pipeline)."""

    def __init__(self):
        self.voxels = 0
        self.seconds = 0.0
        self.blocks = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_voxels: int) -> float:
        """Close a timed region; returns this block's Mvox/s."""
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.voxels += int(n_voxels)
        self.seconds += dt
        self.blocks += 1
        self._t0 = None
        return n_voxels / dt / 1e6 if dt else float("inf")

    @property
    def mvox_per_s(self) -> float:
        return self.voxels / self.seconds / 1e6 if self.seconds else 0.0

    def summary(self) -> Dict[str, float]:
        return {"blocks": self.blocks, "voxels": self.voxels,
                "seconds": round(self.seconds, 3),
                "mvox_per_s": round(self.mvox_per_s, 2)}
