"""Profiling hooks: ``torch.profiler`` traces, the program's spans and
counters, and throughput counters.

Port of ``magellanmapper_tpu/utils/profiler.py``. :func:`trace` records
the host's operators and, on a card, its kernels with
``torch.profiler`` and writes a Chrome trace
(``<host>_<pid>.<ms>.pt.trace.json``) into its directory, which
TensorBoard's profiler plugin, Perfetto and ``chrome://tracing`` open.

:func:`annotate` is the program's one span. While a ``torch.profiler``
session records in the process (:func:`trace`, or any other; the flag
``torch.autograd.profiler`` keeps for such checks), a span opens a
profiler range of the ``cpu_op`` kind named after it, which puts it on
the trace's own clock beside the kernels launched inside it, and keeps
a :class:`SpanRecord` in memory (:func:`spans`): its start and end on the
profiler's host clock, its parent, its root and the counters
:func:`count` added to it. It never opens a
``user_annotation`` range (``record_function``'s), which the profiler
mirrors on the device as if it were device work. While nothing records,
a span is a flag check and a shared no-op: it reads no clock, allocates
nothing and never synchronises.

:class:`Throughput` is the reference's per-block Mvox/s accumulator,
synchronised with the card.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import tempfile
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_logger = logging.getLogger(__name__)

#: most span records kept until :func:`clear_spans`; the spans past it
#: are counted (:func:`dropped_spans`), not kept
MAX_SPANS = 1 << 17


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Record a profiler trace of the block into ``log_dir`` (default
    ``mmtorch_trace`` in the temporary directory, as the reference's
    ``/tmp/mmtpu_trace``): CPU operators and the program's spans, and
    CUDA kernels when a card is visible.

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


class SpanRecord:
    """One span of :func:`annotate`: its ``name``; ``start_ns`` and
    ``end_ns`` on the profiler's host clock (Unix-epoch nanoseconds;
    ``end_ns`` is None while it is open); ``parent``, the index in
    :func:`spans` of the span it opened in (None for a root); ``root``,
    the index of its root (its own for a root); and ``counts``, the
    counters added to it."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "root", "counts",
                 "_index")

    def __init__(self, name: str, start_ns: int, parent: Optional[int],
                 root: int, index: int):
        self.name = name
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None
        self.parent = parent
        self.root = root
        self.counts: Dict[str, int] = {}
        self._index = index


_records: List[SpanRecord] = []
#: the kept spans that are open, innermost last
_open: List[SpanRecord] = []
_dropped = 0
#: the profiler's host clock less ``perf_counter``, ns; taken as a root
#: span opens
_offset_ns = 0


def _clock_offset() -> int:
    """Unix-epoch ns less ``perf_counter`` ns, from the tightest of three
    bracketed reads."""
    best = None
    for _ in range(3):
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, wall - (p0 + p1) // 2)
    return best[1]


def _open_record(name: str, t0: float) -> Optional[SpanRecord]:
    global _dropped, _offset_ns
    if len(_records) >= MAX_SPANS:
        _dropped += 1
        return None
    index = len(_records)
    if _open:
        parent, root = _open[-1]._index, _open[-1].root
    else:
        parent, root = None, index
        _offset_ns = _clock_offset()
    rec = SpanRecord(name, round(t0 * 1e9) + _offset_ns, parent, root,
                     index)
    _records.append(rec)
    _open.append(rec)
    return rec


def _close_record(rec: Optional[SpanRecord], t1: float) -> None:
    if rec is None:
        return
    rec.end_ns = round(t1 * 1e9) + _offset_ns
    if _open and _open[-1] is rec:
        _open.pop()


class _Off:
    """The span while nothing records and no clock is asked for."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    """A span that reads the clock: recorded (a ``cpu_op`` range and a
    :class:`SpanRecord`) when ``on``, else only timed. ``t0`` and ``t1``
    are the ``perf_counter`` reads of its start and end, inside the
    range."""

    __slots__ = ("name", "t0", "t1", "_range", "_rec")

    def __init__(self, name: str, on: bool):
        self.name = name
        self.t0 = self.t1 = 0.0
        self._range = (torch._C._profiler._RecordFunctionFast(name)
                       if on else None)
        self._rec: Optional[SpanRecord] = None

    def __enter__(self):
        if self._range is None:
            self.t0 = time.perf_counter()
            return self
        self._range.__enter__()
        self.t0 = time.perf_counter()
        self._rec = _open_record(self.name, self.t0)
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        if self._range is not None:
            _close_record(self._rec, self.t1)
            self._range.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        """``t1 - t0``."""
        return self.t1 - self.t0


def annotate(name: str, clock: bool = False):
    """The span ``name`` (a ``with`` block): recorded while a profiler
    session records, else a shared no-op. With ``clock``, the span reads
    ``perf_counter`` on entry and exit either way and yields itself, so a
    caller that keeps its own timings takes them from the same reads
    (``span.seconds``, ``span.t0``, ``span.t1``)."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name, True)
    return _Span(name, False) if clock else _OFF


def annotated(name: str):
    """Decorator: every call of the function in the span ``name``
    (:func:`annotate`); the function keeps its name, docstring and
    signature."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span; a
    no-op while nothing records. ``n`` must be a number the host already
    holds, never one read from the card."""
    if not _autograd_profiler._is_profiler_enabled or not _open:
        return
    counts = _open[-1].counts
    counts[name] = counts.get(name, 0) + n


def spans() -> List[SpanRecord]:
    """The spans recorded since the last :func:`clear_spans`, in the
    order they opened."""
    return list(_records)


def dropped_spans() -> int:
    """Spans not kept since the last :func:`clear_spans`, the buffer
    being full (:data:`MAX_SPANS`)."""
    return _dropped


def clear_spans() -> None:
    """Forget the recorded spans. A span open across the call is not
    kept; spans that open inside it afterwards are roots."""
    global _dropped
    _records.clear()
    _open.clear()
    _dropped = 0


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
        """Close a timed region; returns this block's Mvox/s. Where CUDA
        is initialised, the current device is synchronised first: a
        block's kernels are only enqueued when the host returns, so the
        rate would otherwise count the work launched, not the work
        done."""
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
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
