"""The traced run: harness spans around the program's calls, the
profiler's device trace, and what the per-layer readers take from them.

:class:`Spans` wraps functions of the program, for the traced calls only,
in ``torch.profiler.record_function`` ranges named ``portbench.<name>``
and records what each call was given and returned (shapes and the host
counts the program already holds: nothing that waits on the card).
:func:`profile` runs calls under ``torch.profiler`` and :func:`summarise`
reads the trace: each device operation (kernel, copy, set) with the
innermost harness span that was open when the host launched it (by the
CUDA correlation of the launch), the union of device activity over the
traced window, and the idle gaps with what the host was doing then.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

#: span name prefix of the harness's ranges
PREFIX = "portbench."
#: device activities counted as work
_DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
#: host activities that launch device work
_LAUNCH_KINDS = {"cuda_runtime", "cuda_driver"}


@dataclass
class Hook:
    """``module.attr`` wrapped in the span ``name``; ``record(params,
    result)`` returns what to keep of a call, or None. ``params`` maps
    each parameter named in ``reads`` to the call's argument (bound by
    name, defaults applied), so a hook reads no argument by position."""
    module: str
    attr: str
    name: str
    record: Optional[Callable] = None
    reads: Tuple[str, ...] = ()


class Spans:
    """Installs the hooks on enter and restores the originals on exit;
    ``calls[name]`` lists what each hook recorded, in call order."""

    def __init__(self, hooks: Sequence[Hook]):
        self.hooks = list(hooks)
        self.calls: Dict[str, list] = defaultdict(list)
        self._saved: List[Tuple[object, str, object]] = []

    def _wrap(self, fn, hook: Hook):
        span = PREFIX + hook.name
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(span):
                out = fn(*args, **kwargs)
            if hook.record is not None:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                params = {k: bound.arguments[k] for k in hook.reads}
                kept = hook.record(params, out)
                if kept is not None:
                    self.calls[hook.name].append(kept)
            return out
        return inner

    def __enter__(self):
        for hook in self.hooks:
            mod = importlib.import_module(hook.module)
            fn = getattr(mod, hook.attr)
            self._saved.append((mod, hook.attr, fn))
            setattr(mod, hook.attr, self._wrap(fn, hook))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()
        return False


@dataclass
class Trace:
    """What the readers take from one traced window (seconds)."""
    window_s: float
    busy_s: float
    #: (name, seconds, innermost span name or "") of every device op
    ops: List[Tuple[str, float, str]]
    #: (host activity, seconds) of every idle gap in the window
    gaps: List[Tuple[str, float]]
    calls: Dict[str, list] = field(default_factory=dict)

    def kernel_s(self, *names: str) -> float:
        """Seconds of device ops whose name contains one of ``names``."""
        return sum(s for n, s, _ in self.ops if any(k in n for k in names))

    def span_s(self, span: str) -> float:
        """Seconds of device ops launched inside ``portbench.<span>``."""
        return sum(s for _, s, sp in self.ops if sp == PREFIX + span)

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time and the host activities
        that left the device idle longest, by name, summed."""
        ops: Dict[str, float] = defaultdict(float)
        for name, s, _ in self.ops:
            ops[name[:160]] += s
        gaps: Dict[str, float] = defaultdict(float)
        for name, s in self.gaps:
            gaps[name[:160]] += s
        return {"device_ops": sorted(([n, s] for n, s in ops.items()),
                                     key=lambda x: -x[1])[:top],
                "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                                    key=lambda x: -x[1])[:top]}


def profile(fn: Callable[[], None], hooks: Sequence[Hook],
            device="cuda") -> Trace:
    """Run ``fn`` (which opens its own outer span per call) with the
    hooks installed under the profiler, and summarise the trace."""
    on_card = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with Spans(hooks) as spans:
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            if on_card:
                torch.cuda.synchronize(device)
    trace = summarise(prof.profiler.kineto_results.events(),
                      [PREFIX + h.name for h in hooks])
    trace.calls = dict(spans.calls)
    return trace


def _kind(ev) -> Optional[str]:
    """Kineto's activity type, where the installed PyTorch gives it."""
    try:
        return str(ev.activity_type())
    except AttributeError:
        return None


#: CUDA runtime and driver calls, by name, where the activity type is not
#: given
_API = re.compile(r"^cu(da)?[A-Z]")


def _innermost(times: Sequence[Tuple[int, int]],
               intervals: Sequence[Tuple[int, int, str]]) -> Dict[int, str]:
    """For each ``(time, key)``, the name of the innermost of the nested
    ``(start, end, name)`` intervals that contains the time."""
    out: Dict[int, str] = {}
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for t, key in sorted(times):
        while i < len(ivs) and ivs[i][0] <= t:
            while stack and stack[-1][1] < ivs[i][0]:
                stack.pop()
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = stack[-1][2] if stack else ""
    return out


def summarise(events, inner_spans: Sequence[str] = ()) -> Trace:
    """A :class:`Trace` from kineto events. The window runs from the
    first to the last end of a top-level harness span (one a call)."""
    from torch.autograd import DeviceType
    device, launches, host = [], {}, []
    main_tid = None
    for ev in events:
        kind, name = _kind(ev), ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if kind in _DEVICE_KINDS or kind is None and not (
                    name.startswith(PREFIX) or name.startswith("Activity")):
                device.append((name, ev.start_ns(), ev.end_ns(),
                               ev.correlation_id()))
            continue
        if kind in _LAUNCH_KINDS or kind is None and _API.match(name):
            launches[ev.correlation_id()] = ev.start_ns()
        elif kind in ("user_annotation", "cpu_op") or kind is None:
            host.append((ev.start_ns(), ev.end_ns(), name,
                         ev.start_thread_id()))
            if name.startswith(PREFIX) and main_tid is None:
                main_tid = ev.start_thread_id()
    host = [(s, e, n) for s, e, n, tid in host if tid == main_tid]
    spans = [h for h in host if h[2].startswith(PREFIX)]
    inner = set(inner_spans)
    outer = [h for h in spans if h[2] not in inner]
    if not outer:
        raise RuntimeError("the trace holds no harness span")
    w0, w1 = min(h[0] for h in outer), max(h[1] for h in outer)
    # each device op's innermost harness span, by its launch time
    launch_t = [(launches[c], k) for k, (_, _, _, c) in enumerate(device)
                if c in launches]
    where = _innermost(launch_t, spans)
    ops = [(n, (e - s) / 1e9, where.get(k, ""))
           for k, (n, s, e, _) in enumerate(device) if s < w1 and e > w0]
    # union of device activity inside the window, and its gaps
    ivs = sorted((max(s, w0), min(e, w1)) for _, s, e, _ in device
                 if s < w1 and e > w0)
    busy, gaps, cur = 0, [], w0
    for s, e in ivs:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if cur < w1:
        gaps.append((cur, w1))
    # what the host was doing halfway through each gap: the innermost
    # harness span, and inside it the innermost operator, if any
    mids = [((s + e) // 2, k) for k, (s, e) in enumerate(gaps)]
    at_span = _innermost(mids, spans)
    at_op = _innermost(mids, [h for h in host
                              if not h[2].startswith(PREFIX)])
    named = []
    for k, (s, e) in enumerate(gaps):
        label = at_span.get(k, "") or "outside harness spans"
        if at_op.get(k):
            label += " > " + at_op[k]
        named.append((label, (e - s) / 1e9))
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, ops=ops,
                 gaps=named)
