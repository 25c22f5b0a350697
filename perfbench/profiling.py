"""What a ``torch.profiler`` trace of a span of steps says.

:func:`traced` runs ``body`` under the profiler (CPU and CUDA
activities, no shapes or stacks) between two synchronisations, inside a
``perfbench.span`` annotation whose host interval is the traced window.
:func:`reduce` keeps the device operations (kernels, copies and sets)
that start in it and the host operations, and from them this module
gives the device's busy time (the union of the device intervals), the
seconds of the kernels whose names match a pattern, the device
operations that took most time, and the device's idle time by what the
host was doing (the innermost ``aten::`` operation, else the innermost
host event, running at the middle of each idle gap).
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass

SPAN = "perfbench.span"
#: libkineto's activity types of device work: copies, sets, kernels
_DEVICE_WORK = {"gpu_memcpy", "gpu_memset", "kernel", 3, 4, 5}
#: idle gaps shorter than this are summed under "short gaps"
_MIN_GAP_NS = 2_000


@dataclass
class Trace:
    start_ns: int
    end_ns: int
    device: list        # (name, start_ns, end_ns), by start
    host: list          # (name, start_ns, end_ns), by start

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def traced(body, sync):
    """Runs ``body()`` under the profiler; returns the :class:`Trace`
    of the span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        with record_function(SPAN):
            body()
            sync()
    return reduce(prof.profiler.kineto_results.events())


def _is_device_work(ev, host_names: set) -> bool:
    """A kernel, copy or set: a device event that is not a host range
    drawn on the device's timeline (an annotation, which bears the name of
    a host event where the profiler gives no activity type)."""
    if ev.device_type().name != "CUDA":
        return False
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        kind = kind()
        return getattr(kind, "value", kind) in _DEVICE_WORK
    return ev.name() not in host_names


def reduce(events) -> Trace:
    host_events = [e for e in events if e.device_type().name == "CPU"]
    span = [e for e in host_events if e.name() == SPAN]
    if not span:
        raise RuntimeError("the profiler's trace has no span annotation")
    start = span[0].start_ns()
    end = start + span[0].duration_ns()
    names = {e.name() for e in host_events}
    device, host = [], []
    for e in events:
        s = e.start_ns()
        if not start <= s <= end:
            continue
        if _is_device_work(e, names):
            device.append((e.name(), s, s + e.duration_ns()))
        elif e.device_type().name == "CPU" and e.name() != SPAN:
            host.append((e.name(), s, s + e.duration_ns()))
    device.sort(key=lambda t: t[1])
    host.sort(key=lambda t: t[1])
    return Trace(start, end, device, host)


def busy_intervals(trace: Trace) -> list:
    """The union of the device intervals, clipped to the window."""
    merged: list = []
    for _, s, e in trace.device:
        e = min(e, trace.end_ns)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace)) * 1e-9


def kernel_s(trace: Trace, pattern: str) -> tuple:
    """(seconds, launches) of the device operations matching
    ``pattern``."""
    rx = re.compile(pattern)
    hits = [e - s for name, s, e in trace.device if rx.search(name)]
    return sum(hits) * 1e-9, len(hits)


def short_name(name: str, width: int = 160) -> str:
    """A kernel's name without ``void`` and its parameter list (the last
    balanced ``(...)``), cut to ``width`` letters."""
    name = name[5:] if name.startswith("void ") else name
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:width].rstrip() or "(unnamed)"


def device_ops(trace: Trace, top: int = 10) -> list:
    by = defaultdict(int)
    for name, s, e in trace.device:
        by[short_name(name)] += e - s
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[n, ns * 1e-9] for n, ns in ranked]


def _host_at(trace: Trace, starts: list, t: int) -> str:
    """The innermost host event running at ``t``: the latest-starting
    ``aten::`` operation that covers it, else the latest-starting host
    event, among the few hundred that started last before it."""
    i = bisect.bisect_right(starts, t)
    other = None
    for j in range(i - 1, max(i - 300, -1), -1):
        name, s, e = trace.host[j]
        if e < t:
            continue
        if name.startswith("aten::"):
            return name
        other = other or name
    return other or "no host operation"


def idle_gaps(trace: Trace, top: int = 10) -> list:
    """The device's idle seconds in the window, summed by what the host
    was doing, largest first."""
    starts = [s for _, s, _ in trace.host]
    by = defaultdict(int)
    cursor = trace.start_ns
    for s, e in busy_intervals(trace) + [[trace.end_ns, trace.end_ns]]:
        gap = s - cursor
        if gap > 0:
            label = (_host_at(trace, starts, cursor + gap // 2)
                     if gap >= _MIN_GAP_NS else "short gaps")
            by[label] += gap
        cursor = max(cursor, e)
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[n, ns * 1e-9] for n, ns in ranked]


def breakdown(trace: Trace) -> dict:
    return {"device_ops": device_ops(trace), "idle_gaps": idle_gaps(trace)}
