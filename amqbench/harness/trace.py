"""The traced run: ``torch.profiler`` over the window, read into a ``Trace``.

In a ``--trace 1`` run every call the window makes sits in a span of
the benchmark's own (``record_function("amqbench.<name>")``), and the
whole window in ``amqbench.window``; a span opened with ``syncs=True``
also runs under ``torch.cuda.set_sync_debug_mode("warn")`` and counts
the synchronizations the card warns of inside it.  Nothing is added
inside the program.

Each device operation (kernel, copy, fill) is given the span its launch
was issued in: the CUDA runtime call that launched it has its
correlation id and a host time, which falls in one span.  An operation
whose launch is not found takes the span of the CPU operation it is
linked to.
"""

from __future__ import annotations

import bisect
import contextlib
import warnings
from dataclasses import dataclass, field

import torch

PREFIX = "amqbench."
OUTER = PREFIX + "window"
NAME_CHARS = 160  # a kernel's name in the breakdown, at most
GAPS_READ = 2000  # the longest idle gaps given a host activity


@dataclass
class Op:
    name: str
    start_ns: int
    end_ns: int
    span: str  # the benchmark span its launch was issued in, or ""


@dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: list
    syncs: dict = field(default_factory=dict)  # span name -> synchronizations
    sync_sites: dict = field(default_factory=dict)  # (span, file:line) -> count
    breakdown: dict = field(default_factory=dict)

    def device_s(self, span: str, match=None) -> float:
        """Seconds of device operations launched in ``span`` (whose name
        ``match`` accepts, where given)."""
        return sum(
            o.end_ns - o.start_ns
            for o in self.ops
            if o.span == span and (match is None or match(o.name))
        ) / 1e9


class NoTracer:
    """The untraced run: spans cost nothing."""

    def open(self):
        pass

    def close(self):
        pass

    @contextlib.contextmanager
    def span(self, name, syncs=False):
        yield


class Tracer:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.syncs: dict = {}  # span name -> synchronizations
        self.sync_sites: dict = {}  # (span name, file:line) -> synchronizations

    def open(self):
        self.prof.__enter__()
        self.outer = torch.profiler.record_function(OUTER)
        self.outer.__enter__()

    def close(self):
        self.outer.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    @contextlib.contextmanager
    def span(self, name, syncs=False):
        with torch.profiler.record_function(PREFIX + name):
            if not (syncs and self.cuda):
                yield
                return
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    yield
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            warned = [w for w in seen if "synchroniz" in str(w.message)]
            self.syncs[name] = self.syncs.get(name, 0) + len(warned)
            for w in warned:
                site = (name, f"{w.filename}:{w.lineno}")
                self.sync_sites[site] = self.sync_sites.get(site, 0) + 1

    def read(self) -> Trace:
        trace = read_events(self.prof.profiler.kineto_results.events(), self.syncs)
        trace.sync_sites = dict(self.sync_sites)
        return trace


def _spans(cpu) -> tuple:
    """The window's interval and its benchmark spans, sorted by start."""
    window = None
    spans = []
    for start, end, name, _ in cpu:
        if name == OUTER:
            window = (start, end)
        elif name.startswith(PREFIX):
            spans.append((start, end, name[len(PREFIX):]))
    spans.sort()
    return window, spans


def _span_at(spans, starts, t) -> str:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][0] <= t <= spans[i][1]:
        return spans[i][2]
    return ""


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def kind(e) -> str:
    """The event's kind: ``span`` (the benchmark's), ``launch`` (a CUDA
    runtime or driver call), ``cpu_op``, ``device`` (an operation on the
    card) or ``other``, by its device and name (older kineto events
    carry no activity type)."""
    name = e.name()
    if e.device_type() != torch.autograd.DeviceType.CPU:
        return "other" if name.startswith(PREFIX) else "device"
    if name.startswith(PREFIX):
        return "span"
    if name.startswith(("cuda", "cuLaunch", "cuMem")):
        return "launch"
    return "cpu_op"


def read_events(events, syncs=None) -> Trace:
    """A ``Trace`` from the profiler's events (kineto's, or any objects
    with the same accessors)."""
    cpu, launches, linked, device = [], {}, {}, []
    for e in events:
        k = kind(e)
        if k == "launch":
            launches[e.correlation_id()] = e.start_ns()
        elif k in ("cpu_op", "span"):
            cpu.append((e.start_ns(), e.end_ns(), e.name(), k))
            linked[e.correlation_id()] = e.start_ns()
        elif k == "device":
            device.append(e)
    window, spans = _spans(cpu)
    if window is None:
        raise ValueError("the trace holds no window span")
    starts = [s[0] for s in spans]
    ops = []
    for e in device:
        t = launches.get(e.correlation_id(), linked.get(e.linked_correlation_id()))
        span = _span_at(spans, starts, t) if t is not None else ""
        ops.append(Op(e.name(), e.start_ns(), e.end_ns(), span))
    w0, w1 = window
    busy = _union((max(o.start_ns, w0), min(o.end_ns, w1)) for o in ops
                  if o.end_ns > w0 and o.start_ns < w1)
    return Trace(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        ops=ops,
        syncs=dict(syncs or {}),
        breakdown=_breakdown(ops, busy, cpu, spans, window),
    )


def _breakdown(ops, busy, cpu, spans, window) -> dict:
    """The ten device operations that took most time, and the host
    activity during the longest idle gaps: the innermost CPU operation
    running where a gap opens, under the benchmark span around it."""
    by_name: dict = {}
    for o in ops:
        by_name[o.name] = by_name.get(o.name, 0) + o.end_ns - o.start_ns
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    w0, w1 = window
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, reverse=True)[:GAPS_READ]
    inner = sorted((s, e, n) for s, e, n, kind in cpu if kind == "cpu_op")
    inner_starts = [s for s, _, _ in inner]
    starts = [s[0] for s in spans]
    idle: dict = {}
    for length, at in gaps:
        label = _span_at(spans, starts, at) or "between spans"
        i = bisect.bisect_right(inner_starts, at) - 1
        for j in range(i, max(i - 200, -1), -1):
            if inner[j][1] >= at:
                label += "/" + inner[j][2]
                break
        idle[label] = idle.get(label, 0) + length
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "device_ops": [[n[:NAME_CHARS], ns / 1e9] for n, ns in top],
        "idle_gaps": [[n[:NAME_CHARS], ns / 1e9] for n, ns in gaps_top],
    }
