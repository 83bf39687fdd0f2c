"""The program's own spans in a traced run: ``repro_torch.<name>`` events.

While a profiler records, the port opens a span at each layer boundary
of its insert and lookup paths (``repro_torch.tracing``).  ``read``
turns the profiler's events into a ``Program``: each span an interval
with its parent (spans nest), the benchmark span it opened in, and the
device time of the operations launched under it.  An operation belongs
to the innermost program span open at the host time of the CUDA runtime
call that launched it (by its correlation id, as ``trace.read_events``
gives an operation its benchmark span), or of the CPU operation it is
linked to where the launch is not found.

A reader gets only the run; ``of(run)`` finds the events on the
``trace.Tracer`` that recorded the window, which the frame that called
the readers (``cell.run``) still holds, reads them once, keeps the
``Program`` on ``run.trace`` and prints, on standard error, each span's
count, host ms and device ms a call and the share of the calls' device
time that falls under a span below the façade.  A trace without program
spans (a program that opens none) gives an empty ``Program``: the
readers then return nothing, and the lines say so.
"""

from __future__ import annotations

import bisect
import sys
from dataclasses import dataclass, field

import torch

from .trace import PREFIX, Tracer, _span_at, _spans

PROGRAM = "repro_torch."
FACADE = ("filters.insert", "filters.contains")
_KEPT = "program"  # the attribute of ``run.trace`` that keeps its ``Program``


def matches(name: str, names) -> bool:
    """Is ``name`` one of ``names``, or below one of them (``cascade.collapse``
    takes ``cascade.collapse.L3``)?"""
    return any(name == n or name.startswith(n + ".") for n in names)


@dataclass
class Program:
    names: list = field(default_factory=list)  # each span's name, by start
    start: list = field(default_factory=list)  # host ns
    end: list = field(default_factory=list)
    parent: list = field(default_factory=list)  # index, or -1
    span: list = field(default_factory=list)  # the benchmark span it opened in, or ""
    own_ns: list = field(default_factory=list)  # device ns whose innermost span it is
    loose_ns: dict = field(default_factory=dict)  # benchmark span -> device ns under none

    def has(self, names) -> bool:
        return any(matches(n, names) for n in set(self.names))

    def _outermost(self, span, names):
        """Spans in benchmark span ``span`` that ``names`` takes, and no
        span around them does."""
        for i, n in enumerate(self.names):
            if self.span[i] != span or not matches(n, names):
                continue
            j = self.parent[i]
            while j >= 0 and not matches(self.names[j], names):
                j = self.parent[j]
            if j < 0:
                yield i

    def inclusive_ns(self) -> list:
        """Device ns launched under each span, its children's included."""
        out = list(self.own_ns)
        for i in range(len(out) - 1, -1, -1):  # children start after their parents
            if self.parent[i] >= 0:
                out[self.parent[i]] += out[i]
        return out

    def device_s(self, span, names) -> float:
        """Seconds of device operations launched in benchmark span ``span``
        under a program span that ``names`` takes, at any depth."""
        incl = self.inclusive_ns()
        return sum(incl[i] for i in self._outermost(span, names)) / 1e9

    def host_s(self, span, names) -> float:
        """Host seconds inside the spans ``names`` takes, in ``span``."""
        return sum(self.end[i] - self.start[i] for i in self._outermost(span, names)) / 1e9

    def self_s(self, span, names) -> float:
        """Host seconds of the spans ``names`` takes, in ``span``, less the
        part their child spans cover."""
        child_ns = [0] * len(self.names)
        for i, p in enumerate(self.parent):
            if p >= 0:
                child_ns[p] += self.end[i] - self.start[i]
        return sum(
            self.end[i] - self.start[i] - child_ns[i]
            for i, n in enumerate(self.names)
            if self.span[i] == span and matches(n, names)
        ) / 1e9

    def coverage(self, span) -> float:
        """Share of the device time launched in benchmark span ``span``
        whose innermost program span is below the façade, or None."""
        covered = total = 0
        for i, ns in enumerate(self.own_ns):
            if self.span[i] == span:
                total += ns
                covered += 0 if self.names[i] in FACADE else ns
        total += self.loose_ns.get(span, 0)
        return covered / total if total else None

    def lines(self, span, calls: int) -> list:
        """One line a span name (count, host ms and device ms a call, the
        device time its children's included), then the coverage line."""
        incl = self.inclusive_ns()
        by: dict = {}
        for i, n in enumerate(self.names):
            count, host, dev = by.get(n, (0, 0, 0))
            by[n] = (count + 1, host + self.end[i] - self.start[i], dev + incl[i])
        out = [
            f"span {n}: {count} ({count / calls:.4g} a call), host {host / 1e6 / calls:.6g} ms "
            f"a call, device {dev / 1e6 / calls:.6g} ms a call"
            for n, (count, host, dev) in sorted(by.items())
        ]
        share = self.coverage(span)
        if share is None:
            out.append(f"span coverage of {span}: no device time")
        else:
            out.append(f"span coverage of {span}: {100 * share:.4f}% of its device time "
                       "under a program span below the facade")
        return out


def read(events) -> Program:
    """A ``Program`` from the profiler's events (kineto's, or any objects
    with the same accessors)."""
    cpu = torch.autograd.DeviceType.CPU
    bench, launches, device, spans, others = [], {}, [], [], []
    for e in events:
        name = e.name()
        if name.startswith("aten::"):  # a CPU operation: no device type to read
            others.append(e)
        elif e.device_type() != cpu:
            if not name.startswith((PROGRAM, PREFIX)):  # a span's shadow on the card is none
                device.append(e)
        elif name.startswith(PROGRAM):
            spans.append((e.start_ns(), -e.end_ns(), name[len(PROGRAM):]))
        elif name.startswith(PREFIX):
            bench.append((e.start_ns(), e.end_ns(), name, "span"))
        elif name.startswith(("cuda", "cuLaunch", "cuMem")):
            launches[e.correlation_id()] = e.start_ns()
        else:
            others.append(e)
    launched = [(e.end_ns() - e.start_ns(), launches.get(e.correlation_id()), e)
                for e in device]
    if any(t is None for _, t, _ in launched):  # take the CPU operation it is linked to
        linked = {o.correlation_id(): o.start_ns() for o in others}
        launched = [(ns, linked.get(e.linked_correlation_id()) if t is None else t, e)
                    for ns, t, e in launched]
    _, bspans = _spans(bench)
    bstarts = [s[0] for s in bspans]
    spans.sort()
    p = Program()
    stack = []
    for i, (s, neg_e, n) in enumerate(spans):
        while stack and p.end[stack[-1]] < -neg_e:
            stack.pop()
        p.names.append(n)
        p.start.append(s)
        p.end.append(-neg_e)
        p.parent.append(stack[-1] if stack else -1)
        p.span.append(_span_at(bspans, bstarts, s))
        p.own_ns.append(0)
        stack.append(i)
    for ns, t, _ in launched:
        if t is None:
            continue
        i = innermost(p, t)
        if i >= 0:
            p.own_ns[i] += ns
        else:
            b = _span_at(bspans, bstarts, t)
            p.loose_ns[b] = p.loose_ns.get(b, 0) + ns
    return p


def innermost(p: Program, t: int) -> int:
    """The innermost span open at host time ``t``, or -1.  Spans nest, so
    one that opened before the last to open at or before ``t`` and holds
    ``t`` is among that one's ancestors."""
    i = bisect.bisect_right(p.start, t) - 1
    while i >= 0 and p.end[i] < t:
        i = p.parent[i]
    return i


def _recorded_events():
    """The events of the ``Tracer`` held by a calling frame, or None."""
    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, Tracer):
                return v.prof.profiler.kineto_results.events()
        f = f.f_back
    return None


def of(run):
    """The run's ``Program``, read once, or None without a trace."""
    if run.trace is None:
        return None
    kept = getattr(run.trace, _KEPT, None)
    if kept is None:
        events = _recorded_events()
        if events is None:
            return None
        kept = read(events)
        setattr(run.trace, _KEPT, kept)
        if not kept.names:
            print("span lines: the trace holds no program span", file=sys.stderr, flush=True)
        elif run.record.calls:
            print("\n".join(kept.lines(run.op, len(run.record.calls))), file=sys.stderr,
                  flush=True)
    return kept


def per_call_ms(run, op, names, reading):
    """``reading`` (``Program.device_s``, ``.host_s`` or ``.self_s``) of the
    spans ``names`` takes, in the window's ``op`` spans, in ms a call; or
    None where the program opens none of them."""
    p = of(run) if run.op == op and run.record.calls else None
    if p is None or not p.has(names):
        return None
    return reading(p, op, names) / len(run.record.calls) * 1e3
