"""The program's own spans (``qinco_torch.tracing``) inside a traced
stretch, on the trace's clock.

The port records its spans on ``time.time_ns()``'s clock while a torch
profiler session is active, and keeps each session's trace start as it
ends (``tracing.profiler_trace_starts()``); the trace's events lie, in
µs, after that start.  So a span at ``t`` ns lies at ``(t - start) /
1000`` µs of the last session's trace, the stretch that ``devtrace.py``
read.  The stretch's spans are the top-level spans that overlap its
interval ``[t0, t1]``, with their descendants.

The only module of the benchmark besides the drivers and ``program.py``
that imports the program.  Where the program records no spans (a
checkout that has no ``qinco_torch.tracing``), :meth:`Stretch.of`
returns ``None`` and the metrics that read it are left out.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional


class Stretch:
    """The spans of the last profiler session, mapped onto its trace."""

    def __init__(self, trace, spans, start_ns: int):
        self.trace = trace
        self.start_ns = start_ns
        self.spans = spans
        self.kids = defaultdict(list)
        for s in spans:
            self.kids[s.parent].append(s)

    @classmethod
    def of(cls, trace) -> Optional["Stretch"]:
        if trace is None:
            return None
        try:
            from qinco_torch import tracing
        except ImportError:
            return None
        starts = tracing.profiler_trace_starts()
        spans = tracing.spans()
        if not starts or not spans:
            return None
        return cls(trace, spans, starts[-1])

    def us(self, ns: int) -> float:
        """A time on the host's clock (ns) in the trace's µs."""
        return (ns - self.start_ns) / 1e3

    def top(self, name: str) -> list:
        """The top-level spans ``name`` that overlap the stretch."""
        t0, t1 = self.trace.t0, self.trace.t1
        return [s for s in self.kids[0] if s.name == name
                and self.us(s.start_ns) < t1 and self.us(s.end_ns) > t0]

    def children(self, span, name: str) -> list:
        return [s for s in self.kids[span.id] if s.name == name]

    def descendants(self, span) -> list:
        out, todo = [], [span]
        while todo:
            for s in self.kids[todo.pop().id]:
                out.append(s)
                todo.append(s)
        return out


def ms(span) -> float:
    return (span.end_ns - span.start_ns) / 1e6


def gaps(trace) -> list[tuple[float, float]]:
    """The device's idle gaps over the stretch (µs): between its start,
    the union of the device operations' intervals and its end, as
    ``device_idle_pct.*`` counts them."""
    edges = [trace.t0] + [x for iv in trace.intervals() for x in iv] + [trace.t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
