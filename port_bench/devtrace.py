"""The device trace of a steady stretch of a run, and what the per-layer
metrics read from it.

``device_breakdown`` of ``chip_smoke.py`` (commit 3513fb6) summed kernel
durations as the device's busy time; here busy time is the union of the
intervals in which any operation (kernel, copy or fill) ran on the
device, so work on two streams at once counts once, and it is taken over
a stretch of many calls, not over one.

A stretch is traced in one of two ways.  Where a metric reads one of
the benchmark's own spans (``torch.profiler.record_function``, named
``bench.*``) around the calls it makes into the program, the host's
operations are recorded too: the span ``bench.active`` marks the
stretch, and the device operations that the program's CPU operations
inside a span launched are that span's.  Recording the host's
operations slows a host that launches many small operations, so where no
span is read only the device is traced: a marker kernel
(``torch.cuda._sleep``, launched between two synchronizations) marks the
stretch's start, and an idle gap is named by the device operation that
ends it.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

ACTIVE = "bench.active"
MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
MARKER_CYCLES = 1000


def _device_events(events) -> list:
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("bench.") and not e.name.startswith("ProfilerStep")]


class Trace:
    """The events of one profiled stretch: ``wall_s`` by the host's clock
    between two synchronizations, the device operations inside it, and,
    where the host was traced, its operations."""

    def __init__(self, events, wall_s: float, host: bool):
        self.wall_s, self.host = wall_s, host
        cuda = torch.autograd.DeviceType.CUDA
        if host:
            active = [e for e in events if e.name == ACTIVE
                      and e.device_type == torch.autograd.DeviceType.CPU]
            if len(active) != 1:
                raise RuntimeError(f"{len(active)} '{ACTIVE}' spans in the trace")
            self.t0, self.t1 = active[0].time_range.start, active[0].time_range.end
        else:
            marks = [e for e in events if e.device_type == cuda and MARKER in e.name]
            if len(marks) != 1:
                raise RuntimeError(f"{len(marks)} '{MARKER}' kernels in the trace")
            self.t0 = marks[0].time_range.end
        self.device = [e for e in _device_events(events)
                       if MARKER not in e.name and self.t0 <= e.time_range.start
                       and (not host or e.time_range.end <= self.t1)]
        if not host:
            self.t1 = max([e.time_range.end for e in self.device], default=self.t0)
        self.cpu = [e for e in events if host and e.device_type == torch.autograd.DeviceType.CPU
                    and e.name != ACTIVE and self.t0 <= e.time_range.start <= self.t1]
        self.events = events

    def intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals (us), in order."""
        spans = sorted((e.time_range.start, e.time_range.end) for e in self.device)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) / 1e6

    def kernels(self, part: str) -> tuple[int, float]:
        """(count, seconds) of the device operations whose name holds ``part``."""
        us = [e.time_range.elapsed_us() for e in self.device if part in e.name]
        return len(us), sum(us) / 1e6

    def span_device_s(self, span: str) -> tuple[int, float]:
        """(spans, seconds): the number of CPU spans named ``span`` in the
        stretch and the device seconds of the operations that the CPU
        operations inside them launched."""
        spans = [e for e in self.cpu if e.name == span]

        def launched(e) -> float:
            own = sum(k.duration for k in getattr(e, "kernels", []))
            return own + sum(launched(c) for c in e.cpu_children)

        return len(spans), sum(launched(e) for e in spans) / 1e6

    def device_ops(self, n: int = 10) -> list:
        by_name = defaultdict(float)
        for e in self.device:
            by_name[e.name[:120]] += e.time_range.elapsed_us() / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, label: int = 400) -> list:
        """The device's idle time by what the host was doing: the ``label``
        longest gaps between device operations, each named by the
        innermost CPU operation under way at its middle (where the host
        was traced) or by the device operation that ends it, summed by
        name."""
        ivs = self.intervals()
        edges = [self.t0] + [x for iv in ivs for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:label]
        if not self.host:
            return self._gaps_by_next_op(gaps, n)
        cpu = sorted(self.cpu, key=lambda e: e.time_range.start)
        starts = [e.time_range.start for e in cpu]
        by_name = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid)
            name = "host: Python between ops"
            for e in reversed(cpu[max(0, i - 2000):i]):
                if e.time_range.end >= mid:
                    name = e.name[:120]
                    break
            by_name[name] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


    def _gaps_by_next_op(self, gaps: list, n: int) -> list:
        ops = sorted(self.device, key=lambda e: e.time_range.start)
        starts = [e.time_range.start for e in ops]
        by_name = defaultdict(float)
        for a, b in gaps:
            i = bisect.bisect_left(starts, b)
            name = f"before {ops[i].name[:110]}" if i < len(ops) else "the stretch's end"
            by_name[name] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def profiled(warm, active, sync, host: bool) -> tuple[Trace, float]:
    """``warm()`` then ``active()`` under torch.profiler, the device
    synchronized (``sync``) before and after ``active``, the host's
    operations recorded only with ``host``; returns the trace of
    ``active`` and the seconds its reading took."""
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    host = host or not card
    activities = ([ProfilerActivity.CPU] if host else []) + (
        [ProfilerActivity.CUDA] if card else [])
    with profile(activities=activities) as prof:
        warm()
        sync()
        if not host:
            torch.cuda._sleep(MARKER_CYCLES)
        with record_function(ACTIVE):
            t0 = time.perf_counter()
            active()
            sync()
            wall = time.perf_counter() - t0
    t = time.perf_counter()
    trace = Trace(prof.events(), wall, host)
    return trace, time.perf_counter() - t
