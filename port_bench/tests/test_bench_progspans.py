"""The per-layer metrics that read the program's own spans
(``progspans.py``): reported by the tiny CPU cells' traced runs, and left
out, without an error, where the program records no spans."""

import sys
import time

import pytest

import common
from conftest import run_cpu

SPAN_METRICS = {"chunk_host_ms.encode", "kernel_prep_host_ms.encode", "tail_host_ms.train",
                "tail_idle_pct.train"}


@pytest.mark.parametrize("cell,want", [("tiny.encode", {"chunk_host_ms.encode"}),
                                       ("tiny.train", {"tail_host_ms.train",
                                                       "tail_idle_pct.train"})])
def test_traced_tiny_cells_report_the_span_metrics(tiny_root, capsys, cell, want):
    rc, line = run_cpu(tiny_root, capsys, "--workload", cell, "--seed", "2200000011",
                       "--seconds", "1.5", "--trace", "1")
    assert rc == 0 and line["correct"]
    got = {k: v["value"] for k, v in line["metrics"].items() if k in SPAN_METRICS}
    assert set(got) == want  # the kernel wrappers' spans exist only on a card
    host = "chunk_host_ms.encode" if cell == "tiny.encode" else "tail_host_ms.train"
    assert got[host] > 0, got
    if cell == "tiny.train":  # on the CPU no device operation runs: the idle is all gaps
        assert 0 <= got["tail_idle_pct.train"] <= line["metrics"]["device_idle_pct.train"][
            "value"]


def test_a_program_without_spans_reports_none(monkeypatch):
    """On a checkout whose program has no recorder the readers return
    ``None`` (the metric is left out of the line), and raise nothing."""
    monkeypatch.setitem(sys.modules, "qinco_torch.tracing", None)
    trace = type("T", (), dict(t0=0.0, t1=1.0, wall_s=1.0, intervals=lambda self: []))()
    for name in sorted(SPAN_METRICS):
        kind = name.rsplit(".", 1)[1]
        assert common.metric_reader(name)({"kind": kind, "trace": trace}) is None


class FakeTrace:
    def __init__(self, t0, t1, busy, wall_s):
        self.t0, self.t1, self.busy, self.wall_s = t0, t1, busy, wall_s

    def intervals(self):
        return self.busy


def test_gaps_go_to_the_span_under_way(monkeypatch):
    """One step: the device busy through the step's encode and idle after
    it; the gap after the encode is the tail's, the one before the step
    is nobody's."""
    from qinco_torch import tracing

    import idle_by_span

    tracing.clear()
    with tracing.recording():
        with tracing.span("train.step", step=0):
            with tracing.span("train.encode"):
                time.sleep(0.01)
            with tracing.span("train.losses"):
                time.sleep(0.01)
    spans = {s.name: s for s in tracing.spans()}
    tracing.clear()
    step, enc, loss = spans["train.step"], spans["train.encode"], spans["train.losses"]
    start = step.start_ns - 10**6  # the trace starts 1 ms before the step
    monkeypatch.setattr(tracing, "_trace_starts", [start])
    monkeypatch.setattr(tracing, "_spans", list(spans.values()))
    us = lambda ns: (ns - start) / 1e3
    t1 = us(step.end_ns) + 100.0
    trace = FakeTrace(0.0, t1, [(us(enc.start_ns), us(enc.end_ns))], wall_s=t1 / 1e6)
    tail = (t1 - us(enc.end_ns)) / 1e6
    obs = {"kind": "train", "trace": trace}
    assert common.metric_reader("tail_idle_pct.train")(obs) == pytest.approx(
        100 * tail / trace.wall_s)
    assert common.metric_reader("tail_host_ms.train")(obs) == pytest.approx(
        (step.end_ns - enc.end_ns) / 1e6)
    got = idle_by_span.idle_by_span(trace)
    assert set(got) == {"train.losses", "outside"}
    assert got["train.losses"] == [pytest.approx(tail), 1]
    assert got["outside"] == [pytest.approx(us(enc.start_ns) / 1e6), 1]
