"""The port's span and counter recorder (``qinco_torch.tracing``): off
outside a profiler, nesting and ids under ``recording()``, the spans of
``encode_chunked``, of the train step and of ``eval_time``'s export, and
the mapping of a span onto the profiler's clock.  The card's clock check
(a spin kernel inside its span) is the ``cuda`` case, also run by
``scripts/torch_trace_clock.py``."""

import json
import time

import numpy as np
import pytest
import torch

from qinco_torch import tracing
from qinco_torch.models import QincoSpec
from qinco_torch.models.params import init_model_state, init_params
from qinco_torch.models.qinco import encode_chunked
from qinco_torch.ops import kernels
from qinco_torch.train.train_step import build_optimizer, make_train_step

SPEC = dict(D=16, K=16, M=3, L=1, de=16, dh=32, A=4, B=4, ivf_K=32)
TRAIN_CHILDREN = ["train.encode", "train.losses", "train.backward", "train.stats", "train.clip",
                  "train.optimizer"]


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def _model(**kw):
    spec = QincoSpec(**{**SPEC, **kw})
    g = torch.Generator().manual_seed(0)
    ivf = np.random.default_rng(1).normal(size=(spec.ivf_K, spec.D)).astype(np.float32)
    return spec, init_params(spec, g, device="cpu", ivf_centroids=ivf)


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_off_records_nothing():
    assert tracing.span("a", chunk=1) is tracing.NOOP
    with tracing.span("a"):
        tracing.count("c", 3)
    spec, params = _model()
    encode_chunked(params, spec, np.zeros((10, spec.D), np.float32), batch=4)
    assert tracing.spans() == [] and "c" not in tracing.counters()


def test_recording_nests_with_parent_ids():
    with tracing.recording():
        with tracing.span("outer", chunk=7, rows=3):
            with tracing.span("mid", step_i=2):
                with tracing.span("inner"):
                    pass
            with tracing.span("sibling", chunk=8):
                pass
        tracing.count("c", 2)
        tracing.count("c")
    by = {s.name: s for s in tracing.spans()}
    assert by["outer"].parent == 0
    assert by["mid"].parent == by["outer"].id and by["inner"].parent == by["mid"].id
    assert by["sibling"].parent == by["outer"].id
    # the request id is carried down, other ids are not; a child's own wins
    assert by["inner"].ids == {"chunk": 7} and by["mid"].ids == {"chunk": 7, "step_i": 2}
    assert by["sibling"].ids == {"chunk": 8}
    assert all(s.start_ns <= s.end_ns for s in by.values())
    assert by["outer"].start_ns <= by["mid"].start_ns <= by["inner"].end_ns <= by["outer"].end_ns
    assert tracing.counters()["c"] == 3
    assert tracing.span("x") is tracing.NOOP  # off again


def test_a_span_takes_ids_found_inside_it():
    """``set`` adds ids to the open span (the kernel wrappers' plan ids);
    off, the no-op span takes them and records nothing."""
    with tracing.recording():
        with tracing.span("kernels.selected_scores", chunk=3) as sp:
            sp.set(tile_pairs=64, cluster=4)
    (rec,) = tracing.spans()
    assert rec.ids == {"chunk": 3, "tile_pairs": 64, "cluster": 4}
    with tracing.span("off") as sp:
        sp.set(tile_pairs=1)
    assert len(tracing.spans()) == 1


@pytest.mark.parametrize("D", [128, 768])
def test_kernel_spans_carry_the_column_passes(monkeypatch, D):
    """The CUDA paths of B2 and B3 (their plans and spans, the launch left
    out) on CPU tensors at qinco2-L's widths: each span carries the plan's
    ``d_passes`` and ``refetch_bytes`` (2 passes at D = 768, where nothing
    is read again at D = 128), and the counter ``kernels.refetch_bytes``
    sums them over the launches; B2's span carries ``hidden`` (registers at
    D = 128, on 128-pair tiles; shared memory on D = 768's column passes)
    and the counter ``kernels.selected_hidden_regs`` counts the launches
    that held it in registers."""
    monkeypatch.setattr(kernels, "_require_cuda", lambda t: None)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(kernels, "_launch", lambda *a, **kw: None)
    spec = QincoSpec(D=D, K=256, M=2, L=16, de=384, dh=384, A=16, B=32, pallas=True, fast=True,
                     compute_dtype="bfloat16")
    p = init_params(spec, torch.Generator().manual_seed(0), device="cpu").step(0)
    N = 8
    x, xh = torch.zeros((N, D)), torch.zeros((N * 32, D))
    dists = torch.zeros((N, 32 * 16))
    with tracing.recording():
        for _ in range(2):
            kernels._selected_cuda(spec, x, xh, p, 16, 32, None)
        kernels._rebuild_cuda(spec, dists, xh, p, 16, 32, 32)
    sel = [s for s in tracing.spans() if s.name == "kernels.selected_scores"]
    reb = [s for s in tracing.spans() if s.name == "kernels.select_rebuild"]
    assert len(sel) == 2 and len(reb) == 1
    wide = D == 768
    for s in sel + reb:
        assert s.ids["d_passes"] == (2 if wide else 1)
        assert (s.ids["refetch_bytes"] > 0) == wide
    plan = kernels.selected_plan(N * 32, 16, D, 256, 384, 384, bf16=True, topa=True, stages=35)
    assert sel[0].ids["refetch_bytes"] == kernels.selected_refetch_bytes(
        plan, 16, D, 384, wfold=True, res=True)
    assert sel[0].ids["tile_pairs"] == plan.tm and sel[0].ids["cluster"] == plan.cluster
    assert [s.ids["hidden"] for s in sel] == 2 * ["smem" if wide else "regs"]
    assert plan.tm == (64 if wide else 128)
    assert tracing.counters().get("kernels.selected_hidden_regs") == (0 if wide else 2)
    total = sum(s.ids["refetch_bytes"] for s in sel + reb)
    assert tracing.counters().get("kernels.refetch_bytes") == total


def test_cap_counts_dropped_spans(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 2)
    with tracing.recording():
        for _ in range(5):
            with tracing.span("s"):
                pass
    assert len(tracing.spans()) == 2 and tracing.counters()["tracing.dropped"] == 3


def test_encode_chunked_spans():
    spec, params = _model()
    x = np.random.default_rng(2).normal(size=(10, spec.D)).astype(np.float32)
    with tracing.recording():
        codes = encode_chunked(params, spec, x, batch=4)
    assert codes.shape == (spec.M_ivf, 10)
    spans = tracing.spans()
    chunks = [s for s in spans if s.name == "encode.chunk"]
    assert [s.ids for s in chunks] == [{"chunk": 0, "rows": 4, "pad_rows": 0},
                                       {"chunk": 1, "rows": 4, "pad_rows": 0},
                                       {"chunk": 2, "rows": 2, "pad_rows": 2}]
    waits = [s for s in spans if s.name == "encode.wait"]
    # chunk c's codes are waited for in chunk c + 1, the last chunk's in itself
    assert [(w.ids["chunk"], w.parent) for w in waits] == [
        (0, chunks[1].id), (1, chunks[2].id), (2, chunks[2].id)]
    for c in chunks:
        kids = _children(spans, c)
        names = [s.name for s in kids]
        assert names[0] == "encode.upload" and names.count("encode.upload") == 1
        assert names.count("encode.download") == 1
        assert all(s.ids["chunk"] == c.ids["chunk"] for s in kids if s.name != "encode.wait")
        inside = [s for s in spans if c.start_ns <= s.start_ns and s.end_ns <= c.end_ns]
        assert [s.name for s in inside].count("encode.ivf") == 1
        steps = [s for s in inside if s.name == "encode.step"]
        assert [s.ids["step_i"] for s in steps] == list(range(spec.n_mlp_steps))
        assert all(s.ids["chunk"] == c.ids["chunk"] for s in steps)
        assert [s.name for s in inside].count("encode.backtrace") == 1
    assert {w.ids["chunk"] for w in waits} == {0, 1, 2}


def test_train_step_spans():
    spec, params = _model(compute_dtype="float32")
    cfg = type("Cfg", (), dict(optimizer="adamw", lr=1e-3, wd=0.1))()
    opt = build_optimizer(cfg, params, spec)
    step = make_train_step(spec, opt, grad_clip=0.1)
    mstate = init_model_state(spec, device="cpu")
    xb = torch.from_numpy(np.random.default_rng(3).normal(size=(8, spec.D)).astype(np.float32))
    w = torch.ones(8)
    with tracing.recording():
        for _ in range(2):
            params, mstate, _ = step(params, mstate, xb, w)
    spans = tracing.spans()
    tops = [s for s in spans if s.name == "train.step"]
    assert [s.ids["step"] for s in tops] == [0, 1] and all(s.parent == 0 for s in tops)
    for top in tops:
        kids = _children(spans, top)
        assert [s.name for s in kids] == TRAIN_CHILDREN
        assert all(s.ids["step"] == top.ids["step"] for s in kids)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
        enc = kids[0]
        assert [s.name for s in _children(spans, enc)][0] == "encode.ivf"
        assert sum(s.name == "encode.step" for s in _children(spans, enc)) == spec.n_mlp_steps


def test_host_to_device_records_its_bytes():
    from qinco_torch.utils import host_to_device

    with tracing.recording():
        host_to_device(np.zeros((3, 5), np.float64), torch.device("cpu"))
    (s,) = tracing.spans()
    assert s.name == "io.upload" and s.ids == {"bytes": 60}


def test_a_span_maps_onto_the_profilers_clock():
    """Under a CPU profile, a program span and a ``record_function`` opened
    inside it lie at the same interval of the trace, within 50 µs (the
    least of five pairs, so that a pause of the host between the two does
    not count), by the session's start that the recorder keeps."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = len(tracing.profiler_trace_starts())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        for _ in range(5):
            with tracing.span("outer"):
                with record_function("inner"):
                    time.sleep(0.002)
    start = prof.profiler.kineto_results.trace_start_ns()
    assert tracing.profiler_trace_starts()[n:] == [start]
    spans = [s for s in tracing.spans() if s.name == "outer"]
    events = sorted((e for e in prof.events() if e.name == "inner"),
                    key=lambda e: e.time_range.start)
    assert len(spans) == len(events) == 5
    before, after = [], []
    for s, e in zip(spans, events):
        a, b = (s.start_ns - start) / 1e3, (s.end_ns - start) / 1e3
        assert a <= e.time_range.start and e.time_range.end <= b
        before.append(e.time_range.start - a)
        after.append(b - e.time_range.end)
    assert min(before) < 50 and min(after) < 50, (before, after)


def test_launches_is_the_recorders_counter_group():
    assert kernels.LAUNCHES is tracing.LAUNCHES
    assert {"selected_scores", "select_rebuild", "fused_substep_scores",
            "candidate_scores"} <= set(kernels.LAUNCHES)
    assert tracing.counters()["launch.selected_scores"] == kernels.LAUNCHES["selected_scores"]
    tracing.clear()
    assert "selected_scores" in kernels.LAUNCHES


def test_export_writes_a_chrome_trace(tmp_path, monkeypatch):
    with tracing.recording():
        with tracing.span("a", chunk=1):
            tracing.count("io.h2d_bytes", 4)
    monkeypatch.setattr(tracing, "_trace_starts", [tracing.spans()[0].start_ns])
    tracing.export(tmp_path / "spans.json")
    doc = json.loads((tmp_path / "spans.json").read_text())
    (ev,) = doc["traceEvents"]
    assert ev["name"] == "a" and ev["ph"] == "X" and ev["ts"] == 0 and ev["args"]["chunk"] == 1
    assert doc["otherData"]["counters"]["io.h2d_bytes"] == 4


def test_eval_time_writes_spans_beside_its_trace(tmp_path):
    from qinco_torch.__main__ import main

    x = np.random.default_rng(0).normal(size=(600, 16)).astype(np.float32)
    np.save(tmp_path / "db.npy", x)
    trace = tmp_path / "trace"
    assert main(["task=eval_time", f"db={tmp_path / 'db.npy'}", "ds.db=512", "M=3", "K=16",
                 "L=1", "de=8", "dh=16", "A=4", "B=2", "batch=256", "verbose=false",
                 "cpu=true", f"profile_dir={trace}"]) == 0
    assert (trace / "trace.json").exists()
    doc = json.loads((trace / "spans.json").read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"encode.step", "encode.backtrace", "io.upload"} <= names
    assert doc["otherData"]["trace_start_ns"] > 0


@pytest.mark.cuda
def test_spin_kernel_lies_inside_its_span_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "torch_trace_clock.py"
    mod_spec = importlib.util.spec_from_file_location("torch_trace_clock", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    for r in mod.check(repeats=5):
        assert r["inside"] and 0 <= r["start_after_us"] < 200, r
