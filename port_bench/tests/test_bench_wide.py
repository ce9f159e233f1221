"""The ``qinco2-L-contriever`` configuration's width on the CPU: the plain
reference against the program at D = 768 (decode and the exact encode, on
seeded random weights, a small N), and ``refetch_mb.encode``: read from
the program's kernel spans, left out of a tiny traced CPU cell (the
kernel wrappers' CUDA paths, and so their spans, run only on a card), and
``None`` where the program records no spans.  (This test may import
both.)"""

import json
import sys
import time

import pytest
import torch

import common
import gen
import program
from conftest import run_cpu
from reference import qinco_ref

CPU = torch.device("cpu")
WIDE = common.load_json(common.BENCH / "configs" / "qinco2-L-contriever.json")
# the configuration's widths (D = 768, L = 16, de = dh = 384, K = 256) with
# two MLP steps, a beam of 4, 4 candidates a row and a small IVF book
SMALL = dict(WIDE, M=2, A=4, B=4, ivf_K=256, encode_profile="exact")


def setup(n=64):
    shp = qinco_ref.Shape.of(SMALL)
    W = gen.random_weights(shp, 2200000031, CPU)
    x = torch.from_numpy(gen.synthetic_data(W, shp, n, 2200000031, SMALL["data_noise"]))
    return shp, W, x, program.spec(SMALL), program.params(W)


def test_decode_matches_the_program_at_D768():
    shp, W, x, spec, params = setup()
    assert spec.D == 768 and spec.De == 384 and spec.L == 16
    g = torch.Generator().manual_seed(5)
    codes = torch.stack([torch.randint(0, k, (64,), generator=g) for k in [256, 256, 256]])
    torch.testing.assert_close(qinco_ref.decode(W, codes),
                               program.qinco.decode(params, spec, codes.int()),
                               rtol=1e-5, atol=1e-5)


def test_exact_encode_matches_the_program_at_D768():
    shp, W, x, spec, params = setup()
    ref = qinco_ref.encode(W, shp, x)
    codes, _, _ = program.qinco.encode(params, spec, x)
    assert (ref == codes.long()).float().mean() >= 0.999
    e_r = ((x - qinco_ref.decode(W, ref)) ** 2).sum(-1).mean()
    e_p = ((x - qinco_ref.decode(W, codes)) ** 2).sum(-1).mean()
    assert abs(float(e_p / e_r) - 1) < 1e-5


class FakeTrace:
    t0, t1, wall_s = 0.0, 1e9, 1e3


def test_refetch_mb_sums_the_kernel_spans_a_chunk(monkeypatch):
    """Two chunks whose kernel spans carry 3 and 5 MB (one span without the
    id counts as 0): 4 MB a chunk; spans outside the chunks do not count."""
    from qinco_torch import tracing

    tracing.clear()
    with tracing.recording():
        for mb in (3, 5):
            with tracing.span("encode.chunk", chunk=mb):
                with tracing.span("kernels.selected_scores", refetch_bytes=(mb - 1) * 10**6):
                    pass
                with tracing.span("kernels.select_rebuild", refetch_bytes=10**6):
                    pass
                with tracing.span("kernels.candidate_scores"):
                    pass
        with tracing.span("kernels.selected_scores", refetch_bytes=10**9):
            pass
    spans = tracing.spans()
    tracing.clear()
    monkeypatch.setattr(tracing, "_trace_starts", [spans[0].start_ns - 10**6])
    monkeypatch.setattr(tracing, "_spans", spans)
    read = common.metric_reader("refetch_mb.encode")
    assert read({"kind": "encode", "trace": FakeTrace()}) == pytest.approx(4.0)
    assert read({"kind": "train", "trace": FakeTrace()}) is None


def test_refetch_mb_is_none_without_the_id_or_the_recorder(monkeypatch):
    """A program whose kernel spans carry no ``refetch_bytes`` (one without
    the column passes) or that records no spans reports nothing, and the
    reader raises nothing."""
    from qinco_torch import tracing

    tracing.clear()
    with tracing.recording():
        with tracing.span("encode.chunk", chunk=0):
            with tracing.span("kernels.selected_scores", tile_pairs=64):
                time.sleep(0.001)
    spans = tracing.spans()
    tracing.clear()
    monkeypatch.setattr(tracing, "_trace_starts", [spans[0].start_ns - 10**6])
    monkeypatch.setattr(tracing, "_spans", spans)
    read = common.metric_reader("refetch_mb.encode")
    assert read({"kind": "encode", "trace": FakeTrace()}) is None
    monkeypatch.setitem(sys.modules, "qinco_torch.tracing", None)
    assert read({"kind": "encode", "trace": FakeTrace()}) is None


def test_a_traced_tiny_cell_leaves_refetch_mb_out(tiny_root, capsys):
    """The tiny encode cell, traced, with ``refetch_mb.encode`` among its
    metrics: on the CPU the program records no kernel spans, so the line
    leaves the metric out and the run is still correct."""
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for e in m["per_layer"]:
        if e["name"] == "refetch_mb.encode":
            e["workloads"].append("tiny.encode")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(m, indent=1))
    rc, line = run_cpu(tiny_root, capsys, "--workload", "tiny.encode", "--seed", "2200000041",
                       "--seconds", "1.5", "--trace", "1")
    assert rc == 0 and line["correct"]
    assert "chunk_host_ms.encode" in line["metrics"] and "refetch_mb.encode" not in line["metrics"]
