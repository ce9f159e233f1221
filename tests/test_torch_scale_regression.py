"""The port's scale regression (``scripts/torch_scale_regression.py``)
against the JAX script it ports (``scripts/scale_regression.py``), both
with ``--tiny-model`` at ``ARGS``, on the CPU: the JAX run in this
process (its index loads the native library of the ``jax_native_lib``
fixture), the port's with ``--device cpu``.

Bounds:
- the train, DB and query files are the same bytes: both scripts draw
  them with the same numpy code from the same seeds;
- the ground truth: every query's nearest row is the same, and >= 99.9%
  of all (query, rank) ids are.  Both are exact f32 brute force; they
  differ only where two rows' distances round to one f32 value, where the
  order of the sums in the products decides;
- the port's report has every key of the JAX report and the same phases,
  in order.  The search sweep's Pareto skip and its explorer read
  wall-clock times, so which points after the first a run measures
  follows the host's timing: the first point is the same, every point
  lies on the default grid, and the points both measured come in the
  same order;
- cross-fed (the JAX run's data, IVF centroids and checkpoint, shared
  files, in a fresh directory; the port skips ``gen_data``,
  ``ivf_centroids`` and ``train``): the DB codes agree on >= 99% of
  entries (the bound of the encode tests at the exact f32 profile,
  ``tests/test_torch_encode_exact.py``); HNSW coarse recall within 0.01
  (the same native code on the same centroids, against an exact probe
  that may order f32 near-ties otherwise); the int8 norm error's mean
  within 5e-5 relative and its p99 within 1e-4: the two AQ fits solve
  the same normal equations from f32 sums taken in another order, so the
  reconstructions' norms differ by about 1e-6 of their mean.  On
  ``ARGS``'s data the mean moved 1.13e-5 of itself and the p99 2.57e-5;
  over three more tiny runs (DB 30,000 / train 40,000; DB 40,000 /
  train 30,000; ``--query-noise 0.5``) the mean moved at most 1.13e-5,
  but the p99, one order statistic, moved up to 1.33e-4, so its limit
  holds for this data only; R@1/10/100 of each point both runs measured
  within 2/nq, two queries' worth, since a near-tie in the scan's or the
  rerank's distances may flip one query's rank;
- ``scripts/torch_trained_mse_check.py`` on the JAX run's checkpoint:
  its exact MSE is the JAX exact encode's (rtol 1e-5, f32 sums in
  another order), the relabelled weights give the same exact MSE (rtol
  1e-5), and the routes that select the same TPU layout on the card
  give their base route's MSE."""

import importlib.util
import json
import shutil
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_helpers import jax_native_lib, one_torch_thread  # noqa: F401 (autouse fixtures)

from qinco_tpu.checkpoint import load_checkpoint as jax_load
from qinco_tpu.models import init_params
from qinco_tpu.models.qinco import encode as jax_encode
from qinco_tpu.models.spec import QincoSpec

ROOT = Path(__file__).resolve().parent.parent
NQ = 64
ARGS = ["--tiny-model", "--db-size", "20000", "--train-size", "30000", "--nq", str(NQ),
        "--ivf-k", "64", "--kmeans-iters", "5", "--epochs", "1"]
GRID = {"nprobe": (4, 16, 64), "nshort": (10, 100), "nmid_short": (1, 3)}
SHARED = ("train.npy", "db.npy", "queries.npy", "gt.npy", "ivf.npy", "model.npz")
INT8_REL = {"mean": 5e-5, "p99": 1e-4}


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_scale")
    script = load_script("scale_regression")
    with mock.patch.object(sys, "argv", ["scale_regression.py", "--out", str(out), *ARGS]):
        script.main()
    return out


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_scale")
    load_script("torch_scale_regression").main(["--out", str(out), *ARGS, "--device", "cpu"])
    return out


@pytest.fixture(scope="module")
def cross_dir(jax_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_scale_cross")
    for name in SHARED:
        shutil.copy(jax_dir / name, out / name)
    load_script("torch_scale_regression").main(
        ["--out", str(out), *ARGS, "--device", "cpu", "--skip-gen"])
    return out


def report(d: Path) -> dict:
    return json.loads((d / "scale_report.json").read_text())


def point_key(p) -> tuple:
    return tuple(p["parameters"][k] for k in GRID)


@pytest.mark.parametrize("name", ["train.npy", "db.npy", "queries.npy"])
def test_data_files_are_byte_identical(jax_dir, port_dir, name):
    assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes()


def test_ground_truth_agrees(jax_dir, port_dir):
    want, got = np.load(jax_dir / "gt.npy"), np.load(port_dir / "gt.npy")
    assert got.shape == want.shape == (NQ, 100)
    assert (got[:, 0] == want[:, 0]).all()
    assert (got == want).mean() >= 0.999


def test_report_has_the_jax_keys_phases_and_grid(jax_dir, port_dir):
    want, got = report(jax_dir), report(port_dir)
    assert set(want) <= set(got), sorted(set(want) - set(got))
    assert list(got["phases"]) == list(want["phases"])
    assert got["device"] == "cpu"
    assert set(got["launches"]) == set(got["phases"])
    for r in (want, got):
        keys = [point_key(p) for p in r["operating_points"]]
        assert all(v in GRID[k] for key in keys for k, v in zip(GRID, key)), keys
    mine, theirs = ([point_key(p) for p in r["operating_points"]] for r in (got, want))
    assert mine[0] == theirs[0]
    both = set(mine) & set(theirs)
    assert [k for k in mine if k in both] == [k for k in theirs if k in both]


def test_a_second_call_keeps_the_first_calls_numbers(port_dir, tmp_path):
    """With every output in place, a second call runs only the phases that
    always run (the validations; the sweep resumes from its results file)
    and its report keeps the first call's phases and numbers."""
    first = report(port_dir)
    out = tmp_path / "again"
    shutil.copytree(port_dir, out)
    load_script("torch_scale_regression").main(
        ["--out", str(out), *ARGS, "--device", "cpu", "--skip-gen"])
    again = report(out)
    assert list(again["phases"]) == list(first["phases"])
    for key in ("kmeans_sample_mse", "encode_db_vecs_per_s", "operating_points"):
        assert again[key] == first[key], key
    skipped = ("train", "encode_trainset", "encode_db")
    assert {k: again["phases"][k] for k in skipped} == {k: first["phases"][k] for k in skipped}


def test_cross_fed_skips_the_shared_phases(cross_dir):
    assert list(report(cross_dir)["phases"]) == [
        "encode_trainset", "encode_db", "build_index", "validations",
        "train_pairwise_decoder", "search_sweep"]


def test_cross_fed_db_codes_agree(jax_dir, cross_dir):
    want = np.load(jax_dir / "codes_db.part_0.npz")["codes"]
    got = np.load(cross_dir / "codes_db.part_0.npz")["codes"]
    assert got.shape == want.shape
    assert (got == want).mean() >= 0.99


def test_cross_fed_hnsw_recall_agrees(jax_dir, cross_dir):
    key = "hnsw_vs_exact_coarse_recall@16"
    want, got = report(jax_dir)[key], report(cross_dir)[key]
    assert set(got) == set(want) == {"16", "64", "256"}
    for ef in want:
        assert abs(got[ef] - want[ef]) <= 0.01, (ef, got, want)


@pytest.mark.parametrize("stat", ["mean", "p99"])
def test_cross_fed_int8_norm_error_agrees(jax_dir, cross_dir, stat):
    want = report(jax_dir)["int8_norm_rel_err"][stat]
    got = report(cross_dir)["int8_norm_rel_err"][stat]
    assert got == pytest.approx(want, rel=INT8_REL[stat])


def test_cross_fed_recalls_agree(jax_dir, cross_dir):
    want = {point_key(p): p for p in report(jax_dir)["operating_points"]}
    got = {point_key(p): p for p in report(cross_dir)["operating_points"]}
    both = set(want) & set(got)
    assert both
    for key in both:
        for r in ("R@1", "R@10", "R@100"):
            assert abs(got[key][r] - want[key][r]) <= 2 / NQ, (key, r, got[key], want[key])


def test_trained_mse_check_on_the_jax_checkpoint(jax_dir):
    res = load_script("torch_trained_mse_check").main(
        ["--dir", str(jax_dir), "--n", str(NQ), "--device", "cpu"])
    hp = json.loads(bytes(np.load(jax_dir / "model.npz")["_meta"]).decode())["parameters"]
    spec = QincoSpec(D=128, K=hp["K"], M=hp["M"], L=hp["L"], de=hp["de"], dh=hp["dh"],
                     A=hp["A"], B=hp["B"], ivf_K=hp["ivf_K"])
    params = jax_load(str(jax_dir / "model.npz"),
                      params_template=init_params(jax.random.PRNGKey(0), spec))["params"]
    x = jnp.asarray(np.load(jax_dir / "queries.npy")[:NQ])
    want = float(jnp.mean(jnp.sum((x - jax_encode(params, spec, x)[1]) ** 2, -1)))
    assert res["exact"] == pytest.approx(want, rel=1e-5)
    assert res["exact_after_perm"] == pytest.approx(res["exact"], rel=1e-5)
    routes = res["routes"]
    for alias, base in (("ktopa_fsel", "ktopa (exact topA)"),
                        ("selected_fsel (ext)", "fast+pallas (extA)"),
                        ("fused+perbin", "fused_substep"), ("perbin_fsel", "fused_substep")):
        assert routes[alias]["mse"] == routes[base]["mse"], alias
        assert routes[alias]["card_route"], alias
    assert all(np.isfinite(r["mse"]) for r in routes.values())
