"""The port's QINCo1-era family against the JAX package, on the same numpy
inputs and weights: packed code files, the vecs writers, OPQ, PQ-QINCo
encode and decode, ``.pqnpz`` files, the two-stage search, and QINCo-LR
in QINCo1 mode.

Bounds: files are equal byte for byte; codes agree on >= 99% of entries
and reconstructions to rtol 1e-5, atol 1e-4 (f32 sums in another order;
the encode tests' bounds); the OPQ rotation under one shared k-means to
1e-4; the two-stage search returns the same ids on >= 99% of entries,
with recalls within 0.01."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from torch_port_helpers import data, make_models, mse, one_torch_thread  # noqa: F401

from qinco_torch import codec as tcodec
from qinco_torch.data import vecs_io as tvecs
from qinco_torch.models import qinco as tq
from qinco_torch.models import pq_qinco as tpq
from qinco_torch.models.params import param_leaves
from qinco_torch.models.spec import QincoSpec as TorchSpec
from qinco_torch.ops import opq as topq
from qinco_torch.search.two_stage import run_search_two_stage
from qinco_torch.tasks import pq_task as tpq_task
from qinco_tpu import codec as jcodec
from qinco_tpu.data import vecs_io as jvecs
from qinco_tpu.models import QincoSpec as JaxSpec
from qinco_tpu.models import pq_qinco as jpq
from qinco_tpu.models import qinco as jq
from qinco_tpu.ops import opq as jopq
from qinco_tpu.ops.aq import compute_fixed_aq_codebooks
from qinco_tpu.search.two_stage import run_search_two_stage as jax_two_stage
from qinco_tpu.tasks import pq_task as jpq_task

CPU = "cpu"


# ---------------------------------------------------------------------------
# Packed code files and vecs files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbits", [1, 4, 6, 8, 10, 12])
def test_packed_codes_are_the_jax_packages_bytes(nbits, tmp_path):
    K = 2**nbits
    codes = np.random.default_rng(nbits).integers(0, K, size=(37, 5)).astype(np.int32)
    packed = tcodec.pack_codes(codes, nbits)
    assert packed.shape == (37, (5 * nbits + 7) // 8)
    np.testing.assert_array_equal(packed, jcodec.pack_codes(codes, nbits))
    np.testing.assert_array_equal(tcodec.unpack_codes(packed, 5, nbits), codes)

    port_file, jax_file = tmp_path / "port.qcod", tmp_path / "jax.qcod"
    tcodec.write_codes_file(port_file, codes.T, K)  # (M, N): the layout encode returns
    jcodec.write_codes_file(jax_file, codes.T, K)
    assert port_file.read_bytes() == jax_file.read_bytes()
    for reader, path in ((tcodec.read_codes_file, jax_file), (jcodec.read_codes_file, port_file)):
        got, got_K = reader(path)
        assert got_K == K
        np.testing.assert_array_equal(got, codes)


@pytest.mark.parametrize("kind, dtype", [("fvecs", np.float32), ("ivecs", np.int32),
                                         ("bvecs", np.uint8)])
def test_vecs_writers_are_the_jax_packages_bytes(kind, dtype, tmp_path):
    x = (np.random.default_rng(0).random((9, 7)) * 200).astype(dtype)
    port_file, jax_file = tmp_path / f"port.{kind}", tmp_path / f"jax.{kind}"
    getattr(tvecs, f"{kind}_write")(port_file, x)
    getattr(jvecs, f"{kind}_write")(jax_file, x)
    assert port_file.read_bytes() == jax_file.read_bytes()
    for read in (getattr(tvecs, f"{kind}_mmap"), getattr(jvecs, f"{kind}_mmap")):
        np.testing.assert_array_equal(read(port_file), x)


# ---------------------------------------------------------------------------
# OPQ
# ---------------------------------------------------------------------------


def _anisotropic(n=3000, D=8, seed=0):
    rng = np.random.default_rng(seed)
    mix = rng.normal(size=(D, D)).astype(np.float32)
    return (rng.normal(size=(n, D)) @ mix).astype(np.float32)


def _numpy_kmeans(x, K, *, iters=10, seed=0, **_):
    """A seeded Lloyd k-means in numpy, the one k-means both packages get
    in the cross-package OPQ test."""
    x = np.asarray(x, np.float32)
    cent = x[np.random.default_rng(seed).choice(len(x), K, replace=False)].copy()
    for _ in range(iters):
        a = ((x[:, None, :] - cent[None]) ** 2).sum(-1).argmin(1)
        for k in range(K):
            if (a == k).any():
                cent[k] = x[a == k].mean(0)
    return cent


def _pq_error(x, n_parts, K):
    d = x.shape[1] // n_parts
    err = 0.0
    for p in range(n_parts):
        xs = x[:, p * d:(p + 1) * d]
        cent = _numpy_kmeans(xs, K, seed=p)
        err += ((xs[:, None, :] - cent[None]) ** 2).sum(-1).min(1).mean()
    return err


def test_opq_is_orthogonal_and_lowers_the_pq_error():
    x = _anisotropic()
    R = topq.train_opq(x, n_parts=2, K=16, iters=4, kmeans_iters=4, device=CPU)
    assert R.dtype == np.float32 and R.shape == (8, 8)
    np.testing.assert_allclose(R @ R.T, np.eye(8), atol=1e-4)
    assert _pq_error(x @ R.T, 2, 16) < _pq_error(x, 2, 16)


def _product_clustered(n=3000, seed=0):
    """16 x 16 product clusters (std 0.1 around centres of std 3 in each
    4-dim half), turned by a small random rotation."""
    rng = np.random.default_rng(seed)
    books = 3 * rng.normal(size=(2, 16, 4))
    c = rng.integers(0, 16, size=(n, 2))
    x = np.concatenate([books[0][c[:, 0]], books[1][c[:, 1]]], 1) + 0.1 * rng.normal(size=(n, 8))
    skew = rng.normal(size=(8, 8))
    return (x @ scipy.linalg.expm(0.2 * (skew - skew.T))).astype(np.float32)


def test_opq_matches_jax_under_one_kmeans(monkeypatch):
    """Both packages' OPQ with one numpy k-means.  The data are clustered:
    the two packages' f32 assignment products sum in other orders, and on
    continuous data with points near a Voronoi boundary (``_anisotropic``)
    a single flipped assignment moves R by ~5e-4."""
    monkeypatch.setattr(jopq, "kmeans", _numpy_kmeans)
    monkeypatch.setattr(topq, "kmeans", _numpy_kmeans)
    x = _product_clustered(seed=1)
    R_t = topq.train_opq(x, n_parts=2, K=16, iters=3, kmeans_iters=4, seed=3, device=CPU)
    R_j = jopq.train_opq(x, n_parts=2, K=16, iters=3, kmeans_iters=4, seed=3)
    np.testing.assert_allclose(R_t @ R_t.T, np.eye(8), atol=1e-4)
    np.testing.assert_allclose(R_t, R_j, atol=1e-4)
    assert _pq_error(x @ R_t.T, 2, 16) < _pq_error(x, 2, 16)


# ---------------------------------------------------------------------------
# PQ-QINCo
# ---------------------------------------------------------------------------

PQ_SPEC = dict(D=8, K=16, M=3, L=1, de=6, dh=12, A=4, B=2)


def _pq_models(opq: bool, seed=0):
    """Both packages' PQ parameters for the same stacked weights: JAX's
    init with the zero-initialized leaves filled with N(0, 0.05²) noise,
    part scales 0.7 and 1.3, and a random rotation with ``opq``."""
    js, ts = JaxSpec(**PQ_SPEC), TorchSpec(**PQ_SPEC)
    rng = np.random.default_rng(seed)
    R = np.linalg.qr(rng.normal(size=(16, 16)))[0].astype(np.float32) if opq else None
    jp = jpq.init_pq_params(jax.random.PRNGKey(seed), js, 2, opq=R)
    flat, tdef = jax.tree_util.tree_flatten(jp.parts)
    leaves = [np.array(a, np.float32) for a in flat]
    leaves = [(0.05 * rng.standard_normal(a.shape)).astype(np.float32)
              if a.ndim and not a.any() else a for a in leaves]
    scales = np.array([0.7, 1.3], np.float32)
    jp = jpq.PQQincoParams(jax.tree_util.tree_unflatten(tdef, [jnp.asarray(a) for a in leaves]),
                           None if R is None else jnp.asarray(R), jnp.asarray(scales))
    tp = tpq.pq_params_from_numpy(ts, leaves, opq=R, part_scales=scales, device=CPU)
    return js, ts, jp, tp


@pytest.mark.parametrize("opq", [False, True], ids=["plain", "opq"])
def test_pq_encode_and_decode_match_jax(opq):
    js, ts, jp, tp = _pq_models(opq)
    x = data(64, 16, seed=7, scale=2.0)
    cj, xj = jpq.pq_encode(jp, js, 2, jnp.asarray(x))
    ct, xt = tpq.pq_encode(tp, ts, 2, torch.from_numpy(x))
    cj, xj = np.asarray(cj), np.asarray(xj)
    assert ct.shape == cj.shape == (2, js.M_ivf, 64) and ct.dtype == torch.int32
    assert (ct.numpy() == cj).mean() >= 0.99
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-5, atol=1e-4)
    # decode of the JAX codes; the encode's xhat is the decode of its codes
    dj = np.asarray(jpq.pq_decode(jp, js, 2, jnp.asarray(cj)))
    np.testing.assert_allclose(tpq.pq_decode(tp, ts, 2, torch.tensor(cj)).numpy(), dj,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tpq.pq_decode(tp, ts, 2, ct).numpy(), xt.numpy(),
                               rtol=1e-5, atol=1e-4)


def test_pq_parts_equal_independent_models():
    """Each part of the PQ encode equals encoding its slice alone with that
    part's parameters."""
    _, ts, _, tp = _pq_models(opq=False, seed=1)
    x = torch.from_numpy(data(16, 16, seed=2))
    codes, _ = tpq.pq_encode(tp, ts, 2, x)
    for p in range(2):
        pp = tpq.part_params(tp.parts, p)
        want = tq.encode_raw(pp, ts, x[:, 8 * p:8 * (p + 1)] / tp.part_scales[p])
        assert torch.equal(codes[p], want)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_pqnpz_files_cross_the_packages(direction, tmp_path):
    js, ts, jp, tp = _pq_models(opq=True, seed=2)
    path = tmp_path / "m.pqnpz"
    if direction == "port_to_jax":
        tpq_task.save_pq_checkpoint(path, tp, ts, 2)
        got, spec, n = jpq_task.load_pq_checkpoint(path)
        leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(got.parts)]
    else:
        jpq_task.save_pq_checkpoint(path, jp, js, 2)
        got, spec, n = tpq_task.load_pq_checkpoint(path, device=CPU)
        leaves = [a.numpy() for a in param_leaves(got.parts)]
    assert n == 2 and spec.D == 8 and (spec.K, spec.M, spec.A, spec.B) == (16, 3, 4, 2)
    want_leaves = jax.tree_util.tree_leaves(jp.parts)
    assert len(leaves) == len(want_leaves)
    for a, b in zip(leaves, want_leaves):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(np.asarray(got.opq), np.asarray(jp.opq))
    np.testing.assert_array_equal(np.asarray(got.part_scales), np.asarray(jp.part_scales))


# ---------------------------------------------------------------------------
# Two-stage search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nshort", [50, 150])
def test_two_stage_search_matches_jax(nshort):
    """The same codes and AQ books through both packages' two-stage search.
    DB rows that share a code decode to the same vector, a tie that JAX's
    ``np.argsort`` (not stable) and the port's stable sort order
    differently; so the DB is decodes of random codes plus noise, and each
    row gets a code of its own."""
    js, ts, jp, tp, _ = make_models(seed=5, D=16, K=64, M=4, L=1, de=16, dh=32, A=8, B=4)
    rng = np.random.default_rng(5)
    src = rng.integers(0, js.K, size=(js.M, 500)).astype(np.int32)
    db = (np.asarray(jq.decode_raw(jp, js, jnp.asarray(src)))
          + 0.01 * rng.normal(size=(500, js.D))).astype(np.float32)
    codes = np.asarray(jq.encode_raw(jp, js, jnp.asarray(db)))  # (M, N)
    assert len({tuple(c) for c in codes.T}) == 500
    books = compute_fixed_aq_codebooks(db, codes.T, k=js.K)
    queries = db[:40] + 0.01 * rng.normal(size=(40, js.D)).astype(np.float32)
    gt = np.argsort(((queries[:, None, :] - db[None]) ** 2).sum(-1), axis=1)[:, :1]
    quiet = lambda *a: None
    I_j, r_j = jax_two_stage(jp, js, codes, books, queries, gt, nshort=nshort,
                             decode_batch=256, log=quiet)
    I_t, r_t = run_search_two_stage(tp, ts, codes, books, queries, gt, nshort=nshort,
                                    decode_batch=256, batch_queries=16, log=quiet)
    assert I_t.shape == I_j.shape == (40, min(100, nshort))
    assert (I_t == np.asarray(I_j)).mean() >= 0.99
    for k in (1, 10, 100):
        assert abs(r_t[k] - r_j[k]) <= 0.01, (k, r_t, r_j)
    assert r_t[100] > 0.9


# ---------------------------------------------------------------------------
# QINCo-LR in QINCo1 mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["exact", "pallas"])
def test_qinco1_low_rank_matches_jax(route):
    """QINCo1 mode with a low-rank concat (``concat_rank=6``): under the
    exact profile, and under ``pallas=true``, where it takes the candidate
    route (B5's plain version on the CPU)."""
    js, ts, jp, tp, _ = make_models(seed=4, D=16, K=16, M=3, L=1, de=16, dh=12, A=4, B=2,
                                    qinco1_mode=True, concat_rank=6,
                                    pallas=route == "pallas")
    assert tp.steps.concat_w.shape == (2, 32, 6) and tp.steps.concat_w2.shape == (2, 6, 16)
    x = data(48, 16, seed=4)
    cj, xj, _ = jq.encode(jp, js, jnp.asarray(x))
    ct, xt, _ = tq.encode(tp, ts, torch.from_numpy(x))
    cj = np.asarray(cj)
    assert (ct.numpy() == cj).mean() >= 0.99
    mj, mt = mse(x, xj), mse(x, xt.numpy())
    assert abs(mt - mj) <= 1e-4 * mj, (mt, mj)
    np.testing.assert_allclose(tq.decode(tp, ts, torch.tensor(cj)).numpy(),
                               np.asarray(jq.decode(jp, js, jnp.asarray(cj))),
                               rtol=1e-5, atol=1e-4)
