"""The port's search pipeline on the CPU (``qinco_torch.search``,
``qinco_torch.ops.aq``): the cases of ``tests/test_search.py`` one by one
with the port's functions and ``device="cpu"``, then each device
function held against the JAX package's on the same numpy inputs.

Tolerances: f32 results that differ from the JAX package's only in
summation order agree to rtol 1e-5 (atol 1e-5 where values cross zero);
selections (probe lists, greedy pairs, top-k positions) are equal.  The
native library is the port's own build (``build/qinco_torch_native``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import data, make_models, one_torch_thread  # noqa: F401

from qinco_torch.metrics import compute_recalls
from qinco_torch.ops.aq import (
    compute_fixed_aq_codebooks,
    compute_fixed_aq_codebooks_backfit,
    reconstruct_from_codebooks,
)
from qinco_torch.search.index import HnswQuantizer, IvfIndex, build_luts, coarse_probe
from qinco_torch.search.operating_points import OperatingPoints
from qinco_torch.search.optim_order import AdaptiveExplorer, sort_experiments_by_prior
from qinco_torch.search.pairwise_decoder import (
    PairwiseDecoder,
    decompose_ivf_codebook,
    pairwise_decode,
    train_pairwise_decoder,
)

CPU = "cpu"


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# AQ fits (tests/test_search.py)
# ---------------------------------------------------------------------------


def test_aq_fit_recovers_true_codebooks():
    rng = np.random.default_rng(0)
    M, k, D, n = 3, 8, 6, 5000
    true_books = rng.normal(size=(M, k, D)).astype(np.float32)
    codes = rng.integers(0, k, size=(n, M))
    x = reconstruct_from_codebooks(codes, true_books)
    books = compute_fixed_aq_codebooks(x, codes, k, device=CPU)
    err = ((reconstruct_from_codebooks(codes, books) - x) ** 2).mean()
    assert err < 1e-6, err


def test_aq_fit_reduces_error_vs_means():
    rng = np.random.default_rng(1)
    M, k, D, n = 4, 16, 8, 8000
    codes = rng.integers(0, k, size=(n, M))
    x = rng.normal(size=(n, D)).astype(np.float32)
    x += reconstruct_from_codebooks(codes, rng.normal(size=(M, k, D)).astype(np.float32))
    books = compute_fixed_aq_codebooks(x, codes, k, device=CPU)
    base = ((x - x.mean(0)) ** 2).mean()
    assert ((reconstruct_from_codebooks(codes, books) - x) ** 2).mean() < base * 0.6


def test_aq_backfit_matches_normal_equations():
    rng = np.random.default_rng(2)
    M, k, D, n = 3, 16, 8, 6000
    codes = rng.integers(0, k, size=(n, M))
    x = 0.3 * rng.normal(size=(n, D)).astype(np.float32)
    x += reconstruct_from_codebooks(codes, rng.normal(size=(M, k, D)).astype(np.float32))
    exact = compute_fixed_aq_codebooks(x, codes, k, device=CPU)
    err_exact = ((reconstruct_from_codebooks(codes, exact) - x) ** 2).mean()
    bf = compute_fixed_aq_codebooks_backfit(x, codes, k, sweeps=6, shrinkage=1e-6, device=CPU)
    err_bf = ((reconstruct_from_codebooks(codes, bf) - x) ** 2).mean()
    assert err_bf <= err_exact * 1.05, (err_bf, err_exact)


def _paired_problem():
    from qinco_torch.search.index_build import pair_codes_ivf

    rng = np.random.default_rng(7)
    M, K, D = 4, 32, 12
    true_books = rng.normal(size=(M, K, D)).astype(np.float32)
    interact = 0.25 * rng.normal(size=(M // 2, K * K, D)).astype(np.float32)

    def make(n, seed):
        r = np.random.default_rng(seed)
        codes = r.integers(0, K, size=(n, M))
        x = reconstruct_from_codebooks(codes, true_books)
        for m in range(M // 2):
            x += interact[m][codes[:, m] * K + codes[:, m + M // 2]]
        x += 0.1 * r.normal(size=x.shape).astype(np.float32)
        return codes, x

    def paired(codes):
        with_ivf = np.concatenate([np.zeros((len(codes), 1), np.int64), codes], axis=1)
        return pair_codes_ivf(with_ivf, K)[:, 1:]

    return M, K, D, make, paired


def test_aq_backfit_prior_recenters_sparse_bins():
    M, K, D, make, paired = _paired_problem()
    codes_tr, x_tr = make(16384, 1)
    codes_te, x_te = make(4096, 2)
    k2 = K * K
    unp = compute_fixed_aq_codebooks(x_tr, codes_tr, K, device=CPU)
    prior = (unp[: M // 2, :, None, :] + unp[M // 2:, None, :, :]).reshape(M // 2, k2, D)
    plain = compute_fixed_aq_codebooks_backfit(x_tr, paired(codes_tr), k2, shrinkage=8.0,
                                               device=CPU)
    prio = compute_fixed_aq_codebooks_backfit(x_tr, paired(codes_tr), k2, shrinkage=8.0,
                                              prior=prior, device=CPU)
    err_plain = ((reconstruct_from_codebooks(paired(codes_te), plain) - x_te) ** 2).mean()
    err_prior = ((reconstruct_from_codebooks(paired(codes_te), prio) - x_te) ** 2).mean()
    err_unpaired = ((reconstruct_from_codebooks(codes_te, unp) - x_te) ** 2).mean()
    assert err_prior < err_plain * 0.8, (err_prior, err_plain)
    assert err_prior < err_unpaired * 0.95, (err_prior, err_unpaired)


def test_aq_fits_match_jax():
    """Both fits against the JAX package's on the same inputs.  Additive
    books are defined up to a constant moved between books (the ridge
    barely pins it), so the normal-equations fit is compared by its
    reconstructions (atol 1e-4 at values up to about 8); the backfit's
    books themselves agree to rtol 1e-4, atol 1e-4 (f32 sums in another
    order)."""
    from qinco_tpu.ops import aq as jaq

    M, K, D, make, paired = _paired_problem()
    codes, x = make(6000, 3)
    np.testing.assert_allclose(
        reconstruct_from_codebooks(codes, compute_fixed_aq_codebooks(x, codes, K, device=CPU)),
        reconstruct_from_codebooks(codes, jaq.compute_fixed_aq_codebooks(x, codes, K)),
        rtol=1e-5, atol=1e-4)
    pc = paired(codes)
    unp = jaq.compute_fixed_aq_codebooks(x, codes, K)
    prior = (unp[: M // 2, :, None, :] + unp[M // 2:, None, :, :]).reshape(M // 2, K * K, D)
    for kw in (dict(shrinkage=8.0), dict(shrinkage=8.0, prior=prior)):
        np.testing.assert_allclose(
            compute_fixed_aq_codebooks_backfit(x, pc, K * K, device=CPU, **kw),
            jaq.compute_fixed_aq_codebooks_backfit(x, pc, K * K, **kw), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(reconstruct_from_codebooks(codes, unp),
                                  jaq.reconstruct_from_codebooks(codes, unp))


# ---------------------------------------------------------------------------
# The native IVF index with the probe and LUTs on the device
# ---------------------------------------------------------------------------


def test_qlut_scan_2byte_codes_full_norms(tmp_path):
    rng = np.random.default_rng(3)
    nlist, D, M, K = 32, 16, 2, 1024
    centroids = rng.normal(size=(nlist, D)).astype(np.float32) * 4
    books = rng.normal(size=(M, K, D)).astype(np.float32) * 0.5
    n = 4000
    list_nos = rng.integers(0, nlist, size=n)
    codes = rng.integers(0, K, size=(n, M)).astype(np.int64)
    vectors = centroids[list_nos] + books[0][codes[:, 0]] + books[1][codes[:, 1]]

    index = IvfIndex.build(centroids, books, norm_mode="full", device=CPU)
    assert index.code_bytes == 2
    norms = (vectors ** 2).sum(-1)
    index.train_norm(norms, list_nos=list_nos)
    index.add_batch(np.arange(n, dtype=np.int64), list_nos, codes, norms)

    xq = (vectors[:24] + 0.01 * rng.normal(size=(24, D))).astype(np.float32)
    dists, ids, out_codes = index.search_and_return_codes(xq, 8, nprobe=nlist)
    assert (ids[:, 0] == np.arange(24)).mean() > 0.9
    for q in range(24):
        j = ids[q, 0]
        if j < 0:
            continue
        assert out_codes[q, 0, 0] == list_nos[j]
        np.testing.assert_array_equal(out_codes[q, 0, 1:], codes[j])
    true_d = ((xq[0] - vectors[ids[0, :5]]) ** 2).sum(-1)
    np.testing.assert_allclose(dists[0, :5], true_d, rtol=0.1, atol=2.0)

    path = tmp_path / "paired.qivf"
    index.save(path)
    index2 = IvfIndex.load(path, device=CPU)
    assert index2.code_bytes == 2 and index2.norm_mode == "full"
    d2, i2, _ = index2.search_and_return_codes(xq, 8, nprobe=nlist)
    np.testing.assert_array_equal(ids, i2)
    np.testing.assert_allclose(dists, d2, rtol=1e-5)


def test_full_norm_quantizer_relative_precision():
    rng = np.random.default_rng(7)
    nlist, D, M, K = 64, 16, 2, 64
    centroids = rng.normal(size=(nlist, D)).astype(np.float32)
    centroids *= rng.uniform(1.0, 60.0, size=(nlist, 1)).astype(np.float32)
    books = rng.normal(size=(M, K, D)).astype(np.float32) * 0.5
    n = 4000
    list_nos = rng.integers(0, nlist, size=n)
    codes = rng.integers(0, K, size=(n, M)).astype(np.int64)
    vectors = centroids[list_nos] + books[0][codes[:, 0]] + books[1][codes[:, 1]]
    norms = (vectors.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    ids = np.arange(n, dtype=np.int64)
    xq = (vectors[:64] + 0.01 * rng.normal(size=(64, D))).astype(np.float32)

    def max_abs_err(index):
        dists, found, _ = index.search_and_return_codes(xq, 4, nprobe=nlist)
        true = ((xq[:, None, :] - vectors[found]) ** 2).sum(-1)
        return np.abs(dists - true).max()

    idx_rel = IvfIndex.build(centroids, books, norm_mode="full", device=CPU)
    idx_rel.train_norm(norms, list_nos=list_nos)
    idx_rel.add_batch(ids, list_nos, codes, norms)
    idx_abs = IvfIndex.build(centroids, books, norm_mode="full", device=CPU)
    idx_abs._legacy_abs_norms = True
    idx_abs.train_norm(norms)
    idx_abs.add_batch(ids, list_nos, codes, norms)

    err_rel, err_abs = max_abs_err(idx_rel), max_abs_err(idx_abs)
    assert err_rel < err_abs / 10, (err_rel, err_abs)
    rel_range = norms - (centroids[list_nos] ** 2).sum(-1)
    step = (rel_range.max() - rel_range.min()) / 255.0
    assert err_rel < 2.0 * step, (err_rel, step)


def test_build_index_pair_codes_k_gt_16():
    from qinco_torch.config import load_config
    from qinco_torch.search.index_build import build_index_training_phase, pair_codes_ivf

    rng = np.random.default_rng(4)
    nlist, D, M, K, n = 16, 8, 4, 32, 20000
    cfg = load_config(["K=32", "M=4", "search.pair_codes=true",
                       "search.aq_training_samples=20000"])
    centroids = rng.normal(size=(nlist, D)).astype(np.float32) * 4
    encoded = np.concatenate([rng.integers(0, nlist, size=(n, 1)),
                              rng.integers(0, K, size=(n, M))], axis=1).astype(np.int64)
    true_books = rng.normal(size=(M, K, D)).astype(np.float32)
    resid = np.zeros((n, D), np.float32)
    for m in range(M):
        resid += true_books[m][encoded[:, m + 1]]
    vecs = centroids[encoded[:, 0]] + resid

    log_lines = []
    index = build_index_training_phase(
        cfg, centroids, vecs, encoded, log=lambda *a: log_lines.append(" ".join(map(str, a))),
        aq_dense_fit_max=1024, device=CPU)
    assert index.norm_mode == "full" and index.code_bytes == 2
    assert index.K == K * K and index.M == M // 2
    assert any("backfit" in line for line in log_lines), log_lines

    paired = pair_codes_ivf(encoded, K)
    full = reconstruct_from_codebooks(paired[:, 1:], index.codebooks) + centroids[encoded[:, 0]]
    index.add_batch(np.arange(n, dtype=np.int64), encoded[:, 0], paired[:, 1:],
                    (full ** 2).sum(-1))
    _, ids, _ = index.search_and_return_codes(vecs[:32], 4, nprobe=nlist)
    assert (ids[:, 0] == np.arange(32)).mean() > 0.8, ids[:, 0]


@pytest.fixture(scope="module")
def ivf_setup():
    rng = np.random.default_rng(0)
    nlist, D, M, K = 64, 16, 4, 256
    centroids = rng.normal(size=(nlist, D)).astype(np.float32) * 4
    books = rng.normal(size=(M, K, D)).astype(np.float32) * 0.5
    n = 5000
    list_nos = rng.integers(0, nlist, size=n)
    codes = rng.integers(0, K, size=(n, M)).astype(np.uint8)
    recons = np.zeros((n, D), np.float32)
    for m in range(M):
        recons += books[m][codes[:, m]]
    return dict(centroids=centroids, books=books, list_nos=list_nos, codes=codes,
                vectors=centroids[list_nos] + recons, recons=recons, nlist=nlist, D=D, M=M)


def _build_index(s, cls=IvfIndex, **kw):
    index = cls.build(s["centroids"], s["books"], **kw)
    norms = (s["recons"] ** 2).sum(-1)
    index.train_norm(norms)
    index.add_batch(np.arange(len(s["vectors"]), dtype=np.int64), s["list_nos"], s["codes"],
                    norms)
    return index


def test_ivf_index_add_and_scan_exact_distance(ivf_setup):
    s = ivf_setup
    index = _build_index(s, device=CPU)
    assert index.ntotal == len(s["vectors"])
    rng = np.random.default_rng(1)
    xq = (s["vectors"][:32] + 0.01 * rng.normal(size=(32, s["D"]))).astype(np.float32)
    dists, ids, codes = index.search_and_return_codes(xq, 10, nprobe=s["nlist"])
    assert (ids[:, 0] == np.arange(32)).mean() > 0.9
    for q in range(32):
        j = ids[q, 0]
        if j < 0:
            continue
        assert codes[q, 0, 0] == s["list_nos"][j]
        np.testing.assert_array_equal(codes[q, 0, 1:], s["codes"][j])
    true_d = ((xq[0] - s["vectors"][ids[0, :5]]) ** 2).sum(-1)
    np.testing.assert_allclose(dists[0, :5], true_d, rtol=0.1, atol=2.0)


def test_ivf_index_save_load_roundtrip(ivf_setup, tmp_path):
    s = ivf_setup
    index = _build_index(s, device=CPU)
    path = tmp_path / "test.qivf"
    index.save(path)
    index2 = IvfIndex.load(path, device=CPU)
    assert index2.ntotal == index.ntotal and index2.nlist == index.nlist
    xq = s["vectors"][100:110]
    d1, i1, c1 = index.search_and_return_codes(xq, 5, nprobe=8)
    d2, i2, c2 = index2.search_and_return_codes(xq, 5, nprobe=8)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5)


def test_ivf_recall_improves_with_nprobe(ivf_setup):
    s = ivf_setup
    index = _build_index(s, device=CPU)
    rng = np.random.default_rng(3)
    xq = (s["vectors"][:200] + 0.05 * rng.normal(size=(200, s["D"]))).astype(np.float32)
    gt = np.arange(200)[:, None]
    recs = [compute_recalls(index.search_and_return_codes(xq, 10, nprobe=p)[1], gt)[10]
            for p in (1, 4, 16)]
    assert recs[0] <= recs[1] <= recs[2]
    assert recs[2] > 0.9


@pytest.mark.parametrize("split", [False, True])
def test_index_search_equals_the_jax_index(ivf_setup, split):
    """The same index built by both packages (the classic and the split
    LUTs) returns the same ids and codes, distances within rtol 1e-5."""
    from qinco_tpu.search.index import IvfIndex as JaxIvfIndex

    s = ivf_setup
    ours, theirs = _build_index(s, device=CPU), _build_index(s, cls=JaxIvfIndex)
    if split:
        assert ours.enable_split_lut() and theirs.enable_split_lut()
        np.testing.assert_allclose(ours._cterm, theirs._cterm, rtol=1e-5, atol=1e-4)
    rng = np.random.default_rng(9)
    xq = (s["vectors"][:64] + 0.05 * rng.normal(size=(64, s["D"]))).astype(np.float32)
    d1, i1, c1 = ours.search_and_return_codes(xq, 10, nprobe=8)
    d2, i2, c2 = theirs.search_and_return_codes(xq, 10, nprobe=8)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-4)


def test_coarse_probe_nlist_not_multiple_of_chunk():
    """The padded columns of the last chunk never win, distances are
    finite, and the lists and biases equal the JAX probe's."""
    from qinco_tpu.search.index import _coarse_probe_jit

    rng = np.random.default_rng(3)
    nlist, D, nq, nprobe = 100, 16, 32, 8
    cent = rng.normal(size=(nlist, D)).astype(np.float32)
    xq = rng.normal(size=(nq, D)).astype(np.float32)
    idx, dists = (t.numpy() for t in coarse_probe(_t(xq), _t(cent), nprobe, chunk=64))
    assert idx.dtype == np.int32 and idx.max() < nlist and idx.min() >= 0
    assert np.isfinite(dists).all()
    ref = ((xq[:, None, :] - cent[None]) ** 2).sum(-1)
    assert sorted(idx[0].tolist()) == sorted(np.argsort(ref, axis=1)[0, :nprobe].tolist())
    np.testing.assert_allclose(np.sort(dists, axis=1), np.sort(ref, axis=1)[:, :nprobe],
                               rtol=1e-4)
    j_idx, j_d = _coarse_probe_jit(jnp.asarray(xq), jnp.asarray(cent), nprobe, chunk=64)
    np.testing.assert_array_equal(idx, np.asarray(j_idx))
    np.testing.assert_allclose(dists, np.asarray(j_d), rtol=1e-5)


def test_coarse_probe_breaks_ties_toward_the_smaller_index():
    """Duplicated centroids give equal distances: the probe lists them in
    index order, as ``lax.top_k`` does, across chunks too."""
    from qinco_tpu.search.index import _coarse_probe_jit

    rng = np.random.default_rng(5)
    base = rng.normal(size=(10, 8)).astype(np.float32)
    cent = np.concatenate([base, base, base])  # 30 rows, each three times
    xq = rng.normal(size=(6, 8)).astype(np.float32)
    idx, _ = coarse_probe(_t(xq), _t(cent), 6, chunk=16)
    j_idx, _ = _coarse_probe_jit(jnp.asarray(xq), jnp.asarray(cent), 6, chunk=16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    first = idx.numpy()[:, 0] % 10
    np.testing.assert_array_equal(idx.numpy()[:, :3], first[:, None] + np.array([0, 10, 20]))


def test_coarse_probe_bias_is_exact():
    rng = np.random.default_rng(4)
    cent = (rng.normal(size=(64, 8)) + 50.0).astype(np.float32)
    xq = (rng.normal(size=(16, 8)) + 50.0).astype(np.float32)
    idx, bias = (t.numpy() for t in coarse_probe(_t(xq), _t(cent), 4))
    ref = ((xq[:, None, :] - cent[idx]) ** 2).sum(-1)
    np.testing.assert_allclose(bias, ref, rtol=1e-5)


def test_build_luts_matches_jax():
    from qinco_tpu.search.index import build_luts as jax_build_luts

    rng = np.random.default_rng(6)
    xq = rng.normal(size=(9, 16)).astype(np.float32)
    cent = rng.normal(size=(20, 16)).astype(np.float32)
    books = rng.normal(size=(3, 32, 16)).astype(np.float32)
    probes = rng.integers(0, 20, size=(9, 4)).astype(np.int32)
    got = build_luts(_t(xq), _t(cent), _t(books), _t(probes)).numpy()
    assert got.shape == (9, 4, 3, 32)
    np.testing.assert_allclose(got, jax_build_luts(xq, cent, books, probes), rtol=1e-5,
                               atol=1e-5)


def test_pair_unpair_codes_roundtrip():
    from qinco_torch.search.index_build import pair_codes_ivf, unpair_codes_ivf
    from qinco_tpu.search.index_build import pair_codes_ivf as jax_pair

    rng = np.random.default_rng(5)
    K, M = 16, 6
    codes = np.concatenate([rng.integers(0, 1000, size=(200, 1)),
                            rng.integers(0, K, size=(200, M))], axis=1).astype(np.int32)
    paired = pair_codes_ivf(codes, K)
    assert paired.shape == (200, M // 2 + 1) and paired[:, 1:].max() < K * K
    np.testing.assert_array_equal(paired, jax_pair(codes, K))
    np.testing.assert_array_equal(unpair_codes_ivf(paired, K), codes)


def test_split_lut_scan_matches_classic(ivf_setup):
    s = ivf_setup
    index = _build_index(s, device=CPU)
    rng = np.random.default_rng(2)
    xq = (s["vectors"][:48] + 0.01 * rng.normal(size=(48, s["D"]))).astype(np.float32)
    d0, i0, c0 = index.search_and_return_codes(xq, 10, nprobe=8)
    assert index.enable_split_lut()
    d1, i1, c1 = index.search_and_return_codes(xq, 10, nprobe=8)
    np.testing.assert_allclose(d0, d1, rtol=1e-5, atol=1e-3)
    assert (i0 == i1).mean() > 0.99
    np.testing.assert_array_equal(c0[i0 == i1], c1[i0 == i1])


def test_split_lut_scan_long_list_branch():
    rng = np.random.default_rng(3)
    nlist, D, M, K = 4, 8, 2, 16
    centroids = rng.normal(size=(nlist, D)).astype(np.float32) * 4
    books = rng.normal(size=(M, K, D)).astype(np.float32) * 0.5
    n = 600
    list_nos = rng.integers(0, nlist, size=n)
    codes = rng.integers(0, K, size=(n, M)).astype(np.uint8)
    recons = books[0][codes[:, 0]] + books[1][codes[:, 1]]
    vectors = centroids[list_nos] + recons
    index = IvfIndex.build(centroids, books, device=CPU)
    norms = (recons ** 2).sum(-1)
    index.train_norm(norms)
    index.add_batch(np.arange(n, dtype=np.int64), list_nos, codes, norms)
    xq = (vectors[:16] + 0.01 * rng.normal(size=(16, D))).astype(np.float32)
    d0, i0, _ = index.search_and_return_codes(xq, 5, nprobe=nlist)
    assert index.enable_split_lut()
    d1, i1, _ = index.search_and_return_codes(xq, 5, nprobe=nlist)
    np.testing.assert_allclose(d0, d1, rtol=1e-5, atol=1e-3)
    assert (i0 == i1).mean() > 0.99


def test_split_lut_budget_gate():
    rng = np.random.default_rng(4)
    index = IvfIndex.build(rng.normal(size=(32, 8)).astype(np.float32),
                           rng.normal(size=(2, 16, 8)).astype(np.float32), device=CPU)
    assert not index.enable_split_lut(max_bytes=100)
    assert index._cterm is None


def test_index_refuses_the_missing_card(monkeypatch):
    """Without a card and without device='cpu' the index raises instead of
    running its probe on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IvfIndex.build(rng.normal(size=(8, 4)).astype(np.float32),
                       rng.normal(size=(1, 4, 4)).astype(np.float32))


# ---------------------------------------------------------------------------
# Native HNSW coarse quantizer
# ---------------------------------------------------------------------------


def test_hnsw_recall_vs_exact():
    rng = np.random.default_rng(0)
    n, D = 2000, 16
    cent = rng.normal(size=(n, D)).astype(np.float32)
    q = rng.normal(size=(100, D)).astype(np.float32)
    hnsw = HnswQuantizer.build(cent, M=16, ef_construction=40)
    idx, dists = hnsw.search(q, 10, ef=64)
    true = np.argsort(((q[:, None] - cent[None]) ** 2).sum(-1), axis=1)[:, :10]
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(idx, true)])
    assert recall > 0.8, recall
    np.testing.assert_allclose(dists[0, 0], ((q[0] - cent[idx[0, 0]]) ** 2).sum(), rtol=1e-4)
    idx_lo, _ = hnsw.search(q, 10, ef=10)
    recall_lo = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(idx_lo, true)])
    assert recall >= recall_lo - 0.05


def test_hnsw_efconstruction_monotone():
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(64, 24)).astype(np.float32) * 4
    cent = centers[rng.integers(0, 64, size=6000)] + rng.normal(size=(6000, 24)).astype(
        np.float32)
    q = centers[rng.integers(0, 64, size=200)] + rng.normal(size=(200, 24)).astype(np.float32)
    true = np.argsort(((q[:, None] - cent[None]) ** 2).sum(-1), axis=1)[:, :10]

    def recall(efc):
        idx, _ = HnswQuantizer.build(cent, M=8, ef_construction=efc).search(q, 10, ef=48)
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(idx, true)])

    r_lo, r_hi = recall(10), recall(80)
    assert r_hi >= r_lo - 0.03, (r_lo, r_hi)
    assert r_hi > 0.75, r_hi


def test_hnsw_save_load(tmp_path):
    rng = np.random.default_rng(1)
    cent = rng.normal(size=(500, 8)).astype(np.float32)
    h1 = HnswQuantizer.build(cent, M=8, ef_construction=20)
    path = tmp_path / "g.qhnsw"
    h1.save(path)
    h2 = HnswQuantizer.load(path)
    q = rng.normal(size=(20, 8)).astype(np.float32)
    np.testing.assert_array_equal(h1.search(q, 5, ef=32)[0], h2.search(q, 5, ef=32)[0])


def test_ivf_index_with_hnsw_coarse(ivf_setup):
    s = ivf_setup
    index = _build_index(s, device=CPU)
    index.use_hnsw(M=16, ef_construction=40, ef_search=64)
    rng = np.random.default_rng(7)
    xq = (s["vectors"][:100] + 0.01 * rng.normal(size=(100, s["D"]))).astype(np.float32)
    _, ids, _ = index.search_and_return_codes(xq, 10, nprobe=8)
    assert compute_recalls(ids, np.arange(100)[:, None])[10] > 0.8


# ---------------------------------------------------------------------------
# Pairwise decoder
# ---------------------------------------------------------------------------


def _pairwise_problem():
    rng = np.random.default_rng(0)
    IVF_K, K_base, M_base, D, B = 128, 8, 3, 10, 4000
    ivf_centroids = rng.normal(size=(IVF_K, D)).astype(np.float32) * 2
    ivf_codes = rng.integers(0, IVF_K, size=B)
    codes = rng.integers(0, K_base, size=(M_base, B))
    step_books = rng.normal(size=(M_base, K_base, D)).astype(np.float32)
    resid = sum(step_books[m][codes[m]] for m in range(M_base))
    resid = (resid + 0.05 * rng.normal(size=(B, D))).astype(np.float32)
    return codes, ivf_codes, resid, ivf_centroids, K_base


def test_pairwise_decoder_trains_and_roundtrips(tmp_path):
    codes, ivf_codes, resid, ivf_centroids, K_base = _pairwise_problem()
    dec = train_pairwise_decoder(codes, ivf_codes, resid, ivf_centroids, K_base=K_base,
                                 M_target=4, verbose=False, device=CPU)
    rec = dec.decode(codes, ivf_codes)
    mse = ((rec - resid) ** 2).sum(-1).mean()
    assert mse < (resid ** 2).sum(-1).mean() * 0.3
    path = tmp_path / "pd.npz"
    dec.save(path)
    rec2 = PairwiseDecoder.load(path, device=CPU).decode(codes, ivf_codes)
    np.testing.assert_allclose(rec, rec2, rtol=1e-5, atol=1e-5)


def test_train_pairwise_decoder_matches_jax():
    """The same decomposition, the same greedy pairs, books within rtol
    1e-5 of the JAX package's."""
    from qinco_tpu.search.pairwise_decoder import train_pairwise_decoder as jax_train

    codes, ivf_codes, resid, ivf_centroids, K_base = _pairwise_problem()
    kw = dict(K_base=K_base, M_target=4, shrinkage=8.0, verbose=False)
    ours = train_pairwise_decoder(codes, ivf_codes, resid, ivf_centroids, device=CPU, **kw)
    theirs = jax_train(codes, ivf_codes, resid, ivf_centroids, **kw)
    np.testing.assert_array_equal(ours.ivf_code_map, theirs.ivf_code_map)
    np.testing.assert_allclose(ours.ivf_small_books, theirs.ivf_small_books, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ours.pairs, theirs.pairs)
    np.testing.assert_allclose(ours.books, theirs.books, rtol=1e-5, atol=1e-5)


def test_decompose_ivf_codebook_matches_jax():
    from qinco_tpu.search.pairwise_decoder import decompose_ivf_codebook as jax_decompose

    rng = np.random.default_rng(8)
    cent = rng.normal(size=(300, 6)).astype(np.float32)
    usage = rng.integers(0, 20, size=300)
    books, code_map = decompose_ivf_codebook(cent, usage, 8, seed=3, device=CPU)
    j_books, j_map = jax_decompose(cent, usage, 8, seed=3)
    assert books.shape == (5, 8, 6) and code_map.shape == (300, 5)
    np.testing.assert_array_equal(code_map, j_map)
    np.testing.assert_allclose(books, j_books, rtol=1e-5, atol=1e-5)


def test_pairwise_decoder_shrinkage_helps_sparse_bins():
    rng = np.random.default_rng(1)
    IVF_K, K_base, M_base, D = 64, 16, 3, 8
    step_books = rng.normal(size=(M_base, K_base, D)).astype(np.float32)
    ivf_centroids = rng.normal(size=(IVF_K, D)).astype(np.float32)

    def make(B):
        codes = rng.integers(0, K_base, size=(M_base, B))
        ivf = rng.integers(0, IVF_K, size=B)
        resid = sum(step_books[m][codes[m]] for m in range(M_base))
        return codes, ivf, (resid + 2.0 * rng.normal(size=(B, D))).astype(np.float32)

    tr, va = make(3000), make(3000)

    def val_mse(shrink):
        dec = train_pairwise_decoder(*tr, ivf_centroids, K_base=K_base, M_target=3,
                                     shrinkage=shrink, verbose=False, device=CPU)
        return ((dec.decode(va[0], va[1]) - va[2]) ** 2).sum(-1).mean()

    assert val_mse(8.0) < val_mse(0.0)


def _random_decoder(rng, K_base, M_base, ivf_m, n_pair, D, nlist):
    books = rng.normal(size=(n_pair, K_base ** 2, D)).astype(np.float32)
    pairs = np.stack([rng.integers(0, M_base + ivf_m, size=n_pair),
                      rng.integers(0, M_base + ivf_m, size=n_pair)]).astype(np.int64)
    code_map = rng.integers(0, K_base, size=(nlist, ivf_m)).astype(np.int64)
    return dict(books=books, pairs=pairs, ivf_small_books=np.zeros((ivf_m, K_base, D),
                                                                   np.float32),
                ivf_code_map=code_map, K_base=K_base, M_base=M_base)


def test_pairwise_native_decode_matches_torch_and_jax():
    """The native qpw_decode, the torch decode and the JAX package's
    decode sum the same tables in the same order."""
    from qinco_tpu.search.pairwise_decoder import pairwise_decode as jax_decode

    rng = np.random.default_rng(5)
    kw = _random_decoder(rng, 8, 4, 2, 3, 16, 32)
    dec = PairwiseDecoder(**kw, device=CPU)
    B = 257
    codes = rng.integers(0, 8, size=(4, B))
    ivf_codes = rng.integers(0, 32, size=B)
    ref = np.asarray(jax_decode(jnp.asarray(kw["books"]), jnp.asarray(kw["pairs"]),
                                jnp.asarray(kw["ivf_code_map"]), jnp.asarray(codes, jnp.int32),
                                jnp.asarray(ivf_codes, jnp.int32), 8))
    native = dec.decode_native(codes, ivf_codes)
    torch_dec = pairwise_decode(_t(kw["books"]), _t(kw["pairs"]), _t(kw["ivf_code_map"]),
                                _t(codes), _t(ivf_codes), 8).numpy()
    np.testing.assert_allclose(native, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(native, torch_dec)


def test_pairwise_scores_matches_decode_path_and_jax():
    """Mid-rerank scores: native (the CPU decoder) and torch (the decoder's
    device path) against decode + centroid + distance and the JAX
    package's ``pairwise_scores`` (rtol 1e-4, atol 1e-4)."""
    from qinco_tpu.search.pairwise_decoder import pairwise_scores as jax_scores

    from qinco_torch.search.pairwise_decoder import pairwise_scores

    rng = np.random.default_rng(6)
    nlist = 32
    kw = _random_decoder(rng, 8, 4, 2, 5, 16, nlist)
    cents = rng.normal(size=(nlist, 16)).astype(np.float32)
    dec = PairwiseDecoder(**kw, device=CPU)
    nq, nmid = 7, 33
    codes = np.concatenate([rng.integers(0, nlist, size=(nq * nmid, 1)),
                            rng.integers(0, 8, size=(nq * nmid, 4))], axis=1).astype(np.int32)
    xq = rng.normal(size=(nq, 16)).astype(np.float32)
    got = dec.scores(xq, codes, cents, nmid)
    recon = dec.decode_native(codes[:, 1:].T, codes[:, 0]) + cents[codes[:, 0]]
    want = ((np.repeat(xq, nmid, axis=0) - recon) ** 2).sum(-1).reshape(nq, nmid)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    dev = pairwise_scores(_t(kw["books"]), _t(kw["pairs"]), _t(kw["ivf_code_map"]),
                          _t(codes[:, 1:].T).long(), _t(codes[:, 0]).long(), _t(cents), _t(xq),
                          8, nmid).numpy()
    ref = np.asarray(jax_scores(jnp.asarray(kw["books"]), jnp.asarray(kw["pairs"]),
                                jnp.asarray(kw["ivf_code_map"]), jnp.asarray(codes[:, 1:].T),
                                jnp.asarray(codes[:, 0]), jnp.asarray(cents), jnp.asarray(xq),
                                8, nmid))
    np.testing.assert_allclose(dev, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The shortlist rerank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_block", [5, 64])
def test_fused_shortlist_topk_matches_jax(q_block):
    """Decode, score and top-k of each query's shortlist: the same
    positions as the JAX package's, in every block size."""
    from qinco_tpu.search.search import _fused_shortlist_topk as jax_topk

    from qinco_torch.search.search import _fused_shortlist_topk

    js, ts, jp, tp, _ = make_models(seed=2, ivf_K=16, D=16, K=16, M=2, L=1, de=16, dh=16,
                                    A=4, B=4)
    rng = np.random.default_rng(3)
    nq, ns = 12, 20
    codes = np.concatenate([rng.integers(0, 16, size=(nq * ns, 1)),
                            rng.integers(0, 16, size=(nq * ns, 2))], axis=1).astype(np.int32)
    xq = data(nq, 16, seed=4)
    got = _fused_shortlist_topk(tp, ts, codes, xq, 7, q_block=q_block)
    want = jax_topk(jp, js, codes, xq, 7, q_block=q_block)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Operating points and exploration order (copies of the JAX package's)
# ---------------------------------------------------------------------------


def test_operating_points_grid_and_pareto():
    op = OperatingPoints()
    op.add_range("nprobe", [1, 4, 16])
    op.add_range("nshort", [10, 100])
    assert op.num_experiments() == 6 and len(op.all_keys()) == 6
    assert op.get_parameters((2, 1)) == {"nprobe": 16, "nshort": 100}
    op.add_operating_point((0, 0), 0.5, 1.0)
    op.add_operating_point((2, 1), 0.9, 10.0)
    assert not op.is_pareto_optimal(0.4, 2.0)
    assert op.is_pareto_optimal(0.7, 2.0)
    max_perf, min_time = op.predict_bounds((1, 0))
    assert max_perf <= 0.9 and min_time >= 1.0


def test_experiment_ordering_prefers_balanced_settings():
    op = OperatingPoints()
    op.add_range("nprobe", [1, 1024])
    op.add_range("quantizer_efSearch", [4, 2048])
    op.add_range("nshort", [1, 64])
    op.add_range("nmid_short", [1, 64])
    keys = sort_experiments_by_prior(op, op.all_keys())
    assert op.get_parameters(keys[0])["nmid_short"] <= 8
    last = op.get_parameters(keys[-1])
    assert (last["nprobe"], last["nshort"]) in [(1024, 1), (1, 64), (1024, 64), (1, 1)]


def test_adaptive_explorer_seed_order_and_active_features():
    op = OperatingPoints()
    op.add_range("nprobe", [2, 8, 32])
    op.add_range("nshort", [4, 16, 64])
    op.add_range("nmid_short", [1])
    ex = AdaptiveExplorer(op, op.all_keys())
    ns_order = [op.get_parameters(k)["nshort"] for k in ex.remaining[: ex.seed_n]]
    assert ns_order == sorted(ns_order) and ns_order[0] == 4, ns_order
    assert len(ex._feat({})) == 5, ex._feat({})


def _explore(explorer_cls, op_cls):
    op = op_cls()
    op.add_range("nprobe", [2, 4, 8, 16, 32, 64])
    op.add_range("nshort", [10, 30, 100])
    op.add_range("nmid_short", [1, 2, 3])
    ex = explorer_cls(op, op.all_keys())
    explored = []
    while (k := ex.next()) is not None:
        p = op.get_parameters(k)
        r, t = 1.0 - 0.5 / p["nprobe"], 0.2 * p["nprobe"] + 0.05 * p["nshort"] + 0.01 * p[
            "nmid_short"]
        ex.update(p, r, t)
        explored.append((p, r, t))
    return ex, explored


def test_adaptive_explorer_finds_frontier_early():
    ex, explored = _explore(AdaptiveExplorer, OperatingPoints)
    assert len(explored) == 54
    frontier = {(np_, 10, 1) for np_ in (2, 4, 8, 16, 32, 64)}
    early = {(p["nprobe"], p["nshort"], p["nmid_short"])
             for p, _, _ in explored[: ex.seed_n + 2 * len(frontier)]}
    assert len(frontier & early) / len(frontier) >= 0.8


def test_exploration_order_equals_the_jax_package():
    from qinco_tpu.search.operating_points import OperatingPoints as JaxOP
    from qinco_tpu.search.optim_order import AdaptiveExplorer as JaxExplorer

    _, ours = _explore(AdaptiveExplorer, OperatingPoints)
    _, theirs = _explore(JaxExplorer, JaxOP)
    assert ours == theirs


def test_compute_recalls_matches_jax():
    from qinco_tpu.metrics import compute_recalls as jax_recalls

    rng = np.random.default_rng(0)
    I = rng.integers(0, 50, size=(40, 100))
    gt = rng.integers(0, 50, size=(40, 3))
    assert compute_recalls(I, gt) == jax_recalls(I, gt)
