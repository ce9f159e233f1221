"""The search pipeline through the port's command line, on the CPU:
``python -m qinco_torch task=ivf_centroids|train|encode|build_index|
train_pairwise_decoder|search ... cpu=true`` at the sizes and with the
recall thresholds of ``tests/test_search_e2e.py`` (D=12, ivf_K=32, M=2,
K=16), and the files it writes read by the JAX package — and the JAX
package's files read by the port: part files, ``.qivf`` indexes and
pairwise-decoder npz.

Bounds: codes of the encode task agree with the JAX task's on >= 99% of
entries (the encode tests' bound, ``tests/test_torch_encode_exact.py``);
files read across packages give equal arrays; one index searched by
both packages gives equal ids and codes, distances within rtol 1e-5,
atol 1e-4."""

import json

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

import run_qinco
from qinco_torch.__main__ import main
from qinco_torch.config import load_config
from qinco_torch.search.index import IvfIndex
from qinco_torch.search.pairwise_decoder import PairwiseDecoder
from qinco_torch.tasks import get_task
from qinco_torch.tasks.search_tasks import EncodedDBIterator

D, IVF_K = 12, 32
MODEL = ["M=2", "K=16", "L=1", "de=8", "dh=12", "A=4", "B=2"]
GRID = ["search.nprobe=[4,32]", "search.nshort=[10,100]", "search.nmid_short=[1,2]",
        "search.quantizer_efSearch=[]", "batch=512", "search.batch_size=512"]


def port(args):
    assert main([*args, "cpu=true", "verbose=false"]) == 0


def jax_run(args):
    assert run_qinco.main([*args, "verbose=false"]) in (0, None)


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    """The tiny dataset of tests/test_search_e2e.py and the port's pipeline
    over it, up to the index and the pairwise decoder."""
    tmp = tmp_path_factory.mktemp("torch_pipe")
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(64, D)).astype(np.float32) * 3

    def sample(n, seed):
        r = np.random.default_rng(seed)
        return (centers[r.integers(0, 64, size=n)]
                + 0.3 * r.normal(size=(n, D)).astype(np.float32)).astype(np.float32)

    train, db = sample(4000, 1), sample(2000, 2)
    queries = db[:50] + 0.01 * rng.normal(size=(50, D)).astype(np.float32)
    gt = np.argsort(((queries[:, None, :] - db[None]) ** 2).sum(-1), axis=1)[:, :10]
    for name, a in dict(train=train, db=db, queries=queries, gt=gt.astype(np.int32)).items():
        np.save(tmp / f"{name}.npy", a)
    t, ivf = f"trainset={tmp}/train.npy", f"ivf_centroids={tmp}/ivf.npy"
    port(["task=ivf_centroids", t, f"output={tmp}/ivf.npy", f"ivf_K={IVF_K}", "ds.valset=500"])
    port(["task=train", t, f"output={tmp}/model.npz", ivf, *MODEL, "batch=512", "ds.valset=500",
          "epochs=2", "scheduler.stop_patience=0", "lr=0.004"])
    port(["task=encode", t, f"model={tmp}/model.npz", ivf, f"output={tmp}/codes_train.npz",
          "encode_trainset=true", "batch=512", "ds.valset=500"])
    port(["task=encode", f"db={tmp}/db.npy", f"model={tmp}/model.npz", ivf,
          f"output={tmp}/codes_db.npz", "batch=512"])
    port(["task=build_index", t, ivf, f"encoded_trainset={tmp}/codes_train.npz",
          f"encoded_db={tmp}/codes_db.npz", f"output={tmp}/index.qivf", "ds.valset=500"])
    port(["task=train_pairwise_decoder", t, ivf, f"encoded_trainset={tmp}/codes_train.npz",
          f"output={tmp}/pairwise.npz", "ds.valset=500", "n_pairwise_codebooks=2"])
    return dict(tmp=tmp, train=train, db=db, queries=queries, t=t, ivf=ivf)


def test_full_ivf_pipeline(pipe):
    tmp = pipe["tmp"]
    assert np.load(tmp / "ivf.npy").shape == (IVF_K, D)
    codes = np.load(tmp / "codes_db.part_0.npz")["codes"]
    assert codes.shape == (2000, 3) and codes[:, 0].max() < IVF_K
    assert np.load(tmp / "codes_train.part_0.npz")["codes"].shape == (4000, 3)
    search = ["task=search", f"model={tmp}/model.npz", pipe["ivf"], f"index={tmp}/index.qivf",
              f"pairwise_decoder={tmp}/pairwise.npz", f"queries={tmp}/queries.npy",
              f"queries_gt={tmp}/gt.npy", f"output={tmp}/results.json", *GRID]
    port(search)
    res = json.loads((tmp / "results.json").read_text())["ivf_real_res"]
    assert len(res) >= 3
    assert max(r["recalls"]["100"] for r in res) > 0.95, [r["recalls"] for r in res]
    assert max(r["recalls"]["10"] for r in res) > 0.6
    r_small = [r for r in res if r["parameters"]["nprobe"] == 4]
    r_big = [r for r in res if r["parameters"]["nprobe"] == 32]
    if r_small and r_big:
        assert max(x["recalls"]["100"] for x in r_big) >= max(
            x["recalls"]["100"] for x in r_small)
    # a resumed search measures nothing again
    port([*search, "resume=true"])
    assert json.loads((tmp / "results.json").read_text())["ivf_real_res"] == res


def test_flat_search(pipe, capsys):
    tmp = pipe["tmp"]
    port(["task=train", pipe["t"], f"output={tmp}/flat_model.npz", "M=4", "K=16", "L=1", "de=8",
          "dh=12", "A=4", "B=2", "batch=512", "ds.valset=500", "epochs=2",
          "scheduler.stop_patience=0", "lr=0.004"])
    capsys.readouterr()
    port(["task=search", f"model={tmp}/flat_model.npz", f"db={tmp}/db.npy",
          f"queries={tmp}/queries.npy", f"queries_gt={tmp}/gt.npy", "batch=512",
          "search.batch_size=512"])
    r100 = float(capsys.readouterr().out.split("R@100=")[1].split()[0])
    assert r100 > 95.0


def test_pair_codes_index_and_search(pipe):
    tmp = pipe["tmp"]
    port(["task=build_index", pipe["t"], pipe["ivf"], f"encoded_trainset={tmp}/codes_train.npz",
          f"encoded_db={tmp}/codes_db.npz", f"output={tmp}/index_paired.qivf", "ds.valset=500",
          "search.pair_codes=true"])
    port(["task=search", f"model={tmp}/model.npz", pipe["ivf"],
          f"index={tmp}/index_paired.qivf", f"queries={tmp}/queries.npy",
          f"queries_gt={tmp}/gt.npy", f"output={tmp}/results_paired.json", "search.nprobe=[32]",
          "search.nshort=[100]", "search.nmid_short=[1]", "search.quantizer_efSearch=[]",
          "search.pair_codes=true", "batch=512", "search.batch_size=512"])
    res = json.loads((tmp / "results_paired.json").read_text())["ivf_real_res"]
    assert res and max(r["recalls"]["100"] for r in res) > 0.95, [r["recalls"] for r in res]


@pytest.fixture(scope="module")
def jax_artifacts(pipe):
    """The JAX package's encode, index and pairwise decoder over the same
    model and data."""
    tmp = pipe["tmp"]
    jax_run(["task=encode", f"db={tmp}/db.npy", f"model={tmp}/model.npz", pipe["ivf"],
             f"output={tmp}/jax_codes_db.npz", "batch=512"])
    jax_run(["task=build_index", pipe["t"], pipe["ivf"],
             f"encoded_trainset={tmp}/codes_train.npz", f"encoded_db={tmp}/codes_db.npz",
             f"output={tmp}/jax_index.qivf", "ds.valset=500"])
    jax_run(["task=train_pairwise_decoder", pipe["t"], pipe["ivf"],
             f"encoded_trainset={tmp}/codes_train.npz", f"output={tmp}/jax_pairwise.npz",
             "ds.valset=500", "n_pairwise_codebooks=2"])
    return tmp


def test_encode_task_codes_match_the_jax_task(jax_artifacts):
    tmp = jax_artifacts
    ours = np.load(tmp / "codes_db.part_0.npz")["codes"]
    theirs = np.load(tmp / "jax_codes_db.part_0.npz")["codes"]
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    assert (ours == theirs).mean() >= 0.99


def test_part_files_cross_both_ways(jax_artifacts):
    from qinco_tpu.config import load_config as jax_load_config
    from qinco_tpu.tasks.search_tasks import EncodedDBIterator as JaxIterator

    tmp = jax_artifacts
    for name in ("codes_db", "jax_codes_db"):
        path = str(tmp / f"{name}.npz")
        a = EncodedDBIterator(load_config([]), path)
        b = JaxIterator(jax_load_config([]), path)
        assert (a.n_parts, a.D) == (b.n_parts, b.D) == (1, D)
        np.testing.assert_array_equal(a.load_all(), b.load_all())
        batches = [x.shape[0] for x in a.iter(700)]
        assert batches == [700, 700, 600] and a.batch_end_id == 2000


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_index_crosses_both_ways(jax_artifacts, pipe, writer):
    """Each package loads the other's .qivf; searching one index with both
    gives the same ids and codes, and distances within rtol 1e-5, atol
    1e-4 (sums of f32 terms of magnitude about 10, in another order)."""
    from qinco_tpu.search.index import IvfIndex as JaxIvfIndex

    tmp = jax_artifacts
    path = tmp / ("index.qivf" if writer == "port" else "jax_index.qivf")
    ours, theirs = IvfIndex.load(path, device="cpu"), JaxIvfIndex.load(path)
    assert ours.ntotal == theirs.ntotal == 2000
    np.testing.assert_array_equal(ours.codebooks, theirs.codebooks)
    xq = pipe["queries"]
    for nprobe in (4, 32):
        d1, i1, c1 = ours.search_and_return_codes(xq, 20, nprobe=nprobe)
        d2, i2, c2 = theirs.search_and_return_codes(xq, 20, nprobe=nprobe)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pairwise_decoder_crosses_both_ways(jax_artifacts, writer):
    from qinco_tpu.search.pairwise_decoder import PairwiseDecoder as JaxDecoder

    tmp = jax_artifacts
    path = tmp / ("pairwise.npz" if writer == "port" else "jax_pairwise.npz")
    ours, theirs = PairwiseDecoder.load(path, device="cpu"), JaxDecoder.load(path)
    for f in ("books", "pairs", "ivf_small_books", "ivf_code_map"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    assert (ours.K_base, ours.M_base) == (theirs.K_base, theirs.M_base)
    codes = np.load(tmp / "codes_db.part_0.npz")["codes"]
    np.testing.assert_array_equal(ours.decode(codes[:, 1:].T, codes[:, 0]),
                                  theirs.decode_native(codes[:, 1:].T, codes[:, 0]))


def test_port_and_jax_pairwise_decoders_choose_the_same_pairs(jax_artifacts):
    """The same pairs, books within rtol 1e-5 and the same decodes.  (At
    ivf_K = 32 and K_base = 16 the IVF book's residual centroids vanish
    by the last decomposition stage, so that stage's codes are ties that
    either package may break its own way; no chosen pair reads it.)"""
    tmp = jax_artifacts
    ours = PairwiseDecoder.load(tmp / "pairwise.npz", device="cpu")
    theirs = PairwiseDecoder.load(tmp / "jax_pairwise.npz", device="cpu")
    np.testing.assert_array_equal(ours.pairs, theirs.pairs)
    np.testing.assert_allclose(ours.books, theirs.books, rtol=1e-5, atol=1e-5)
    codes = np.load(tmp / "codes_db.part_0.npz")["codes"]
    np.testing.assert_allclose(ours.decode(codes[:, 1:].T, codes[:, 0]),
                               theirs.decode(codes[:, 1:].T, codes[:, 0]), rtol=1e-5, atol=1e-5)


def test_kmeans_over_chunks_matches_jax_from_the_same_init():
    """k-means with K over several codebook chunks:
    the port's assignments and segment sums give the JAX package's
    centroids (rtol 1e-5, atol 1e-5)."""
    from qinco_torch.ops.kmeans import kmeans
    from qinco_tpu.ops.kmeans import kmeans as jax_kmeans

    rng = np.random.default_rng(2)
    x = rng.normal(size=(3000, 8)).astype(np.float32)
    init = x[rng.choice(3000, size=96, replace=False)]
    got = kmeans(x, 96, iters=3, chunk=32, init_centroids=init, device="cpu")
    want = jax_kmeans(x, 96, iters=3, chunk=32, init_centroids=init)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["ivf_centroids", "encode", "build_index",
                                  "train_pairwise_decoder", "search"])
def test_search_tasks_are_registered(name):
    assert get_task(name).__module__ == "qinco_torch.tasks.search_tasks"


def test_search_tasks_run_on_the_card_unless_told(pipe, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["task=ivf_centroids", pipe["t"], f"output={pipe['tmp']}/x.npy", "ivf_K=8",
              "ds.valset=500"])
