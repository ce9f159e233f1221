"""The port over several processes (``qinco_torch/parallel``), on the CPU
with gloo: real groups of ranks (``tests/torch_dist_worker.py``, spawned
as subprocesses, rendezvous through a ``file://`` path) held against the
single-process port and against the JAX package.

- The mesh at world 4 (``(4, 1)``, ``(2, 2)``, the shapes that raise) and
  the trivial mesh without a group, whose helpers return their inputs.
- Two ranks, three train steps on a global batch of 64 (2 x 32; with
  ``grad_accumulate=2``; with a padded last batch): losses within rtol
  1e-5 of the single-process port, parameters within rtol 1e-4, atol 1e-5
  (``tests/test_multihost.py``'s tolerances), EMA buffers within rtol
  1e-5, atol 1e-6, usage histograms equal, and the two ranks' parameters
  equal bit for bit, with ``(2·Ms + 2)·accum + 2`` collectives a step; one step
  against the JAX train step on the same
  global batch at ``tests/test_torch_train_step.py``'s one-step tolerance.
- k-means over two ranks within rtol 1e-3, atol 1e-3 of the
  single-process port and of JAX's ``kmeans(..., mesh=make_mesh())``
  (``tests/test_training.py``'s tolerance); ``compute_mse`` over two
  ranks within 1e-6 relative of the single-process MSE.
- ``mesh.model = 2``: the sharded top-k's ids equal brute force and JAX's
  ``sharded_coarse_topk`` on an 8-device mesh, its distances within 1e-3;
  the sharded assignment equals the argmin; the sharded IVF encode's codes
  equal the replicated encode's, its xhat within 1e-4.
- ``python -m qinco_torch`` on two ranks through the ``QINCO_*``
  variables: ``train`` (one checkpoint, by rank 0, its leaves against a
  one-process run at the tolerances above; each log line once; after each
  epoch's dead-codeword reset, which fires, both ranks' parameters and
  model state equal bit for bit),
  ``encode`` (two part files that together hold the single-process codes
  bit for bit, read by JAX's ``EncodedDBIterator``), ``encode
  mesh.model=2`` with IVF (one part equal to the replicated run's),
  ``eval`` and ``ivf_centroids``.
- The loader's shards equal the JAX loader's, bit for bit; the start-up
  never falls back to gloo on the card's path; two ranks building the
  native library at once both load it.

Each group's workers run all their scenarios in one launch, under a
wall-clock timeout, with one intra-op thread each.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_port_helpers import data, make_models
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

from qinco_torch.__main__ import main
from qinco_torch.checkpoint import load_checkpoint, save_checkpoint
from qinco_torch.config import load_config as torch_config
from qinco_torch.data.datasets import BlockShuffledLoader
from qinco_torch.models.params import init_model_state, param_leaves
from qinco_torch.models.qinco import encode, encode_chunked
from qinco_torch.ops.distances import sqdist_topk
from qinco_torch.parallel import distributed as pdist
from qinco_torch.parallel import mesh as pmesh
from qinco_torch.parallel.sharded_ops import sharded_coarse_topk
from qinco_torch.train import train_step as tts

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).parent / "torch_dist_worker.py"
TIMEOUT_S = 240
TINY = dict(D=8, K=16, M=3, L=1, de=6, dh=12, A=4, B=2)
MODEL_ARGS = ["M=3", "K=16", "L=1", "de=6", "dh=12", "A=4", "B=2"]
CASES = ("full", "accum2", "padded")
MSTATE = ("xtarget_mean", "xtarget_var", "x0_mean", "x0_std", "usage0", "usage")


def _save_model_inputs(path, spec, leaves):
    fields = {f: getattr(spec, f) for f in spec.__dataclass_fields__}
    np.savez(path, spec=json.dumps(fields), n_leaves=len(leaves),
             **{f"leaf{i}": a for i, a in enumerate(leaves)})


def _checkpoint(path, ts, tp):
    hyper = dict(K=ts.K, M=ts.M, de=ts.de, dh=ts.dh, L=ts.L, A=ts.A, B=ts.B)
    if ts.ivf_in_use:
        hyper.update(ivf_in_use=True, ivf_K=ts.ivf_K)
    save_checkpoint(path, params=tp, hyperparams=hyper, data_dim=ts.D)


def _inputs(tmp):
    """Every input of the workers, written to ``tmp``; returns what the
    tests compare with."""
    js, ts, jp, tp, leaves = make_models(seed=0, **TINY)
    _save_model_inputs(tmp / "tiny.npz", ts, leaves)
    jsi, tsi, _, tpi, leaves_i = make_models(seed=1, ivf_K=32, **TINY)
    _save_model_inputs(tmp / "tiny_ivf.npz", tsi, leaves_i)

    x = data(64, 8, seed=42)
    w_pad = np.ones((64,), np.float32)
    w_pad[24:32] = w_pad[56:64] = 0.0
    train = dict(full_x=x, full_w=np.ones((64,), np.float32),
                 accum2_x=x.reshape(2, 32, 8), accum2_w=np.ones((2, 32), np.float32),
                 padded_x=x, padded_w=w_pad)
    np.savez(tmp / "train_data.npz", **train)

    rng = np.random.default_rng(2)
    xk = rng.normal(size=(3000, 8)).astype(np.float32)
    np.savez(tmp / "kmeans.npz", x=xk, init=xk[rng.choice(3000, size=96, replace=False)])
    np.save(tmp / "val.npy", data(100, 8, seed=3))
    sharded = dict(book=data(64, 8, seed=4), xq=data(33, 8, seed=5), ivf_book=data(128, 8, seed=6),
                   x=data(50, 8, seed=7), x_ivf=data(40, 8, seed=8))
    np.savez(tmp / "sharded.npz", **sharded)

    # the command-line runs: a trainset (64 + 32 validation rows), a DB and models
    np.save(tmp / "train.npy", data(96, 8, seed=9))
    np.save(tmp / "db.npy", data(80, 8, seed=10))
    _checkpoint(tmp / "model.npz", ts, tp)
    _checkpoint(tmp / "model_ivf.npz", tsi, tpi)
    ivf_raw = tpi.codebook0.numpy() * tpi.data_std.numpy() + tpi.data_mean.numpy()
    np.save(tmp / "ivf.npy", ivf_raw.astype(np.float32))
    return dict(js=js, ts=ts, jp=jp, leaves=leaves, jsi=jsi, tsi=tsi, leaves_i=leaves_i,
                train=train, kmeans=np.load(tmp / "kmeans.npz"), sharded=sharded)


def _cli_runs(tmp):
    """(two-rank argv, one-process argv) of each command-line case."""
    t = [f"trainset={tmp}/train.npy", "ds.valset=32"]
    ivf = [f"ivf_centroids={tmp}/ivf.npy"]
    common = ["cpu=true", "verbose=false"]
    runs = {
        "train": (["task=train", *t, *MODEL_ARGS, "epochs=2", "scheduler.stop_patience=0",
                   "lr=0.01", "seed=3", *common], "output", "train_{}.npz"),
        "encode": (["task=encode", f"db={tmp}/db.npy", f"model={tmp}/model.npz", "batch=16",
                    *common], "output", "enc_{}.npz"),
        "encode_ivf": (["task=encode", f"db={tmp}/db.npy", f"model={tmp}/model_ivf.npz", *ivf,
                        "batch=16", *common], "output", "enc_ivf_{}.npz"),
        "eval": (["task=eval", f"db={tmp}/db.npy", f"model={tmp}/model.npz", "batch=16",
                  *common], None, None),
        "ivf_centroids": (["task=ivf_centroids", *t, "ivf_K=8", "kmeans_iters=5", *common],
                          "output", "ivf_{}.npy"),
    }
    two, one = [], []
    for name, (argv, key, pattern) in runs.items():
        a2, a1 = list(argv), list(argv)
        if key:
            a2.append(f"{key}={tmp / pattern.format('dist')}")
            a1.append(f"{key}={tmp / pattern.format('one')}")
        if name == "train":  # per-rank batch 32 on two ranks: the global batch of 64
            a2.append("batch=32")
            a1.append("batch=64")
        if name == "encode_ivf":
            a2.append("mesh.model=2")
        two.append(a2)
        one.append((name, a1))
    return two, one


def _launch(tmp, world, scenarios, tag):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "QINCO_COORDINATOR")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    init = tmp / f"pg_{tag}"
    return [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world), str(init),
                              str(tmp), ",".join(scenarios)],
                             env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]


def _finish(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o[-6000:]}"
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dist")
    ref = _inputs(tmp)
    two, one = _cli_runs(tmp)
    (tmp / "cli_runs.json").write_text(json.dumps(two))
    procs2 = _launch(tmp, 2, ["train", "kmeans", "mse", "sharded", "native", "cli"], "w2")
    procs4 = _launch(tmp, 4, ["mesh"], "w4")
    try:
        one_logs = {}  # the one-process runs, meanwhile
        for name, argv in one:
            one_logs[name] = _captured_main(argv)
    finally:
        outs2, outs4 = _finish(procs2), _finish(procs4)
    return dict(tmp=tmp, ref=ref, outs2=outs2, outs4=outs4, one_logs=one_logs)


def _captured_main(argv):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _rank(tmp, name, r):
    return np.load(tmp / f"{name}_rank{r}.npz")


# ---------------------------------------------------------------------------
# In process, no group
# ---------------------------------------------------------------------------


def test_mesh_without_a_group_is_trivial():
    assert not dist.is_initialized()
    m = pmesh.make_mesh()
    assert (m.device_mesh, m.data_size, m.model_size, m.rank, m.world, m.is_main) == (
        None, 1, 1, 0, 1, True)
    t = [torch.arange(3.0), torch.ones(2, dtype=torch.int64)]
    before = dict(pmesh.COLLECTIVES)
    for fn in (lambda: pmesh.all_reduce_sum(m, t), lambda: pmesh.replicate(m, t),
               lambda: pmesh.all_reduce_sum(None, t)):
        got = fn()
        assert all(a is b for a, b in zip(got, t))
    assert pmesh.all_gather_cat(m, t[0]) is t[0]
    pmesh.barrier(m)
    assert dict(pmesh.COLLECTIVES) == before
    for data_, model in ((2, 1), (-1, 2)):
        with pytest.raises(ValueError):
            pmesh.make_mesh(data_, model)


def test_sharded_coarse_topk_without_a_group_is_the_plain_topk():
    book, xq = torch.from_numpy(data(64, 8, seed=4)), torch.from_numpy(data(33, 8, seed=5))
    ids, d = sharded_coarse_topk(pmesh.make_mesh(), xq, book, 5, exact=False)
    want_ids, want_d = sqdist_topk(xq, book, 5)
    assert torch.equal(ids, want_ids) and torch.equal(d, want_d)


LOADERS = {
    "shuffled": dict(n=203, batch=16, shuffle=True),
    "blocks_loop": dict(n=300, batch=16, shuffle=True, loop=150, block_rows=40),
    "ordered": dict(n=101, batch=8, shuffle=False),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_shards_match_jax(name):
    from qinco_tpu.data.datasets import BlockShuffledLoader as JaxLoader

    kw = dict(LOADERS[name])
    x = data(kw.pop("n"), 4, seed=11)
    batch = kw.pop("batch")
    for i in range(2):
        ours = BlockShuffledLoader(x, batch, seed=5, shard=(i, 2), **kw)
        theirs = JaxLoader(x, batch, seed=5, shard=(i, 2), **kw)
        assert len(ours) == len(theirs)
        for epoch in range(2):
            a, b = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
            assert len(a) == len(b) == len(ours)
            for p, q in zip(a, b):
                assert p.n_valid == q.n_valid
                np.testing.assert_array_equal(p.x, q.x)


@pytest.mark.parametrize("style", ["torchrun", "qinco"])
def test_no_fallback_to_gloo(monkeypatch, style):
    """With the rendezvous variables set and ``cpu=false``, no CUDA means
    an error, not a gloo group."""
    if style == "torchrun":
        env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                   MASTER_PORT="29999")
    else:
        env = dict(QINCO_COORDINATOR="localhost:29999", QINCO_NUM_PROCS="1", QINCO_PROC_ID="0")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "QINCO_COORDINATOR", "QINCO_NUM_PROCS", "QINCO_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        pdist.maybe_init_distributed(cpu=False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        main(["task=eval", "db=unused.npy", "model=unused.npz"])
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# Groups of ranks
# ---------------------------------------------------------------------------


def test_make_mesh_at_world_4(runs):
    res = [json.loads((runs["tmp"] / f"mesh_rank{r}.json").read_text()) for r in range(4)]
    for r, got in enumerate(res):
        m = got["4x1"]
        assert (m["data_rank"], m["data_size"], m["model_rank"], m["model_size"]) == (r, 4, 0, 1)
        assert m["sum_data"] == 6.0 and m["sum_model"] == r and m["gather_model"] == [r]
        for key in ("2x2", "-1x2"):
            m = got[key]
            assert (m["data_rank"], m["data_size"], m["model_rank"], m["model_size"]) == (
                r // 2, 2, r % 2, 2)
            assert (m["rank"], m["world"], m["is_main"]) == (r, 4, r == 0)
            # the data axis joins the ranks of one model index, the model axis a model group
            assert m["sum_data"] == (r % 2) + (r % 2 + 2)
            assert m["sum_model"] == 2 * (r // 2) * 2 + 1
            assert m["gather_model"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert got["raises 3x1"] and got["raises 2x1"] and got["raises -1x3"]


def _one_process_steps(ref, case):
    ts = ref["ts"]
    _, _, _, tp, _ = make_models(seed=0, **TINY)
    opt = tts.build_optimizer(torch_config({"lr": 1e-2}), tp, ts)
    accum = 2 if case == "accum2" else 1
    step = tts.make_train_step(ts, opt, 0.1, accum)
    x, w = (torch.from_numpy(ref["train"][f"{case}_{k}"]) for k in ("x", "w"))
    mstate, losses = init_model_state(ts, device="cpu"), []
    for _ in range(3):
        tp, mstate, out = step(tp, mstate, x, w)
        losses.append(float(out.total_loss))
    return tp, mstate, losses


@pytest.mark.parametrize("case", CASES)
def test_two_rank_train_steps_match_one_process(runs, case):
    ranks = [_rank(runs["tmp"], "train", r) for r in range(2)]
    tp, mstate, losses = _one_process_steps(runs["ref"], case)
    got = ranks[0]
    np.testing.assert_allclose(got[f"{case}_losses"], losses, rtol=1e-5)
    leaves = param_leaves(tp)
    for j, a in enumerate(leaves):
        np.testing.assert_allclose(got[f"{case}_leaf{j}"], a.detach().numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=f"{case}: parameter leaf {j}")
    for f in MSTATE[:4]:
        np.testing.assert_allclose(got[f"{case}_{f}"], getattr(mstate, f).numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{case}: {f}")
    for f in MSTATE[4:]:
        np.testing.assert_array_equal(got[f"{case}_{f}"], getattr(mstate, f).numpy())
    # a fixed count of collectives a step: two for each MLP step's residual
    # statistics and two for the x0 statistics a micro-batch, two a step
    accum = 2 if case == "accum2" else 1
    want = (2 * runs["ref"]["ts"].n_mlp_steps + 2) * accum + 2
    assert [int(got[f"{case}_collectives{i}"]) for i in range(3)] == [want] * 3
    # every rank holds the same parameters and state, bit for bit
    for key in ranks[0].files:
        if key.startswith(case) and "codes" not in key:
            np.testing.assert_array_equal(ranks[1][key], ranks[0][key], err_msg=key)


def test_two_rank_train_step_matches_jax(runs):
    """One step on the global batch of 64 against the JAX train step."""
    from qinco_tpu.config import load_config as jax_config
    from qinco_tpu.models import init_model_state as jax_init_model_state
    from qinco_tpu.train import train_step as jts

    ref = runs["ref"]
    js, jp = ref["js"], ref["jp"]
    tx = jts.build_optimizer(jax_config({"lr": 1e-2}), jp, js)
    step = jts.make_train_step(js, tx, grad_clip=0.1)
    x, w = ref["train"]["full_x"], ref["train"]["full_w"]
    jp2, _, jm2, jout = step(jp, tx.init(jp), jax_init_model_state(js), jnp.asarray(x),
                             jnp.asarray(w))
    ranks = [_rank(runs["tmp"], "train", r) for r in range(2)]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["full_step1_codes"],
                                      np.asarray(jout.codes)[:, 32 * r:32 * (r + 1)])
    got = ranks[0]
    np.testing.assert_allclose(got["full_losses"][0], float(jout.total_loss), rtol=1e-5)
    for j, b in enumerate(jax.tree_util.tree_leaves(jp2)):
        np.testing.assert_allclose(got[f"full_step1_leaf{j}"], np.asarray(b), rtol=2e-5,
                                   atol=2e-6, err_msg=f"parameter leaf {j}")
    for f in MSTATE[:4]:
        np.testing.assert_allclose(got[f"full_step1_{f}"], np.asarray(getattr(jm2, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    for f in MSTATE[4:]:
        np.testing.assert_array_equal(got[f"full_step1_{f}"], np.asarray(getattr(jm2, f)))


def test_two_rank_kmeans_matches_one_process_and_jax(runs):
    from qinco_torch.ops.kmeans import kmeans
    from qinco_tpu.ops.kmeans import kmeans as jax_kmeans
    from qinco_tpu.parallel.mesh import make_mesh as jax_make_mesh

    inp = runs["ref"]["kmeans"]
    ranks = [_rank(runs["tmp"], "kmeans", r) for r in range(2)]
    one = kmeans(inp["x"], 96, iters=3, chunk=32, init_centroids=inp["init"], device="cpu")
    theirs = jax_kmeans(inp["x"], 96, iters=3, chunk=32, init_centroids=inp["init"],
                        mesh=jax_make_mesh())
    seeded = kmeans(inp["x"], 24, iters=4, seed=2, device="cpu")
    for got in ranks:
        np.testing.assert_allclose(got["init"], one, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got["init"], theirs, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got["seeded"], seeded, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(ranks[0]["init"], ranks[1]["init"])
    np.testing.assert_array_equal(ranks[0]["seeded"], ranks[1]["seeded"])


def test_two_rank_compute_mse_matches_one_process(runs):
    from qinco_torch.train.loop import compute_mse

    ref = runs["ref"]
    _, _, _, tp, _ = make_models(seed=0, **TINY)
    xval = np.load(runs["tmp"] / "val.npy")
    want = compute_mse(tp, ref["ts"], BlockShuffledLoader(xval, 16))
    for r in range(2):
        got = _rank(runs["tmp"], "mse", r)
        assert int(got["batches"]) == 4  # 50 rows a rank at batch 16
        np.testing.assert_allclose(float(got["mse"]), want, rtol=1e-6)


@pytest.mark.parametrize("exact", [True, False])
def test_sharded_coarse_topk_matches_brute_force_and_jax(runs, exact):
    from qinco_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from qinco_tpu.parallel.sharded_ops import shard_codebook as jax_shard
    from qinco_tpu.parallel.sharded_ops import sharded_coarse_topk as jax_topk

    inp = runs["ref"]["sharded"]
    book, xq = inp["book"], inp["xq"]
    full = ((xq[:, None] - book[None]) ** 2).sum(-1)
    want = np.argsort(full, axis=1, kind="stable")[:, :5]
    jmesh = jax_make_mesh(data=2, model=4)
    jids, _ = jax_topk(jmesh, jnp.asarray(xq), jax_shard(jmesh, book), 5, exact=exact)
    for r in range(2):
        got = _rank(runs["tmp"], "sharded", r)
        assert int(got["shard_rows"]) == 32
        ids, d = got[f"topk_ids_{exact}"], got[f"topk_d_{exact}"]
        np.testing.assert_array_equal(ids, want)
        np.testing.assert_array_equal(ids, np.asarray(jids))
        true_d = np.take_along_axis(full, want, axis=1)
        if not exact:  # partial distances: the constant |x|^2 left out
            true_d = true_d - (xq ** 2).sum(-1, keepdims=True)
        np.testing.assert_allclose(d, true_d, rtol=1e-3, atol=1e-3)


def test_sharded_ivf_assign_is_the_argmin(runs):
    inp = runs["ref"]["sharded"]
    want = np.argmin(((inp["x"][:, None] - inp["ivf_book"][None]) ** 2).sum(-1), axis=1)
    for r in range(2):
        np.testing.assert_array_equal(_rank(runs["tmp"], "sharded", r)["assign"], want)


def test_encode_ivf_sharded_matches_the_replicated_encode(runs):
    ref = runs["ref"]
    tsi = ref["tsi"]
    _, _, _, tpi, _ = make_models(seed=1, ivf_K=32, **TINY)
    x = ref["sharded"]["x_ivf"]
    codes, xhat, _ = encode(tpi, tsi, torch.from_numpy(x))
    raw = x * tpi.data_std.numpy() + tpi.data_mean.numpy()
    chunked = encode_chunked(tpi, tsi, raw, batch=16)
    for r in range(2):
        got = _rank(runs["tmp"], "sharded", r)
        np.testing.assert_array_equal(got["enc_codes"], codes.numpy())
        np.testing.assert_allclose(got["enc_xhat"], xhat.numpy(), atol=1e-4)
        np.testing.assert_array_equal(got["chunked_codes"], chunked)


def test_native_library_first_build_by_two_ranks(runs):
    """Both ranks build the library at once (each into its own temporary
    name, then a rename): both load the one file, and no temporary file is
    left behind."""
    res = [json.loads((runs["tmp"] / f"native_rank{r}.json").read_text()) for r in range(2)]
    assert res[0]["path"] == res[1]["path"]
    assert all(r["has_search"] for r in res)
    assert not any(n.endswith(".tmp") for n in os.listdir(Path(res[0]["path"]).parent))


def _cli_logs(outs):
    """Each rank's output, split by command-line run."""
    logs = []
    for out in outs:
        parts = re.split(r"==== cli run (\d+)\n", out)
        logs.append({int(parts[i]): parts[i + 1] for i in range(1, len(parts), 2)})
    return logs


CLI = {"train": 0, "encode": 1, "encode_ivf": 2, "eval": 3, "ivf_centroids": 4}


def test_cli_train_on_two_ranks(runs):
    tmp, ts = runs["tmp"], runs["ref"]["ts"]
    saves = [json.loads((tmp / f"cli_rank{r}.json").read_text())["saves"] for r in range(2)]
    assert saves[1] == [] and saves[0] and set(saves[0]) == {str(tmp / "train_dist.npz")}
    got = load_checkpoint(tmp / "train_dist.npz", ts, device="cpu")
    want = load_checkpoint(tmp / "train_one.npz", ts, device="cpu")
    assert got["meta"]["epoch"] == want["meta"]["epoch"]
    for a, b in zip(param_leaves(got["params"]), param_leaves(want["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    for f in MSTATE:
        np.testing.assert_allclose(getattr(got["mstate"], f).numpy(),
                                   getattr(want["mstate"], f).numpy(), rtol=1e-4, atol=1e-5)
    logs = _cli_logs(runs["outs2"])
    log0, log1 = logs[0][CLI["train"]], logs[1][CLI["train"]]
    assert "RUNNING TASK train" not in log1 and "Validation metrics" not in log1
    for line in ("RUNNING TASK train", "Training done", "Task done", "Process group: 2 rank(s)"):
        assert log0.count(line) == 1, line
    one = runs["one_logs"]["train"]
    assert log0.count("Start epoch") == one.count("Start epoch") > 1
    val = re.findall(r"Validation metrics: \[\[MSE=([^\]]+)\]\]", log0)
    want_val = re.findall(r"Validation metrics: \[\[MSE=([^\]]+)\]\]", one)
    np.testing.assert_allclose([float(v) for v in val], [float(v) for v in want_val], rtol=1e-4)


def test_cli_train_resets_the_same_codewords_on_both_ranks(runs):
    """The dead-codeword reset at each epoch's end fires (64 training rows
    leave codewords of the 16 unused) and leaves both ranks with the same
    parameters and model state, bit for bit."""
    tmp = runs["tmp"]
    epochs = sorted(int(p.name.split("_")[1][1:]) for p in tmp.glob("reset_e*_rank0.npz"))
    assert epochs == list(range(len(epochs))) and len(epochs) > 1
    fired = 0
    for e in epochs:
        r0, r1 = (np.load(tmp / f"reset_e{e}_rank{r}.npz") for r in range(2))
        assert sorted(r0.files) == sorted(r1.files)
        for key in r0.files:
            np.testing.assert_array_equal(r1[key], r0[key], err_msg=f"epoch {e}: {key}")
        fired += int(r0["n_reset"].sum())
    assert fired > 0


def test_cli_encode_on_two_ranks_writes_one_part_per_rank(runs):
    from qinco_tpu.config import load_config as jax_config
    from qinco_tpu.tasks.search_tasks import EncodedDBIterator

    tmp = runs["tmp"]
    assert int(np.load(tmp / "enc_dist.npz")["n_parts"]) == 2
    parts = [np.load(tmp / f"enc_dist.part_{i}.npz")["codes"] for i in range(2)]
    assert [len(p) for p in parts] == [40, 40]
    one = np.load(tmp / "enc_one.part_0.npz")["codes"]
    np.testing.assert_array_equal(np.concatenate(parts), one)
    it = EncodedDBIterator(jax_config({}), str(tmp / "enc_dist.npz"))
    assert it.n_parts == 2
    np.testing.assert_array_equal(it.load_all(), one)


def test_cli_encode_with_the_ivf_book_sharded_over_two_ranks(runs):
    tmp = runs["tmp"]
    assert int(np.load(tmp / "enc_ivf_dist.npz")["n_parts"]) == 1
    assert not (tmp / "enc_ivf_dist.part_1.npz").exists()
    np.testing.assert_array_equal(np.load(tmp / "enc_ivf_dist.part_0.npz")["codes"],
                                  np.load(tmp / "enc_ivf_one.part_0.npz")["codes"])
    assert "Sharding the IVF codebook over 2 ranks" in _cli_logs(runs["outs2"])[0][
        CLI["encode_ivf"]]


def test_cli_eval_on_two_ranks(runs):
    logs = _cli_logs(runs["outs2"])
    pattern = r"Test metrics: \[\[MSE=([^\]]+)\]\]"
    got = re.findall(pattern, logs[0][CLI["eval"]])
    assert got == re.findall(pattern, runs["one_logs"]["eval"]) and len(got) == 1
    assert not re.findall(pattern, logs[1][CLI["eval"]])


def test_cli_ivf_centroids_on_two_ranks(runs):
    tmp = runs["tmp"]
    np.testing.assert_allclose(np.load(tmp / "ivf_dist.npy"), np.load(tmp / "ivf_one.npy"),
                               rtol=1e-3, atol=1e-3)
