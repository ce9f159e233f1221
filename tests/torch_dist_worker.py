"""One rank of the port's gloo tests (``tests/test_torch_parallel.py``):

    python torch_dist_worker.py <rank> <world> <init_file> <tmpdir> <scenario>[,<scenario>...]

The rank joins a gloo group through ``file://<init_file>`` and runs the
scenarios in order, each reading its inputs from ``<tmpdir>`` (written by
the test) and writing ``<scenario>_rank<r>.npz`` or ``.json`` there.  The
``cli`` scenario leaves that group and runs ``python -m qinco_torch``'s
``main`` several times, each joining a fresh group through the
``QINCO_*`` variables.  It imports torch and the port only.
"""

import json
import os
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
INIT_FILE, TMP = sys.argv[3], Path(sys.argv[4])
SCENARIOS = sys.argv[5].split(",")
TIMEOUT = timedelta(seconds=60)

torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{INIT_FILE}", rank=RANK, world_size=WORLD,
                        timeout=TIMEOUT)

from qinco_torch.config import load_config  # noqa: E402
from qinco_torch.models.params import init_model_state, param_leaves  # noqa: E402
from qinco_torch.models.params import params_from_numpy  # noqa: E402
from qinco_torch.models.spec import QincoSpec  # noqa: E402
from qinco_torch.parallel import mesh as pmesh  # noqa: E402
from qinco_torch.train import train_step as tts  # noqa: E402


def out(name: str, **arrays) -> None:
    np.savez(TMP / f"{name}_rank{RANK}.npz", **arrays)


def spec_and_params(prefix: str):
    inp = np.load(TMP / f"{prefix}.npz")
    spec = QincoSpec(**json.loads(str(inp["spec"])))
    leaves = [inp[f"leaf{i}"] for i in range(int(inp["n_leaves"]))]
    return spec, params_from_numpy(spec, leaves, device="cpu")


def scenario_mesh():
    """Mesh shapes at world 4, the axes' groups, and the shapes that raise."""
    res = {}
    for data, model in ((4, 1), (2, 2), (-1, 2)):
        m = pmesh.make_mesh(data, model)
        t = torch.tensor([float(RANK)])
        (s_data,) = pmesh.all_reduce_sum(m, [t.clone()], axis="data")
        (s_model,) = pmesh.all_reduce_sum(m, [t.clone()], axis="model")
        gathered = pmesh.all_gather_cat(m, t)
        res[f"{data}x{model}"] = dict(
            data_rank=m.data_rank, data_size=m.data_size, model_rank=m.model_rank,
            model_size=m.model_size, rank=m.rank, world=m.world, is_main=m.is_main,
            sum_data=float(s_data), sum_model=float(s_model), gather_model=gathered.tolist())
    for data, model in ((3, 1), (2, 1), (-1, 3)):
        try:
            pmesh.make_mesh(data, model)
            res[f"raises {data}x{model}"] = False
        except ValueError:
            res[f"raises {data}x{model}"] = True
    (TMP / f"mesh_rank{RANK}.json").write_text(json.dumps(res))


def scenario_train():
    """Three steps on this rank's share of each global batch, in three
    cases (see the test), with the mesh; the losses, the parameters after
    step 1 and step 3, and the model state."""
    spec, _ = spec_and_params("tiny")
    inp = np.load(TMP / "train_data.npz")
    mesh = pmesh.make_mesh()
    res = {}
    for case in ("full", "accum2", "padded"):
        _, params = spec_and_params("tiny")
        x, w = inp[f"{case}_x"], inp[f"{case}_w"]  # the global batch
        accum = 2 if case == "accum2" else 1
        n = x.shape[-2] // WORLD  # this rank's rows of each (micro-)batch
        xs, ws = x[..., RANK * n:(RANK + 1) * n, :], w[..., RANK * n:(RANK + 1) * n]
        opt = tts.build_optimizer(load_config({"lr": 1e-2}), params, spec)
        step = tts.make_train_step(spec, opt, 0.1, accum, mesh=mesh)
        mstate = init_model_state(spec, device="cpu")
        losses = []
        for i in range(3):
            pmesh.COLLECTIVES["calls"] = 0
            params, mstate, o = step(params, mstate, torch.from_numpy(np.ascontiguousarray(xs)),
                                     torch.from_numpy(np.ascontiguousarray(ws)))
            losses.append(float(o.total_loss))
            res[f"{case}_collectives{i}"] = np.int64(pmesh.COLLECTIVES["calls"])
            if i == 0:
                for j, a in enumerate(param_leaves(params)):
                    res[f"{case}_step1_leaf{j}"] = a.detach().numpy().copy()
                for f, a in mstate._asdict().items():
                    res[f"{case}_step1_{f}"] = a.numpy().copy()
                res[f"{case}_step1_codes"] = o.codes.numpy()
        res[f"{case}_losses"] = np.asarray(losses)
        for j, a in enumerate(param_leaves(params)):
            res[f"{case}_leaf{j}"] = a.detach().numpy()
        for f, a in mstate._asdict().items():
            res[f"{case}_{f}"] = a.numpy()
    out("train", **res)


def scenario_kmeans():
    from qinco_torch.ops.kmeans import kmeans

    inp = np.load(TMP / "kmeans.npz")
    mesh = pmesh.make_mesh()
    out("kmeans",
        init=kmeans(inp["x"], 96, iters=3, chunk=32, init_centroids=inp["init"], device="cpu",
                    mesh=mesh),
        seeded=kmeans(inp["x"], 24, iters=4, seed=2, device="cpu", mesh=mesh))


def scenario_mse():
    from qinco_torch.data.datasets import BlockShuffledLoader
    from qinco_torch.train.loop import compute_mse

    spec, params = spec_and_params("tiny")
    xval = np.load(TMP / "val.npy")
    mesh = pmesh.make_mesh()
    loader = BlockShuffledLoader(xval, 16, shard=(mesh.data_rank, mesh.data_size))
    out("mse", mse=np.float64(compute_mse(params, spec, loader, mesh=mesh)),
        batches=np.int64(len(loader)))


def scenario_sharded():
    """``mesh.model=2``: the sharded top-k and assignment, and the sharded
    IVF encode."""
    from qinco_torch.models.qinco import encode_chunked
    from qinco_torch.parallel.sharded_ops import (
        encode_ivf_sharded,
        shard_codebook,
        sharded_coarse_topk,
        sharded_ivf_assign,
    )

    inp = np.load(TMP / "sharded.npz")
    mesh = pmesh.make_mesh(data=1, model=2)
    book, xq = torch.from_numpy(inp["book"]), torch.from_numpy(inp["xq"])
    shard = shard_codebook(mesh, book)
    res = {"shard_rows": np.int64(shard.shape[0])}
    for exact in (True, False):
        ids, d = sharded_coarse_topk(mesh, xq, shard, 5, exact=exact)
        res[f"topk_ids_{exact}"], res[f"topk_d_{exact}"] = ids.numpy(), d.numpy()
    res["assign"] = sharded_ivf_assign(mesh, torch.from_numpy(inp["x"]),
                                       shard_codebook(mesh, torch.from_numpy(inp["ivf_book"])),
                                       chunk=8).numpy()
    spec, params = spec_and_params("tiny_ivf")
    sparams = params._replace(codebook0=shard_codebook(mesh, params.codebook0))
    xn = torch.from_numpy(inp["x_ivf"])
    codes, xhat, _ = encode_ivf_sharded(mesh, sparams, spec, xn)
    res["enc_codes"], res["enc_xhat"] = codes.numpy(), xhat.numpy()
    raw = inp["x_ivf"] * params.data_std.numpy() + params.data_mean.numpy()
    res["chunked_codes"] = encode_chunked(sparams, spec, raw, batch=16, mesh=mesh)
    out("sharded", **res)


def scenario_native():
    """The native library's first build by both ranks at once, into one
    fresh directory: both load the same file."""
    import ctypes

    from qinco_torch.search import index

    index._NATIVE_BUILD = TMP / "native_build"
    dist.barrier()
    path = index.build_native()
    lib = ctypes.CDLL(str(path))
    (TMP / f"native_rank{RANK}.json").write_text(json.dumps(
        dict(path=str(path), has_search=hasattr(lib, "qivf_search"))))


def scenario_cli():
    """``python -m qinco_torch``'s main, rendezvous through the QINCO_*
    variables, once per run in ``cli_runs.json`` (each with its own init
    file); counts the checkpoint writes of this rank, and writes the
    parameters and model state after each epoch's dead-codeword reset,
    with its counts, to ``reset_e<epoch>_rank<r>.npz``."""
    from qinco_torch.__main__ import main
    from qinco_torch.tasks import base, train_task

    dist.destroy_process_group()
    saves = []
    real_save = base.save_checkpoint
    base.save_checkpoint = lambda path, **kw: (saves.append(str(path)), real_save(path, **kw))
    real_reset = train_task.TrainTask._reset_codebooks

    def reset(self, params, mstate, epoch):
        params, n_reset = real_reset(self, params, mstate, epoch)
        leaves = {f"leaf{j}": a.detach().numpy().copy() for j, a in enumerate(param_leaves(params))}
        out(f"reset_e{epoch}", n_reset=n_reset, **leaves,
            **{f: a.numpy().copy() for f, a in mstate._asdict().items()})
        return params, n_reset

    train_task.TrainTask._reset_codebooks = reset
    runs = json.loads((TMP / "cli_runs.json").read_text())
    for i, argv in enumerate(runs):
        os.environ.update(QINCO_COORDINATOR=f"file://{TMP}/cli_pg_{i}",
                          QINCO_NUM_PROCS=str(WORLD), QINCO_PROC_ID=str(RANK))
        print(f"==== cli run {i}", flush=True)
        assert main(argv) == 0
        assert not dist.is_initialized(), "main left its process group up"
    (TMP / f"cli_rank{RANK}.json").write_text(json.dumps(dict(saves=saves)))


for name in SCENARIOS:
    globals()[f"scenario_{name}"]()
if dist.is_initialized():
    dist.destroy_process_group()
print(f"rank {RANK} done", flush=True)
