"""PQ-QINCo tasks (counterpart of ``qinco_tpu/tasks/pq_task.py``; the
reference's ``qinco_v1/pq_qinco.py``): ``train_pq`` trains one QINCo
model per product split of the (optionally OPQ-rotated) data, one after
the other in this process, and writes them as one ``.pqnpz``;
``eval_pq`` reports the MSE and the flat-search recall of such a model.

A ``.pqnpz`` holds the parts' stacked parameter leaves as ``part_0000``,
... in JAX tree order with ``None`` dropped, ``opq`` (when there is a
rotation), ``part_scales`` and a ``meta`` JSON record (uint8 bytes)
``{n_parts, n_leaves, spec}``; both packages read each other's.  The
sub-spec comes from ``meta`` alone, so ``eval_pq`` encodes at the exact
f32 profile whatever ``encode_profile`` says, as the JAX package does.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..config import load_config
from ..data.datasets import load_queries_data, load_vec_db, load_vec_trainset
from ..metrics import compute_recalls, corrected_mse
from ..models.params import param_leaves
from ..models.pq_qinco import PQQincoParams, pq_encode, pq_params_from_numpy, stack_part_params
from ..models.spec import QincoSpec
from ..ops.distances import topk_smallest
from ..ops.opq import train_opq
from ..utils import Timer, host_to_device, resolve_device, sync
from .base import BaseTask

SPEC_KEYS = ("D", "K", "M", "L", "de", "dh", "A", "B", "qinco1_mode")
# The exact flat search holds at most this many (query, DB row, dim)
# differences at once.
SEARCH_BLOCK_ELEMS = 2**28


def save_pq_checkpoint(path, params: PQQincoParams, sub_spec: QincoSpec, n_parts: int) -> None:
    leaves = param_leaves(params.parts)
    arrays = {f"part_{i:04d}": a.detach().cpu().numpy() for i, a in enumerate(leaves)}
    if params.opq is not None:
        arrays["opq"] = params.opq.cpu().numpy()
    arrays["part_scales"] = params.part_scales.cpu().numpy()
    meta = {"n_parts": n_parts, "n_leaves": len(leaves),
            "spec": {k: getattr(sub_spec, k) for k in SPEC_KEYS}}
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_pq_checkpoint(path, *, device=None) -> tuple[PQQincoParams, QincoSpec, int]:
    """-> (params on ``device`` (default ``cuda``), sub-spec, n_parts)."""
    device = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        sub_spec = QincoSpec(**meta["spec"])
        params = pq_params_from_numpy(
            sub_spec, [z[f"part_{i:04d}"] for i in range(meta["n_leaves"])],
            opq=z["opq"] if "opq" in z else None, part_scales=z["part_scales"],
            device=device)
    return params, sub_spec, meta["n_parts"]


class PQTrainTask(BaseTask):
    """task=train_pq: ``pq_parts`` QINCo models, each trained by
    :class:`~qinco_torch.tasks.train_task.TrainTask` on its dimension
    split (after the OPQ rotation with ``opq=true``), combined into one
    ``.pqnpz``."""

    USE_MODEL = False

    def setup(self):
        super().setup()
        cfg = self.cfg
        if not (cfg.output and str(cfg.output).endswith(".pqnpz")):
            raise ValueError("Specify a .pqnpz output for the PQ-QINCo model")
        self.n_parts = int(cfg.get("pq_parts", 2) or 2)
        self.use_opq = bool(cfg.get("opq", False))

    def load_data(self):
        (self.train_vecs, self.val_vecs), _ = load_vec_trainset(self.cfg)
        self.data_dim = self.train_vecs.shape[-1]
        if self.data_dim % self.n_parts:
            raise ValueError(f"D={self.data_dim} not divisible by pq_parts={self.n_parts}")

    def run(self):
        from .train_task import TrainTask

        cfg = self.cfg
        D, P = self.data_dim, self.n_parts
        d_sub = D // P
        x = np.asarray(self.train_vecs, np.float32)

        opq = None
        if self.use_opq:
            self.print("Training OPQ rotation")
            with Timer() as t:
                opq = train_opq(x[:100_000], P, min(cfg.K or 256, 256), seed=cfg.seed,
                                verbose=cfg.verbose, device=self.device)
            self.print(f"OPQ rotation trained ({t.s()})")
            x = x @ opq.T
        xval = np.asarray(self.val_vecs, np.float32)
        if opq is not None:
            xval = xval @ opq.T

        out_dir = Path(cfg.output).parent
        out_dir.mkdir(parents=True, exist_ok=True)
        parts = []
        for p_i in range(P):
            self.print(f"===== training PQ part {p_i + 1}/{P} (dims {d_sub})")
            sl = slice(p_i * d_sub, (p_i + 1) * d_sub)
            part_path = out_dir / f"_pq_part{p_i}.npy"
            np.save(part_path, np.concatenate([x[:, sl], xval[:, sl]]))
            sub_cfg = load_config({
                **{k: cfg.get(k) for k in (
                    "M", "K", "L", "de", "dh", "A", "B", "lr", "wd", "grad_clip", "batch",
                    "epochs", "optimizer", "seed", "qinco1_mode", "verbose", "cpu")},
                "task": "train",
                "trainset": str(part_path),
                "output": str(out_dir / f"_pq_part{p_i}.npz"),
                "ds.valset": cfg.ds.valset,
                "ds.loop": cfg.ds.loop,
                "scheduler.stop_patience": cfg.scheduler.stop_patience,
            })
            with Timer() as t:
                task = TrainTask(sub_cfg)
                task.run()
            self.print(f"PQ part {p_i + 1}/{P} trained ({t.s()})")
            parts.append(task.params)
            self.sub_spec = task.spec
            part_path.unlink()

        params = stack_part_params(parts, opq=opq)
        save_pq_checkpoint(cfg.output, params, self.sub_spec, P)
        self.print(f"Saved PQ-QINCo model to {cfg.output}")

        x_orig = np.asarray(self.val_vecs[:10_000], np.float32)
        _, xhat = pq_encode(params, self.sub_spec, P, host_to_device(x_orig, self.device))
        mse = corrected_mse(xhat.cpu().numpy(), x_orig, cfg.mse_scale)
        self.print(f"PQ-QINCo validation MSE: {mse:g}")
        return params


class PQEvalTask(BaseTask):
    """task=eval_pq: the DB MSE of a PQ-QINCo model (``model=``, a
    ``.pqnpz``) and, with ``queries=``, the recall of an exact flat
    search over the DB's reconstructions."""

    USE_MODEL = False

    def load_data(self):
        cfg = self.cfg
        self.db, _ = load_vec_db(cfg)
        self.data_dim = self.db.shape[-1]
        self.xq = self.xq_gt = None
        if cfg.queries:
            self.xq, self.xq_gt = load_queries_data(cfg)

    def run(self):
        cfg, device = self.cfg, self.device
        if not cfg.model:
            raise ValueError("Specify the .pqnpz model via 'model'")
        params, sub_spec, n_parts = load_pq_checkpoint(cfg.model, device=device)

        db = np.asarray(self.db, np.float32)
        with Timer() as t:
            xhat = torch.cat([pq_encode(params, sub_spec, n_parts,
                                        host_to_device(db[i:i + cfg.batch], device))[1]
                              for i in range(0, len(db), cfg.batch)])
            sync(device)
        self.print(f"Encoded {len(db)} vectors ({t.s()})")
        mse = corrected_mse(xhat.cpu().numpy(), db, cfg.mse_scale)
        self.print(f"PQ-QINCo DB MSE: {mse:g}")

        recalls = None
        if self.xq is not None:
            xq = host_to_device(self.xq, device)
            block = max(1, SEARCH_BLOCK_ELEMS // xhat.numel())
            I = torch.cat([
                topk_smallest((q[:, None, :] - xhat[None]).square_().sum(-1), 100)[0].cpu()
                for q in xq.split(block)]).numpy()
            recalls = compute_recalls(I, np.asarray(self.xq_gt))
            self.print(f"R@1={recalls[1] * 100:.2f} R@10={recalls[10] * 100:.2f} "
                       f"R@100={recalls[100] * 100:.2f}")
        return mse, recalls
