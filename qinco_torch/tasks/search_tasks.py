"""Search-pipeline tasks (counterpart of ``qinco_tpu/tasks/search_tasks.py``):
IVF centroid training, DB encoding into part files, the index build,
the pairwise decoder's training and the search.  Over a process group the
k-means splits its rows over the data axis, and the DB encode writes one
part file per data group, with the IVF book sharded over each model group
when ``mesh.model > 1``."""

from __future__ import annotations

import numpy as np

from ..data.datasets import load_queries_data, load_vec_db, load_vec_trainset
from ..models.qinco import encode_chunked
from ..ops.kmeans import kmeans
from ..parallel.mesh import barrier
from ..parallel.sharded_ops import shard_codebook
from ..utils import TimersManager
from .base import BaseTask


class IVFTrainTask(BaseTask):
    """k-means of the training set into ``ivf_K`` centroids
    (``kmeans_iters`` Lloyd iterations, on the task's device), saved as
    ``.npy`` (by rank 0; every rank ends with the same centroids)."""

    USE_MODEL = False
    DISTRIBUTED = True

    def setup(self):
        super().setup()
        if not (self.cfg.output and str(self.cfg.output).endswith(".npy")):
            raise ValueError("Specify a .npy output for the IVF centroids")
        if not self.cfg.ivf_K:
            raise ValueError("Specify ivf_K (e.g. 1048576)")

    def load_data(self):
        self.print(f"Loading training data from {self.cfg.trainset}")
        (self.train_vecs, _), _ = load_vec_trainset(self.cfg)
        self.print(f"Training set: {self.train_vecs.shape}")

    def run(self):
        cfg = self.cfg
        centroids = kmeans(self.train_vecs, int(cfg.ivf_K),
                           iters=int(cfg.get("kmeans_iters", 100) or 100), seed=cfg.seed,
                           verbose=cfg.verbose, device=self.device, mesh=self.mesh)
        self.print(f"Storing IVF centroids to {cfg.output}")
        if self.is_main:
            np.save(cfg.output, centroids)
        barrier(self.mesh)
        return centroids


class EncodeDBTask(BaseTask):
    """Encode the database (or the training + validation rows with
    ``encode_trainset=true``) through ``encode_chunked`` at ``batch``
    vectors a chunk, and write the part-file contract of the JAX package:
    a header npz ``{n_parts, K, M, D}`` at ``output`` and
    ``<base>.part_{g}.npz`` holding ``codes (n, M_ivf)``.

    Over a process group, data group ``g`` of ``G`` encodes the rows
    ``[(n//G)·g, (n//G)·(g+1))`` (the last group takes the rest) and its
    model rank 0 writes part ``g``; rank 0 writes the header with
    ``n_parts = G``.  With ``mesh.model > 1`` and an IVF model, the ranks
    of a model group split the IVF book and encode their group's rows
    together (without IVF each encodes them whole).  The task returns when
    every part and the header exist."""

    DISTRIBUTED = True

    def setup(self):
        super().setup()
        if not (self.cfg.output and str(self.cfg.output).endswith(".npz")):
            raise ValueError("Specify a .npz output path")

    def load_data(self):
        cfg = self.cfg
        if cfg.encode_trainset:
            (train_vecs, val_vecs), _ = load_vec_trainset(cfg)
            self.db_vecs = np.concatenate([np.asarray(train_vecs), np.asarray(val_vecs)], axis=0)
            self.print(f"Training + validation sets: {self.db_vecs.shape}")
        else:
            self.print(f"Loading database from {cfg.db}")
            self.db_vecs, _ = load_vec_db(cfg)
            self.print(f"Database: {self.db_vecs.shape}")
        self.data_dim = self.db_vecs.shape[-1]

    def run(self):
        cfg, mesh = self.cfg, self.mesh
        output_base = str(cfg.output)[:-4]
        n_parts, part = mesh.data_size, mesh.data_rank
        n = len(self.db_vecs)
        start = (n // n_parts) * part
        end = (n // n_parts) * (part + 1) if part < n_parts - 1 else n
        params, sharded = self.params, mesh.model_size > 1 and self.spec.ivf_in_use
        if sharded:
            self.print(f"Sharding the IVF codebook over {mesh.model_size} ranks")
            params = params._replace(codebook0=shard_codebook(mesh, params.codebook0))
        timers = TimersManager("encode", "saving")
        self.print(f"Encoding {n} vectors using {n_parts} data group(s)")
        with timers.encode:
            # the reference stores the codes transposed, (n, M_ivf)
            codes = encode_chunked(params, self.spec, self.db_vecs[start:end], batch=cfg.batch,
                                   enc_max_bs=cfg.enc_max_bs, mesh=mesh if sharded else None).T
        self.print(f"Encoding done in {timers.encode} ({timers.encode.s()})")
        with timers.saving:
            if self.is_main:
                np.savez_compressed(cfg.output, n_parts=n_parts, K=cfg.K, M=cfg.M,
                                    D=self.spec.D)
            if mesh.model_rank == 0:
                np.savez_compressed(f"{output_base}.part_{part}.npz", codes=codes)
            barrier(mesh)
        self.print(f"Stored codes into {cfg.output} and {n_parts} part file(s) "
                   f"[done in {timers.saving}]")
        return codes


class EncodedDBIterator:
    """Streams the part files of an encoded database, in part order."""

    def __init__(self, cfg, base_path: str):
        if not str(base_path).endswith(".npz"):
            raise ValueError(f"an encoded database is a .npz header, got {base_path}")
        self.part_base_path = str(base_path)[:-4]
        info = np.load(base_path)
        self.n_parts = int(info["n_parts"])
        for name in ("K", "M"):
            val = int(info[name])
            if cfg.get(name) is None:
                cfg[name] = val
            elif cfg[name] != val:
                raise ValueError(f"{name} mismatch: cfg {cfg[name]} vs db {val}")
        self.D = int(info["D"])
        self.batch_start_id = 0

    def iter(self, batch_size: int | None = None):
        self.batch_start_id = 0
        for i_part in range(self.n_parts):
            codes = np.load(f"{self.part_base_path}.part_{i_part}.npz")["codes"]
            bs = batch_size or len(codes)
            for ib in range(0, len(codes), bs):
                batch = codes[ib:ib + bs]
                self.batch_end_id = self.batch_start_id + len(batch)
                yield batch
                self.batch_start_id += len(batch)

    def load_all(self) -> np.ndarray:
        return np.concatenate(list(self.iter()), axis=0)


class BuildIndexTask(BaseTask):
    USE_MODEL = False

    def run(self):
        from ..search.index_build import run_build_index

        return run_build_index(self)


class TrainPairwiseDecoderTask(BaseTask):
    USE_MODEL = False

    def load_data(self):
        (self.train_vecs, self.val_vecs), _ = load_vec_trainset(self.cfg)
        self.data_dim = self.train_vecs.shape[-1]

    def run(self):
        from ..search.pairwise_decoder import run_train_pairwise_decoder

        return run_train_pairwise_decoder(self)


class SearchTask(BaseTask):
    """IVF search over an index (``index=``), or the flat search of a
    database (``db=``)."""

    def load_data(self):
        cfg = self.cfg
        self.xq, self.xq_gt = load_queries_data(cfg)
        if cfg.index:
            self.print(f"Reading index from {cfg.index}")
        else:
            self.print(f"Reading database from {cfg.db}")
            self.db, _ = load_vec_db(cfg)
        self.data_dim = self.xq.shape[-1]

    def run(self):
        from ..search.search import run_search_flat, run_search_ivf

        return run_search_ivf(self) if self.cfg.index else run_search_flat(self)
