"""Search-pipeline tasks (counterpart of ``qinco_tpu/tasks/search_tasks.py``):
IVF centroid training, DB encoding into part files, the index build,
the pairwise decoder's training and the search.  One process encodes
the whole database as one part; encoding with the IVF book sharded over
several cards (``mesh.model > 1``) is not ported yet (ROADMAP A11)."""

from __future__ import annotations

import numpy as np

from ..data.datasets import load_queries_data, load_vec_db, load_vec_trainset
from ..models.qinco import encode_chunked
from ..ops.kmeans import kmeans
from ..utils import TimersManager
from .base import BaseTask


class IVFTrainTask(BaseTask):
    """k-means of the training set into ``ivf_K`` centroids
    (``kmeans_iters`` Lloyd iterations, on the task's device), saved as
    ``.npy``."""

    USE_MODEL = False

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
        # a writable copy in memory: the rows may be a read-only memmap
        centroids = kmeans(np.array(self.train_vecs, np.float32), int(cfg.ivf_K),
                           iters=int(cfg.get("kmeans_iters", 100) or 100), seed=cfg.seed,
                           verbose=cfg.verbose, device=self.device)
        self.print(f"Storing IVF centroids to {cfg.output}")
        np.save(cfg.output, centroids)
        return centroids


class EncodeDBTask(BaseTask):
    """Encode the database (or the training + validation rows with
    ``encode_trainset=true``) through ``encode_chunked`` at ``batch``
    vectors a chunk, and write the part-file contract of the JAX package:
    a header npz ``{n_parts, K, M, D}`` at ``output`` and
    ``<base>.part_0.npz`` holding ``codes (n, M_ivf)``."""

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
        cfg = self.cfg
        output_base = str(cfg.output)[:-4]
        if cfg.mesh.model > 1 and self.spec.ivf_in_use:
            raise NotImplementedError(
                "encoding with the IVF book sharded over mesh.model > 1 cards is not ported "
                "(ROADMAP A11)")
        timers = TimersManager("encode", "saving")
        self.print(f"Encoding {len(self.db_vecs)} vectors using 1 process(es)")
        with timers.encode:
            # the reference stores the codes transposed, (n, M_ivf)
            codes = encode_chunked(self.params, self.spec, self.db_vecs, batch=cfg.batch,
                                   enc_max_bs=cfg.enc_max_bs).T
        self.print(f"Encoding done in {timers.encode}")
        with timers.saving:
            np.savez_compressed(cfg.output, n_parts=1, K=cfg.K, M=cfg.M, D=self.spec.D)
            np.savez_compressed(f"{output_base}.part_0.npz", codes=codes)
        self.print(f"Stored codes into {cfg.output} and 1 part file(s) "
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
